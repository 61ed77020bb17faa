"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card: ``nvidia-smi`` name and power limit, torch's CUDA device;
  2. build every CUDA kernel of the serving path from ``src/`` with nvcc;
  3. each kernel against its plain PyTorch version on the card, in bf16 and
     f32, at the shapes the serving path gives it and at the TPU kernel's
     own (BH, S, d) case; the kernel's time beside the plain version's, one
     PyTorch library call's, and the least time the card could take;
  4. gemma3-1b at full width cut to 2 layers (one sliding-window, one
     global), f32: the engine on the CPU
     (plain attention) and on the card (the kernel) must give identical
     greedy tokens, and serve_step logits within a stated tolerance;
  5. gemma3-1b at full width (26 layers, bf16 compute, f32 params, random
     weights from seed 0) served through ``repro_torch.launch.serve``: 4
     requests of 600-700 prompt tokens, 16 new tokens each; every kernel
     launch counter is set to 0 just before and read just after, and the
     flash-attention kernel must have run once per layer per step.
The line before the last is the kernels' JSON record; the last line is the
device JSON. Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by the type
# the kernel computes in (bf16 on tensor cores; f32 on the CUDA cores, since
# the f32 path uses no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tests/test_kernels.py TOL, by dtype: printed beside each case as the repo's
# reference, not used to pass or fail it
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}
# what a case must meet: the kernel and its plain version both compute in f32
# from the same inputs, so they differ by summation order and, in bf16, by
# one rounding of the output (one bf16 step is at most |x|/128)
CHECK_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-4),
             torch.bfloat16: dict(rtol=1 / 128, atol=2e-3)}

ARCH = "gemma3-1b"
REQUESTS, PROMPT_MIN, PROMPT_MAX, MAX_NEW = 4, 600, 700, 16
PREFILL_CHUNK, BLOCK_SIZE = 128, 16
# phase 4: f32 CPU vs card, logits |Δ| <= atol + rtol·|cpu| (summation order
# differs between the CPU and the card; both are full f32)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------


def serving_case(cfg, Sq: int, q0, ctx, dtype, seed: int):
    """Attention inputs as attention_paged gives them during phase 5: batch
    REQUESTS, the gathered context of the engine's block tables (Skv), the
    G query heads of gemma3-1b's single KV head; row b's new tokens at
    positions q0[b].. (−1 past its context), keys 0..ctx[b]-1 (−1 after);
    ctx 0 is a padding row."""
    B = REQUESTS
    Skv = -(-(PROMPT_MAX + MAX_NEW) // BLOCK_SIZE) * BLOCK_SIZE
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)
    qpos = torch.full((B, Sq), -1, dtype=torch.int32)
    kpos = torch.full((B, Skv), -1, dtype=torch.int32)
    for b in range(B):
        n = min(Sq, ctx[b] - q0[b]) if ctx[b] else 0
        qpos[b, :n] = torch.arange(q0[b], q0[b] + n)
        kpos[b, :ctx[b]] = torch.arange(ctx[b])
    return dict(q=mk(B, Sq, H, dh), k=mk(B, Skv, Hkv, dh),
                v=mk(B, Skv, Hkv, dh), q_positions=qpos.cuda(),
                kv_positions=kpos.cuda(), window=cfg.window)


def tpu_case(BH: int, S: int, d: int, dtype, seed: int):
    """The TPU kernel's own case: (BH, S, d), causal over arange, Sq == Skv;
    heads folded into the batch (H = Hkv = 1)."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda: torch.randn(BH, S, 1, d, generator=g).to("cuda", dtype)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(BH, S)
    return dict(q=mk(), k=mk(), v=mk(), q_positions=pos.contiguous(),
                kv_positions=pos.contiguous(), window=0)


def bound(case, ref) -> tuple:
    """Times (ms) the bytes and the operations of this call need at the
    card's peaks: bytes / HBM rate, operations / peak rate of the type; the
    least time the card could take is the larger. Counts what these inputs
    need: q, out, positions, and the K/V rows some query of the batch row
    may see; 4·dh operations per visible (query head, key) pair."""
    q, k = case["q"], case["k"]
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    vis = ref.visible(case["q_positions"], case["kv_positions"],
                      causal=True, window=case["window"])
    es = q.element_size()
    keys = int(vis.any(dim=1).sum())
    nbytes = (2 * q.numel() * es + 2 * keys * Hkv * dh * es
              + 4 * (case["q_positions"].numel()
                     + case["kv_positions"].numel()))
    ops = 4 * dh * H * int(vis.sum())
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[q.dtype] * 1e3


def check_kernel_case(name: str, case, fa, ref) -> dict:
    import torch.nn.functional as F

    kw = {n: case[n] for n in ("q_positions", "kv_positions", "window")}
    q, k, v = case["q"], case["k"], case["v"]
    got = fa.flash_attention(q, k, v, causal=True, **kw)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=True, **kw)
    keep = case["q_positions"] >= 0      # rows with no visible key hold 0
    g, w = got[keep].float(), want[keep].float()
    err = (g - w).abs()
    tol = CHECK_TOL[q.dtype]
    ok = bool((err <= tol["atol"] + tol["rtol"] * w.abs()).all())
    if not torch.isfinite(got).all() or got[~keep].any():
        ok = False
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True, **kw))
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True, **kw),
                       iters=5)
    # the library yardstick: SDPA with the same boolean mask, GQA inside
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = ref.visible(case["q_positions"], case["kv_positions"], causal=True,
                       window=case["window"])[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    bytes_ms, ops_ms = bound(case, ref)
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    row = dict(case=name, dtype=str(q.dtype).replace("torch.", ""),
               shape=dict(B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1],
                          H=q.shape[2], Hkv=k.shape[2], dh=q.shape[3]),
               max_abs_err=float(err.max()), tol=tol, repo_tol=TOL[q.dtype],
               ok=ok, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms)
    log(f"  {name:>14} {row['dtype']:>8} err={row['max_abs_err']:.3e} "
        f"{'ok' if ok else 'FAIL'} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
        f"sdpa={library_ms:.4f}ms bound={bound_ms:.5f}ms ({bound_by})")
    return row


def phase_kernels(cfg, fa, ref) -> list:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        # decode: every row at S=1 past the 512 window, one padding row
        rows.append(check_kernel_case("decode", serving_case(
            cfg, 1, q0=[699, 649, 0, 612], ctx=[700, 650, 0, 613],
            dtype=dtype, seed=1), fa, ref))
        # a prefill chunk: the 6th chunk of a 700-token prompt (positions
        # 640.., 60 valid, −1 after), a first chunk, a padding row, a chunk
        # whose window starts inside the context
        rows.append(check_kernel_case("prefill_chunk", serving_case(
            cfg, PREFILL_CHUNK, q0=[640, 0, 0, 512], ctx=[700, 128, 0, 640],
            dtype=dtype, seed=2), fa, ref))
        for BH, S, d in ((8, 512, 128), (16, 2048, 128)):
            rows.append(check_kernel_case(
                f"tpu_{BH}x{S}x{d}", tpu_case(BH, S, d, dtype, seed=S + d),
                fa, ref))
    return rows


# ---------------------------------------------------------------------------
# phase 4: reduced depth, f32, CPU plain attention vs the card's kernel
# ---------------------------------------------------------------------------


def run_steps(lm, prompts):
    """A prefill of each prompt in one step, then one decode step (of token
    7), through serve_step; returns both steps' logits on the CPU."""
    from repro_torch.models.attention import KVView

    dev = lm.device
    B, S = len(prompts), max(len(p) for p in prompts)
    width = -(-(S + 1) // BLOCK_SIZE)
    bt = torch.arange(B * width, dtype=torch.int32).reshape(B, width)
    toks = torch.zeros(B, S, dtype=torch.int32)
    pos = torch.full((B, S), -1, dtype=torch.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.as_tensor(p)
        pos[b, :len(p)] = torch.arange(len(p))
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    pools = lm.init_pools(B * width, BLOCK_SIZE)
    view = KVView(bt.to(dev), pos.to(dev), lens.to(dev), (lens - 1).to(dev))
    first, pools = lm.serve_step(toks.to(dev), pools, view)
    nxt = torch.full((B, 1), 7, dtype=torch.int32, device=dev)
    view = KVView(bt.to(dev), lens[:, None].to(dev), (lens + 1).to(dev),
                  torch.zeros(B, dtype=torch.int32, device=dev))
    second, _ = lm.serve_step(nxt, pools, view)
    return [first.cpu(), second.cpu()]


def phase_reference(cfg_full):
    import numpy as np

    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE
    from repro_torch.serve import Engine, Request, ServeConfig

    # one sliding-window and one global layer: the 530-token prompt reaches
    # past the window, so the two layers' masks differ
    cfg = cfg_full.scaled(num_layers=2, layer_pattern=("swa", "attn"))
    cpu = LM(cfg, SMOKE, device="cpu", seed=0)
    gpu = LM(cfg, SMOKE, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (530, 97)]
    want, got = run_steps(cpu, prompts), run_steps(gpu, prompts)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **LOGIT_TOL)
    sc = ServeConfig(max_batch=2, s_max=540, block_size=BLOCK_SIZE,
                     prefill_chunk=PREFILL_CHUNK)
    tokens = []
    for lm, dev in ((cpu, "cpu"), (gpu, "cuda")):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        Engine(lm, cfg, SMOKE, sc, device=dev).run(reqs, seed=0)
        tokens.append([r.out_tokens for r in reqs])
    if tokens[0] != tokens[1]:
        raise AssertionError(f"greedy tokens differ: cpu {tokens[0]} "
                             f"card {tokens[1]}")
    log(f"  2-layer f32: logits max|Δ| {err:.3e} within {LOGIT_TOL}; greedy "
        f"tokens identical {tokens[1]}")
    return err


# ---------------------------------------------------------------------------
# phase 5: serve gemma3-1b at full width
# ---------------------------------------------------------------------------


def phase_serve(cfg, fa):
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0                                # count the main path only
    t0 = time.monotonic()
    eng, reqs = serve.main([
        "--arch", ARCH, "--device", "cuda", "--requests", str(REQUESTS),
        "--prompt-len", str(PROMPT_MAX), "--prompt-len-min", str(PROMPT_MIN),
        "--max-new", str(MAX_NEW), "--prefill-chunk", str(PREFILL_CHUNK),
        "--block-size", str(BLOCK_SIZE), "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fa.launches
    if not all(r.done and len(r.out_tokens) == MAX_NEW for r in reqs):
        raise AssertionError("a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("a token outside the vocabulary")
    if launches != eng.steps * cfg.num_layers or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"expected {eng.steps} steps x "
                             f"{cfg.num_layers} layers")
    rep = dict(eng.last_report)
    rep.update(steps=eng.steps, launches=launches, wall_s=wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               prompt_lens=[len(r.prompt) for r in reqs],
               params=cfg.param_count())
    log(f"  served {len(reqs)} requests in {eng.steps} steps; "
        f"launches {launches} = {eng.steps} x {cfg.num_layers}")
    log("  latency " + json.dumps(rep))
    return rep


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    log("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    log("phase 2: build")
    t = time.monotonic()
    lib = fa.build()
    log(f"  {fa.SOURCE.relative_to(ROOT)} -> {lib.name} "
        f"({time.monotonic() - t:.1f}s)")
    log(Path(f"{lib}.log").read_text().strip())

    cfg = get_arch(ARCH)
    log("phase 3: kernel vs plain version (within CHECK_TOL)")
    rows = phase_kernels(cfg, fa, ref)
    if not all(r["ok"] for r in rows):
        raise AssertionError("flash_attention disagrees with its plain "
                             "version")

    log("phase 4: 2-layer full-width f32, CPU plain vs card kernel")
    phase_reference(cfg)

    log(f"phase 5: serve {ARCH} at full width, bf16 compute, f32 params")
    rep = phase_serve(cfg, fa)

    log("kernel cases " + json.dumps({"flash_attention": rows}))
    log(f"chip_smoke: {time.monotonic() - t_start:.1f}s")
    # the kernel's record reads the serving path's most frequent call: a
    # decode step in bf16 (every case is on the "kernel cases" line)
    head = next(r for r in rows if r["case"] == "decode"
                and r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": rep["launches"], "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
