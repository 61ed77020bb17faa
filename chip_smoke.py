"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card: ``nvidia-smi`` name and power limit, torch's CUDA device and
     its properties beside the H100 spec the planner uses;
  2. build every CUDA kernel from ``src/`` with nvcc, one nvcc per source,
     all started together; print each library's count of wgmma (``HGMMA``)
     and TMA load (``UTMALDG``) instructions by ``cuobjdump -sass``, and
     fail if any of the three libraries lacks either;
  3. each kernel against its plain PyTorch version on the card, in bf16 and
     f32: flash attention at the shapes the serving path, the
     tensor-parallel path and a rank of phase 10 give it and at the TPU
     kernel's own (BH, S, d) case; matmul at the TPU kernel's test shapes,
     at the shapes the ring schedules of phase 6 and the serve graphs of
     phase 10 give it, and at every shape phase 9's
     backward gives it with a transposed operand, in its layout (``nt``:
     dx = dy·wᵀ, ``tn``: dw = xᵀ·dy; the kernel, the plain version and
     cuBLAS all take the same strided views); the kernel's time beside the
     plain version's, one PyTorch library call's, and the least time the
     card could take, each timed by CUDA events around 20 calls launched from
     Python (``ms``, ``plain_ms``, ``library_ms``: what a caller that
     launches eagerly waits, the host's launch cost included); every row
     also times all three as a CUDA graph of 20 calls replayed between two
     events (``graph_ms``, ``plain_graph_ms``, ``library_graph_ms``: the
     device's time alone), and names the variant its ``plan`` chose
     (flash: ``wgmma``, ``splitkv`` or ``ffma``; the GEMMs: ``wgmma``,
     ``splitk`` or ``ffma``), its tile, the rate reached (TF/s or GB/s, by
     what bounds the call) and the share of the bound, both by ``ms`` and
     by ``graph_ms``;
  4. gemma3-1b at full width cut to 2 layers (one sliding-window, one
     global), f32: the engine on the CPU
     (plain attention) and on the card (the kernel) must give identical
     greedy tokens, and serve_step logits within a stated tolerance;
  5. gemma3-1b at full width (26 layers, bf16 compute, f32 params, random
     weights from seed 0) served through ``repro_torch.launch.serve``: 4
     requests of 600-700 prompt tokens, 16 new tokens each; every kernel
     launch counter is set to 0 just before and read just after, and the
     flash-attention kernel must have run once per layer per step, every
     prefill chunk through the wgmma variant and every decode step through
     split-KV, at call shapes phase 3 checked;
  6. the tensor-parallel training forward: internlm2-1.8b at full width and
     depth (24 layers), batch 2 of 4096 tokens from a numpy seed, random
     weights from seed 0, ``LM.loss`` on one device (the per-block path)
     and on a ring of 4 ranks sharing the card over gloo (each rank its own
     process holding its weight shards; gloo moves host memory, so every
     ring hop is staged through the host, which makes this phase a check
     of correctness and not of TP speed): ``barrier`` and ``cais`` with 1
     and 2 microbatches in f32, and ``cais`` with 2 microbatches in bf16.
     The f32 losses must lie within 1e-4 relative of the one-device f32
     loss, the bf16 loss within ``BF16_LOSS_RTOL`` of the one-device bf16
     loss, and the f32 final hidden states of the cais 2-microbatch run
     within ``HIDDEN_TOL`` of one device's; every rank's matmul launches
     must equal the count derived from its optimized period graphs, all of
     them through the wgmma variant in the bf16 run and the FFMA kernel in
     f32, its flash launches one per layer per microbatch (wgmma in bf16,
     ffma in f32), every matmul
     call shape must be among those phase 3 checked, and a 2-microbatch run
     must execute ``overlap_asym``.
  7. minicpm3-4b (MLA) at full width cut to 2 layers, f32: ``LM.prefill``
     and three ``LM.decode_step`` calls on the CPU (plain versions) and on
     the card (the kernels) must give logits within ``LOGIT_TOL``, and the
     dense engine identical greedy tokens;
  8. minicpm3-4b at full width and depth (62 layers, bf16 compute, f32
     params, random weights from seed 0) served through
     ``repro_torch.launch.serve``, which routes MLA to the dense engine: 4
     requests of 1024 prompt tokens, 16 new tokens each; the launch
     counters are set to 0 just before and read just after: matmul_rmsnorm
     must have run twice a layer (the query and KV latent norms) in every
     prefill and decode call, the prefill's through the wgmma variant and
     every decode step's through split-K, flash attention once a layer in
     the prefill through the wgmma variant, and every call shape of both
     must be among those phase 3 checked;
  9. one training step of internlm2-1.8b at full width and depth: batch 2 of
     4096 tokens (train_4k's length, its global batch of 256 cut to 2) from
     ``data.pipeline.make_batch``, seed 0, random weights from seed 0,
     AdamW at a constant lr ``TRAIN_LR``. First the one-device step (f32,
     remat on, the per-block path), whose loss, grad norm, gradients, m, v
     and updated parameters are kept in files on the host while the card is
     freed; then one spawn of 4 gloo ranks sharing the card runs the step
     through ``train.step.make_train_step`` (LM.loss, each period's
     graph-built backward, the ring's grad sums, AdamW) for ``barrier`` with
     1 microbatch and ``cais`` with 2, in f32, and ``cais`` with 2 in bf16.
     Each run's loss must lie within 1e-4 (f32) or ``BF16_LOSS_RTOL`` (bf16)
     of one device's; in f32 the grad norm within ``TRAIN_RTOL``, every
     gradient, m and v within ``TRAIN_RTOL`` times the one-device tensor's
     max, and every parameter within the first-step bound (2 lr where the
     one-device gradient lies within its bound of zero, where Adam's sign
     may differ; 1e-3 lr elsewhere; plus 1e-6 |p|); every rank's matmul and
     flash launches must equal the counts derived from the optimized
     forward and training graphs, the transposed layouts must run on wgmma
     in bf16 and FFMA in f32, overlap_asym must execute as the graphs say,
     with a backward node paired with a forward one at 2 microbatches, and
     every matmul call shape and layout must be among those phase 3
     checked. Step times are printed with the note that gloo stages every
     hop through the host.
 10. paged serving over the ring: internlm2-1.8b at full width and depth,
     random weights from seed 0, f32 params, phase 5's traffic (4 requests
     of 600-700 prompt tokens, 16 new tokens, prefill chunk 128, block 16)
     through the paged ``Engine``, and a scripted ``serve_step`` schedule (2
     prefill chunks of 128 for the 4 rows, a mixed step of 127 tokens, 4
     decode steps). First on one device in f32 and bf16 compute, its tokens,
     top-2 margins and logits kept on the host while the card is freed; then
     one spawn of 4 gloo ranks sharing the card (each holding its weight
     shards and its kv heads' pools) runs ``barrier`` f32, ``cais`` f32 and
     ``cais`` bf16: the f32 logits must lie within ``LOGIT_TOL`` of one
     device's, the bf16 ones within ``BF16_LOGIT_FACTOR`` times one device's
     bf16 distance from its f32 logits, every rank's logits bitwise equal and
     its tokens identical, the f32 tokens one device's (or, from a request's
     first difference, a one-device top-2 margin below ``LOGIT_TOL``), the
     matmul launches equal to ``matmul_calls`` of the optimized serve graphs,
     flash once a layer a step (decode on split-KV, prefill on wgmma in bf16
     and FFMA in f32), two ``gemm_ar`` a layer a step dispatched through the
     backend, and every call shape of both kernels among phase 3's. Then
     gemma3-1b cut to one period (5 sliding-window layers and a global one;
     its kv head replicated and sliced on each rank), ``cais`` f32, its
     scripted logits over 4 prefill chunks (past the 512 window) within
     ``LOGIT_TOL`` of one device's.
Phase 3 also holds matmul_rmsnorm against its plain version at the TPU
kernel's test shapes, at every shape phase 8 calls (b a column slice of
``wkv_a`` for the KV latent) and at N 8192, and flash attention at the MLA
prefill's call (dh 96, dv 64).
The line before the last is the kernels' JSON record; the last line is the
device JSON. Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
# flash attention's wgmma variant rounds each probability p to bf16 before
# p @ v, as JAX's model does (p.astype(v.dtype)); the plain version keeps p
# in f32. A rounding moves p by at most 2^-8 p, so an output element by at
# most 2^-8 sum_j p_j |v_j| / l: this bound, computed by the plain version
# on |v|, is added to CHECK_TOL on the wgmma rows only
P_ROUNDING = 2.0 ** -8

ARCH = "gemma3-1b"
# phase 6: the tensor-parallel training forward (train_4k's length)
TP_ARCH, TP_WORLD, TP_BATCH, TP_SEQ, SEED = "internlm2-1.8b", 4, 2, 4096, 0
TP_RUNS = [("barrier", 1, "float32"), ("barrier", 2, "float32"),
           ("cais", 1, "float32"), ("cais", 2, "float32"),
           ("cais", 2, "bfloat16")]
# f32 TP loss against the one-device f32 loss: the same f32 math summed in
# another order (ring partial sums, the kernel's k order, cuBLAS's)
F32_LOSS_RTOL = 1e-4
# bf16 TP loss against the one-device bf16 loss: both round every
# activation to bf16 (2^-9 relative), at different points (the ring adds
# partial sums in bf16; cuBLAS rounds once); the mean over 8192 tokens
# averages the per-token differences
BF16_LOSS_RTOL = 1e-2
# f32 final hidden states, TP against one device (as LOGIT_TOL)
HIDDEN_TOL = dict(rtol=1e-4, atol=1e-4)
# phase 9: one training step on the ring against one device, AdamW at a
# constant lr (the launcher's cosine schedule gives lr 0 at step 0, which
# would compare nothing)
TRAIN_RUNS = [("barrier", 1, "float32"), ("cais", 2, "float32"),
              ("cais", 2, "bfloat16")]
TRAIN_LR = 1e-4
# AdamW's eps and clip norm (its defaults), named for the parameter bound
TRAIN_EPS, TRAIN_CLIP = 1e-8, 1.0
# f32 gradients, m and v against one device: |Δ| <= TRAIN_RTOL·max|ref| of
# each tensor (the same f32 math summed in other orders: ring partial sums,
# the kernels' k order, cuBLAS's), and the grad norm within TRAIN_RTOL
TRAIN_RTOL = 1e-4
REQUESTS, PROMPT_MIN, PROMPT_MAX, MAX_NEW = 4, 600, 700, 16
PREFILL_CHUNK, BLOCK_SIZE = 128, 16
# phase 4: f32 CPU vs card, logits |Δ| <= atol + rtol·|cpu| (summation order
# differs between the CPU and the card; both are full f32)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# phases 7 and 8: minicpm3-4b (MLA) through the dense engine
MLA_ARCH, MLA_REQUESTS, MLA_PROMPT, MLA_MAX_NEW = "minicpm3-4b", 4, 1024, 16
# matmul_rmsnorm's check, per element of out = z·(1 + scale)/rms(z) with
# z = a @ b: CHECK_TOL on out, plus matmul_tol on z (the two f32 summation
# orders of z) carried through the norm, i.e. scaled by |1 + scale[n]| /
# rms(z[m]); the two rms differ by far less, as each averages N errors
MLN_EPS = 1e-6
# phase 10: paged serving over the ring (phase 5's traffic): internlm2-1.8b
# (kv heads sharded, 2 a rank) in these (mode, compute type) runs, its
# scripted serve_step logits over SCRIPTED_CHUNKS prefill chunks; then
# gemma3-1b cut to one period (5 sliding-window layers and a global one;
# its one kv head replicated and sliced on every rank), cais f32, over
# REPL_CHUNKS chunks, so that positions pass its 512 window
SERVE_TP_RUNS = [("barrier", "float32"), ("cais", "float32"),
                 ("cais", "bfloat16")]
SCRIPTED_CHUNKS = 2
REPL_ARCH, REPL_LAYERS, REPL_CHUNKS = "gemma3-1b", 6, 4
# bf16 ring logits against the one-device bf16 logits: both round every
# activation to bf16, and the ring also rounds each rank's partial product
# before the gemm_ar sums the four in bf16 (two more roundings a reduction
# than one device's one). So the ring lies within a few of one device's
# distances from the f32 logits, and ||ring - one|| <= ||ring - f32|| +
# ||one - f32||: held per step at BF16_LOGIT_FACTOR times ||one - f32||
# (Frobenius norms over the rows)
BF16_LOGIT_FACTOR = 4.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call, by CUDA events around ``iters`` calls
    launched from Python back to back: the device time, or the host's time
    to launch the call where that is longer."""
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


def graph_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph (after ``warmup`` calls on the capturing stream), the graph
    replayed between two CUDA events. The replay launches no Python, so a
    call of a few microseconds is timed on the device and not by the host
    code around it (that is :func:`cuda_ms`)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timings(kernel, plain, library) -> dict:
    """The kernel's, the plain version's and the library call's times,
    launched from Python (:func:`cuda_ms`) and replayed as a graph
    (:func:`graph_ms`)."""
    return dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library), graph_ms=graph_ms(kernel),
                plain_graph_ms=graph_ms(plain),
                library_graph_ms=graph_ms(library))


def achieved(bytes_ms: float, ops_ms: float, bound_by: str, ms: float,
             dtype, graph: Optional[float] = None) -> dict:
    """The rate the call reached in ``ms`` in the unit of what bounds it
    (GB/s of HBM or TF/s of the type's peak) and its share of that bound;
    with ``graph`` (the call's graph time), the share by that time too."""
    if bound_by == "bytes":
        rate = dict(value=HBM_BYTES_PER_S * bytes_ms / ms / 1e9, unit="GB/s")
    else:
        rate = dict(value=PEAK_FLOPS[dtype] * ops_ms / ms / 1e12,
                    unit="TF/s")
    row = dict(achieved=rate, bound_share=max(bytes_ms, ops_ms) / ms)
    if graph is not None:
        row.update(graph_bound_share=max(bytes_ms, ops_ms) / graph)
    return row


def sass_census(lib: Path) -> dict:
    """Count the wgmma (``HGMMA``) and TMA load (``UTMALDG``) instructions
    in a built library's SASS, by ``cuobjdump -sass``."""
    import os

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return {op: sum(op in line for line in sass.splitlines())
            for op in ("HGMMA", "UTMALDG")}


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------


def serving_skv() -> int:
    """The keys attention_paged gathers in phase 5: the engine's block
    table width (s_max = prompt + new tokens, in blocks) times the block."""
    return -(-(PROMPT_MAX + MAX_NEW) // BLOCK_SIZE) * BLOCK_SIZE


def serving_case(cfg, Sq: int, q0, ctx, dtype, seed: int):
    """Attention inputs as attention_paged gives them during phase 5: batch
    REQUESTS, the gathered context of the engine's block tables (Skv), the
    G query heads of gemma3-1b's single KV head; row b's new tokens at
    positions q0[b].. (−1 past its context), keys 0..ctx[b]-1 (−1 after);
    ctx 0 is a padding row."""
    B = REQUESTS
    Skv = serving_skv()
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


def get_tp_cfg():
    from repro_torch.configs import get_arch

    return get_arch(TP_ARCH)


def tp_core_case(cfg, B: int, dtype, seed: int):
    """The attention core as a rank of phase 6 calls it: TP_SEQ causal
    positions, H/TP_WORLD query heads over Hkv/TP_WORLD kv heads."""
    g = torch.Generator().manual_seed(seed)
    H, Hkv = cfg.num_heads // TP_WORLD, cfg.num_kv_heads // TP_WORLD
    dh = cfg.resolved_head_dim
    mk = lambda h: torch.randn(B, TP_SEQ, h, dh, generator=g).to("cuda",
                                                                 dtype)
    pos = torch.arange(TP_SEQ, dtype=torch.int32,
                       device="cuda").expand(B, TP_SEQ).contiguous()
    return dict(q=mk(H), k=mk(Hkv), v=mk(Hkv), q_positions=pos,
                kv_positions=pos, window=0)


def get_mla_cfg():
    from repro_torch.configs import get_arch

    return get_arch(MLA_ARCH)


def mla_core_case(cfg, dtype, seed: int):
    """The attention core of an MLA prefill layer in phase 8: MLA_REQUESTS
    prompts of MLA_PROMPT causal positions, H query = kv heads, q/k head dim
    nope + rope (96), v head dim 64."""
    m = cfg.mla
    g = torch.Generator().manual_seed(seed)
    B, S, H = MLA_REQUESTS, MLA_PROMPT, cfg.num_heads
    mk = lambda d: torch.randn(B, S, H, d, generator=g).to("cuda", dtype)
    dh = m.qk_nope_head_dim + m.qk_rope_head_dim
    pos = torch.arange(S, dtype=torch.int32,
                       device="cuda").expand(B, S).contiguous()
    return dict(q=mk(dh), k=mk(dh), v=mk(m.v_head_dim), q_positions=pos,
                kv_positions=pos, window=0)


def bound(case, ref) -> tuple:
    """Times (ms) the bytes and the operations of this call need at the
    card's peaks: bytes / HBM rate, operations / peak rate of the type; the
    least time the card could take is the larger. Counts what these inputs
    need: q, out, positions, and the K/V rows some query of the batch row
    may see; 2·(dh + dv) operations per visible (query head, key) pair."""
    q, k = case["q"], case["k"]
    B, Sq, H, dh = q.shape
    Hkv, dv = k.shape[2], case["v"].shape[3]
    vis = ref.visible(case["q_positions"], case["kv_positions"],
                      causal=True, window=case["window"])
    es = q.element_size()
    keys = int(vis.any(dim=1).sum())
    nbytes = (B * Sq * H * (dh + dv) * es + keys * Hkv * (dh + dv) * es
              + 4 * (case["q_positions"].numel()
                     + case["kv_positions"].numel()))
    ops = 2 * (dh + dv) * H * int(vis.sum())
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[q.dtype] * 1e3


def flash_plan(fa, q, k, v):
    return fa.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                   k.shape[2], q.shape[3], v.shape[3], q.dtype)


def check_kernel_case(name: str, case, fa, ref) -> dict:
    import torch.nn.functional as F

    kw = {n: case[n] for n in ("q_positions", "kv_positions", "window")}
    q, k, v = case["q"], case["k"], case["v"]
    p = flash_plan(fa, q, k, v)
    got = fa.flash_attention(q, k, v, causal=True, **kw)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=True, **kw)
    keep = case["q_positions"] >= 0      # rows with no visible key hold 0
    g, w = got[keep].float(), want[keep].float()
    err = (g - w).abs()
    tol = CHECK_TOL[q.dtype]
    check = tol["atol"] + tol["rtol"] * w.abs()
    limit = check
    if p.variant == "wgmma":
        limit = check + P_ROUNDING * ref.attention_ref(
            q, k, v.abs(), causal=True, **kw)[keep].float()
    ok = bool((err <= limit).all())
    if not torch.isfinite(got).all() or got[~keep].any():
        ok = False
    # the library yardstick: SDPA with the same boolean mask, GQA inside
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = ref.visible(case["q_positions"], case["kv_positions"], causal=True,
                       window=case["window"])[:, None]
    t = timings(lambda: fa.flash_attention(q, k, v, causal=True, **kw),
                lambda: ref.attention_ref(q, k, v, causal=True, **kw),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True))
    ms = t["ms"]
    bytes_ms, ops_ms = bound(case, ref)
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    row = dict(case=name, dtype=str(q.dtype).replace("torch.", ""),
               shape=dict(B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1],
                          H=q.shape[2], Hkv=k.shape[2], dh=q.shape[3],
                          dv=v.shape[3]),
               variant=p.variant, tile=list(p.tile), splits=p.splits,
               ctas=p.ctas, max_abs_err=float(err.max()),
               tol=dict(tol, p_rounding=(
                   "2^-8 * attention_ref(q, k, |v|)"
                   if p.variant == "wgmma" else None)),
               worst_err_over_limit=float((err / limit).max()),
               worst_err_over_check_tol=float((err / check).max()),
               repo_tol=TOL[q.dtype], ok=ok, **t, bound_ms=bound_ms,
               bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
               **achieved(bytes_ms, ops_ms, bound_by, ms, q.dtype,
                          t["graph_ms"]))
    log(f"  {name:>14} {row['dtype']:>8} {p.variant} {p.tile[0]}x"
        f"{p.tile[1]} splits {p.splits} err={row['max_abs_err']:.3e} "
        f"(err/limit {row['worst_err_over_limit']:.3f}, err/CHECK_TOL "
        f"{row['worst_err_over_check_tol']:.3f}) {'ok' if ok else 'FAIL'} "
        f"kernel={ms:.4f}ms plain={t['plain_ms']:.4f}ms "
        f"sdpa={t['library_ms']:.4f}ms (graph: kernel={t['graph_ms']:.4f}ms "
        f"plain={t['plain_graph_ms']:.4f}ms "
        f"sdpa={t['library_graph_ms']:.4f}ms) bound={bound_ms:.5f}ms "
        f"({bound_by}, {row['bound_share']:.1%}; graph "
        f"{row['graph_bound_share']:.1%})")
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
        # the attention-core node of phase 6: the gathered sequence with
        # this rank's heads (16/4 q heads, 8/4 kv heads), per microbatch
        rows.append(check_kernel_case("tp_core", tp_core_case(
            get_tp_cfg(), TP_BATCH // 2, dtype, seed=3), fa, ref))
        for BH, S, d in ((8, 512, 128), (16, 2048, 128)):
            rows.append(check_kernel_case(
                f"tpu_{BH}x{S}x{d}", tpu_case(BH, S, d, dtype, seed=S + d),
                fa, ref))
        # the MLA prefill core of phase 8: dh 96, dv 64
        rows.append(check_kernel_case("mla_prefill", mla_core_case(
            get_mla_cfg(), dtype, seed=4), fa, ref))
    # phase 10's rank-local cores: internlm2-1.8b's 4 q / 2 kv heads (bf16
    # and f32) and gemma3-1b's 1 q head over its replicated kv head (f32,
    # the 512 window), at a decode step, a prefill chunk and the ragged
    # mixed step (decode rows beside prefill rows)
    from repro_torch.configs import get_arch

    for arch, dtypes, p0 in ((TP_ARCH, (torch.bfloat16, torch.float32), 256),
                             (REPL_ARCH, (torch.float32,), 512)):
        rank_cfg = serve_rank_cfg(get_arch(arch))
        for dtype in dtypes:
            for name, Sq, q0, ctx in (
                    ("decode", 1, [699, 649, 0, 612], [700, 650, 0, 613]),
                    ("prefill_chunk", PREFILL_CHUNK, [640, 0, 0, 512],
                     [700, 128, 0, 640]),
                    ("mixed", PREFILL_CHUNK - 1, [p0] * 4,
                     [p0 + 1, p0 + 1, p0 + PREFILL_CHUNK - 1,
                      p0 + PREFILL_CHUNK - 1])):
                rows.append(check_kernel_case(
                    f"ring_{arch.split('-')[0]}_{name}", serving_case(
                        rank_cfg, Sq, q0=q0, ctx=ctx, dtype=dtype,
                        seed=Sq + p0), fa, ref))
    return rows


def tp_matmul_shapes(cfg, itemsize: int) -> list:
    """(M, K, N) of every matmul call of phase 6 on one rank in a type of
    ``itemsize`` bytes, by the schedules' own arithmetic: barrier GEMMs over
    the gathered sequence; cais ring steps of B·S_loc/c rows on the gather
    side (c as the cais planner picks it) and of B·S_loc/2 on the
    bidirectional reduce side; one S_loc slice a hop in overlap_asym.
    Phase 6 checks that its calls were all among these."""
    from repro_torch.core import primitives as prim
    from repro_torch.core.backends import CAISBackend

    n, d, dh = TP_WORLD, cfg.d_model, cfg.resolved_head_dim
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // n
    ff = cfg.d_ff // n
    s_loc = TP_SEQ // n
    shapes = set()
    for mb in (1, 2):
        b = TP_BATCH // mb
        c = prim._pick_chunks(s_loc, CAISBackend.plan_chunks(
            b * TP_SEQ * d * itemsize, n))
        for m_ag, m_rs in ((b * TP_SEQ, b * TP_SEQ),      # barrier
                           (b * s_loc // c, b * s_loc // 2),   # cais rings
                           (b * s_loc, b * s_loc)):       # overlap_asym
            shapes |= {(m_ag, d, fq), (m_ag, d, fkv), (m_ag, d, ff),
                       (m_rs, fq, d), (m_rs, ff, d)}
    return sorted(shapes)


def matmul_tol(a, b, want, dtype):
    """What a matmul case must meet, per element: CHECK_TOL plus the
    difference two f32 summations of the same K products may show in
    different orders, sqrt(K)·2^-24 of the sum of the products' magnitudes
    for each (the probabilistic dot-product bound, Higham and Mary 2019),
    twice. The kernel sums K in its own order and the plain version in
    cuBLAS's; at K = 2048 with unit normal inputs the partial sums reach
    about 45, so the orders differ by up to ~5e-4, beyond CHECK_TOL's atol
    where an output is near 0."""
    tol = CHECK_TOL[dtype]
    K = a.shape[1]
    mag = a.float().abs() @ b.float().abs()
    return (tol["atol"] + tol["rtol"] * want.float().abs()
            + 2 * K ** 0.5 * 2.0 ** -24 * mag)


def check_matmul_case(name, M, K, N, dtype, mmk, ref,
                      layout: str = "nn") -> dict:
    """One matmul case; ``layout`` "t" stores that operand transposed, as
    the backward passes it (aᵀ's storage (K, M), bᵀ's (N, K)), and the
    kernel, the plain version and cuBLAS all take the same strided views."""
    g = torch.Generator().manual_seed(M * 7 + K * 3 + N)
    a = torch.randn(M, K, generator=g).to("cuda", dtype)
    b = torch.randn(K, N, generator=g).to("cuda", dtype)
    if layout[0] == "t":
        a = a.T.contiguous().T
    if layout[1] == "t":
        b = b.T.contiguous().T
    if mmk.layout(a, b) != layout:
        raise AssertionError(f"({M},{K},{N}) is not laid out {layout}")
    got = mmk.matmul(a, b)
    torch.cuda.synchronize()
    want = ref.matmul_ref(a, b)
    err = (got.float() - want.float()).abs()
    tol = CHECK_TOL[dtype]
    limit = matmul_tol(a, b, want, dtype)
    ok = bool((err <= limit).all() and torch.isfinite(got).all())
    worst = float((err / limit).max())
    p = mmk.plan(M, N, K, b.stride(1) if layout[1] == "t" else N, dtype,
                 layout=layout, lda=a.stride(1) if layout[0] == "t" else K)
    t = timings(lambda: mmk.matmul(a, b), lambda: ref.matmul_ref(a, b),
                lambda: torch.matmul(a, b))
    ms = t["ms"]
    es = a.element_size()
    bytes_ms = (M * K + K * N + M * N) * es / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * M * K * N / PEAK_FLOPS[dtype] * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    row = dict(case=name, dtype=str(dtype).replace("torch.", ""),
               shape=dict(M=M, K=K, N=N), layout=layout, variant=p.variant,
               tile=[p.bm, p.bn], ctas=p.ctas, max_abs_err=float(err.max()),
               tol=dict(tol, summation="2*sqrt(K)*2^-24*(|a|@|b|)"),
               worst_err_over_limit=worst, repo_tol=TOL[dtype], ok=ok, **t,
               bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
               ops_ms=ops_ms, **achieved(bytes_ms, ops_ms, bound_by, ms,
                                         dtype, t["graph_ms"]))
    log(f"  {name:>10} {row['dtype']:>8} ({M},{K},{N}) {layout} "
        f"{p.variant} {p.bm}x{p.bn} err={row['max_abs_err']:.3e} (err/limit "
        f"{worst:.3f}) {'ok' if ok else 'FAIL'} kernel={ms:.4f}ms "
        f"plain={t['plain_ms']:.4f}ms cublas={t['library_ms']:.4f}ms "
        f"(graph: kernel={t['graph_ms']:.4f}ms "
        f"plain={t['plain_graph_ms']:.4f}ms "
        f"cublas={t['library_graph_ms']:.4f}ms) bound={bound_ms:.5f}ms "
        f"({bound_by}) {row['achieved']['value']:.1f} "
        f"{row['achieved']['unit']} ({row['bound_share']:.1%} of the bound; "
        f"graph {row['graph_bound_share']:.1%})")
    return row


def phase_matmul(mmk, ref) -> list:
    rows = []
    jax_sweep = [(128, 128, 128), (256, 512, 128), (64, 384, 96),
                 (32, 32, 32), (512, 128, 256), (128, 1024, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in jax_sweep:
            rows.append(check_matmul_case("sweep", M, K, N, dtype, mmk, ref))
        for M, K, N in tp_matmul_shapes(get_tp_cfg(), dtype.itemsize):
            rows.append(check_matmul_case("tp", M, K, N, dtype, mmk, ref))
        # phase 9's backward: dx through wᵀ (nt), dw = xᵀ·dy (tn)
        for M, K, N, lay in train_matmul_shapes(get_tp_cfg()):
            rows.append(check_matmul_case("train", M, K, N, dtype, mmk, ref,
                                          layout=lay))
        # phase 10's serving rows on a rank: decode (M = 4), the ragged
        # mixed step, prefill chunks and the cais ring's partials
        for M, K, N in serve_matmul_shapes(get_tp_cfg(), serve_traffic()):
            rows.append(check_matmul_case("serve_tp", M, K, N, dtype, mmk,
                                          ref))
    from repro_torch.configs import get_arch

    for M, K, N in serve_matmul_shapes(get_arch(REPL_ARCH),
                                       serve_traffic()):
        rows.append(check_matmul_case("serve_repl", M, K, N, torch.float32,
                                      mmk, ref))
    return rows


def train_matmul_shapes(cfg, world: int = TP_WORLD, batch: int = TP_BATCH,
                        seq: int = TP_SEQ, runs=None) -> list:
    """(M, K, N, layout) of every matmul call with a transposed operand that
    phase 9's backward makes on one rank, by the training graph's own
    arithmetic (its forward calls are ``tp_matmul_shapes``'): per chain of
    b = batch / mb rows of the full sequence, the grad all-gathers through
    w_down^T and wo^T (nt, b·S rows), the weight grads xᵀ·dy over the folded
    b·S rows (tn), and the grad reduce-scatters through the concatenated
    transposed up+gate and q+k+v weights (nt: b·S rows under barrier, b·S_loc
    / 2 a hop on the bidirectional cais ring, b·S_loc paired in
    overlap_asym)."""
    runs = TRAIN_RUNS if runs is None else runs
    n, d, dh = world, cfg.d_model, cfg.resolved_head_dim
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    ff, s_loc = cfg.d_ff // n, seq // n
    shapes = set()
    for mode, mb, _ in runs:
        b = batch // mb
        rows = b * seq
        shapes |= {(rows, d, ff, "nt"), (rows, d, fq, "nt"),
                   (ff, rows, d, "tn"), (d, rows, ff, "tn"),
                   (fq, rows, d, "tn"), (d, rows, fq, "tn"),
                   (d, rows, fkv, "tn")}
        m_rs = rows if mode == "barrier" else b * s_loc // 2
        ks = (2 * ff, fq + 2 * fkv)
        shapes |= {(m_rs, k, d, "nt") for k in ks}
        if mb > 1:
            shapes |= {(b * s_loc, k, d, "nt") for k in ks}
    return sorted(shapes)


def mla_norm_shapes(cfg) -> list:
    """(M, K, N, ldb) of every matmul_rmsnorm call of phase 8, by the MLA
    code's own arithmetic: the query latent rmsnorm(x @ wq_a) and the KV
    latent rmsnorm(x @ wkv_a[:, :kv_rank]) (row stride kv_rank + rope), on
    the B·S rows of the prefill and the B rows of a decode step."""
    m, d = cfg.mla, cfg.d_model
    return [(M, d, n, ldb)
            for M in (MLA_REQUESTS * MLA_PROMPT, MLA_REQUESTS)
            for n, ldb in ((m.q_lora_rank, m.q_lora_rank),
                           (m.kv_lora_rank,
                            m.kv_lora_rank + m.qk_rope_head_dim))]


def check_mln_case(name, M, K, N, ldb, dtype, mln, ref) -> dict:
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(M * 7 + K * 3 + N + ldb)
    a = torch.randn(M, K, generator=g).to("cuda", dtype)
    b = torch.randn(K, ldb, generator=g).to("cuda", dtype)[:, :N]
    scale = (0.1 * torch.randn(N, generator=g)).cuda()
    got = mln.matmul_rmsnorm(a, b, scale, eps=MLN_EPS)
    torch.cuda.synchronize()
    want = ref.matmul_rmsnorm_ref(a, b, scale, MLN_EPS)
    z = ref.matmul_ref(a, b.contiguous(), torch.float32)
    rms = torch.sqrt(z.square().mean(-1, keepdim=True) + MLN_EPS)
    tol = CHECK_TOL[dtype]
    limit = (tol["atol"] + tol["rtol"] * want.float().abs()
             + matmul_tol(a, b, z, dtype) * (1 + scale).abs() / rms)
    err = (got.float() - want.float()).abs()
    ok = bool((err <= limit).all() and torch.isfinite(got).all())
    worst = float((err / limit).max())
    p = mln.plan(M, N, K, ldb, dtype)
    # the library yardstick is TWO calls: cuBLAS, then PyTorch's rms_norm
    # (whose weight is 1 + scale), with z through device memory between them
    w1 = (1 + scale).to(dtype)
    t = timings(lambda: mln.matmul_rmsnorm(a, b, scale, eps=MLN_EPS),
                lambda: ref.matmul_rmsnorm_ref(a, b, scale, MLN_EPS),
                lambda: F.rms_norm(torch.matmul(a, b), (N,), w1, MLN_EPS))
    ms = t["ms"]
    es = a.element_size()
    bytes_ms = ((M * K + K * N + M * N) * es + 4 * N) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * M * K * N / PEAK_FLOPS[dtype] * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    row = dict(case=name, dtype=str(dtype).replace("torch.", ""),
               shape=dict(M=M, K=K, N=N, ldb=ldb), variant=p.variant,
               tile=[p.bm, p.bn], cluster=p.cluster, splits=(
                   p.grid[1] if p.variant == "splitk" else 1), ctas=p.ctas,
               max_abs_err=float(err.max()),
               tol=dict(tol, z="matmul_tol * |1 + scale| / rms(z)"),
               worst_err_over_limit=worst, repo_tol=TOL[dtype], ok=ok, **t,
               library="torch.matmul + F.rms_norm (two calls)",
               bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms,
               ops_ms=ops_ms, **achieved(bytes_ms, ops_ms, bound_by, ms,
                                         dtype, t["graph_ms"]))
    log(f"  {name:>10} {row['dtype']:>8} ({M},{K},{N}) ldb {ldb} "
        f"{p.variant} {p.bm}x{p.bn} cluster {p.cluster} splits "
        f"{row['splits']} err={row['max_abs_err']:.3e} (err/limit "
        f"{worst:.3f}) {'ok' if ok else 'FAIL'} kernel={ms:.4f}ms "
        f"plain={t['plain_ms']:.4f}ms "
        f"matmul+rms_norm={t['library_ms']:.4f}ms (graph: "
        f"kernel={t['graph_ms']:.4f}ms plain={t['plain_graph_ms']:.4f}ms "
        f"matmul+rms_norm={t['library_graph_ms']:.4f}ms) "
        f"bound={bound_ms:.5f}ms ({bound_by}) "
        f"{row['achieved']['value']:.1f} {row['achieved']['unit']} "
        f"({row['bound_share']:.1%} of the bound; graph "
        f"{row['graph_bound_share']:.1%})")
    return row


def phase_matmul_rmsnorm(mln, ref) -> list:
    rows = []
    # tests/test_kernels.py's sweep and its model-norm case
    jax_sweep = [(128, 256, 128), (64, 512, 384), (256, 128, 64),
                 (32, 64, 48)]
    for dtype in (torch.bfloat16, torch.float32):
        for M, K, N in jax_sweep:
            rows.append(check_mln_case("sweep", M, K, N, N, dtype, mln, ref))
        for M, K, N, ldb in mla_norm_shapes(get_mla_cfg()):
            rows.append(check_mln_case("mla", M, K, N, ldb, dtype, mln, ref))
        # the row width the TPU kernel's docstring sizes for (N 8192)
        rows.append(check_mln_case("wide", 128, 2048, 8192, 8192, dtype,
                                   mln, ref))
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


def record_calls(ops, calls: dict):
    """Wrap ``ops.flash_attention`` so that each call's shape key (B, Sq, H,
    dh, Skv, Hkv, dv, dtype) is counted in ``calls``; returns the original
    to put back."""
    core = ops.flash_attention

    def core_shapes(q, k, v, **kw):
        key = (*q.shape, k.shape[1], k.shape[2], v.shape[3],
               str(q.dtype).replace("torch.", ""))
        calls[key] = calls.get(key, 0) + 1
        return core(q, k, v, **kw)

    ops.flash_attention = core_shapes
    return core


def phase_serve(cfg, fa):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    calls = {}
    core = record_calls(ops, calls)
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0                            # count the main path only
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        t0 = time.monotonic()
        eng, reqs = serve.main([
            "--arch", ARCH, "--device", "cuda", "--requests", str(REQUESTS),
            "--prompt-len", str(PROMPT_MAX), "--prompt-len-min",
            str(PROMPT_MIN), "--max-new", str(MAX_NEW), "--prefill-chunk",
            str(PREFILL_CHUNK), "--block-size", str(BLOCK_SIZE), "--seed",
            "0"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = fa.launches
        variants = dict(fa.launches_by_variant)
    finally:
        ops.flash_attention = core
    if not all(r.done and len(r.out_tokens) == MAX_NEW for r in reqs):
        raise AssertionError("a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("a token outside the vocabulary")
    if launches != eng.steps * cfg.num_layers or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"expected {eng.steps} steps x "
                             f"{cfg.num_layers} layers")
    # a step whose rows all decode (Sq 1: G query rows a kv head) runs
    # split-KV; a step with a prefill chunk in it runs the wgmma variant
    G = cfg.num_heads // cfg.num_kv_heads
    decode = sum(n for key, n in calls.items()
                 if key[1] * G <= fa.SPLIT_MAX_ROWS)
    want = dict(splitkv=decode, wgmma=launches - decode, ffma=0)
    if variants != want or decode == 0 or decode == launches:
        raise AssertionError(f"flash_attention variants {variants}, "
                             f"expected {want}")
    rep = dict(eng.last_report)
    rep.update(steps=eng.steps, launches=launches, flash_variants=variants,
               wall_s=wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               prompt_lens=[len(r.prompt) for r in reqs],
               params=cfg.param_count(),
               call_shapes=sorted([*k, v] for k, v in calls.items()))
    log(f"  served {len(reqs)} requests in {eng.steps} steps; "
        f"launches {launches} = {eng.steps} x {cfg.num_layers}; flash by "
        f"variant {json.dumps(variants)}")
    log("  latency " + json.dumps(rep))
    return rep


# ---------------------------------------------------------------------------
# phase 6: the tensor-parallel training forward, 4 ranks on the card
# ---------------------------------------------------------------------------


def tp_rank(group, tokens, runs):
    """One rank of phase 6: LM.loss of every run on this rank's shards, with
    the kernels' launch counts (set to 0 just before each run), the counts
    derived from the optimized period graphs, and the overlap_asym
    executions."""
    from repro_torch.core import dataflow
    from repro_torch.core import tp as tp_mod
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime, TPConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_tp_cfg()
    lm = LM(cfg, Runtime(compute_dtype="float32"), device="cuda", seed=0,
            group=group)
    asym = [0]
    for name in ("barrier", "cais"):
        be = get_backend(name)

        def counted(*a, _inner=be.overlap_asymmetric, **k):
            asym[0] += 1
            return _inner(*a, **k)

        be.overlap_asymmetric = counted
    calls = {}              # (M, K, N, dtype) of every matmul call

    def shapes(a, b, _inner=ops.matmul, **k):
        key = (*a.shape, b.shape[1], str(a.dtype).replace("torch.", ""))
        calls[key] = calls.get(key, 0) + 1
        return _inner(a, b, **k)

    ops.matmul = shapes
    tok = torch.from_numpy(tokens).cuda()
    out = []
    for mode, mb, dtype in runs:
        rt = Runtime(compute_dtype=dtype, tp=TPConfig(mode=mode,
                                                      microbatches=mb))
        lm.rt = rt
        torch.cuda.synchronize()
        mmk.launches = fa.launches = asym[0] = 0
        mmk.launches_by_variant = dict.fromkeys(mmk.COUNTERS, 0)
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        calls.clear()
        t0 = time.monotonic()
        loss = lm.loss({"tokens": tok, "labels": tok})
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = (mmk.launches, fa.launches, asym[0])
        tpc = tp_mod.TPContext.from_config(rt.tp, group)
        base, _ = tp_mod._period_graph(tpc, [lm.blocks[0]], cfg, ("attn",))
        graph = dataflow.optimize(tp_mod.microbatch_period_graph(base, mb))
        per_period = tp_mod.matmul_calls(graph, tpc, TP_BATCH // mb, TP_SEQ,
                                         cfg.d_model, rt.dtype.itemsize)
        out.append(dict(
            mode=mode, mb=mb, dtype=dtype, loss=float(loss),
            finite=bool(torch.isfinite(loss)), wall_s=wall,
            matmul_launches=launches[0],
            matmul_variants=mmk.variant_totals(),
            matmul_derived=per_period * cfg.num_layers,
            flash_launches=launches[1], flash_derived=mb * cfg.num_layers,
            flash_variants=dict(fa.launches_by_variant),
            overlap_asym=launches[2],
            call_shapes=sorted(([*k, v] for k, v in calls.items()),
                               key=lambda r: -r[-1]),
            overlap_asym_nodes=sum(n.op == "overlap_asym"
                                   for n in graph.nodes) * cfg.num_layers,
            wire=f"{group.backend}" + (", staged through the host"
                                       if group.staged(loss) else "")))
    # the hidden states themselves, on the run with every schedule in it
    lm.rt = Runtime(compute_dtype="float32",
                    tp=TPConfig(mode="cais", microbatches=2))
    hidden, _ = lm.forward(tok)
    return out, hidden.cpu().numpy()


def phase_tp(mmk, fa) -> dict:
    import numpy as np

    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime

    cfg = get_tp_cfg()
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (TP_BATCH, TP_SEQ)).astype(np.int64)
    tok = torch.from_numpy(tokens).cuda()
    one = LM(cfg, Runtime(compute_dtype="float32"), device="cuda", seed=0)
    one_hidden = one.forward(tok)[0].cpu().numpy()
    single = {}
    for dtype in ("float32", "bfloat16"):
        one.rt = Runtime(compute_dtype=dtype)
        t0 = time.monotonic()
        single[dtype] = float(one.loss({"tokens": tok, "labels": tok}))
        torch.cuda.synchronize()
        log(f"  one device {dtype}: loss {single[dtype]:.7f} "
            f"({time.monotonic() - t0:.2f}s, per-block path)")
    del one
    torch.cuda.empty_cache()

    t0 = time.monotonic()      # each rank counts launches in its own process
    ranks = run_ranks(tp_rank, TP_WORLD, tokens, TP_RUNS, device="cuda",
                      timeout=900)
    wall = time.monotonic() - t0
    hidden = np.concatenate([h for _, h in ranks], axis=1)
    ranks = [r for r, _ in ranks]
    h_err = np.abs(hidden - one_hidden)
    h_ok = bool((h_err <= HIDDEN_TOL["atol"]
                 + HIDDEN_TOL["rtol"] * np.abs(one_hidden)).all())
    log(f"  final hidden states (cais, mb=2, f32), the {TP_WORLD} sequence "
        f"shards against one device: max|Δ| {h_err.max():.3e} "
        f"(max|x| {np.abs(one_hidden).max():.3e}) within {HIDDEN_TOL}: "
        f"{'ok' if h_ok else 'FAIL'}")
    if not h_ok:
        raise AssertionError("phase 6: TP hidden states differ from one "
                             "device")
    rows, total_mm, total_fa, shapes = [], 0, 0, set()
    for i, run in enumerate(TP_RUNS):
        per = [r[i] for r in ranks]
        head = per[0]
        ref_loss = single[head["dtype"]]
        rtol = F32_LOSS_RTOL if head["dtype"] == "float32" else \
            BF16_LOSS_RTOL
        rel = abs(head["loss"] - ref_loss) / abs(ref_loss)
        checks = {
            "ranks agree": len({p["loss"] for p in per}) == 1,
            "finite": all(p["finite"] for p in per),
            f"within {rtol:g} of one device": rel <= rtol,
            "matmul launches = graph": all(
                p["matmul_launches"] == p["matmul_derived"] > 0 for p in per),
            "flash launches = layers x mb": all(
                p["flash_launches"] == p["flash_derived"] for p in per),
            # the bf16 attention core takes the wgmma forward, f32 the FFMA
            # kernel (no TF32)
            "flash variants": all(p["flash_variants"] == dict(
                splitkv=0,
                wgmma=p["flash_launches"] if p["dtype"] == "bfloat16" else 0,
                ffma=p["flash_launches"] if p["dtype"] == "float32" else 0)
                for p in per),
            # bf16 ring GEMMs all take the wgmma mainloop, f32 the FFMA
            # kernel (no TF32)
            "matmul variants": all(p["matmul_variants"] == (
                dict(wgmma=p["matmul_launches"], ffma=0)
                if p["dtype"] == "bfloat16" else
                dict(wgmma=0, ffma=p["matmul_launches"])) for p in per),
            "overlap_asym ran": all(
                p["overlap_asym"] == p["overlap_asym_nodes"]
                and (p["overlap_asym"] > 0) == (p["mb"] > 1) for p in per),
        }
        shapes |= {(M, K, N, dt) for p in per
                   for M, K, N, dt, _ in p["call_shapes"]}
        total_mm += sum(p["matmul_launches"] for p in per)
        total_fa += sum(p["flash_launches"] for p in per)
        row = dict(head, rel_to_one_device=rel, one_device=ref_loss,
                   wall_s=[p["wall_s"] for p in per], checks=checks)
        rows.append(row)
        log(f"  {run[0]:>7} mb={run[1]} {run[2]:>8}: loss "
            f"{head['loss']:.7f} (one device {ref_loss:.7f}, rel "
            f"{rel:.2e}); per rank: matmul {head['matmul_launches']} "
            f"launches (graph {head['matmul_derived']}; "
            f"{json.dumps(head['matmul_variants'])}), flash "
            f"{head['flash_launches']} "
            f"{json.dumps(head['flash_variants'])}, overlap_asym "
            f"{head['overlap_asym']}; "
            f"{max(row['wall_s']):.2f}s; wire: {head['wire']}")
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError(f"phase 6 {run}: failed {bad}")
    by = {(r["mode"], r["mb"], r["dtype"]): r["loss"] for r in rows}
    for mb in (1, 2):
        d = abs(by[("barrier", mb, "float32")] - by[("cais", mb, "float32")])
        log(f"  barrier vs cais, mb={mb}, f32: |Δloss| {d:.3e}")
    log(f"  {TP_WORLD} ranks, {len(TP_RUNS)} runs in {wall:.1f}s (spawn and "
        "weights included); launches over all ranks and runs: matmul "
        f"{total_mm}, flash {total_fa}")
    return dict(runs=rows, single=single, matmul_launches=total_mm,
                flash_launches=total_fa, wall_s=wall,
                hidden_max_abs_err=float(h_err.max()),
                call_shapes=sorted(shapes))


# ---------------------------------------------------------------------------
# phase 7: MLA at reduced depth, f32, CPU plain versions vs the card's kernels
# ---------------------------------------------------------------------------


def prefill_decode(lm, tokens, steps: int = 3):
    """LM.prefill of ``tokens`` then ``steps`` decode steps of fixed
    tokens; returns every step's logits on the CPU."""
    dev = lm.device
    B, S = tokens.shape
    logits, caches = lm.prefill(tokens.to(dev), s_max=S + steps)
    out = [logits.cpu()]
    for t in range(steps):
        tok = torch.full((B, 1), 7 + t, dtype=torch.int32, device=dev)
        idx = torch.full((B,), S + t, dtype=torch.int32, device=dev)
        logits, caches = lm.decode_step(tok, caches, idx)
        out.append(logits.cpu())
    return out


def phase_mla_reference(cfg_full):
    import numpy as np

    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE
    from repro_torch.serve import Engine, Request, ServeConfig

    cfg = cfg_full.scaled(num_layers=2)
    cpu = LM(cfg, SMOKE, device="cpu", seed=0)
    gpu = LM(cfg, SMOKE, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 96)
                                           ).astype(np.int32))
    want, got = prefill_decode(cpu, tokens), prefill_decode(gpu, tokens)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **LOGIT_TOL)
    sc = ServeConfig(max_batch=2, s_max=100)
    out = []
    for lm, dev in ((cpu, "cpu"), (gpu, "cuda")):
        reqs = [Request(rid=i, prompt=p.numpy(), max_new_tokens=4)
                for i, p in enumerate(tokens)]
        eng = Engine(lm, cfg, SMOKE, sc, device=dev)
        eng.run(reqs, seed=0)
        if eng.paged:
            raise AssertionError("MLA did not take the dense engine")
        out.append([r.out_tokens for r in reqs])
    if out[0] != out[1]:
        raise AssertionError(f"greedy tokens differ: cpu {out[0]} card "
                             f"{out[1]}")
    log(f"  2-layer f32: prefill + 3 decode logits max|Δ| {err:.3e} within "
        f"{LOGIT_TOL}; dense-engine greedy tokens identical {out[1]}")
    return err


# ---------------------------------------------------------------------------
# phase 8: serve minicpm3-4b at full width and depth
# ---------------------------------------------------------------------------


def phase_mla_serve(cfg, fa, mln, mmk):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    calls = {"matmul_rmsnorm": {}, "flash_attention": {}}
    norm = ops.matmul_rmsnorm

    def norm_shapes(a, b, scale, **k):
        key = (*a.shape, b.shape[1], b.stride(0),
               str(a.dtype).replace("torch.", ""))
        calls["matmul_rmsnorm"][key] = calls["matmul_rmsnorm"].get(key, 0) + 1
        return norm(a, b, scale, **k)

    ops.matmul_rmsnorm = norm_shapes
    core = record_calls(ops, calls["flash_attention"])
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = mln.launches = mmk.launches = 0  # the main path only
        mln.launches_by_variant = dict.fromkeys(mln.VARIANTS, 0)
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        t0 = time.monotonic()
        eng, reqs = serve.main([
            "--arch", MLA_ARCH, "--device", "cuda", "--requests",
            str(MLA_REQUESTS), "--prompt-len", str(MLA_PROMPT),
            "--prompt-len-min", str(MLA_PROMPT), "--max-new",
            str(MLA_MAX_NEW), "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(matmul_rmsnorm=mln.launches,
                        flash_attention=fa.launches, matmul=mmk.launches)
        variants = dict(mln.launches_by_variant)
        fa_variants = dict(fa.launches_by_variant)
    finally:
        ops.matmul_rmsnorm, ops.flash_attention = norm, core
    if not all(r.done and len(r.out_tokens) == MLA_MAX_NEW for r in reqs):
        raise AssertionError("a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("a token outside the vocabulary")
    # equal prompt lengths and max_batch = MLA_REQUESTS: one static batch,
    # one prefill, then a decode step for every token after the first
    prefills, decodes = 1, MLA_MAX_NEW - 1
    if eng.steps != prefills + decodes:
        raise AssertionError(f"{eng.steps} model calls, expected "
                             f"{prefills} prefill + {decodes} decode")
    # _mla_q and _mla_latents: one matmul_rmsnorm call each per layer per
    # forward; the prefill computes its cached latents once (mla_prefill)
    norms = cfg.num_layers * 2 * (prefills + decodes)
    cores = cfg.num_layers * prefills     # the absorbed decode has no core
    if launches["matmul_rmsnorm"] != norms or norms == 0:
        raise AssertionError(f"matmul_rmsnorm launched "
                             f"{launches['matmul_rmsnorm']} times, expected "
                             f"{cfg.num_layers} layers x 2 x "
                             f"{prefills + decodes} calls = {norms}")
    # the prefill's norms (M = 4 x 1024 rows, bf16) on the wgmma mainloop,
    # every decode step's (M = 4) on split-K
    want = dict(splitk=cfg.num_layers * 2 * decodes,
                wgmma=cfg.num_layers * 2 * prefills, ffma=0)
    if variants != want:
        raise AssertionError(f"matmul_rmsnorm variants {variants}, "
                             f"expected {want}")
    if launches["flash_attention"] != cores:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, "
                             f"expected {cores}")
    # the bf16 prefill cores (dh 96, dv 64) on the wgmma forward
    if fa_variants != dict(splitkv=0, wgmma=cores, ffma=0):
        raise AssertionError(f"flash_attention variants {fa_variants}, "
                             f"expected {cores} wgmma")
    rep = dict(eng.last_report)
    rep.update(steps=eng.steps, launches=launches, wall_s=wall,
               matmul_rmsnorm_variants=variants, flash_variants=fa_variants,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               prompt_lens=[len(r.prompt) for r in reqs],
               params=cfg.param_count(),
               call_shapes={n: sorted([*k, v] for k, v in c.items())
                            for n, c in calls.items()})
    log(f"  served {len(reqs)} requests in {eng.steps} model calls "
        f"({prefills} prefill + {decodes} decode); launches "
        f"{json.dumps(launches)}; matmul_rmsnorm by variant "
        f"{json.dumps(variants)}; flash by variant {json.dumps(fa_variants)}")
    log("  latency " + json.dumps(rep))
    return rep


# ---------------------------------------------------------------------------
# phase 9: one training step on a flat TP ring of 4 ranks against one device
# ---------------------------------------------------------------------------


class RefStore:
    """The one-device step's gradients, AdamW ``m`` and ``v`` and updated
    parameters, in four flat f32 files in a temporary directory (the
    memory-mapped page cache, shared with the rank processes, which read
    only their shards). Picklable: the ranks open the files by name."""

    QUANTITIES = ("grad", "m", "v", "param")

    def __init__(self, shapes: dict, root: str):
        self.shapes = dict(shapes)
        self.offsets, n = {}, 0
        for name, shape in self.shapes.items():
            self.offsets[name] = n
            n += int(torch.Size(shape).numel())
        self.numel, self.root = n, root

    def path(self, q: str) -> str:
        return str(Path(self.root) / f"{q}.f32")

    def create(self) -> None:
        for q in self.QUANTITIES:
            with open(self.path(q), "wb") as f:
                f.truncate(4 * self.numel)

    def _flat(self, q: str) -> torch.Tensor:
        return torch.from_file(self.path(q), shared=True, size=self.numel,
                               dtype=torch.float32)

    def write(self, q: str, tensors: dict) -> None:
        flat = self._flat(q)
        for name, t in tensors.items():
            o = self.offsets[name]
            flat[o:o + t.numel()].copy_(t.detach().reshape(-1).float())
        del flat

    def read(self, q: str, name: str) -> torch.Tensor:
        o = self.offsets[name]
        return self._flat(q)[o:o + torch.Size(self.shapes[name]).numel()] \
            .view(self.shapes[name])


def train_batch():
    """Phase 9's batch: step 0 of ``data.pipeline.make_batch`` at train_4k's
    length, its global batch of 256 cut to TP_BATCH."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch

    shape = ShapeConfig("train_4k", TP_SEQ, TP_BATCH, "train")
    return make_batch(get_tp_cfg(), shape, 0, DataConfig(SEED))


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize()


def _peak_start(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device) -> Optional[float]:
    return torch.cuda.max_memory_allocated() / 2**30 \
        if _on_card(device) else None


def train_reference(batch, root: str, cfg, device="cuda") -> tuple:
    """The one-device step, f32, remat on, the per-block path: its loss,
    grad norm, time and peak memory, the one-device bf16 loss (forward
    only), and a :class:`RefStore` of its gradients, m, v and parameters.
    Frees the card before it returns."""
    from repro_torch.models import LM
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.runtime import Runtime
    from repro_torch.train.step import init_state, make_train_step

    rt = Runtime(compute_dtype="float32")
    lm = LM(cfg, rt, device=device, seed=SEED)
    tok = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with torch.no_grad():
        lm.rt = Runtime(compute_dtype="bfloat16")
        loss_bf16 = float(lm.loss(tok))
        lm.rt = rt
    opt = adamw(constant_schedule(TRAIN_LR), eps=TRAIN_EPS,
                clip_norm=TRAIN_CLIP)
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, rt)
    _peak_start(device)
    t0 = time.monotonic()
    state, metrics = step(state, batch)
    _sync(device)
    step_s = time.monotonic() - t0
    peak = _peak_gib(device)
    params = dict(lm.named_parameters())
    store = RefStore({k: tuple(p.shape) for k, p in params.items()}, root)
    store.create()
    t0 = time.monotonic()
    grads = {k: p.grad for k, p in params.items()}
    store.write("grad", grads)
    store.write("m", state["opt"]["m"])
    store.write("v", state["opt"]["v"])
    store.write("param", params)
    maxabs = {q: {k: float(t.abs().max()) for k, t in src.items()}
              for q, src in (("grad", grads), ("m", state["opt"]["m"]),
                             ("v", state["opt"]["v"]))}
    write_s = time.monotonic() - t0
    ref = dict(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]), loss_bf16=loss_bf16,
               step_s=step_s, peak_gib=peak, write_s=write_s, maxabs=maxabs,
               store_gb=4 * 4 * store.numel / 1e9)
    del lm, state, step, opt, params, grads, metrics, tok
    if _on_card(device):
        torch.cuda.empty_cache()
    return ref, store


def _ref_shard(store, q: str, name: str, r: int, n: int, cfg):
    """Rank ``r``'s shard of the one-device tensor ``name`` of quantity
    ``q``, flat and contiguous on the host."""
    from repro_torch.core.tp import param_shard_dim

    want = store.read(q, name)
    dim = param_shard_dim(name, cfg, n)
    if dim is not None:
        size = want.shape[dim] // n
        want = want.narrow(dim, r * size, size)
    return want.contiguous().reshape(-1)


CHUNK = 1 << 24     # elements a comparison moves to the card at a time


def param_limit(g_ref, p_ref, delta):
    """The first AdamW step's bound on |Δp|, per element, from the bound
    ``delta`` on the clipped gradient's error. The step moves p by
    lr·(u + wd·p) with u = ĝ / (|ĝ| + eps) (m̂ = ĝ, v̂ = ĝ² at step 1), so u
    is a sign where |ĝ| >> eps, and linear in ĝ where |ĝ| is near eps: where
    |ĝ_ref| <= delta the sign may differ (|Δu| <= 2); elsewhere |Δu| <=
    delta·eps / (|ĝ_ref| − delta + eps)², u's steepest slope on
    [|ĝ_ref| − delta, |ĝ_ref| + delta]; plus 1e-3 lr and 1e-6 |p_ref| for
    f32 rounding. ``g_ref`` is the clipped one-device gradient ĝ_ref."""
    a = g_ref.abs()
    du = torch.where(a <= delta, torch.full_like(a, 2.0),
                     (delta * TRAIN_EPS / (a - delta + TRAIN_EPS) ** 2)
                     .clamp(max=2.0))
    tight = 1e-3 * TRAIN_LR + 1e-6 * p_ref.abs()
    return TRAIN_LR * du + tight, tight, a <= delta


def train_errors(lm, state, store, ref, r: int, n: int, cfg) -> tuple:
    """This rank's f32 gradients, m, v and parameters against the one-device
    step's shards, CHUNK elements at a time (the card holds four ranks'
    models and states): per parameter (max|Δ|, bound) for grad, m and v,
    (max|Δ|, max err/limit) for the parameter (:func:`param_limit`, from
    the gradient bound times the one-device clip scale), and the count of
    parameter elements past the tight bound where the sign may differ."""
    errs, at_sign = {}, 0
    clip = min(1.0, TRAIN_CLIP / ref["grad_norm"])
    for k, p in lm.named_parameters():
        mine = {"grad": p.grad, "m": state["opt"]["m"][k],
                "v": state["opt"]["v"][k], "param": p.detach()}
        want = {q: _ref_shard(store, q, k, r, n, cfg) for q in mine}
        mine = {q: t.reshape(-1) for q, t in mine.items()}
        bound = {q: TRAIN_RTOL * ref["maxabs"][q][k]
                 for q in ("grad", "m", "v")}
        worst = dict.fromkeys(("grad", "m", "v", "param", "ratio"), 0.0)
        for lo in range(0, mine["grad"].numel(), CHUNK):
            sl = slice(lo, lo + CHUNK)
            w = {q: t[sl].to(p.device) for q, t in want.items()}
            for q in ("grad", "m", "v"):
                worst[q] = max(worst[q], float(
                    (mine[q][sl].float() - w[q]).abs().max()))
            limit, tight, near = param_limit(w["grad"] * clip, w["param"],
                                             bound["grad"] * clip)
            perr = (mine["param"][sl] - w["param"]).abs()
            worst["param"] = max(worst["param"], float(perr.max()))
            worst["ratio"] = max(worst["ratio"], float((perr / limit).max()))
            at_sign += int((near & (perr > tight)).sum())
            del w, near, tight, limit, perr
        errs[k] = dict(grad=(worst["grad"], bound["grad"]),
                       m=(worst["m"], bound["m"]), v=(worst["v"], bound["v"]),
                       param=(worst["param"], worst["ratio"]))
    return errs, at_sign


def train_rank(group, batch, runs, store, ref, cfg, device="cuda"):
    """One rank of phase 9: for each (mode, microbatches, dtype) run, one
    train step (LM.loss, its graph-built backward, the ring's grad sums,
    AdamW) from the same initial shards, with the kernels' launches (set to
    0 just before the step) against the counts derived from the optimized
    forward and training graphs, every matmul call's shape and layout, and
    in f32 this rank's gradients, m, v and parameters against the one-device
    step's shards."""
    from repro_torch.core import dataflow
    from repro_torch.core import tp as tp_mod
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.runtime import Runtime, TPConfig
    from repro_torch.train.step import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    n, r = group.size, group.rank
    B, S = batch["tokens"].shape
    lm = LM(cfg, Runtime(compute_dtype="float32"), device=device, seed=SEED,
            group=group)
    if _on_card(device):
        torch.cuda.empty_cache()      # the whole model drawn for the shards
    init = {k: p.detach().to("cpu", copy=True)
            for k, p in lm.named_parameters()}
    asym = [0]
    for name in ("barrier", "cais"):
        be = get_backend(name)

        def counted(*a, _inner=be.overlap_asymmetric, **k):
            asym[0] += 1
            return _inner(*a, **k)

        be.overlap_asymmetric = counted
    calls = {}

    def shapes(a, b, _inner=ops.matmul, **k):
        key = (*a.shape, b.shape[1], str(a.dtype).replace("torch.", ""),
               mmk.layout(a, b))
        calls[key] = calls.get(key, 0) + 1
        return _inner(a, b, **k)

    ops.matmul = shapes
    out = []
    for mode, mb, dtype in runs:
        rt = Runtime(compute_dtype=dtype, tp=TPConfig(mode=mode,
                                                      microbatches=mb))
        lm.rt = rt
        with torch.no_grad():
            for k, p in lm.named_parameters():
                p.copy_(init[k])
        opt = adamw(constant_schedule(TRAIN_LR), eps=TRAIN_EPS,
                    clip_norm=TRAIN_CLIP)
        state = init_state(lm, opt)
        step = make_train_step(lm, opt, rt)
        _peak_start(device)
        mmk.launches = fa.launches = asym[0] = 0
        mmk.launches_by_variant = dict.fromkeys(mmk.COUNTERS, 0)
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        calls.clear()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        _sync(device)
        wall = time.monotonic() - t0
        launches = (mmk.launches, fa.launches, asym[0])
        layouts = dict(mmk.launches_by_variant)
        peak = _peak_gib(device)
        tpc = tp_mod.TPContext.from_config(rt.tp, group)
        base, _ = tp_mod._period_graph(tpc, [lm.blocks[0]], cfg, ("attn",))
        merged = tp_mod.microbatch_period_graph(base, mb)
        fwd = dataflow.optimize(merged)
        _, bwd = tp_mod.training_graph(merged, cfg.norm)
        per = sum(tp_mod.matmul_calls(g, tpc, B // mb, S, cfg.d_model,
                                      rt.dtype.itemsize)
                  for g in (fwd, bwd))
        fper = sum(tp_mod.flash_calls(g) for g in (fwd, bwd))
        pairs = [nd.name for g in (fwd, bwd) for nd in g.nodes
                 if nd.op == "overlap_asym"]
        cross = tp_mod.cross_direction_pairs(merged, bwd)
        row = dict(
            mode=mode, mb=mb, dtype=dtype, loss=float(metrics["loss"]),
            grad_norm=float(metrics["grad_norm"]), wall_s=wall,
            peak_gib=peak, matmul_launches=launches[0],
            matmul_derived=per * cfg.num_layers, matmul_layouts=layouts,
            matmul_variants=mmk.variant_totals(layouts),
            flash_launches=launches[1],
            flash_derived=fper * cfg.num_layers,
            flash_variants=dict(fa.launches_by_variant),
            overlap_asym=launches[2],
            overlap_asym_nodes=len(pairs) * cfg.num_layers,
            cross_direction_pairs=cross,
            call_shapes=sorted([*k, v] for k, v in calls.items()),
            wire=group.backend + (", staged through the host"
                                  if group.staged(metrics["grad_norm"])
                                  else ""))
        if dtype == "float32":
            if _on_card(device):
                torch.cuda.empty_cache()
            errs, at_sign = train_errors(lm, state, store, ref, r, n, cfg)
            row.update(errs=errs, params_at_sign_bound=at_sign)
        out.append(row)
        del state, opt, step, metrics
        for p in lm.parameters():
            p.grad = None
        if _on_card(device):
            torch.cuda.empty_cache()
    return out


def phase_train() -> dict:
    import gc
    import tempfile

    from repro_torch.launch.ranks import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    batch, cfg = train_batch(), get_tp_cfg()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ref_") as root:
        import shutil

        free = shutil.disk_usage(root).free
        need = 16 * cfg.param_count()
        if free < need + 2**30:
            raise AssertionError(f"phase 9 keeps the one-device reference "
                                 f"on the host: {need / 1e9:.1f} GB under "
                                 f"{root}, which has {free / 1e9:.1f} GB")
        ref, store = train_reference(batch, root, cfg)
        log(f"  one device f32 (remat, per-block path): loss "
            f"{ref['loss']:.7f}, grad norm {ref['grad_norm']:.7f}, step "
            f"{ref['step_s']:.2f}s, peak {ref['peak_gib']} GiB; bf16 "
            f"loss (forward) {ref['loss_bf16']:.7f}; reference kept on the "
            f"host: {ref['store_gb']:.1f} GB in {ref['write_s']:.1f}s")
        t0 = time.monotonic()
        ranks = run_ranks(train_rank, TP_WORLD, batch, TRAIN_RUNS, store, ref,
                          cfg, device="cuda", timeout=1200)
        wall = time.monotonic() - t0
    rows, total_mm, total_fa, shapes, failed = [], 0, 0, set(), []
    for i, run in enumerate(TRAIN_RUNS):
        per = [rk[i] for rk in ranks]
        head = per[0]
        f32 = head["dtype"] == "float32"
        ref_loss = ref["loss"] if f32 else ref["loss_bf16"]
        rtol = F32_LOSS_RTOL if f32 else BF16_LOSS_RTOL
        rel = abs(head["loss"] - ref_loss) / abs(ref_loss)
        gn_rel = abs(head["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        checks = {
            "ranks agree": len({p["loss"] for p in per}) == 1
            and len({p["grad_norm"] for p in per}) == 1,
            f"loss within {rtol:g} of one device": rel <= rtol,
            "matmul launches = graphs": all(
                p["matmul_launches"] == p["matmul_derived"] > 0 for p in per),
            "flash launches = forward + recompute": all(
                p["flash_launches"] == p["flash_derived"] > 0 for p in per),
            "flash variants": all(p["flash_variants"] == dict(
                splitkv=0, wgmma=p["flash_launches"] if not f32 else 0,
                ffma=p["flash_launches"] if f32 else 0) for p in per),
            "matmul variants": all(p["matmul_variants"] == (
                dict(wgmma=0, ffma=p["matmul_launches"]) if f32 else
                dict(wgmma=p["matmul_launches"], ffma=0)) for p in per),
            "transposed layouts launched": all(
                p["matmul_layouts"][f"{v}.{lay}"] > 0
                for p in per for lay in ("nt", "tn")
                for v in (("ffma",) if f32 else ("wgmma",))),
            "overlap_asym executed as the graphs say": all(
                p["overlap_asym"] == p["overlap_asym_nodes"] for p in per),
            "a backward node paired with a forward one": (
                all(p["cross_direction_pairs"] for p in per)
                if head["mb"] > 1 else True),
        }
        if f32:
            checks[f"grad norm within {TRAIN_RTOL:g}"] = gn_rel <= TRAIN_RTOL
            for q in ("grad", "m", "v"):
                checks[f"every {q} within {TRAIN_RTOL:g} max|ref|"] = all(
                    e[q][0] <= e[q][1] for p in per
                    for e in p["errs"].values())
            checks["params within the first-step bound"] = all(
                e["param"][1] <= 1.0 for p in per
                for e in p["errs"].values())
        shapes |= {tuple(c[:5]) for p in per for c in p["call_shapes"]}
        total_mm += sum(p["matmul_launches"] for p in per)
        total_fa += sum(p["flash_launches"] for p in per)
        worst = {}
        if f32:
            for q in ("grad", "m", "v"):
                worst[q] = max(e[q][0] / e[q][1] for p in per
                               for e in p["errs"].values())
            worst["param_err_over_limit"] = max(
                e["param"][1] for p in per for e in p["errs"].values())
        row = dict({k: v for k, v in head.items()
                    if k not in ("errs", "call_shapes")},
                   rel_to_one_device=rel, grad_norm_rel=gn_rel,
                   one_device=ref_loss, worst_over_bound=worst,
                   params_at_sign_bound=[p.get("params_at_sign_bound")
                                         for p in per],
                   wall_s=[p["wall_s"] for p in per],
                   peak_gib=[p["peak_gib"] for p in per], checks=checks)
        rows.append(row)
        log(f"  {run[0]:>7} mb={run[1]} {run[2]:>8}: loss "
            f"{head['loss']:.7f} (one device {ref_loss:.7f}, rel "
            f"{rel:.2e}), grad norm {head['grad_norm']:.7f} (rel "
            f"{gn_rel:.2e}); worst err/bound {json.dumps(worst)}; "
            f"elements at the sign bound {row['params_at_sign_bound']}; per "
            f"rank: matmul {head['matmul_launches']} (graphs "
            f"{head['matmul_derived']}; {json.dumps(head['matmul_layouts'])})"
            f", flash {head['flash_launches']} (graphs "
            f"{head['flash_derived']}), overlap_asym {head['overlap_asym']} "
            f"({len(head['cross_direction_pairs'])} cross-direction nodes a "
            f"period); step {max(row['wall_s']):.2f}s; peak "
            f"{row['peak_gib']} GiB by rank; wire: {head['wire']}")
        failed += [(run, k) for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 9: failed {failed}")
    log(f"  {TP_WORLD} ranks, {len(TRAIN_RUNS)} steps in {wall:.1f}s (spawn "
        "and weights included; gloo stages every hop through the host, so "
        "these are not TP speeds); launches over all ranks and runs: "
        f"matmul {total_mm}, flash {total_fa}")
    return dict(runs=rows, reference={k: v for k, v in ref.items()
                                      if k != "maxabs"},
                matmul_launches=total_mm, flash_launches=total_fa,
                wall_s=wall, call_shapes=sorted(shapes))


# ---------------------------------------------------------------------------
# phase 10: paged serving over a flat TP ring of 4 ranks against one device
# ---------------------------------------------------------------------------


def serve_traffic() -> dict:
    """Phase 10's traffic: phase 5's constants."""
    return dict(requests=REQUESTS, prompt_min=PROMPT_MIN,
                prompt_max=PROMPT_MAX, max_new=MAX_NEW, chunk=PREFILL_CHUNK,
                block=BLOCK_SIZE)


def serve_prompts(cfg, tr: dict) -> list:
    """``tr["requests"]`` prompts of prompt_min..prompt_max tokens from a
    numpy seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)
    return [rng.integers(1, cfg.vocab_size, int(rng.integers(
        tr["prompt_min"], tr["prompt_max"] + 1))).astype(np.int32)
        for _ in range(tr["requests"])]


def serve_config(tr: dict):
    """The engine's config, as ``launch.serve`` builds it."""
    from repro_torch.serve import ServeConfig

    return ServeConfig(max_batch=tr["requests"],
                       s_max=tr["prompt_max"] + tr["max_new"],
                       block_size=tr["block"], prefill_chunk=tr["chunk"])


def serve_width(tr: dict) -> int:
    """The engine's block-table width (s_max in blocks), which the scripted
    steps share, so that both gather the same Skv."""
    return -(-(tr["prompt_max"] + tr["max_new"]) // tr["block"])


def scripted_steps(cfg, tr: dict, chunks: int) -> list:
    """The scripted ``serve_step`` schedule over ``tr["requests"]`` rows, row
    b in blocks b·W .. b·W + W − 1: ``chunks`` prefill chunks of
    ``tr["chunk"]`` tokens for every row; one mixed step of chunk − 1
    tokens (S % 4 != 0: the monolithic gemm_ar), the first half of the rows
    decoding and the rest prefilling; then 4 decode steps. Tokens from a
    numpy seed. Returns [(tokens, (block_tables, positions, context_lens,
    last))] in numpy."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    B, C, W = tr["requests"], tr["chunk"], serve_width(tr)
    if (chunks + 1) * C + 3 > W * tr["block"]:
        raise ValueError(f"{chunks} chunks and 5 steps more do not fit "
                         f"{W} blocks a row")
    bt = np.arange(B * W, dtype=np.int32).reshape(B, W)
    tok = lambda *s: rng.integers(1, cfg.vocab_size, s).astype(np.int32)
    steps = []
    for j in range(chunks):
        pos = np.broadcast_to(np.arange(j * C, (j + 1) * C, dtype=np.int32),
                              (B, C)).copy()
        steps.append((tok(B, C), (bt, pos, np.full(B, (j + 1) * C, np.int32),
                                  np.full(B, C - 1, np.int32))))
    S, p0, dec = C - 1, chunks * C, np.arange(B) < B // 2
    pos = np.full((B, S), -1, np.int32)
    pos[dec, 0] = p0
    pos[~dec] = np.arange(p0, p0 + S)
    nxt = np.where(dec, p0 + 1, p0 + S).astype(np.int32)
    steps.append((np.where(pos >= 0, tok(B, S), 0).astype(np.int32),
                  (bt, pos, nxt, np.where(dec, 0, S - 1).astype(np.int32))))
    for t in range(4):
        p = (nxt + t).astype(np.int32)
        steps.append((tok(B, 1), (bt, p[:, None].copy(), p + 1,
                                  np.zeros(B, np.int32))))
    return steps


def run_scripted(lm, steps, block: int, keep: bool = True) -> tuple:
    """``lm.serve_step`` over ``steps`` from fresh pools: every step's logits
    on the host (with ``keep``) and their SHA-256 digests."""
    import hashlib

    from repro_torch.models.attention import KVView

    dev = lm.device
    pools = lm.init_pools(steps[0][1][0].size, block)
    out, digests = [], []
    for toks, view in steps:
        v = KVView(*(torch.from_numpy(a).to(dev) for a in view))
        lg, pools = lm.serve_step(torch.from_numpy(toks).to(dev), pools, v)
        lg = lg.cpu().numpy()
        digests.append(hashlib.sha256(lg.tobytes()).hexdigest())
        if keep:
            out.append(lg)
    return out, digests


def engine_tokens(lm, cfg, prompts, tr: dict, margins=None) -> tuple:
    """The paged Engine's greedy tokens for ``prompts`` on ``lm`` (one
    device or this rank of its ring) and its step count; with ``margins``
    (a dict), the gap between the two largest logits of each sampled
    (rid, token index) and the largest."""
    import numpy as np

    from repro_torch.serve import Engine, Request
    from repro_torch.serve import engine as engine_mod

    sample = engine_mod._sample_token

    def recorded(row, seed, rid, index, temperature):
        top = np.sort(np.partition(row, -2)[-2:])
        margins[(rid, index)] = (float(top[1] - top[0]), float(top[1]))
        return sample(row, seed, rid, index, temperature)

    if margins is not None:
        engine_mod._sample_token = recorded
    try:
        reqs = [Request(rid=i, prompt=p, max_new_tokens=tr["max_new"])
                for i, p in enumerate(prompts)]
        eng = Engine(lm, cfg, lm.rt, serve_config(tr), device=lm.device)
        eng.run(reqs, seed=SEED)
    finally:
        engine_mod._sample_token = sample
    if not all(r.done and len(r.out_tokens) == tr["max_new"] for r in reqs):
        raise AssertionError("a request did not finish")
    return [list(r.out_tokens) for r in reqs], eng.steps


def serve_reference(cfg, tr: dict, prompts, steps, dtypes,
                    device="cuda") -> dict:
    """One device, f32 params from seed SEED, each compute type of
    ``dtypes``: the scripted steps' logits and (with ``prompts``) the
    Engine's tokens and top-2 margins. Frees the card before it returns."""
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime

    lm = LM(cfg, Runtime(compute_dtype="float32"), device=device, seed=SEED)
    out = {}
    for dtype in dtypes:
        lm.rt = Runtime(compute_dtype=dtype)
        _sync(device)
        t0 = time.monotonic()
        res = dict(logits=run_scripted(lm, steps, tr["block"])[0])
        _sync(device)
        res["script_s"] = time.monotonic() - t0
        if prompts is not None:
            margins = {}
            t0 = time.monotonic()
            res["tokens"], res["engine_steps"] = engine_tokens(
                lm, cfg, prompts, tr, margins)
            _sync(device)
            res.update(margins=margins, engine_s=time.monotonic() - t0)
        out[dtype] = res
    del lm
    if _on_card(device):
        torch.cuda.empty_cache()
    return out


def serve_matmul_shapes(cfg, tr: dict, world: int = TP_WORLD) -> list:
    """(M, K, N) of every matmul call a rank makes in phase 10, by the serve
    graph's own arithmetic: the gemm_col GEMMs (q, k, v, up, gate) over the
    B·S rows of a step (S 1, chunk − 1, chunk); each gemm_ar's one GEMM over
    those rows (barrier, and cais where S does not split over the ring) or
    the cais ring's partial GEMMs of B·(S/n)/2 rows (S = chunk, the
    bidirectional halves)."""
    n, d, dh = world, cfg.d_model, cfg.resolved_head_dim
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    ff = cfg.d_ff // n
    B, C = tr["requests"], tr["chunk"]
    rows = {B * s for s in (1, C - 1, C)}
    ring = {B * (C // n) // 2}
    return sorted({(m, d, f) for m in rows for f in (fq, fkv, ff)}
                  | {(m, k, d) for m in rows | ring for k in (fq, ff)})


def serve_rank_cfg(cfg, world: int = TP_WORLD):
    """``cfg`` as one rank's attention core sees it: its query heads, its kv
    heads (a replicated kv head sliced to the ones its q heads use)."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    h = H // world
    kv = Hkv // world if Hkv % world == 0 else max(h // (H // Hkv), 1)
    return cfg.scaled(num_heads=h, num_kv_heads=kv,
                      head_dim=cfg.resolved_head_dim)


def serve_tp_rank(group, tr, runs, prompts, steps, repl_steps, cfg, rcfg,
                  device="cuda"):
    """One rank of phase 10. For each (mode, dtype) run on ``cfg``
    (internlm2-1.8b): the scripted steps' logits (kept on rank 0; digests
    on every rank) and the ring Engine's tokens, with the kernels' launches
    (set to 0 just before the run) against the counts derived from the
    optimized serve graphs, the gemm_ar dispatches, every call shape, times
    and peak memory. Then ``rcfg`` (gemma3-1b cut to REPL_LAYERS layers),
    cais f32, scripted steps only."""
    from repro_torch.core import dataflow
    from repro_torch.core import tp as tp_mod
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime, TPConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    ar = [0]
    for name in ("barrier", "cais"):
        be = get_backend(name)

        def counted(*a, _inner=be.gemm_ar, **k):
            ar[0] += 1
            return _inner(*a, **k)

        be.gemm_ar = counted
    mm_calls, fa_calls = {}, {}

    def shapes(a, b, _inner=ops.matmul, **k):
        key = (*a.shape, b.shape[1], str(a.dtype).replace("torch.", ""))
        mm_calls[key] = mm_calls.get(key, 0) + 1
        return _inner(a, b, **k)

    ops.matmul = shapes
    record_calls(ops, fa_calls)

    def one_run(lm, cfg, mode, dtype, script_steps, with_engine):
        rt = Runtime(compute_dtype=dtype, tp=TPConfig(mode=mode))
        lm.rt = rt
        bs = []
        inner = lm.serve_step

        def step(tokens, pools, view):
            bs.append(tuple(tokens.shape))
            return inner(tokens, pools, view)

        lm.serve_step = step
        _peak_start(device)
        mmk.launches = fa.launches = ar[0] = 0
        mmk.launches_by_variant = dict.fromkeys(mmk.COUNTERS, 0)
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        mm_calls.clear()
        fa_calls.clear()
        t0 = time.monotonic()
        logits, digests = run_scripted(lm, script_steps, tr["block"],
                                       keep=group.rank == 0)
        _sync(device)
        script_s = time.monotonic() - t0
        tokens, engine_steps = (engine_tokens(lm, cfg, prompts, tr)
                                if with_engine else (None, 0))
        _sync(device)
        wall = time.monotonic() - t0
        peak = _peak_gib(device)
        launches = (mmk.launches, fa.launches, ar[0])
        del lm.serve_step
        tpc = tp_mod.TPContext.from_config(rt.tp, group)
        P = len(cfg.layer_pattern)
        g, _ = tp_mod.serve_period_graph(tpc, lm.blocks[:P], cfg,
                                         cfg.layer_kinds()[:P])
        g = dataflow.optimize(g)
        per = {s: tp_mod.matmul_calls(g, tpc, s[0], s[1], cfg.d_model,
                                      rt.dtype.itemsize)
               for s in set(bs)}
        decode = sum(S == 1 for _, S in bs)
        f32 = dtype == "float32"
        return dict(
            mode=mode, dtype=dtype, logits=logits, digests=digests,
            tokens=tokens, steps=len(bs), engine_steps=engine_steps,
            decode_steps=decode, script_s=script_s, wall_s=wall,
            peak_gib=peak, matmul_launches=launches[0],
            matmul_derived=sum(per[s] for s in bs) * (cfg.num_layers // P),
            matmul_variants=mmk.variant_totals(),
            flash_launches=launches[1],
            flash_derived=cfg.num_layers * len(bs),
            flash_variants=dict(fa.launches_by_variant),
            flash_expected=dict(
                splitkv=cfg.num_layers * decode,
                wgmma=0 if f32 else cfg.num_layers * (len(bs) - decode),
                ffma=cfg.num_layers * (len(bs) - decode) if f32 else 0),
            gemm_ar=launches[2], gemm_ar_derived=2 * cfg.num_layers * len(bs),
            matmul_shapes=sorted([*k, v] for k, v in mm_calls.items()),
            flash_shapes=sorted([*k, v] for k, v in fa_calls.items()),
            wire=group.backend + (", staged through the host"
                                  if _on_card(device)
                                  and group.backend == "gloo" else ""))

    lm = LM(cfg, Runtime(compute_dtype="float32"), device=device, seed=SEED,
            group=group)
    if _on_card(device):
        torch.cuda.empty_cache()      # the whole model drawn for the shards
    out = [one_run(lm, cfg, mode, dtype, steps, True) for mode, dtype in runs]
    del lm
    if _on_card(device):
        torch.cuda.empty_cache()
    lm = LM(rcfg, Runtime(compute_dtype="float32"), device=device, seed=SEED,
            group=group)
    repl = one_run(lm, rcfg, "cais", "float32", repl_steps, False)
    del lm
    if _on_card(device):
        torch.cuda.empty_cache()
    return out, repl


def _logits_close(got, want, tol) -> tuple:
    """(max |Δ|, worst |Δ| / (atol + rtol·|want|)) over every step."""
    import numpy as np

    err = worst = 0.0
    for g, w in zip(got, want):
        d = np.abs(g - w)
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (tol["atol"] + tol["rtol"]
                                      * np.abs(w))).max()))
    return err, worst


def _logits_rel(got, want) -> list:
    """Per step, ||got − want|| / ||want|| (Frobenius, every row)."""
    import numpy as np

    return [float(np.linalg.norm(g - w) / np.linalg.norm(w))
            for g, w in zip(got, want)]


def token_rule(got, want, margins, tol) -> tuple:
    """Whether the ring's f32 tokens follow the rule: equal to one device's,
    or, from the first position where a request's differ, the one-device
    margin between its top two logits there below ``tol`` (atol + rtol ·
    the top logit). Returns (ok, [(rid, index, margin, limit)] at each
    first difference)."""
    diffs = []
    for rid, (g, w) in enumerate(zip(got, want)):
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is not None:
            margin, top = margins[(rid, j)]
            diffs.append((rid, j, margin,
                          tol["atol"] + tol["rtol"] * abs(top)))
    return all(m < lim for _, _, m, lim in diffs), diffs


def serve_tp_checks(one: dict, repl_one: dict, ranks: list,
                    runs=None) -> tuple:
    """Phase 10's checks on what the ranks returned, against the one-device
    references. Returns (rows, failed)."""
    runs = SERVE_TP_RUNS if runs is None else runs
    rows, failed = [], []
    cases = [(run, [rk[0][i] for rk in ranks], one)
             for i, run in enumerate(runs)]
    cases.append(((REPL_ARCH, "cais", "float32"), [rk[1] for rk in ranks],
                  repl_one))
    for run, per, ref in cases:
        head = per[0]
        f32 = head["dtype"] == "float32"
        checks = {
            "logits bitwise equal across ranks": all(
                p["digests"] == head["digests"] for p in per),
            "matmul launches = serve graphs": all(
                p["matmul_launches"] == p["matmul_derived"] > 0 for p in per),
            "flash launches = layers x steps": all(
                p["flash_launches"] == p["flash_derived"] > 0 for p in per),
            "flash variants (decode splitkv; prefill wgmma bf16, ffma f32)":
                all(p["flash_variants"] == p["flash_expected"] for p in per),
            "matmul variants (wgmma bf16, ffma f32)": all(
                p["matmul_variants"] == (
                    dict(wgmma=0, ffma=p["matmul_launches"]) if f32 else
                    dict(wgmma=p["matmul_launches"], ffma=0)) for p in per),
            "two gemm_ar a layer a step through the backend": all(
                p["gemm_ar"] == p["gemm_ar_derived"] > 0 for p in per),
        }
        row = {k: v for k, v in head.items() if k not in (
            "logits", "digests", "matmul_shapes", "flash_shapes")}
        if f32:
            err, worst = _logits_close(head["logits"],
                                       ref["float32"]["logits"], LOGIT_TOL)
            checks[f"f32 logits within {LOGIT_TOL}"] = worst <= 1.0
            row.update(logits_max_abs_err=err, logits_err_over_tol=worst)
        else:
            rel = _logits_rel(head["logits"], ref["bfloat16"]["logits"])
            scale = _logits_rel(ref["bfloat16"]["logits"],
                                ref["float32"]["logits"])
            checks[f"bf16 logits within {BF16_LOGIT_FACTOR:g} x one "
                   "device's bf16 distance from f32"] = all(
                r <= BF16_LOGIT_FACTOR * s for r, s in zip(rel, scale))
            row.update(logits_rel=rel, one_device_bf16_rel_to_f32=scale)
        if head["tokens"] is not None:
            checks["tokens equal across ranks"] = all(
                p["tokens"] == head["tokens"] for p in per)
            want = ref[head["dtype"]]["tokens"]
            row["tokens_equal_one_device"] = head["tokens"] == want
            if f32:
                ok, diffs = token_rule(head["tokens"], want,
                                       ref["float32"]["margins"], LOGIT_TOL)
                checks["f32 tokens: one device's, or a tie within "
                       "LOGIT_TOL"] = ok
                row["first_differences"] = diffs
        row.update(checks=checks, wall_s=[p["wall_s"] for p in per],
                   peak_gib=[p["peak_gib"] for p in per])
        rows.append(row)
        failed += [(run, k) for k, v in checks.items() if not v]
    return rows, failed


def phase_serve_tp() -> dict:
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.launch.ranks import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    tr, cfg = serve_traffic(), get_tp_cfg()
    rcfg = get_arch(REPL_ARCH).scaled(num_layers=REPL_LAYERS)
    prompts = serve_prompts(cfg, tr)
    steps = scripted_steps(cfg, tr, SCRIPTED_CHUNKS)
    repl_steps = scripted_steps(rcfg, tr, REPL_CHUNKS)
    t0 = time.monotonic()
    one = serve_reference(cfg, tr, prompts, steps, ("float32", "bfloat16"))
    repl_one = serve_reference(rcfg, tr, None, repl_steps, ("float32",))
    ref_s = time.monotonic() - t0
    for dtype, res in one.items():
        log(f"  one device {dtype}: scripted {len(steps)} steps "
            f"{res['script_s']:.2f}s, engine {res['engine_steps']} steps "
            f"{res['engine_s']:.2f}s, tokens {res['tokens']}")
    t0 = time.monotonic()
    ranks = run_ranks(serve_tp_rank, TP_WORLD, tr, SERVE_TP_RUNS, prompts,
                      steps, repl_steps, cfg, rcfg, device="cuda",
                      timeout=900)
    wall = time.monotonic() - t0
    rows, failed = serve_tp_checks(one, repl_one, ranks)
    total_mm = sum(p["matmul_launches"] for rk in ranks
                   for p in rk[0] + [rk[1]])
    total_fa = sum(p["flash_launches"] for rk in ranks
                   for p in rk[0] + [rk[1]])
    mm_shapes = {tuple(s[:4]) for rk in ranks for p in rk[0] + [rk[1]]
                 for s in p["matmul_shapes"]}
    fa_shapes = {tuple(s[:-1]) for rk in ranks for p in rk[0] + [rk[1]]
                 for s in p["flash_shapes"]}
    for row in rows:
        arch = TP_ARCH if row["tokens"] is not None else \
            f"{REPL_ARCH} ({REPL_LAYERS} layers)"
        log(f"  {arch} {row['mode']} {row['dtype']}: "
            + ", ".join(f"{k} {json.dumps(row[k])}" for k in (
                "logits_max_abs_err", "logits_err_over_tol", "logits_rel",
                "one_device_bf16_rel_to_f32", "tokens_equal_one_device",
                "first_differences") if k in row)
            + f"; per rank: {row['steps']} serve steps "
            f"({row['decode_steps']} decode; engine {row['engine_steps']}), "
            f"matmul {row['matmul_launches']} (graphs "
            f"{row['matmul_derived']}; {json.dumps(row['matmul_variants'])})"
            f", flash {row['flash_launches']} "
            f"{json.dumps(row['flash_variants'])}, gemm_ar "
            f"{row['gemm_ar']}; scripted {row['script_s']:.2f}s, all "
            f"{max(row['wall_s']):.2f}s; peak {row['peak_gib']} GiB by rank;"
            f" wire: {row['wire']}")
    if failed:
        raise AssertionError(f"phase 10: failed {failed}")
    log(f"  {TP_WORLD} ranks in {wall:.1f}s (spawn and weights included; "
        "gloo stages every ring hop through the host, so these times check "
        "correctness, not TP speed: that needs NCCL and 4 cards); one-device "
        f"references {ref_s:.1f}s; launches over all ranks and runs: matmul "
        f"{total_mm}, flash {total_fa}")
    return dict(runs=rows, matmul_launches=total_mm, flash_launches=total_fa,
                wall_s=wall, reference_s=ref_s,
                one_device={k: {kk: v[kk] for kk in ("tokens", "script_s",
                                                    "engine_s",
                                                    "engine_steps")}
                            for k, v in one.items()},
                matmul_shapes=sorted(mm_shapes),
                flash_shapes=sorted(fa_shapes))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.hw import H100
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import matmul_rmsnorm as mln
    from repro_torch.kernels import nvcc, ref

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
    props = torch.cuda.get_device_properties(0)
    log(f"  properties: {props.total_memory / 1e9:.1f} GB, "
        f"{props.multi_processor_count} SMs, sm_{props.major}{props.minor}; "
        f"the planner's H100 spec: {H100.hbm_bytes / 1e9:.0f} GB, "
        f"{H100.hbm_bw / 1e12:.2f} TB/s, link {H100.ici_bw / 1e9:.0f} GB/s "
        f"each way, hop {H100.hop_latency * 1e6:.0f} us")

    log("phase 2: build (one nvcc per source, all started together)")
    t = time.monotonic()
    libs = nvcc.build_all([fa.SOURCE, mmk.SOURCE, mln.SOURCE])
    log(f"  {len(libs)} kernels built in {time.monotonic() - t:.1f}s")
    census = {}
    for src, lib in libs.items():
        log(f"  {src.relative_to(ROOT)} -> {lib.name}")
        log(Path(f"{lib}.log").read_text().strip())
        census[src.stem] = sass_census(lib)
        log(f"  SASS {src.stem}: " + json.dumps(census[src.stem]))
    for name in (fa.SOURCE.stem, mmk.SOURCE.stem, mln.SOURCE.stem):
        if not all(census[name].values()):
            raise AssertionError(f"{name}: no wgmma or no TMA load in its "
                                 f"SASS: {census[name]}")

    cfg = get_arch(ARCH)
    log("phase 3: kernels vs plain versions (within CHECK_TOL)")
    rows = phase_kernels(cfg, fa, ref)
    if not all(r["ok"] for r in rows):
        raise AssertionError("flash_attention disagrees with its plain "
                             "version")
    mm_rows = phase_matmul(mmk, ref)
    if not all(r["ok"] for r in mm_rows):
        raise AssertionError("matmul disagrees with its plain version")
    mln_rows = phase_matmul_rmsnorm(mln, ref)
    if not all(r["ok"] for r in mln_rows):
        raise AssertionError("matmul_rmsnorm disagrees with its plain "
                             "version")

    log("phase 4: 2-layer full-width f32, CPU plain vs card kernel")
    phase_reference(cfg)

    log(f"phase 5: serve {ARCH} at full width, bf16 compute, f32 params")
    rep = phase_serve(cfg, fa)
    checked_fa = {(r["shape"]["B"], r["shape"]["Sq"], r["shape"]["H"],
                   r["shape"]["dh"], r["shape"]["Skv"], r["shape"]["Hkv"],
                   r["shape"]["dv"], r["dtype"]) for r in rows}
    unchecked = [s for s in rep["call_shapes"]
                 if tuple(s[:-1]) not in checked_fa]
    if unchecked:
        raise AssertionError(f"phase 5 called flash_attention at shapes "
                             f"phase 3 did not check: {unchecked}")

    log(f"phase 6: {TP_ARCH} LM.loss at full width, {TP_WORLD} TP ranks on "
        "one card over gloo")
    tp = phase_tp(mmk, fa)
    if tp["matmul_launches"] == 0 or tp["flash_launches"] == 0:
        raise AssertionError("the tensor-parallel path launched no kernel")
    checked = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"],
                r["dtype"]) for r in mm_rows if r["layout"] == "nn"}
    unchecked = [s for s in tp["call_shapes"] if tuple(s) not in checked]
    if unchecked:
        raise AssertionError(f"phase 6 called matmul at shapes phase 3 did "
                             f"not check: {unchecked}")
    log("  tp " + json.dumps(tp))

    mla_cfg = get_mla_cfg()
    log(f"phase 7: {MLA_ARCH} 2-layer full-width f32, CPU plain vs card "
        "kernels (prefill, decode, dense engine)")
    phase_mla_reference(mla_cfg)

    log(f"phase 8: serve {MLA_ARCH} at full width and depth, bf16 compute, "
        "f32 params, through the dense engine")
    mla = phase_mla_serve(mla_cfg, fa, mln, mmk)
    checked = {"matmul_rmsnorm": {
        (r["shape"]["M"], r["shape"]["K"], r["shape"]["N"],
         r["shape"]["ldb"], r["dtype"]) for r in mln_rows},
        "flash_attention": checked_fa}
    unchecked = [(n, s) for n, shapes in mla["call_shapes"].items()
                 for s in shapes if tuple(s[:-1]) not in checked[n]]
    if unchecked:
        raise AssertionError(f"phase 8 called kernels at shapes phase 3 did "
                             f"not check: {unchecked}")

    log(f"phase 9: one {TP_ARCH} training step at full width and depth, "
        f"{TP_WORLD} TP ranks on one card over gloo, against one device")
    log("  " + smi)
    train = phase_train()
    checked = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"],
                r["dtype"], r["layout"]) for r in mm_rows}
    unchecked = [s for s in train["call_shapes"] if tuple(s) not in checked]
    if unchecked:
        raise AssertionError(f"phase 9 called matmul at shapes phase 3 did "
                             f"not check: {unchecked}")
    log("  train " + json.dumps(train))

    log(f"phase 10: paged serving of {TP_ARCH} at full width and depth and "
        f"{REPL_ARCH} cut to {REPL_LAYERS} layers, {TP_WORLD} TP ranks on one "
        "card over gloo, against one device")
    log("  " + smi)
    serve_tp = phase_serve_tp()
    checked_mm = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"],
                   r["dtype"]) for r in mm_rows if r["layout"] == "nn"}
    unchecked = [("matmul", s) for s in serve_tp["matmul_shapes"]
                 if s not in checked_mm]
    unchecked += [("flash_attention", s) for s in serve_tp["flash_shapes"]
                  if s not in checked_fa]
    if unchecked:
        raise AssertionError(f"phase 10 called kernels at shapes phase 3 "
                             f"did not check: {unchecked}")
    log("  serve_tp " + json.dumps(serve_tp))

    log("kernel cases " + json.dumps({"flash_attention": rows,
                                      "matmul": mm_rows,
                                      "matmul_rmsnorm": mln_rows}))
    log(f"chip_smoke: {time.monotonic() - t_start:.1f}s")
    # flash_attention's record reads the paged serving path's most frequent
    # call, a decode step in bf16, with its launches on every path (phases
    # 5, 6, 8, 9 and 10); matmul's reads the ring step that carries most
    # of phase 6's GEMM work, the gate/up chunk of the cais schedule, in f32
    # (the FFMA kernel: f32 runs are four of phase 6's five; the same step
    # in bf16, the wgmma variant, is printed on the line before it);
    # matmul_rmsnorm's reads phase 8's most frequent call, the query latent
    # of a decode step (M = 4, N = 768) in bf16 (split-K). Every case is on
    # the "kernel cases" line. ms, plain_ms and library_ms are the times of
    # calls launched from Python.
    head = next(r for r in rows if r["case"] == "decode"
                and r["dtype"] == "bfloat16")
    d, ff = get_tp_cfg().d_model, get_tp_cfg().d_ff // TP_WORLD
    bf16_cais = next(r for r in tp["runs"] if r["dtype"] == "bfloat16")
    m_step = next(M for M, K, N, _, _ in bf16_cais["call_shapes"]
                  if (K, N) == (d, ff))
    mm_head = next(r for r in mm_rows if r["case"] == "tp"
                   and r["dtype"] == "float32"
                   and (r["shape"]["K"], r["shape"]["N"]) == (d, ff))
    mm_bf16 = next(r for r in mm_rows if r["case"] == "tp"
                   and r["dtype"] == "bfloat16"
                   and (r["shape"]["M"], r["shape"]["K"], r["shape"]["N"])
                   == (m_step, d, ff))
    q_rank = mla_cfg.mla.q_lora_rank
    mln_head = next(r for r in mln_rows if r["case"] == "mla"
                    and r["dtype"] == "bfloat16"
                    and (r["shape"]["M"], r["shape"]["N"])
                    == (MLA_REQUESTS, q_rank))
    record = lambda r: {k: r[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    log("matmul bf16 gate/up step (wgmma) " + json.dumps(dict(
        shape=mm_bf16["shape"], **record(mm_bf16), **{
            k: mm_bf16[k] for k in ("graph_ms", "plain_graph_ms",
                                    "library_graph_ms")})))
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:86",
         "launches": rep["launches"] + tp["flash_launches"]
         + mla["launches"]["flash_attention"] + train["flash_launches"]
         + serve_tp["flash_launches"],
         **record(head)},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:56",
         "launches": tp["matmul_launches"] + train["matmul_launches"]
         + serve_tp["matmul_launches"],
         **record(mm_head)},
        {"name": "matmul_rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_rmsnorm.cu",
         "replaces": "src/repro/kernels/matmul_ln.py:55",
         "launches": mla["launches"]["matmul_rmsnorm"],
         **record(mln_head)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
