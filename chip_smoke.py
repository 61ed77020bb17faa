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
     tensor-parallel path (phase 9's auto and barrier runs' core over the
     whole batch among them) and a rank of phase 10 give it and at the TPU
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
  6. the tensor-parallel training forward: internlm2-1.8b at full width cut to
     TP_LAYERS of its 24 layers, batch 2 of 4096 tokens from a numpy seed,
     random weights from seed 0, ``LM.loss`` on one device (the per-block path)
     and on a ring of 4 ranks sharing the card over gloo (each rank its own
     process holding its weight shards; gloo moves host memory, so every ring
     hop is staged through the host, which makes this phase a check of
     correctness and not of TP speed): ``barrier`` and ``cais`` with 1 and 2
     microbatches in f32, and ``cais`` with 2 microbatches in bf16. The f32
     losses must lie within 1e-4 relative of the one-device f32 loss, the bf16
     loss within ``BF16_LOSS_RTOL`` of the one-device bf16 loss, and the f32
     final hidden states of the cais 2-microbatch run within ``HIDDEN_TOL`` of
     one device's; every rank's matmul launches must equal the count derived
     from its optimized period graphs, all of them through the wgmma variant in
     the bf16 run and the FFMA kernel in f32, its flash launches one per layer
     per microbatch (wgmma in bf16, ffma in f32), every matmul call shape must
     be among those phase 3 checked, and a 2-microbatch run must execute
     ``overlap_asym``.
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
  9. one training step of internlm2-1.8b at full width, TP_LAYERS layers: batch
     2 of 4096 tokens (train_4k's length, its global batch of 256 cut to 2)
     from ``data.pipeline.make_batch``, seed 0, random weights from seed 0,
     AdamW at a constant lr ``TRAIN_LR``. First the one-device step (f32, remat
     on, the per-block path), whose loss, grad norm, gradients, m, v and
     updated parameters are kept in files on the host while the card is freed;
     then one spawn of 4 gloo ranks sharing the card runs the step through
     ``train.step.make_train_step`` (LM.loss, each period's graph-built
     backward, the ring's grad sums, AdamW) for ``barrier`` with 1 microbatch
     and ``cais`` with 2, in f32, ``cais`` with 2 in bf16, and ``cais`` in f32
     under ``planner="perfsim"`` with the split ``auto`` (the planner picks the
     split and both directions' pairings), and the default TP mode ``auto``
     in f32 and bf16 (DTensor placements over the one-device code: no graph,
     no matmul launch, the flash kernel on each rank's heads once a layer in
     the forward and once in the remat recompute; the collectives DTensor
     issued are printed a layer and direction, one all-gather in and one
     reduce-scatter out a sub-layer in the forward required, with the step
     time beside barrier's). Each run's loss must lie within 1e-4
     (f32) or ``BF16_LOSS_RTOL`` (bf16) of one device's; in f32 the grad norm
     within ``TRAIN_RTOL``, every gradient, m and v within ``TRAIN_RTOL`` times
     the one-device tensor's max, and every parameter within the first-step
     bound (2 lr where the one-device gradient lies within its bound of zero,
     where Adam's sign may differ; 1e-3 lr elsewhere; plus 1e-6 |p|); every
     rank's matmul and flash launches must equal the counts derived from the
     optimized forward and training graphs, the transposed layouts must run on
     wgmma in bf16 and FFMA in f32, overlap_asym must execute as the graphs
     say, with a backward node paired with a forward one at 2 microbatches, and
     every matmul call shape and layout must be among those phase 3 checked.
     The perfsim run must also hold one plan on every rank (a digest gathered
     over the ring), graphs that pair what the plans say, and executed
     overlap_asym nodes that are the plans' pairs; it prints the plans, their
     simulated makespans against greedy's, the cache's hits, misses and memo
     hits and the planner's host seconds. Step times are printed with the note
     that gloo stages every hop through the host. Then the same step on the 2D
     mesh of the same ranks (tp_in 2 x tp_out 2, whose composite index cuts the
     flat ring's shards): ``cais`` mb 2 in f32, held by the same rules, the
     launches the 2D graphs' (the hierarchical compositions), and the loss's
     difference from the flat ``cais`` mb 2 run printed (the 2D ``barrier`` run
     is left out to keep the script inside its time limit).
 10. paged serving over the ring: internlm2-1.8b at full width, TP_LAYERS
     layers, random weights from seed 0, f32 params, phase 5's traffic (4
     requests of 600-700 prompt tokens, 16 new tokens, prefill chunk 128, block
     16) through the paged ``Engine``, and a scripted ``serve_step`` schedule
     (2 prefill chunks of 128 for the 4 rows, a mixed step of 127 tokens, 4
     decode steps). First on one device in f32 and bf16 compute, its tokens,
     top-2 margins and logits kept on the host while the card is freed; then
     one spawn of 4 gloo ranks sharing the card (each holding its weight shards
     and its kv heads' pools) runs ``barrier`` f32, ``cais`` f32, ``cais`` bf16
     and ``cais`` f32 under the perfsim planner (its logits bitwise the greedy
     ``cais`` f32 run's, its plans pairing nothing, its planning host time a
     step printed): the f32 logits must lie within ``LOGIT_TOL`` of one
     device's, the bf16 ones within ``BF16_LOGIT_FACTOR`` times one device's
     bf16 distance from its f32 logits, every rank's logits bitwise equal and
     its tokens identical, the f32 tokens one device's (or, from a request's
     first difference, a one-device top-2 margin below ``LOGIT_TOL``), the
     matmul launches equal to ``matmul_calls`` of the optimized serve graphs,
     flash once a layer a step (decode on split-KV, prefill on wgmma in bf16
     and FFMA in f32), two ``gemm_ar`` a layer a step dispatched through the
     backend, and every call shape of both kernels among phase 3's. Then
     gemma3-1b cut to one period (5 sliding-window layers and a global one; its
     kv head replicated and sliced on each rank), ``cais`` f32, its scripted
     logits over 4 prefill chunks (past the 512 window) within ``LOGIT_TOL`` of
     one device's. Between them, ``cais`` f32 on the 2D mesh (data axis 1: the
     hierarchical ``gemm_ar``, the admission clock agreed over the whole TP
     group), held as the flat runs.
 11. MoE: mixtral-8x7b at its published widths (8 experts top-2, capacity
     factor 1.25, group 512, window 4096) cut from 32 to MOE_LAYERS layers,
     random weights from seed 0, f32 params. (a) Served on one device
     through ``repro_torch.launch.serve --layers``: phase 5's traffic in
     bf16, flash once a layer a step (decode on split-KV, prefill on
     wgmma), TTFT and per-token p50 and the peak printed; then a scripted
     f32 ``serve_step`` schedule (a prefill chunk of 128 for the 4 rows,
     MOE_DECODE_STEPS decode steps) on the card and on the CPU (plain
     versions). (b) One training step, batch MOE_BATCH of MOE_SEQ tokens
     (a rank's 512 tokens are one published routing group, so ring and one
     device route the same groups): one device in f32 first (as phase 9),
     then 4 gloo ranks, experts sharded by whole expert (2 a rank), each MoE
     block one period graph route → a2a_ffn → unroute: ``barrier`` f32,
     ``cais`` f32 and bf16, and ``cais`` f32 under the perfsim planner (the
     split ``auto`` gives 1). Routing is discrete, so every MoE comparison
     compares routing first (each (token, layer)'s two experts and capacity
     slots, against the CPU in (a) and one device's group in (b)) and
     prints the count of differences: a difference is allowed only at a
     reference probability gap (top-1/top-2 or top-2/top-3) below
     ROUTE_TOL, and the logits (a) and the grad norm, grads, m, v and
     parameters (b) are held element-wise, as in phases 4 and 9, only where
     the routing agreed; bf16 runs by the loss rule alone. The launches
     must equal the graphs' counts, the expert all-to-all and its adjoint
     must run through the backend with the matmul kernel inside, and every
     call shape must be among phase 3's (which adds mixtral's attention
     cores and every expert and attention GEMM of the ring's step).
 12. data parallelism and the 2D mesh, 4 gloo ranks sharing the card: (a)
     internlm2-1.8b (DP_LAYERS layers) on data 2 x model 2, global batch
     DP_BATCH x 4096 (a replica's rows from ``replica_rows``), ``cais`` mb 2
     and ``barrier`` mb 1 in f32, held to the one-device step of the whole
     batch by phase 9's rules; then each replica's grads of a step (summed
     over the TP group only) summed over the data axis in int8 by
     ``optim.compression.compressed_psum``, within COMPRESS_RTOL of the
     exact sum's max. (b) grouped EP: mixtral-8x7b cut to GEP_LAYERS layer
     on tp_in 2 x tp_out 2, 4 whole experts a rank (replicated across
     tp_in), ``cais`` f32 mb 1, batch 1 of MOE_SEQ, held as phase 11 (b)
     (routing first), every concrete expert all-to-all and adjoint on the
     tp_out ring. (c) ``python -m repro_torch.launch.train --arch
     DEBUG_ARCH --smoke --mesh debug`` (8 ranks, data 2 x model 4) in
     ``barrier``, ``cais`` and with no ``--tp-mode`` (the default ``auto``):
     rank 0's losses within 1e-5 of ``--mesh none``'s. Phase 3 checks the
     matmul shapes of (a) and (b) and of the 2D runs of phases 9 and 10.
 13. TP training past whole blocks, 4 gloo ranks sharing the card, every
     run f32 through phase 9's machinery (one-device reference first, one
     spawn) and held by its rules: (a) minicpm3-4b (MLA) at its published
     widths cut to MLA_TRAIN_LAYERS layers, batch MLA_TRAIN_BATCH x
     MLA_TRAIN_SEQ from ``make_batch``: first, on one device, the grads of
     every layer's q_norm, kv_norm, wq_a and wkv_a with matmul_rmsnorm's
     kernel against the same backward with its plain version, within
     TRAIN_RTOL and not zero (the kernel's VJP is torch math); then the
     ring, ``cais`` mb 2 and ``barrier`` mb 1, each MLA mixer run replicated over the gathered rows and each FFN
     through ``sp_ffn``'s one-sub-layer graph and its graph-built backward:
     matmul launches the graphs' count, matmul_rmsnorm twice and flash once
     a layer a forward.
     (b) internlm2-1.8b cut to RAGGED_LAYERS layers, one spawn, two
     batches: TP_BATCH x RAGGED_SEQ (S % 4 = 1), ``cais`` in the
     replicated layout (every gemm_ar dispatched through the backend as
     the graphs hold it), and TP_BATCH x TP_SEQ ``cais`` mb 2 with
     ``sequence_parallel`` off and on, the off loss within SP_LOSS_RTOL of
     the on loss and of the one-device loss. Every call shape of the three
     kernels must be among phase 3's (which adds the sp_ffn ring steps, the
     ragged step's GEMMs and its attention core).
 14. the recurrent families at their published widths, random weights
     from seed 0, f32 params: (a) mamba2-130m (Mamba-2 SSD mixers, no
     attention, no FFN) and (b) recurrentgemma-2b (RG-LRU, RG-LRU and
     sliding-window attention: window 2048, 10 query heads over one kv
     head), each first cut to REC_CHECK_LAYERS layers in f32, ``LM.prefill``
     of REC_CHECK_BATCH prompts (1024 / 2560 tokens: the window cuts) and
     REC_DECODE_STEPS decode steps on the CPU (plain versions) and on the
     card, logits within ``LOGIT_TOL``; then at full depth served through
     ``repro_torch.launch.serve`` (the dense engine) in bf16, REC_REQUESTS
     prompts of REC_PROMPT tokens, REC_MAX_NEW new tokens: one prefill and
     the decode calls, flash once a sliding-window layer a call (prefill on
     wgmma, decode on split-KV), TTFT, per-token latency and the peak
     printed. (c) One training step of each on 4 gloo ranks sharing the
     card, f32, through phase 9's machinery and rules (one-device reference
     first): recurrentgemma-2b cut to REC_TRAIN_LAYERS (one period), 1 x
     4096, ``cais`` and ``barrier`` (a batch of 1 clamps cais's 2
     microbatches to 1), its RG-LRU mixers and its attention (10 heads do
     not split over 4 ranks) replicated over the gathered rows, its FFN
     through ``sp_ffn``; mamba2-130m cut to 2 layers, 2 x 2048, ``cais``,
     every mixer replicated and no graph at all. Matmul launches the
     graphs', flash once a replicated attention layer a forward, every call
     shape of both kernels among phase 3's (which adds recurrentgemma-2b's
     attention cores and sp_ffn ring steps).
 15. the enc-dec and VLM families at their published widths, random
     weights from seed 0, f32 params: whisper-tiny (4 encoder + 4 decoder
     layers, d 384, 6 heads of 64, 1500 source frames; the encoder's and
     the cross-attention's cores non-causal) and paligemma-3b (18 layers,
     d 2048, 8 query heads over 1 kv head of 256, 256 image-prefix
     tokens attending bidirectionally in training). (a) whisper-tiny at
     full depth, f32, card against CPU: prefill + PF_DECODE_STEPS decode
     logits within LOGIT_TOL, the loss and every grad by phase 9's f32
     rules; (b) served in bf16 through ``launch.serve`` (the dense engine):
     flash 12 times in the prefill (4 encoder, 4 self, 4 cross, all
     ``ffma``) and 8 a decode call (``splitkv``); (c) paligemma-3b cut to
     VLM_CHECK_LAYERS, f32, card against CPU: the prefix-LM loss forward
     within TRAIN_RTOL (the prefix mask on ``ffma``), prefill + decode
     logits within LOGIT_TOL; (d) served at full depth in bf16: flash 18
     ``wgmma`` in the prefill and 18 ``splitkv`` a decode call; (e) one
     training step on 4 gloo ranks against one device through phase 9's
     machinery and rules (f32, ``cais``, cut to VLM_TRAIN_LAYERS, 1 x (256
     + 1024) rows, so rank 0's 320 straddle the prefix boundary), every
     flash call carrying the prefix. Every call shape, with its mask, among
     phase 3's (which adds the prefix rows of all three variants and the
     non-causal rows).
 16. arctic-480b (128 experts top-2 beside a dense residual MLP, 56 query
     heads over 8 kv heads of 128) at full width cut to 1 of 35 layers:
     14.05 B parameters, 28.1 GB in bf16, drawn on the card. (a) Served
     through ``launch.serve`` with phase 5's traffic: flash once a layer a
     step (decode on ``splitkv``, prefill chunks on ``wgmma``), TTFT,
     per-token latency and the peak printed. (b1) The port's adafactor
     alone on one expert leaf (128 x 7168 x 4864, bf16, seeded grads)
     against its formula evaluated expert by expert in f64: each new
     parameter within one bf16 ulp, its extra memory printed (a few
     experts, not an f32 copy of the leaf). (b2) One adafactor train step
     of the served model on 1 x 2048 tokens (four routing groups of 512):
     finite loss and grad norm, every parameter changed, the loss on the
     batch lower after the step, flash once a layer. (c) internlm2-1.8b
     cut to 2 layers, f32 adafactor, 2 x 4096, ``cais`` on 4 gloo ranks:
     step 0, a checkpoint (``repro_torch.checkpoint``: the shards
     gathered, rank 0 writes), step 1; the checkpoint restored on one
     device and step 1 there, and restored on the ring and step 1 again,
     each held to the ring's step 1 (loss, grad norm, parameters);
     launches the graphs'. Before (b2) changes it, the served model runs
     phase 11 (a)'s scripted schedule in bf16: its logits and routing are
     phase 17 (b)'s reference.
 17. MoE serving on a ring: 4 gloo ranks sharing the card, spawned once,
     each serve graph routing the whole step on every rank alike, the
     rank's experts (E/4 whole experts) on the matmul kernel, one
     all-reduce of their partial outputs an MoE layer. (a) mixtral-8x7b at
     full width cut to 2 layers: phase 11 (a)'s scripted f32 schedule held
     to phase 11 (a)'s one-device card result (routing by the routing
     rule, then the logits within LOGIT_TOL where routing agreed); then the
     bf16 ``Engine`` on phase 5's traffic (every request finished, tokens
     inside the vocabulary, TTFT and per-token p50 and the first token
     difference from phase 11 (a)'s one-device engine reported, not held:
     bf16 sums in another order on a ring). (b) arctic-480b cut to 1
     layer, its runtime's bf16 parameters (32 experts a rank beside the
     replicated dense residual MLP, added once after the sum): the same
     schedule in bf16 against phase 16's one-device result (routing
     differences counted; each step's logits held, over the rows whose
     routing agreed, to the tightest bound phase 10 held a bf16 ring row
     to), then the ``Engine``. Both: every
     rank's routing and logits bitwise rank 0's at every step, flash once a
     layer a step (decode ``splitkv``; prefill ``ffma`` f32, ``wgmma``
     bf16), matmul launches equal to the recorded serve graphs'
     (``tp.serve_launches``: q/k/v/o and three an owned expert; f32 all
     ``ffma``, bf16 all ``wgmma``), one all-reduce node an MoE layer a
     step, every call shape among phase 3's (which adds both models' ring
     attention cores and every ring GEMM, the expert GEMMs at their decode
     and prefill capacities 1 and 160 / 10 rows, f32 and bf16).
Phase 3 also holds matmul_rmsnorm against its plain version at the TPU
kernel's test shapes, at every shape phase 8 calls (b a column slice of
``wkv_a`` for the KV latent) and at N 8192, and flash attention at the MLA
prefill's call (dh 96, dv 64).
The line before the last is the kernels' JSON record; the last line is the
device JSON. Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

# a spawned rank's start-up, split: when its interpreter reached this
# module, and when torch was imported (train_legs logs both)
T_MODULE = time.time()
import torch  # noqa: E402

T_TORCH = time.time()

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
# phases 6, 9 and 10 run internlm2-1.8b at full width cut to TP_LAYERS of
# its 24 layers: at all 24 the script took 1120-1264 s of its 1200 s limit
# on an NVIDIA H100 80GB HBM3 at 700 W, most of it in these three phases'
# gloo rings (a layer costs the same checks at any depth); at 6, with phase
# 9's two auto runs added, 1048.5 s
TP_LAYERS = 4
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
              ("cais", 2, "bfloat16"),
              # the perfsim planner picks the split and both directions'
              # pairs (the others plan greedily)
              ("cais", "auto", "float32", "perfsim"),
              # the default TP mode: DTensor placements over the one-device
              # code (no period graph; the projections DTensor's local
              # products, none on the matmul kernel; the attention core the
              # flash kernel on each rank's heads, in the forward and the
              # remat recompute)
              ("auto", 1, "float32"), ("auto", 1, "bfloat16")]
# phase 9 on a 2D (tp_in 2 x tp_out 2) mesh of the same 4 ranks: the same
# shards (the composite index is the flat rank), the hierarchical schedules
TRAIN_2D_RUNS = [("cais", 2, "float32", "greedy", "2x2")]
# the meshes a run may name (repro_torch.sharding.init_mesh's arguments)
MESHES = {"flat": {}, "2x2": dict(tp_in=2, tp_out=2), "dp2": dict(dp=2)}
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
                 ("cais", "bfloat16"), ("cais", "float32", "perfsim"),
                 # the 2D mesh with data axis 1 (the hierarchical gemm_ar)
                 ("cais", "float32", "greedy", "2x2")]
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
# phase 11: MoE, mixtral-8x7b at full width cut to MOE_LAYERS layers (its
# f32 training state, 46.7 B parameters whole, does not fit one card).
# Training batch 1 of MOE_SEQ tokens: a rank's shard of 512 tokens is the
# published routing group, so the ring routes the groups one device does
# (capacity 160 on both sides); every run at 1 microbatch ("auto" never
# splits an MoE period)
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_SEQ = "mixtral-8x7b", 2, 1, 2048
MOE_RUNS = [("barrier", 1, "float32"), ("cais", 1, "float32"),
            ("cais", 1, "bfloat16"), ("cais", "auto", "float32", "perfsim")]
# phase 11 (b)'s second leg, in the same spawn: the same model at a ragged
# sequence, batch MOE_RAGGED_BATCH x MOE_RAGGED_SEQ (S % 4 = 2: the
# replicated activation layout, every rank routing the whole batch as one
# device does: B·S 4112 tokens in groups of 16, capacity 5, where the
# choices past an expert's 5 slots are dropped), each rank's experts on
# the matmul kernel, summed by one all-reduce a layer. 8 x 1026 (8208
# tokens, the same groups and capacity) passed too, but brought the script
# to 1008.4 s on an NVIDIA H100 80GB HBM3, 700 W; 514 halves the leg
MOE_RAGGED_BATCH, MOE_RAGGED_SEQ = 8, 514
MOE_RAGGED_RUNS = [("cais", 1, "float32"), ("barrier", 1, "float32")]
# routing is discrete: two f32 computations of the same router input that
# differ by summation order (the CPU and the card, the ring and one device)
# may choose another expert where the router's probabilities of the
# token's top-1/top-2 or top-2/top-3 experts lie closer than this; a
# routing difference is allowed only there, and element-wise holds are made
# only where the routing agreed
ROUTE_TOL = 1e-4
# phase 11 (a): the scripted f32 serve_step schedule, one prefill chunk for
# every row then decode steps
MOE_DECODE_STEPS = 2
# phase 12 (a): data 2 x model 2, internlm2-1.8b at full width cut to
# DP_LAYERS of 24 layers (a rank holds its half of the blocks and the whole
# embedding and head, with grads, m and v), global batch DP_BATCH of TP_SEQ
# so that each replica's 2 rows split into 2 microbatches; then the int8
# compressed sum of a step's per-replica grads over the data axis within
# COMPRESS_RTOL of the exact sum (JAX's compression.int8_close bound).
# Every check holds each layer alike, so the depth is what the script's
# 1200 s limit leaves room for (the ring's two steps took 132 s at 6
# layers, 80.6 s at 4, on an NVIDIA H100 80GB HBM3, 700 W)
DP_LAYERS, DP_BATCH = 2, 4
DP_RUNS = [("cais", 2, "float32", "greedy", "dp2"),
           ("barrier", 1, "float32", "greedy", "dp2")]
COMPRESS_RTOL = 0.05
# phase 12 (b): grouped EP, mixtral-8x7b at full width cut to GEP_LAYERS
# layer on the 2D mesh (4 whole experts a rank over tp_out, replicated
# across tp_in), batch 1 of MOE_SEQ tokens (a rank's 512 the routing group)
GEP_LAYERS = 1
GEP_RUNS = [("cais", 1, "float32", "greedy", "2x2")]
# phase 12 (c): the launcher on JAX's debug mesh (8 ranks, data 2 x model 4)
DEBUG_ARCH, DEBUG_STEPS = "deepseek-7b", 3
# phase 13: TP training past whole blocks, 4 gloo ranks sharing the card.
# (a) minicpm3-4b (MLA: on the ring its mixer runs replicated over the
# gathered rows, its FFN through sp_ffn's one-sub-layer graph) at its
# published widths cut to MLA_TRAIN_LAYERS of 62 layers, batch
# MLA_TRAIN_BATCH x MLA_TRAIN_SEQ: the MLA shapes phase 3 checks (latent
# norms at M 4096, flash B 4, S 1024, dh 96, dv 64)
MLA_TRAIN_LAYERS, MLA_TRAIN_BATCH, MLA_TRAIN_SEQ = 2, 4, 1024
MLA_TRAIN_RUNS = [("cais", 2, "float32"), ("barrier", 1, "float32")]
# (b) internlm2-1.8b cut to RAGGED_LAYERS of 24 layers: batch TP_BATCH x
# RAGGED_SEQ (S % 4 = 1: the replicated layout, every out/down projection a
# gemm_ar), and batch TP_BATCH x TP_SEQ with sequence_parallel off and on
# (off: the activation whole between periods; the same values)
RAGGED_LAYERS, RAGGED_SEQ = 2, 4093
RAGGED_RUNS = [("cais", 1, "float32")]
SP_RUNS = [("cais", 2, "float32", "greedy", "flat", False),
           ("cais", 2, "float32", "greedy", "flat", True)]
# the sequence_parallel=False loss against the flag-on step's and the
# one-device step's: the same f32 math on the same rows (the sequence-
# sharded step matched one device bitwise), so bitwise or within this
SP_LOSS_RTOL = 1e-6
# phase 14: the recurrent families at their published widths, random
# weights from seed 0, f32 params. mamba2-130m (Mamba-2 SSD mixers, no FFN)
# and recurrentgemma-2b (RG-LRU : RG-LRU : sliding-window attention, window
# 2048, 10 query heads over one kv head, head dim 256). The f32 card-vs-CPU
# check cuts depth to REC_CHECK_LAYERS (recurrentgemma-2b: one period),
# batch REC_CHECK_BATCH x the prompt, then REC_DECODE_STEPS decode steps;
# recurrentgemma-2b's prompt of 2560 passes the window in prefill and decode
SSM_ARCH, HYB_ARCH = "mamba2-130m", "recurrentgemma-2b"
REC_CHECK_LAYERS = {SSM_ARCH: 2, HYB_ARCH: 3}
REC_CHECK_BATCH, REC_DECODE_STEPS = 2, 4
# served at full depth in bf16 through launch.serve (the dense engine):
# REC_REQUESTS prompts of REC_PROMPT tokens (one length group), REC_MAX_NEW
# new tokens each, greedy
REC_PROMPT = {SSM_ARCH: 2048, HYB_ARCH: 2560}
REC_CHECK_PROMPT = {SSM_ARCH: 1024, HYB_ARCH: 2560}
REC_REQUESTS, REC_MAX_NEW = 4, 16
# (c) one training step on TP_WORLD gloo ranks, f32, against one device:
# every SSM and RG-LRU mixer, and recurrentgemma-2b's attention (10 heads
# do not split over 4 ranks), whole on every rank and run replicated over
# the gathered rows; recurrentgemma-2b's FFN through sp_ffn (d_ff 7680 over
# 4 ranks). Depth cut to REC_TRAIN_LAYERS (recurrentgemma-2b: one period);
# batch x sequence REC_TRAIN_SHAPE. A batch of 1 clamps cais's 2
# microbatches to 1 (resolve_microbatches).
REC_TRAIN_LAYERS = {HYB_ARCH: 3, SSM_ARCH: 2}
REC_TRAIN_SHAPE = {HYB_ARCH: (1, 4096), SSM_ARCH: (2, 2048)}
REC_TRAIN_RUNS = {HYB_ARCH: [("cais", 2, "float32"),
                             ("barrier", 1, "float32")],
                  SSM_ARCH: [("cais", 2, "float32")]}
# phase 15: the enc-dec and VLM families at their published widths, random
# weights from seed 0, f32 params: whisper-tiny (4 encoder + 4 decoder
# layers, d 384, 6 heads of 64, 1500 source frames) and paligemma-3b (18
# layers, d 2048, 8 query heads over 1 kv head of 256, d_ff 16384, 256
# image-prefix tokens of width 1152)
ENC_ARCH, VLM_ARCH = "whisper-tiny", "paligemma-3b"
PF_DECODE_STEPS = 4
# (a) whisper-tiny at full depth, f32 card vs CPU: ENC_CHECK_BATCH prompts
# of ENC_PROMPT tokens over 1500 frames; (b) served in bf16: ENC_REQUESTS
# prompts of ENC_PROMPT tokens (one length group), ENC_MAX_NEW new, greedy
ENC_CHECK_BATCH, ENC_PROMPT, ENC_REQUESTS, ENC_MAX_NEW = 2, 64, 4, 16
# (c) paligemma-3b cut to VLM_CHECK_LAYERS, f32 card vs CPU:
# VLM_CHECK_BATCH x (256 prefix + VLM_PROMPT text); (d) served at full depth
# in bf16: VLM_REQUESTS x (256 + VLM_PROMPT), VLM_MAX_NEW new
VLM_CHECK_LAYERS, VLM_CHECK_BATCH, VLM_PROMPT = 2, 2, 256
VLM_REQUESTS, VLM_MAX_NEW = 4, 16
# (e) one training step on TP_WORLD gloo ranks against one device, cut to
# VLM_TRAIN_LAYERS: batch 1 x (256 prefix + 1024 text) = 1280 rows, 320 a
# rank, so rank 0's shard straddles the prefix boundary
VLM_TRAIN_LAYERS, VLM_TRAIN_SHAPE = 1, (1, 1024)
VLM_TRAIN_RUNS = [("cais", 1, "float32")]
# phase 16: arctic-480b (128 experts top-2 beside a dense residual MLP, 56
# query heads over 8 kv heads of 128, trained with adafactor) at its
# published widths cut to ARCTIC_LAYERS of 35 layers: 14.05 B parameters,
# 28.1 GB in bf16, its runtime's parameter type (the published 480 B are
# above 6e10), drawn on the card. (a) served through launch.serve with
# phase 5's traffic; (b1) adafactor alone on one expert leaf (128 x 7168 x
# 4864, bf16) against its formula in f64; (b2) one adafactor train step on
# a batch of ARCTIC_TRAIN_SHAPE (four routing groups of 512, capacity 10),
# bf16 parameters and grads, remat off, at ARCTIC_LR
ARCTIC_ARCH, ARCTIC_LAYERS, ARCTIC_TRAIN_SHAPE = "arctic-480b", 1, (1, 2048)
# the launcher's default schedule's first lr past 0: its cosine schedule
# (peak 3e-4, 20 warmup steps) gives 0 at step 0 and 3e-4 / 20 at step 1.
# At the peak itself one adafactor step from the random init overshoots
# (NVIDIA H100 80GB HBM3, 700 W: the loss on the batch 11.67 -> 35.02)
ARCTIC_LR = 3e-4 / 20
# (b1): each new bf16 parameter within one bf16 ulp (2^-7 of its size) of
# the formula evaluated expert by expert in f64 with the f64 RMS, plus
# ADA_F32 of its two terms' sizes (p and lr·u are f32 before the
# subtraction, whose result can be far smaller than either); vr and vc
# (f32 means of 4864 / 7168 squares) within ADA_STATE_RTOL of f64
ADA_ULP, ADA_F32, ADA_STATE_RTOL = 2.0 ** -7, 2.0 ** -20, 1e-5
# (c) checkpoint across ring layouts: internlm2-1.8b at full width cut to
# CKPT_LAYERS of 24 layers, f32 adafactor at TRAIN_LR, batch TP_BATCH x
# TP_SEQ, CKPT_RUN on TP_WORLD gloo ranks: step 0, save (gathered, rank 0
# writes), step 1 (saved too); then step 1 from the first checkpoint on
# one device and again on the ring. Updated parameters against the ring's:
# |Δp| <= TRAIN_RTOL·max|p_ring - p_ckpt| of each tensor (the update, as
# phase 9 holds gradients) + CKPT_ROUNDING·|p_ring| (two f32 roundings)
CKPT_LAYERS, CKPT_RUN = 2, ("cais", 2, "float32")
CKPT_ROUNDING = 2.0 ** -22
# phase 17: MoE serving on TP_WORLD gloo ranks sharing the card, spawned
# once: mixtral-8x7b (MOE_LAYERS layers, f32 parameters) and arctic-480b
# (ARCTIC_LAYERS layer, bf16 parameters, 32 experts and about 7 GB a rank),
# each serve graph's MoE on the cais backend. Arctic has no f32 reference
# (its f32 weights would not fit beside the rest), so its bf16 logits are
# held, each step over the rows whose routing agreed, by their relative
# distance (Frobenius) from one device's bf16 logits, within the tightest
# bound phase 10 held a bf16 ring row to: BF16_LOGIT_FACTOR times one
# device's bf16 distance from f32 at one of its steps


T_START: Optional[float] = None     # main() sets it


def log(msg: str) -> None:
    """Print ``msg``; a phase's heading (``"phase N: ..."``) with the
    seconds since the script began."""
    if T_START is not None and msg.startswith("phase "):
        msg += f" [at {time.monotonic() - T_START:.1f}s]"
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
    """Phases 6, 9 and 10's model: internlm2-1.8b at full width, TP_LAYERS
    layers."""
    from repro_torch.configs import get_arch

    return get_arch(TP_ARCH).scaled(num_layers=TP_LAYERS)


def get_dp_cfg():
    """Phase 12 (a)'s model: internlm2-1.8b at full width, DP_LAYERS
    layers."""
    return get_tp_cfg().scaled(num_layers=DP_LAYERS)


def tp_core_case(cfg, B: int, dtype, seed: int, seq: int = TP_SEQ,
                 window: int = 0):
    """The attention core as a rank of phase 6 calls it: ``seq`` causal
    positions, H/TP_WORLD query heads over Hkv/TP_WORLD kv heads."""
    g = torch.Generator().manual_seed(seed)
    H, Hkv = cfg.num_heads // TP_WORLD, cfg.num_kv_heads // TP_WORLD
    dh = cfg.resolved_head_dim
    mk = lambda h: torch.randn(B, seq, h, dh, generator=g).to("cuda", dtype)
    pos = torch.arange(seq, dtype=torch.int32,
                       device="cuda").expand(B, seq).contiguous()
    return dict(q=mk(H), k=mk(Hkv), v=mk(Hkv), q_positions=pos,
                kv_positions=pos, window=window)


def get_moe_cfg():
    """mixtral-8x7b at its published widths, cut to MOE_LAYERS layers."""
    from repro_torch.configs import get_arch

    return get_arch(MOE_ARCH).scaled(num_layers=MOE_LAYERS)


def get_gep_cfg():
    """Phase 12 (b)'s model: mixtral-8x7b at full width, GEP_LAYERS layer."""
    from repro_torch.configs import get_arch

    return get_arch(MOE_ARCH).scaled(num_layers=GEP_LAYERS)


def get_mla_cfg():
    from repro_torch.configs import get_arch

    return get_arch(MLA_ARCH)


def get_mla_train_cfg():
    """Phase 13 (a)'s model: minicpm3-4b at full width, MLA_TRAIN_LAYERS
    layers."""
    return get_mla_cfg().scaled(num_layers=MLA_TRAIN_LAYERS)


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
    may see; 2·(dh + dv) operations per visible (query head, key) pair
    under the case's mask (:func:`case_mask`)."""
    q, k = case["q"], case["k"]
    B, Sq, H, dh = q.shape
    Hkv, dv = k.shape[2], case["v"].shape[3]
    vis = ref.visible(case["q_positions"], case["kv_positions"],
                      **case_mask(case))
    es = q.element_size()
    keys = int(vis.any(dim=1).sum())
    nbytes = (B * Sq * H * (dh + dv) * es + keys * Hkv * (dh + dv) * es
              + 4 * (case["q_positions"].numel()
                     + case["kv_positions"].numel()))
    ops = 2 * (dh + dv) * H * int(vis.sum())
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[q.dtype] * 1e3


def case_mask(case) -> dict:
    """A flash case's mask: causal unless the case says not (the enc-dec
    family's encoder and cross-attention), its window, its prefix-LM
    prefix (the VLM's training core; 0: none)."""
    return dict(causal=case.get("causal", True), window=case["window"],
                prefix_len=case.get("prefix_len", 0))


def flash_plan(fa, q, k, v):
    return fa.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                   k.shape[2], q.shape[3], v.shape[3], q.dtype)


def check_kernel_case(name: str, case, fa, ref) -> dict:
    import torch.nn.functional as F

    mask = case_mask(case)
    kw = dict(q_positions=case["q_positions"],
              kv_positions=case["kv_positions"], **mask)
    q, k, v = case["q"], case["k"], case["v"]
    p = flash_plan(fa, q, k, v)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, **kw)
    keep = case["q_positions"] >= 0      # rows with no visible key hold 0
    g, w = got[keep].float(), want[keep].float()
    err = (g - w).abs()
    tol = CHECK_TOL[q.dtype]
    check = tol["atol"] + tol["rtol"] * w.abs()
    limit = check
    if p.variant == "wgmma":
        limit = check + P_ROUNDING * ref.attention_ref(
            q, k, v.abs(), **kw)[keep].float()
    ok = bool((err <= limit).all())
    if not torch.isfinite(got).all() or got[~keep].any():
        ok = False
    # the library yardstick: SDPA with the same boolean mask (the prefix
    # rows' included), GQA inside; without one where every key is visible
    # (a non-causal row: is_causal=False)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    seen = ref.visible(case["q_positions"], case["kv_positions"], **mask)
    sdpa_mask = None if bool(seen.all()) and not mask["causal"] \
        else seen[:, None]
    t = timings(lambda: fa.flash_attention(q, k, v, **kw),
                lambda: ref.attention_ref(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask, is_causal=False,
                    enable_gqa=True))
    ms = t["ms"]
    bytes_ms, ops_ms = bound(case, ref)
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    row = dict(case=name, dtype=str(q.dtype).replace("torch.", ""),
               shape=dict(B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1],
                          H=q.shape[2], Hkv=k.shape[2], dh=q.shape[3],
                          dv=v.shape[3]),
               causal=mask["causal"], prefix_len=mask["prefix_len"],
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
    log(f"  {name:>14} {row['dtype']:>8} "
        f"{'' if mask['causal'] else 'non-causal '}"
        f"{'prefix %d ' % mask['prefix_len'] if mask['prefix_len'] else ''}"
        f"{p.variant} {p.tile[0]}x"
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
        # phase 9's auto runs (and its barrier run): the core on a rank's
        # heads over the whole batch, 2 x 4096
        rows.append(check_kernel_case("auto_tp_core", tp_core_case(
            get_tp_cfg(), TP_BATCH, dtype, seed=25), fa, ref))
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
    # phase 11: mixtral-8x7b served on one device (32 q / 8 kv heads, its
    # 4096 window past every position) in bf16 and in the scripted f32
    # steps, and the ring's attention core (a rank's 8 q / 2 kv heads over
    # the gathered MOE_SEQ tokens)
    moe = get_moe_cfg()
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_kernel_case("moe_decode", serving_case(
            moe, 1, q0=[699, 649, 0, 612], ctx=[700, 650, 0, 613],
            dtype=dtype, seed=5), fa, ref))
        rows.append(check_kernel_case("moe_prefill_chunk", serving_case(
            moe, PREFILL_CHUNK, q0=[640, 0, 0, 512], ctx=[700, 128, 0, 640],
            dtype=dtype, seed=6), fa, ref))
        rows.append(check_kernel_case("moe_tp_core", tp_core_case(
            moe, MOE_BATCH, dtype, seed=7, seq=MOE_SEQ, window=moe.window),
            fa, ref))
    # phase 13 (b)'s ragged step: a rank's 4 q / 2 kv heads over the whole
    # RAGGED_SEQ tokens of both rows (the replicated layout, f32)
    rows.append(check_kernel_case("ragged_tp_core", tp_core_case(
        get_tp_cfg(), TP_BATCH, torch.float32, seed=8, seq=RAGGED_SEQ), fa,
        ref))
    # phase 14: recurrentgemma-2b's sliding-window layers (10 q heads over
    # one kv head, dh 256, window 2048) served, checked and on the ring
    hyb = get_rec_cfg(HYB_ARCH)
    for i, (name, B, Sq, Skv, dtype) in enumerate(rec_flash_cases()):
        rows.append(check_kernel_case(name, rec_core_case(
            hyb, B, Sq, Skv, dtype, seed=9 + i), fa, ref))
    # phase 15: whisper-tiny's non-causal encoder and cross-attention cores
    # and its causal decoder, paligemma-3b's prefix-LM training cores (all
    # three variants: ffma f32, wgmma bf16, a split-KV decode whose queries
    # lie inside the prefix) and its causal serving cores
    for i, case in enumerate(pf_flash_cases()):
        rows.append(check_kernel_case(case[0], pf_core_case(
            *case[1:], seed=30 + i), fa, ref))
    # phase 16: arctic-480b's 56 q / 8 kv heads served (bf16 decode steps
    # and prefill chunks) and trained (its 1 x 2048 core, bf16), and the
    # one-device f32 step of the checkpoint check (internlm2-1.8b's whole
    # 16 q / 8 kv heads)
    for name, make in arctic_flash_cases():
        rows.append(check_kernel_case(name, make(), fa, ref))
    # phase 17: a rank's attention cores of both MoE models served on the
    # ring (mixtral-8x7b's 8 q / 2 kv heads, f32 and bf16; arctic-480b's 14
    # q / 2 kv heads, bf16), a decode step and a prefill chunk
    for name, make in moe_ring_flash_cases():
        rows.append(check_kernel_case(name, make(), fa, ref))
    return rows


def tp_matmul_shapes(cfg, itemsize: int, world: int = TP_WORLD,
                     batch: int = TP_BATCH, seq: int = TP_SEQ,
                     ring: Optional[int] = None, mbs=(1, 2)) -> list:
    """(M, K, N) of every matmul call of phase 6 on one rank in a type of
    ``itemsize`` bytes, by the schedules' own arithmetic: barrier GEMMs over
    the gathered sequence; cais ring steps of B·S_r/c rows on the gather
    side (c as the cais planner picks it) and of B·S_r/2 on the
    bidirectional reduce side, S_r = S / ``ring``; one S_loc slice a hop in
    the flat ring's overlap_asym. ``ring`` is the ring the fused schedules
    run on: the whole TP group of ``world`` (flat), or tp_in on a 2D mesh,
    whose weight shards are still the composite ``world``'s. Phases 6, 9
    and 12 check that their calls were all among these."""
    from repro_torch.core import primitives as prim
    from repro_torch.core.backends import CAISBackend

    n, d, dh = world, cfg.d_model, cfg.resolved_head_dim
    r = ring or n
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    ff = cfg.d_ff // n
    s_r = seq // r
    shapes = set()
    for mb in mbs:
        b = batch // mb
        c = prim._pick_chunks(s_r, CAISBackend.plan_chunks(
            b * seq * d * itemsize, r))
        pairs = [(b * seq, b * seq),                  # barrier
                 (b * s_r // c, b * s_r // 2)]        # cais rings
        if r == n:
            pairs.append((b * s_r, b * s_r))          # overlap_asym
        for m_ag, m_rs in pairs:
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
    # phase 11's ring training step: the attention ring GEMMs and, per
    # local expert, the expert GEMMs of the all-to-all and their backward
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N, lay in moe_matmul_shapes(get_moe_cfg(),
                                              str(dtype)[6:]):
            rows.append(check_matmul_case("moe", M, K, N, dtype, mmk, ref,
                                          layout=lay))
    # phase 17: every matmul call of a rank serving mixtral-8x7b (f32 and
    # bf16) and arctic-480b (bf16) on the ring: the attention GEMMs, the
    # expert GEMMs at their decode and prefill capacities; and arctic's
    # expert GEMMs in f32 too
    done = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"], r["dtype"],
             r["layout"]) for r in rows}
    arc = get_arctic_cfg()
    experts = {(arc.d_model, arc.d_ff), (arc.d_ff, arc.d_model)}
    cases = [(M, K, N, dtype) for dtype in (torch.float32, torch.bfloat16)
             for M, K, N in moe_serve_matmul_shapes(get_moe_cfg(),
                                                    serve_traffic())]
    cases += [(M, K, N, dtype)
              for M, K, N in moe_serve_matmul_shapes(arc, serve_traffic())
              for dtype in (torch.float32, torch.bfloat16)
              if dtype == torch.bfloat16 or (K, N) in experts]
    for M, K, N, dtype in cases:
        if (M, K, N, str(dtype)[6:], "nn") not in done:
            rows.append(check_matmul_case("moe_serve", M, K, N, dtype, mmk,
                                          ref))
    # the meshes' runs, all f32, at the shapes not checked above: phase 9's
    # and phase 10's 2D runs (the tp_in ring's steps), phase 12 (a)'s data
    # 2 x model 2 step (a ring of 2 on a replica's rows) and (b)'s grouped-EP
    # step on the 2D mesh
    seen = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"], r["dtype"],
             r["layout"]) for r in rows}
    f32, cfg = torch.float32, get_tp_cfg()
    ring = MESHES["2x2"]["tp_in"]
    dp_tp, dp_rows = TP_WORLD // MESHES["dp2"]["dp"], DP_BATCH // 2
    mesh_cases = [
        ("tp_2d", [(*s, "nn") for s in tp_matmul_shapes(cfg, 4, ring=ring)]
         + train_matmul_shapes(cfg, runs=TRAIN_2D_RUNS, ring=ring)),
        ("serve_2d", [(*s, "nn") for s in serve_matmul_shapes(
            cfg, serve_traffic(), ring=ring)]),
        ("dp", [(*s, "nn") for s in tp_matmul_shapes(
            cfg, 4, world=dp_tp, batch=dp_rows)]
         + train_matmul_shapes(cfg, world=dp_tp, batch=dp_rows,
                               runs=DP_RUNS)),
        ("gep_2d", moe_matmul_shapes(get_gep_cfg(), "float32",
                                     runs=GEP_RUNS, ring=ring)),
        # phase 13: minicpm3-4b's sp_ffn ring steps and their backward,
        # and internlm2-1.8b's ragged step (gemm_ar partials whole)
        ("sp_ffn", sp_ffn_matmul_shapes(get_mla_train_cfg())),
        ("ragged", ragged_matmul_shapes(cfg)),
        # phase 11 (b)'s ragged MoE leg: the attention GEMMs over the B·S
        # rows and each of a rank's experts on its G·C rows
        ("moe_ragged", ragged_matmul_shapes(get_moe_cfg(),
                                            batch=MOE_RAGGED_BATCH,
                                            seq=MOE_RAGGED_SEQ)),
        # phase 14 (c): recurrentgemma-2b's sp_ffn ring steps (2560 ->
        # 1920 a rank and back) and their backward
        ("rec_ffn", rec_matmul_shapes()),
        # phase 15 (e): paligemma-3b's whole-block ring step over the 1280
        # prefix + text rows and its backward
        ("vlm_ring", vlm_matmul_shapes())]
    for name, shapes in mesh_cases:
        for M, K, N, lay in shapes:
            if (M, K, N, "float32", lay) not in seen:
                seen.add((M, K, N, "float32", lay))
                rows.append(check_matmul_case(name, M, K, N, f32, mmk, ref,
                                              layout=lay))
    return rows


def moe_matmul_shapes(cfg, dtype: str, world: int = TP_WORLD,
                      batch: int = MOE_BATCH, seq: int = MOE_SEQ,
                      runs=None, ring: Optional[int] = None) -> list:
    """(M, K, N, layout) of every matmul call one rank makes in phase 11's
    training step in the runs of compute type ``dtype``, by the graphs' own
    arithmetic (mb 1): the attention block's ring GEMMs as in phases 6 and
    9 (barrier over the gathered b·S rows; cais gather steps of b·S_loc/c
    rows, c as the cais planner picks it, reduce steps of b·S_loc/2), the
    backward's grad all-gather through woᵀ and grad reduce-scatter through
    the concatenated (wq+wk+wv)ᵀ (nt), the attention weight grads over the
    b·S rows (tn); and per local expert of the all-to-all, on its cap rows
    (cap from a rank's b·S_loc tokens): the up, gate and down GEMMs (nn,
    run again by the expert VJP), dh = dy·w_downᵀ and dx = du·w_upᵀ +
    dg·w_gateᵀ (nt), the weight grads xᵀ·du, xᵀ·dg and hᵀ·dy (tn). On a
    2D mesh (phase 12 (b)) the ring steps are tp_in's (``ring``), of
    b·S_r rows, S_r = S / ring."""
    from repro_torch.core import primitives as prim
    from repro_torch.core.backends import CAISBackend
    from repro_torch.models.ffn import capacity

    runs = MOE_RUNS if runs is None else runs
    n, d, dh = world, cfg.d_model, cfg.resolved_head_dim
    r = ring or n
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    f, s_loc = cfg.d_ff, seq // n
    rows, cap = batch * seq, capacity(batch * s_loc, cfg)
    itemsize = {"float32": 4, "bfloat16": 2}[dtype]
    shapes = {(cap, d, f, "nn"), (cap, f, d, "nn"), (cap, d, f, "nt"),
              (cap, f, d, "nt"), (f, cap, d, "tn"), (d, cap, f, "tn"),
              (rows, d, fq, "nt"), (fq, rows, d, "tn"), (d, rows, fq, "tn"),
              (d, rows, fkv, "tn")}
    for mode in {r[0] for r in runs if r[2] == dtype}:
        if mode == "barrier":
            m_ag = m_rs = rows
        else:
            s_r = seq // r
            c = prim._pick_chunks(s_r, CAISBackend.plan_chunks(
                rows * d * itemsize, r))
            two = r % 2 == 0 and s_r % 2 == 0
            m_ag, m_rs = batch * s_r // c, batch * s_r // (2 if two else 1)
        shapes |= {(m_ag, d, fq, "nn"), (m_ag, d, fkv, "nn"),
                   (m_rs, fq, d, "nn"), (m_rs, fq + 2 * fkv, d, "nt")}
    return sorted(shapes)


def moe_serve_matmul_shapes(cfg, tr: dict, world: int = TP_WORLD) -> list:
    """(M, K, N) of every matmul call a rank makes serving the MoE ``cfg``
    on a ring of ``world`` in phase 17, by the serve graph's arithmetic:
    the q, k and v GEMMs over the B·S rows of a step (S 1 and a prefill
    chunk); the out-projection's ``gemm_ar``, one GEMM over the decode
    rows (S % world != 0: the monolithic all-reduce) or the cais ring's
    partial GEMMs of B·(S/world)/2 rows; and each owned expert's up, gate
    and down GEMMs over its G·C rows (the groups and capacity
    ``route_tokens`` gives the step's B·S tokens)."""
    from repro_torch.models.ffn import capacity

    n, d, dh, f = world, cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    B, C = tr["requests"], tr["chunk"]
    shapes = {(B * (C // n) // 2, fq, d), (B, fq, d)}
    for tokens in (B, B * C):
        g = min(cfg.moe.group_size, tokens)
        while tokens % g:
            g //= 2
        e = tokens // g * capacity(g, cfg)
        shapes |= {(tokens, d, fq), (tokens, d, fkv), (e, d, f), (e, f, d)}
    return sorted(shapes)


def batch_split(batch: int, mb: int) -> int:
    """The microbatches a run asking for ``mb`` takes on ``batch`` rows:
    the largest count up to ``mb`` that divides the batch, as
    ``core.tp.resolve_microbatches`` clamps it."""
    mb = max(1, min(mb, batch))
    while batch % mb:
        mb -= 1
    return mb


def train_matmul_shapes(cfg, world: int = TP_WORLD, batch: int = TP_BATCH,
                        seq: int = TP_SEQ, runs=None,
                        ring: Optional[int] = None) -> list:
    """(M, K, N, layout) of every matmul call with a transposed operand that
    phase 9's backward makes on one rank, by the training graph's own
    arithmetic (its forward calls are ``tp_matmul_shapes``'): per chain of
    b = batch / mb rows of the full sequence, the grad all-gathers through
    w_down^T and wo^T (nt, b·S rows), the weight grads xᵀ·dy over the folded
    b·S rows (tn), and the grad reduce-scatters through the concatenated
    transposed up+gate and q+k+v weights (nt: b·S rows under barrier, b·S_loc
    / 2 a hop on the bidirectional cais ring, b·S_loc paired in
    overlap_asym). A run's microbatches ``"auto"`` (the perfsim planner
    picks them) stand for every split the planner may take: 1, 2 and 4
    where they divide the batch. On a 2D mesh the reduce-scatter ring is
    tp_in (``ring``): b·S_r / 2 rows a hop, S_r = S / ring, and its overlap
    pairs run the same hierarchical schedules. A run of the ``auto`` TP mode
    makes no matmul call."""
    runs = TRAIN_RUNS if runs is None else runs
    n, d, dh = world, cfg.d_model, cfg.resolved_head_dim
    r = ring or n
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    ff, s_loc = cfg.d_ff // n, seq // n
    shapes = set()
    splits = [(mode, mb) for mode, req, *_ in runs if mode != "auto"
              for mb in ((1, 2, 4) if req == "auto"
                         else (batch_split(batch, req),))
              if batch % mb == 0]
    for mode, mb in splits:
        b = batch // mb
        rows = b * seq
        shapes |= {(rows, d, ff, "nt"), (rows, d, fq, "nt"),
                   (ff, rows, d, "tn"), (d, rows, ff, "tn"),
                   (fq, rows, d, "tn"), (d, rows, fq, "tn"),
                   (d, rows, fkv, "tn")}
        m_rs = rows if mode == "barrier" else b * (seq // r) // 2
        ks = (2 * ff, fq + 2 * fkv)
        shapes |= {(m_rs, k, d, "nt") for k in ks}
        if mb > 1 and r == n:
            shapes |= {(b * s_loc, k, d, "nt") for k in ks}
    return sorted(shapes)


def sp_ffn_matmul_shapes(cfg, batch: int = MLA_TRAIN_BATCH,
                         seq: int = MLA_TRAIN_SEQ,
                         runs=MLA_TRAIN_RUNS) -> list:
    """(M, K, N, layout) of every matmul call of phase 13 (a)'s ring steps,
    which are the FFNs' (an MLA mixer runs replicated, with torch's own
    products): per run's chain of b = batch / mb rows, the forward's up/gate
    and down GEMMs as :func:`tp_matmul_shapes` counts them for the run's
    mode (barrier over the gathered b·S rows; cais gather steps of b·S_r/c,
    reduce steps of b·S_r/2, and at mb > 1 the overlap pair's b·S_r rows a
    hop), and the backward's as :func:`train_matmul_shapes` does (the FFN's
    of them: the grad gathers through w_downᵀ, the grad reduce-scatters
    through (w_up+w_gate)ᵀ, the weight grads)."""
    from repro_torch.core import primitives as prim
    from repro_torch.core.backends import CAISBackend

    n, d, ff = TP_WORLD, cfg.d_model, cfg.d_ff // TP_WORLD
    s_r = seq // n
    shapes = set()
    for mode, mb, *_ in runs:
        mb = batch_split(batch, mb)
        b = batch // mb
        if mode == "barrier":
            pairs = [(b * seq, b * seq)]
        else:
            c = prim._pick_chunks(s_r, CAISBackend.plan_chunks(
                b * seq * d * 4, n))
            pairs = [(b * s_r // c, b * s_r // 2)]
            if mb > 1:
                pairs.append((b * s_r, b * s_r))
        for m_ag, m_rs in pairs:
            shapes |= {(m_ag, d, ff, "nn"), (m_rs, ff, d, "nn")}
    shapes |= {s_ for s_ in train_matmul_shapes(cfg, batch=batch, seq=seq,
                                                runs=runs)
               if ff in s_[:3] or s_[1] == 2 * ff}
    return sorted(shapes)


def ragged_matmul_shapes(cfg, world: int = TP_WORLD, batch: int = TP_BATCH,
                         seq: int = RAGGED_SEQ) -> list:
    """(M, K, N, layout) of every matmul call one rank makes in a ragged
    step (phase 13 (b); phase 11 (b)'s MoE leg), by the replicated-
    activation graph's arithmetic over the B·S rows (S % ring != 0, so each
    gemm_ar is cais's monolithic fallback: one GEMM, then the all-reduce):
    the column GEMMs q, k, v, up and gate (nn), their adjoints' gemm_ar
    through wᵀ (nt) and weight grads xᵀ·dy (tn); the gemm_ar partials of wo
    and w_down (nn), their adjoints' dx = dy·wᵀ (nt) and weight grads (tn).
    An MoE's FFN is instead each of a rank's experts on its G·C rows (the
    groups and capacity ``route_tokens`` gives the B·S tokens): up, gate
    and down (nn, run again by the VJP), dh = dy·w_downᵀ and the row grads
    du·w_upᵀ, dg·w_gateᵀ (nt), the weight grads (tn)."""
    from repro_torch.models.ffn import capacity

    n, d, dh = world, cfg.d_model, cfg.resolved_head_dim
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    rows = batch * seq
    ff = cfg.d_ff // n
    cols, outs = ((fq, fkv), (fq,)) if cfg.moe else ((fq, fkv, ff), (fq, ff))
    shapes = set()
    for f in cols:
        shapes |= {(rows, d, f, "nn"), (rows, f, d, "nt"), (d, rows, f, "tn")}
    for f in outs:
        shapes |= {(rows, f, d, "nn"), (rows, d, f, "nt"), (f, rows, d, "tn")}
    if cfg.moe:
        g = min(cfg.moe.group_size, rows)
        while rows % g:
            g //= 2
        e, f = rows // g * capacity(g, cfg), cfg.d_ff
        shapes |= {(e, d, f, "nn"), (e, f, d, "nn"), (e, d, f, "nt"),
                   (e, f, d, "nt"), (f, e, d, "tn"), (d, e, f, "tn")}
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


def record_calls(ops, calls: dict, masked: bool = False):
    """Wrap ``ops.flash_attention`` so that each call's shape key (B, Sq, H,
    dh, Skv, Hkv, dv, dtype), with ``masked`` followed by its mask (causal,
    prefix_len), is counted in ``calls``; returns the original to put
    back."""
    core = ops.flash_attention

    def core_shapes(q, k, v, **kw):
        key = (*q.shape, k.shape[1], k.shape[2], v.shape[3],
               str(q.dtype).replace("torch.", ""))
        if masked:
            key += (kw.get("causal", True), kw.get("prefix_len", 0))
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


def prefill_decode(lm, tokens, steps: int = 3, extras=None):
    """The model's prefill of ``tokens`` (with ``extras``, the enc-dec and
    VLM families' frontend inputs) then ``steps`` decode steps of fixed
    tokens, positions past a VLM's image prefix; returns every step's
    logits on the CPU."""
    dev = lm.device
    B, S = tokens.shape
    P = lm.cfg.num_prefix_tokens
    batch = tokens.to(dev)
    if extras:
        batch = {"tokens": batch, **{k: v.to(dev)
                                     for k, v in extras.items()}}
    logits, caches = lm.prefill(batch, s_max=P + S + steps)
    out = [logits.cpu()]
    for t in range(steps):
        tok = torch.full((B, 1), 7 + t, dtype=torch.int32, device=dev)
        idx = torch.full((B,), P + S + t, dtype=torch.int32, device=dev)
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
    parameters, one flat f32 file each in a temporary directory (the
    memory-mapped page cache, shared with the rank processes, which read
    only their shards). Picklable: the ranks open the files by name.
    ``quantities`` may keep the gradients alone: phase 11's four would be
    50.6 GB, past what a chip call may write to its disk (45 GiB, phase 9's
    store included); its m, v and parameters are then AdamW's first step
    of those gradients (:func:`first_step`)."""

    QUANTITIES = ("grad", "m", "v", "param")

    def __init__(self, shapes: dict, root: str, quantities=QUANTITIES):
        self.quantities = tuple(quantities)
        self.shapes = dict(shapes)
        self.offsets, n = {}, 0
        for name, shape in self.shapes.items():
            self.offsets[name] = n
            n += int(torch.Size(shape).numel())
        self.numel, self.root = n, root

    def path(self, q: str) -> str:
        return str(Path(self.root) / f"{q}.f32")

    def create(self) -> None:
        for q in self.quantities:
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


def train_batch(cfg=None, seq: int = TP_SEQ, batch: int = TP_BATCH):
    """Phase 9's batch: step 0 of ``data.pipeline.make_batch`` at train_4k's
    length, its global batch of 256 cut to TP_BATCH (phase 11: ``seq`` and
    ``batch`` of ``cfg``)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch

    shape = ShapeConfig("train_4k", seq, batch, "train")
    return make_batch(cfg or get_tp_cfg(), shape, 0, DataConfig(SEED))


def routing_probe():
    """Wrap the MoE dispatch (``models.ffn._top2_dispatch``, which the
    one-device ``moe_forward`` and the ring's ``route_fn`` call) so that
    each call's routing is recorded on the host: per token
    (expert 1, its slot, expert 2, its slot), −1 for a dropped choice's
    slot, and the token's three largest router probabilities. Returns
    (records, restore)."""
    from repro_torch.models import ffn

    inner = ffn._top2_dispatch
    rec = []

    def recorded(probs, capacity):
        out = inner(probs, capacity)
        rec.append(compact_routing(probs, out[0]))
        return out

    def restore():
        ffn._top2_dispatch = inner

    ffn._top2_dispatch = recorded
    return rec, restore


def compact_routing(probs, dispatch) -> tuple:
    """((T, 4) int32 (e1, slot1, e2, slot2), (T, 3) f32 top-3 router
    probabilities) of one dispatch call, tokens in group-major order."""
    p = probs.detach().float().reshape(-1, probs.shape[-1])
    d = dispatch.reshape(p.shape[0], p.shape[1], -1)
    e1 = torch.argmax(p, -1)
    e2 = torch.argmax(p.scatter(1, e1[:, None], -1.0), -1)
    t = torch.arange(p.shape[0], device=p.device)

    def slot(e):
        row = d[t, e]
        return torch.where(row.any(-1), row.float().argmax(-1), -1)

    routing = torch.stack([e1, slot(e1), e2, slot(e2)], 1).int()
    top3 = p.sort(-1, descending=True).values[:, :3]
    return routing.cpu().numpy(), top3.cpu().numpy()


def routing_differences(got: list, want: list) -> dict:
    """The (token, layer) pairs whose routing differs between ``got`` and
    the reference ``want`` (lists of :func:`compact_routing` records, in
    the same order): ``choice``, the pairs whose two experts differ;
    ``slots``, the pairs with the same experts in other capacity slots (a
    choice elsewhere in the group moves them); ``worst_gap``, the largest
    reference gap (top-1/top-2 or top-2/top-3, the smaller) among the
    choice differences; ``first``, the index of the first record with a
    difference (None where all agree)."""
    import numpy as np

    out = dict(choice=0, slots=0, worst_gap=None, first=None)
    for i, ((g, _), (w, top3)) in enumerate(zip(got, want)):
        ch = (g[:, 0] != w[:, 0]) | (g[:, 2] != w[:, 2])
        sl = ~ch & ((g[:, 1] != w[:, 1]) | (g[:, 3] != w[:, 3]))
        out["choice"] += int(ch.sum())
        out["slots"] += int(sl.sum())
        if ch.any():
            gap = np.minimum(top3[:, 0] - top3[:, 1],
                             top3[:, 1] - top3[:, 2])[ch]
            out["worst_gap"] = max(out["worst_gap"] or 0.0, float(gap.max()))
        if out["first"] is None and (ch.any() or sl.any()):
            out["first"] = i
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routing records against "
                             f"{len(want)}")
    return out


def routing_rule(diff: dict) -> bool:
    """Routing agrees, or every expert choice that differs sits at a
    reference probability gap below ROUTE_TOL."""
    return diff["choice"] == 0 and diff["slots"] == 0 or (
        diff["worst_gap"] is not None and diff["worst_gap"] < ROUTE_TOL)


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


def train_reference(batch, root: str, cfg, device="cuda",
                    quantities=RefStore.QUANTITIES) -> tuple:
    """The one-device step, f32, remat on, the per-block path: its loss,
    grad norm, time and peak memory, the one-device bf16 loss (forward
    only), an MoE's routing in the step's forward (:func:`routing_probe`),
    and a :class:`RefStore` of its gradients, m, v and parameters. Frees
    the card before it returns."""
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.runtime import Runtime
    from repro_torch.train.step import init_state, make_train_step

    rt = Runtime(compute_dtype="float32")
    lm = build_model(cfg, rt, device=device, seed=SEED)
    tok = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with torch.no_grad():
        lm.rt = Runtime(compute_dtype="bfloat16")
        loss_bf16 = float(lm.loss(tok))
        lm.rt = rt
    opt = adamw(constant_schedule(TRAIN_LR), eps=TRAIN_EPS,
                clip_norm=TRAIN_CLIP)
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, rt)
    routes, restore = routing_probe()
    _peak_start(device)
    t0 = time.monotonic()
    try:
        state, metrics = step(state, batch)
        _sync(device)
    finally:
        restore()
    step_s = time.monotonic() - t0
    peak = _peak_gib(device)
    params = dict(lm.named_parameters())
    store = RefStore({k: tuple(p.shape) for k, p in params.items()}, root,
                     quantities)
    store.create()
    t0 = time.monotonic()
    grads = {k: p.grad for k, p in params.items()}
    for q, src in (("grad", grads), ("m", state["opt"]["m"]),
                   ("v", state["opt"]["v"]), ("param", params)):
        if q in quantities:
            store.write(q, src)
    maxabs = {q: {k: float(t.abs().max()) for k, t in src.items()}
              for q, src in (("grad", grads), ("m", state["opt"]["m"]),
                             ("v", state["opt"]["v"]))}
    write_s = time.monotonic() - t0
    ref = dict(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]), loss_bf16=loss_bf16,
               step_s=step_s, peak_gib=peak, write_s=write_s, maxabs=maxabs,
               store_gb=4 * len(quantities) * store.numel / 1e9,
               routing=routes[:cfg.num_layers])
    del lm, state, step, opt, params, grads, metrics, tok
    if _on_card(device):
        torch.cuda.empty_cache()
    return ref, store


def plan_probe() -> dict:
    """On this rank, wrap the perfsim planner's two entry points
    (``repro_torch.plan.period_planner``, ``PerfsimPlanner.pair``) and
    ``dataflow.execute``. Returns the record they fill: "times", the host
    seconds of every planning call by what answered it ("miss": the search
    ran; "memo": the in-process memo; "hit": the cache's JSON entry);
    "plans", the Plan of each call; "executed", {overlap_asym node:
    executions}. Clear it with :func:`probe_reset`."""
    from repro_torch import plan
    from repro_torch.core import dataflow

    probe = dict(times={"miss": [], "memo": [], "hit": []}, plans=[],
                 executed={})

    def timed(fn, plan_of):
        def wrapped(*a, **k):
            c = plan.default_cache()
            before = (c.misses, c.memo_hits)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            kind = ("miss" if c.misses > before[0] else
                    "memo" if c.memo_hits > before[1] else "hit")
            probe["times"][kind].append(dt)
            probe["plans"].append(plan_of(a, out))
            return out
        return wrapped

    plan.period_planner = timed(plan.period_planner, lambda a, out: out[0])
    plan.search.PerfsimPlanner.pair = timed(plan.search.PerfsimPlanner.pair,
                                            lambda a, out: a[0].plan)
    execute = dataflow.execute

    def recorded(g, *a, **k):
        for nd in g.nodes:
            if nd.op == "overlap_asym":
                probe["executed"][nd.name] = \
                    probe["executed"].get(nd.name, 0) + 1
        return execute(g, *a, **k)

    dataflow.execute = recorded
    return probe


def probe_reset(probe: dict) -> None:
    for v in probe["times"].values():
        v.clear()
    probe["plans"].clear()
    probe["executed"].clear()


def probe_times(probe: dict) -> dict:
    """{kind: (calls, min, median, max host seconds)} of the planning
    calls."""
    out = {}
    for kind, ts in probe["times"].items():
        if ts:
            ts = sorted(ts)
            out[kind] = (len(ts), ts[0], ts[len(ts) // 2], ts[-1])
    return out


def plan_digests_agree(group, obj) -> bool:
    """Whether every rank of ``group`` holds the same ``obj`` (a JSON-able
    plan record): its SHA-256 gathered over the ring."""
    import hashlib

    digest = hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                            ).digest()
    mine = torch.tensor(list(digest), dtype=torch.int64)[None]
    every = group.all_gather(mine, 0)
    return bool((every == mine).all())


def _ref_shard(store, q: str, name: str, group, cfg):
    """This rank's shard on the TP group ``group`` (a flat ring or a 2D
    mesh's composite group) of the one-device tensor ``name`` of quantity
    ``q``, flat and contiguous on the host."""
    from repro_torch.core.tp import shard_param

    return shard_param(store.read(q, name), name, cfg,
                       group).contiguous().reshape(-1)


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


def first_step(g_ref, p0, grad_norm: float) -> tuple:
    """AdamW's first step from the one-device gradient ``g_ref`` (a chunk,
    f32) and the initial parameter ``p0``, clipped by the one-device grad
    norm: (m, v, parameter) as the one-device step holds them, through the
    port's own ``adamw`` with the clip applied here (the chunk is not the
    whole model)."""
    from repro_torch.optim import adamw, constant_schedule

    opt = adamw(constant_schedule(TRAIN_LR), eps=TRAIN_EPS,
                clip_norm=float("inf"))
    p = {"x": p0.float().clone()}
    state = opt.init(p)
    scale = min(1.0, TRAIN_CLIP / max(grad_norm, 1e-9))
    p, state = opt.apply(p, {"x": g_ref * scale}, state, 0)
    return state["m"]["x"], state["v"]["x"], p["x"]


def train_errors(lm, state, store, ref, cfg, init=None) -> tuple:
    """This rank's f32 gradients, m, v and parameters against the one-device
    step's shards, CHUNK elements at a time (the card holds four ranks'
    models and states): per parameter (max|Δ|, bound) for grad, m and v,
    (max|Δ|, max err/limit) for the parameter (:func:`param_limit`, from
    the gradient bound times the one-device clip scale), and the count of
    parameter elements past the tight bound where the sign may differ.
    Where the store keeps the gradients alone, the one-device m, v and
    parameters are :func:`first_step` of them from this rank's initial
    shard ``init`` (the one-device model's, drawn from the same seed)."""
    errs, at_sign = {}, 0
    clip = min(1.0, TRAIN_CLIP / ref["grad_norm"])
    for k, p in lm.named_parameters():
        mine = {"grad": p.grad, "m": state["opt"]["m"][k],
                "v": state["opt"]["v"][k], "param": p.detach()}
        want = {q: _ref_shard(store, q, k, lm.group, cfg)
                for q in store.quantities}
        if "param" not in want:
            want["p0"] = init[k].reshape(-1)
        mine = {q: t.reshape(-1) for q, t in mine.items()}
        bound = {q: TRAIN_RTOL * ref["maxabs"][q][k]
                 for q in ("grad", "m", "v")}
        worst = dict.fromkeys(("grad", "m", "v", "param", "ratio"), 0.0)
        for lo in range(0, mine["grad"].numel(), CHUNK):
            sl = slice(lo, lo + CHUNK)
            w = {q: t[sl].to(p.device) for q, t in want.items()}
            if "p0" in w:
                w["m"], w["v"], w["param"] = first_step(
                    w["grad"], w.pop("p0"), ref["grad_norm"])
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


def _mesh_switch(lm, cfg, mesh) -> None:
    """Run ``lm`` on ``mesh`` from now on, where its shards and data axis
    are the ones ``lm`` holds (phases 9 and 10: the 2D mesh of the flat
    ring's 4 ranks cuts every dense weight by the composite index, which
    is the flat rank)."""
    from repro_torch.core.tp import param_placement
    from repro_torch.sharding import as_mesh

    mesh = as_mesh(mesh)

    def place(name, g):
        p = param_placement(name, cfg, g)
        return None if p is None else (p[0], p[1].size, p[1].rank)

    if mesh.data.size != lm.dp or any(
            place(k, lm.group) != place(k, mesh.tp)
            for k, _ in lm.named_parameters()):
        raise AssertionError("the mesh cuts other shards than the model's")
    lm.mesh = mesh


def _group_name(g, lm) -> str:
    """Which of ``lm``'s groups ``g`` is: its TP group's tp_out ring, tp_in
    ring, the whole TP group, or another."""
    from repro_torch.sharding import CompositeGroup

    tp = lm.group
    if isinstance(tp, CompositeGroup):
        if g is tp.tp_out:
            return "tp_out"
        if g is tp.tp_in:
            return "tp_in"
    return "tp" if g is tp else "other"


def compress_check(lm, batch) -> dict:
    """Phase 12 (a)'s compression: this replica's grads of a step on its
    rows (summed over the TP group, not yet over the replicas), their int8
    ``compressed_psum`` over the data axis against the exact sum, tensor by
    tensor: the worst max|Δ| / max|exact| and the bytes an f32 and an int8
    all-reduce move."""
    from repro_torch.optim.compression import (compressed_psum,
                                               init_error_feedback,
                                               wire_bytes_saved)

    for p in lm.parameters():
        p.grad = None
    rows = {k: torch.as_tensor(v).to(lm.device) for k, v in batch.items()}
    lm.loss(rows).backward()
    lm.sync_grads(rows["tokens"].shape[1], data=False)
    worst, name, sizes = 0.0, None, [0, 0]
    t0 = time.monotonic()
    for k, p in lm.named_parameters():
        g = {k: p.grad}
        exact = lm.data.all_reduce(p.grad)
        red, _ = compressed_psum(g, init_error_feedback(g), lm.data,
                                 mean=False)
        rel = float((red[k] - exact).abs().max()
                    / (exact.abs().max() + 1e-30))
        if rel >= worst:
            worst, name = rel, k
        f32, i8 = wire_bytes_saved(g)
        sizes[0] += f32
        sizes[1] += i8
        p.grad = None
        del g, exact, red
    return dict(worst_rel=worst, worst_param=name, f32_bytes=sizes[0],
                int8_bytes=sizes[1], seconds=time.monotonic() - t0)


def train_legs(group, legs, cfg, device="cuda", mesh="flat",
               compress=False, spawned: Optional[float] = None) -> list:
    """One rank of the training phases: for each leg (batch, runs, store,
    ref) and each of its (mode, microbatches, dtype[, planner[, mesh[,
    sequence_parallel]]]) runs, one train step (LM.loss, its graph-built
    backward, the grad sums over the TP group and the data axis, AdamW) from
    the same initial shards of one model, with the kernels' launches (set
    to 0 just before the step) against the counts derived from the planned
    forward and training graphs the step ran (``tp.recording``,
    ``tp.step_launches``: whole periods, per-block graphs, one-sub-layer
    graphs and replicated MLA mixers alike), every kernel call's shape
    (and a matmul's layout), the backend's ``gemm_ar`` dispatches, under
    the ``auto`` mode the collectives DTensor issued (:class:`CommCensus`),
    and in f32 this rank's gradients, m, v
    and parameters against the one-device step's shards (the leg's
    ``store``). The model is built on the mesh ``mesh`` (a key of MESHES,
    factored from the world ``group``); a run naming another mesh with the
    same shards runs there. A replica steps on its rows of the batch. A
    perfsim run also returns its plans (split, pairings, simulated
    makespans against greedy's), whether every rank holds the same, the
    overlap_asym nodes its graphs executed against the plans' pairs, and
    the planner's host time by what answered each call. With ``compress``,
    :func:`compress_check` after each leg's runs. ``spawned``: the host's
    clock (``time.time``) when the ranks were started, for their start-up
    time. Returns one dict(runs, compress) a leg."""
    from collections import Counter

    from repro_torch import plan as plan_mod
    from repro_torch.core import tp as tp_mod
    from repro_torch.core.backends import get_backend
    from repro_torch.data.pipeline import replica_rows
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import matmul_rmsnorm as mln
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.transformer import activation_layout
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.runtime import Runtime, TPConfig
    from repro_torch.sharding import CompositeGroup, init_mesh
    from repro_torch.train.step import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    startup_s = None if spawned is None else time.time() - spawned
    reached = None if spawned is None else (T_MODULE - spawned,
                                            T_TORCH - T_MODULE)
    t_setup = time.monotonic()
    meshes = {}

    def mesh_of(key):      # every rank makes the same meshes in one order
        if key not in meshes:
            meshes[key] = group if key == "flat" else \
                init_mesh(group, **MESHES[key])
        return meshes[key]

    lm = build_model(cfg, Runtime(compute_dtype="float32"), device=device,
                     seed=SEED, group=mesh_of(mesh))
    if _on_card(device):
        torch.cuda.empty_cache()      # the whole model drawn for the shards
    init = {k: p.detach().to("cpu", copy=True)
            for k, p in lm.named_parameters()}
    asym, gemm_ar = [0], [0]
    for name in ("barrier", "cais"):
        be = get_backend(name)

        def counted(*a, _inner=be.overlap_asymmetric, **k):
            asym[0] += 1
            return _inner(*a, **k)

        def counted_ar(*a, _inner=be.gemm_ar, **k):
            gemm_ar[0] += 1
            return _inner(*a, **k)

        be.overlap_asymmetric = counted
        be.gemm_ar = counted_ar
    # the expert all-to-all and its adjoint through the backends, with the
    # matmul launches made inside them (the expert GEMMs)
    # on a 2D mesh the composite group's dispatch re-enters on tp_out:
    # the concrete dispatches are counted, and the groups they name kept
    a2a = {"a2a_expert_ffn": [0, 0], "grad_a2a_expert_ffn": [0, 0]}
    a2a_groups = set()
    for name in ("barrier", "cais"):
        be = get_backend(name)
        for meth in a2a:
            def wrapped(*a, _inner=getattr(be, meth), _m=meth, **k):
                g = a[2] if _m == "a2a_expert_ffn" else a[3]
                if isinstance(g, CompositeGroup):
                    return _inner(*a, **k)
                a2a_groups.add(f"{_m}:{_group_name(g, lm)}")
                before = mmk.launches
                out = _inner(*a, **k)
                a2a[_m][0] += 1
                a2a[_m][1] += mmk.launches - before
                return out
            setattr(be, meth, wrapped)
    routes, _ = routing_probe()
    calls = {}

    def shapes(a, b, _inner=ops.matmul, **k):
        key = (*a.shape, b.shape[1], str(a.dtype).replace("torch.", ""),
               mmk.layout(a, b))
        calls[key] = calls.get(key, 0) + 1
        return _inner(a, b, **k)

    ops.matmul = shapes
    norm_calls, flash_calls = {}, {}

    def norm_shapes(a, b, scale, _inner=ops.matmul_rmsnorm, **k):
        key = (*a.shape, b.shape[1], b.stride(0),
               str(a.dtype).replace("torch.", ""))
        norm_calls[key] = norm_calls.get(key, 0) + 1
        return _inner(a, b, scale, **k)

    ops.matmul_rmsnorm = norm_shapes
    record_calls(ops, flash_calls, masked=True)
    probe = plan_probe()
    setup_s = time.monotonic() - t_setup     # the model drawn, its shards
    legs_out = []
    for batch, runs, store, ref in legs:
        if lm.dp > 1:
            batch = replica_rows(batch, lm.data.rank, lm.dp)
        B, S = batch["tokens"].shape
        S += cfg.num_prefix_tokens       # the rows the stack sees (a VLM's)
        out = []
        for run in runs:
            t_run = time.monotonic()
            mode, mb, dtype = run[:3]
            planner = run[3] if len(run) > 3 else "greedy"
            run_mesh = run[4] if len(run) > 4 else mesh
            sp = run[5] if len(run) > 5 else True
            if mesh_of(run_mesh) is not lm.mesh and \
                    mesh_of(run_mesh) is not lm.group:
                _mesh_switch(lm, cfg, mesh_of(run_mesh))
            rt = Runtime(compute_dtype=dtype, tp=TPConfig(
                mode=mode, microbatches=mb, planner=planner,
                sequence_parallel=sp))
            lm.rt = rt
            with torch.no_grad():
                for k, p in lm.named_parameters():
                    p.copy_(init[k])
            opt = adamw(constant_schedule(TRAIN_LR), eps=TRAIN_EPS,
                        clip_norm=TRAIN_CLIP)
            state = init_state(lm, opt)
            step = make_train_step(lm, opt, rt)
            _peak_start(device)
            mmk.launches = fa.launches = mln.launches = asym[0] = 0
            gemm_ar[0] = 0
            mmk.launches_by_variant = dict.fromkeys(mmk.COUNTERS, 0)
            fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
            for c in (calls, norm_calls, flash_calls):
                c.clear()
            probe_reset(probe)
            routes.clear()
            a2a_groups.clear()
            for v in a2a.values():
                v[0] = v[1] = 0
            census = CommCensus(lm) if mode == "auto" else None
            t0 = time.monotonic()
            with tp_mod.recording() as rec, \
                    (census or contextlib.nullcontext()):
                state, metrics = step(state, batch)
            _sync(device)
            wall = time.monotonic() - t0
            launches = (mmk.launches, fa.launches, asym[0], mln.launches,
                        gemm_ar[0])
            layouts = dict(mmk.launches_by_variant)
            executed, times = dict(probe["executed"]), probe_times(probe)
            peak = _peak_gib(device)
            t_derive = time.monotonic()
            tpc = tp_mod.TPContext.from_config(rt.tp, lm.group)
            derived = tp_mod.step_launches(rec, B, S, cfg.d_model,
                                           rt.dtype.itemsize)
            trained = [(p_, p_.training()) for p_ in rec.periods]
            period = bwd = bwd_planner = fwd = None
            mb, periods = 1, len(trained)
            if trained:      # none where every sub-layer ran replicated
                period, (_, bwd, bwd_planner) = trained[0]
                fwd, mb = period.graph, period.mb
            pairs = [nd.name for g in (fwd, bwd) if g is not None
                     for nd in g.nodes if nd.op == "overlap_asym"]
            plans = None
            if planner == "perfsim":
                fp, bp = period.plan, bwd_planner.plan
                plans = dict(
                    mb=mb, forward=[list(p) for p in fp.pairing],
                    backward=[list(p) for p in bp.pairing],
                    chunks=[fp.num_chunks, bp.num_chunks],
                    makespan_ms=[fp.makespan * 1e3, bp.makespan * 1e3],
                    greedy_makespan_ms=[fp.greedy_makespan * 1e3,
                                        bp.greedy_makespan * 1e3])
                planned = sorted(f"{a}+{b}"
                                 for a, b in fp.pairing + bp.pairing)
                cache = plan_mod.default_cache()
                plans.update(
                    same_on_every_rank=plan_digests_agree(
                        group, {k: plans[k] for k in ("mb", "forward",
                                                      "backward", "chunks")}),
                    graphs_pair_the_plan=sorted(pairs) == planned,
                    executed_is_the_plan=executed == {
                        p: c * periods for p, c in Counter(planned).items()},
                    host_s=times,
                    cache=dict(cache.stats, memo_hits=cache.memo_hits))

            def nodes(op, attr=None):
                return sum(
                    (tpc.route_ring * getattr(nd.fn, attr) if attr else 1)
                    for p_, t_ in trained for g in (p_.graph, t_[1])
                    for nd in g.nodes if nd.op == op)

            row = dict(
                mode=mode, mb=mb, requested_mb=run[1], planner=planner,
                mesh=run_mesh, sequence_parallel=sp,
                layout=activation_layout(rt, S, lm.tp), batch=[B, S],
                topology=list(tpc.topology), dp=lm.dp, dtype=dtype,
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                peak_gib=peak, matmul_launches=launches[0],
                matmul_derived=derived["matmul"], matmul_layouts=layouts,
                matmul_variants=mmk.variant_totals(layouts),
                flash_launches=launches[1], flash_derived=derived["flash"],
                flash_variants=dict(fa.launches_by_variant),
                mln_launches=launches[3],
                mln_derived=derived["matmul_rmsnorm"],
                gemm_ar=launches[4], gemm_ar_derived=nodes("gemm_ar"),
                expert_ar=nodes("expert_ar"),
                overlap_asym=launches[2],
                overlap_asym_nodes=derived["overlap_asym"],
                # a2a_ffn / bwd_a2a_ffn: backend dispatches and the matmul
                # launches inside them, against the graphs' nodes and
                # counts
                # copies: the counters are reset in place for the next run
                a2a=[list(a2a["a2a_expert_ffn"]),
                     list(a2a["grad_a2a_expert_ffn"])],
                a2a_derived=[[nodes(op), nodes(op, attr)]
                             for op, attr in (("a2a_ffn", "matmul_calls"),
                                              ("bwd_a2a_ffn",
                                               "vjp_matmul_calls"))],
                a2a_groups=sorted(a2a_groups),
                setup_s=setup_s, derive_s=time.monotonic() - t_derive,
                routing=routes[:cfg.num_layers],
                cross_direction_pairs=derived["cross_direction_pairs"],
                call_shapes=sorted([*k, v] for k, v in calls.items()),
                norm_shapes=sorted([*k, v] for k, v in norm_calls.items()),
                flash_shapes=sorted([*k, v] for k, v in flash_calls.items()),
                plans=plans,
                comm=None if census is None else census.per_layer(
                    cfg.num_layers),
                wire=group.backend + (", staged through the host"
                                      if group.staged(metrics["grad_norm"])
                                      else ""))
            if dtype == "float32":
                if _on_card(device):
                    torch.cuda.empty_cache()
                t_errs = time.monotonic()
                errs, at_sign = train_errors(lm, state, store, ref, cfg,
                                             init)
                row.update(errs=errs, params_at_sign_bound=at_sign,
                           errs_s=time.monotonic() - t_errs)
            row.update(startup_s=startup_s, reached=reached,
                       run_s=time.monotonic() - t_run)
            out.append(row)
            del state, opt, step, metrics, rec, trained, period, bwd
            for p in lm.parameters():
                p.grad = None
            if _on_card(device):
                torch.cuda.empty_cache()
        comp = compress_check(lm, batch) if compress else None
        legs_out.append(dict(runs=out, compress=comp))
    return legs_out


class CommCensus:
    """The collectives DTensor issues in one ``auto`` training step, by
    direction: entered around the step, it counts them all
    (``CommDebugMode``), and those of the forward in a second mode entered
    around ``lm.loss`` while it is active; the backward's are the rest (a
    remat recompute's among them). The modes see every op of the step on
    the host, which adds host time to the step's."""

    def __init__(self, lm):
        from torch.distributed.tensor.debug import CommDebugMode

        self.lm, self.all, self.fwd = lm, CommDebugMode(), CommDebugMode()

    def __enter__(self):
        inner = self.lm.loss

        def loss(batch):
            with self.fwd:
                return inner(batch)

        self.lm.loss = loss
        self.all.__enter__()
        return self

    def __exit__(self, *exc):
        self.all.__exit__(*exc)
        del self.lm.loss

    def per_layer(self, layers: int) -> dict:
        """{"forward": {op: count a layer}, "backward": ...} of DTensor's
        functional collectives, and "outside": the step's other
        collectives in all (the TP group's own: the loss's all-reduce of
        (sum, count), ``sync_grads``', the grad norm's)."""
        count = lambda m: {str(k).split(".")[-1]: v  # noqa: E731
                           for k, v in m.get_comm_counts().items()}
        fwd, tot = count(self.fwd), count(self.all)
        bwd = {k: v - fwd.get(k, 0) for k, v in tot.items()
               if v - fwd.get(k, 0)}
        per = lambda d: {k: v / layers for k, v in sorted(d.items())  # noqa
                         if not k.endswith("_")}
        return dict(forward=per(fwd), backward=per(bwd),
                    outside={k: v for k, v in sorted(tot.items())
                             if k.endswith("_")})


def plan_checks(per: list) -> dict:
    """A perfsim run's checks on what every rank returned: one plan on every
    rank (gathered over the ring, and as returned), the optimized graphs
    pairing what the plans say, and the graphs executed doing so."""
    key = lambda p: json.dumps({k: p["plans"][k] for k in (  # noqa: E731
        "mb", "forward", "backward", "chunks")})
    return {
        "plans equal on every rank": all(
            p["plans"]["same_on_every_rank"] for p in per)
        and len({key(p) for p in per}) == 1,
        "the optimized graphs pair what the plans say": all(
            p["plans"]["graphs_pair_the_plan"] for p in per),
        "executed overlap_asym = the plans' pairs": all(
            p["plans"]["executed_is_the_plan"] for p in per),
    }


@contextlib.contextmanager
def plan_cache_at(root):
    """Point the plan cache of the ranks spawned inside the block at
    ``root`` (they share it, and read ``REPRO_TORCH_PLAN_CACHE`` when they
    first plan): a fresh directory a phase, so its first lookups miss."""
    var = "REPRO_TORCH_PLAN_CACHE"
    saved = os.environ.get(var)
    os.environ[var] = str(root)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = saved


def phase_train(cfg=None, batch=None, runs=None, label: str = "phase 9",
                quantities=RefStore.QUANTITIES, mesh: str = "flat",
                compress: bool = False, legs=None) -> dict:
    """One training step on TP_WORLD gloo ranks against one device (phase
    9: internlm2-1.8b, TRAIN_RUNS; phase 11 (b): mixtral-8x7b cut to
    MOE_LAYERS layers, MOE_RUNS; phase 13: minicpm3-4b and internlm2-1.8b
    cut to 2 layers). ``legs`` (a list of (batch, runs)) steps one model
    on several batches in one spawn, each leg held to its own one-device
    step; otherwise the one leg (``batch``, ``runs``). An MoE run is held
    to one device under the routing rule: its routing against the
    one-device forward's (a rank's shard is one group of one device);
    element-wise holds (grad norm, grads, m, v, parameters) and the f32
    loss tolerance only where every rank's routing agreed, and where it
    did not the differences must sit at gaps below ROUTE_TOL and the loss
    within BF16_LOSS_RTOL. Its expert all-to-all and adjoint must have run
    through the backend as often as the graphs hold them, with the matmul
    kernel inside, on tp_out alone on a 2D mesh (grouped EP). In the
    replicated layout (a ragged S) every rank routes one device's whole
    batch, and each MoE layer is an ``expert_ar`` node in the forward and
    in its recompute, with no all-to-all. The ranks
    build the model on ``mesh`` (phase 12: "dp2", "2x2"); a run may name
    another mesh of the same shards (phase 9's "2x2" runs). With
    ``compress``, each replica's grads are summed over the data axis in int8
    (:func:`compress_check`) within COMPRESS_RTOL of the exact sum."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.ranks import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg or get_tp_cfg()
    if legs is None:
        legs = [(batch if batch is not None else train_batch(),
                 runs or TRAIN_RUNS)]
    refs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ref_") as root:
        free = shutil.disk_usage(root).free
        need = 4 * len(quantities) * cfg.param_count() * len(legs)
        if free < need + 2**30:
            raise AssertionError(f"{label} keeps the one-device reference "
                                 f"on the host: {need / 1e9:.1f} GB under "
                                 f"{root}, which has {free / 1e9:.1f} GB")
        for i, (leg_batch, _) in enumerate(legs):
            leg_root = Path(root) / f"leg{i}"
            leg_root.mkdir()
            t_ref = time.monotonic()
            ref, store = train_reference(leg_batch, str(leg_root), cfg,
                                         quantities=quantities)
            refs.append((ref, store))
            B, S = leg_batch["tokens"].shape
            log(f"  one device f32 (remat, per-block path), batch {B} x {S}"
                f": loss {ref['loss']:.7f}, grad norm "
                f"{ref['grad_norm']:.7f}, step {ref['step_s']:.2f}s, peak "
                f"{ref['peak_gib']} GiB; bf16 loss (forward) "
                f"{ref['loss_bf16']:.7f}; reference kept on the host: "
                f"{ref['store_gb']:.1f} GB in {ref['write_s']:.1f}s; "
                f"{time.monotonic() - t_ref:.1f}s in all")
            gc.collect()
            torch.cuda.empty_cache()
        free_b, total_b = torch.cuda.mem_get_info()
        log(f"  before the ranks: this process holds "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, the card "
            f"has {free_b / 2**30:.2f} of {total_b / 2**30:.2f} GiB free")
        t0 = time.monotonic()
        with plan_cache_at(Path(root) / "plans"):
            got = run_ranks(train_legs, TP_WORLD, [
                (leg_batch, leg_runs, store,
                 {k: v for k, v in ref.items() if k != "routing"})
                for (leg_batch, leg_runs), (ref, store) in zip(legs, refs)],
                cfg, "cuda", mesh, compress, time.time(), device="cuda",
                timeout=1200)
        wall = time.monotonic() - t0
    rows, failed, comp = [], [], None
    for i, ((leg_batch, leg_runs), (ref, _)) in enumerate(zip(legs, refs)):
        ranks = [g[i]["runs"] for g in got]
        B, S = leg_batch["tokens"].shape
        r, f = train_checks(cfg, ref, ranks, leg_runs, B * S // TP_WORLD)
        rows += r
        failed += f
    if compress:
        comp = [g[0]["compress"] for g in got]
        worst = max(c["worst_rel"] for c in comp)
        log(f"  compressed_psum of each replica's grads over the data axis "
            f"(int8, one scale a tensor agreed by max): worst max|d| / "
            f"max|exact| {worst:.3e} ({comp[0]['worst_param']}), "
            f"{comp[0]['f32_bytes'] / 1e9:.3f} GB f32 -> "
            f"{comp[0]['int8_bytes'] / 1e9:.3f} GB int8 a rank, "
            f"{max(c['seconds'] for c in comp):.1f}s")
        if not worst <= COMPRESS_RTOL:
            failed.append(("compress", f"within {COMPRESS_RTOL}"))
    if failed:
        raise AssertionError(f"{label}: failed {failed}")
    per = [p for g in got for leg in g for p in leg["runs"]]
    total = {k: sum(p[k] for p in per)
             for k in ("matmul_launches", "flash_launches", "mln_launches")}
    shapes = {tuple(c[:5]) for p in per for c in p["call_shapes"]}
    norms = {tuple(c[:5]) for p in per for c in p["norm_shapes"]}
    cores = {tuple(c[:8]) for p in per for c in p["flash_shapes"]}
    log(f"  {TP_WORLD} ranks, {sum(len(r_) for _, r_ in legs)} steps in "
        f"{wall:.1f}s (spawn and weights included; gloo stages every hop "
        "through the host, so these are not TP speeds); launches over all "
        f"ranks and runs: matmul {total['matmul_launches']}, flash "
        f"{total['flash_launches']}, matmul_rmsnorm {total['mln_launches']}")
    strip = ("maxabs", "routing")
    return dict(runs=rows,
                reference={k: v for k, v in refs[0][0].items()
                           if k not in strip},
                references=[{k: v for k, v in ref.items() if k not in strip}
                            for ref, _ in refs],
                matmul_launches=total["matmul_launches"],
                flash_launches=total["flash_launches"],
                mln_launches=total["mln_launches"], wall_s=wall,
                call_shapes=sorted(shapes), norm_shapes=sorted(norms),
                flash_shapes=sorted(cores), compress=comp)


def train_checks(cfg, ref, ranks, runs, T: int) -> tuple:
    """Each run's checks of :func:`phase_train` on what the ranks returned,
    logged: (rows, failed (run, check) pairs). ``T`` is a rank's tokens (an
    MoE rank's routing group)."""
    moe = cfg.moe is not None
    kinds = cfg.layer_kinds()
    # a model whose every sub-layer runs replicated (mamba2-130m: SSM mixers
    # and no FFN) runs no period graph, and one with no attention no flash
    graphs = cfg.d_ff > 0 or moe or any(
        k in ("attn", "swa") and cfg.num_heads % TP_WORLD == 0
        for k in kinds)
    attends = any(k in ("attn", "swa", "mla") for k in kinds)
    rows, failed = [], []
    for i, run in enumerate(runs):
        per = [rk[i] for rk in ranks]
        head = per[0]
        f32 = head["dtype"] == "float32"
        route = None
        replicated = head["layout"] == "replicated"
        if moe and replicated:    # every rank routes one device's batch
            route = [routing_differences(p["routing"], ref["routing"])
                     for p in per]
        elif moe:     # rank r routes one device's group r
            route = [routing_differences(p["routing"], [
                (w[r * T:(r + 1) * T], top[r * T:(r + 1) * T])
                for w, top in ref["routing"]]) for r, p in enumerate(per)]
        agreed = route is None or all(
            d["choice"] == 0 and d["slots"] == 0 for d in route)
        held = f32 and agreed
        # the auto TP mode runs no graph: no matmul launch, no overlap
        auto = head["mode"] == "auto"
        ref_loss = ref["loss"] if f32 else ref["loss_bf16"]
        rtol = F32_LOSS_RTOL if held else BF16_LOSS_RTOL
        rel = abs(head["loss"] - ref_loss) / abs(ref_loss)
        gn_rel = abs(head["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        checks = {
            "ranks agree": len({p["loss"] for p in per}) == 1
            and len({p["grad_norm"] for p in per}) == 1,
            f"loss within {rtol:g} of one device": rel <= rtol,
            "matmul launches = graphs": all(
                p["matmul_launches"] == p["matmul_derived"]
                and (p["matmul_derived"] > 0) == (graphs and not auto)
                for p in per),
            "flash launches = forward + recompute": all(
                p["flash_launches"] == p["flash_derived"]
                and (p["flash_derived"] > 0) == attends for p in per),
            "every flash call causal with the model's prefix": all(
                c[8:10] == [True, cfg.num_prefix_tokens]
                for p in per for c in p["flash_shapes"]),
            "matmul_rmsnorm launches = 2 a replicated MLA mixer": all(
                p["mln_launches"] == p["mln_derived"] for p in per),
            "flash variants": all(p["flash_variants"] == dict(
                splitkv=0, wgmma=p["flash_launches"] if not f32 else 0,
                ffma=p["flash_launches"] if f32 else 0) for p in per),
            "matmul variants": all(p["matmul_variants"] == (
                dict(wgmma=0, ffma=p["matmul_launches"]) if f32 else
                dict(wgmma=p["matmul_launches"], ffma=0)) for p in per),
            "transposed layouts launched": all(
                (p["matmul_layouts"][f"{v}.{lay}"] > 0) == (graphs
                                                            and not auto)
                for p in per for lay in ("nt", "tn")
                for v in (("ffma",) if f32 else ("wgmma",))),
            "overlap_asym executed as the graphs say": all(
                p["overlap_asym"] == p["overlap_asym_nodes"] for p in per),
            "a backward node paired with a forward one": (
                all(p["cross_direction_pairs"] for p in per)
                if head["mb"] > 1 and head["planner"] == "greedy"
                and graphs else True),
        }
        if auto:
            # Megatron-SP's census, as JAX's constraint on a block's output
            # implies: per layer one all-gather of the normed input and one
            # reduce-scatter of the output a sub-layer
            sharded = head["layout"] == "sharded"
            want = {"all_gather_into_tensor": 2.0,
                    "reduce_scatter_tensor": 2.0} if sharded else \
                {"all_reduce": 2.0}
            checks["DTensor's forward: one gather in, one reduce out a "
                   "sub-layer"] = all(p["comm"]["forward"] == want
                                      for p in per)
        if moe and replicated:
            checks["expert_ar a layer in the forward and its recompute, "
                   "no expert all-to-all"] = all(
                p["expert_ar"] == 2 * cfg.num_layers
                and p["a2a"] == [[0, 0], [0, 0]] for p in per)
            if f32:
                checks[f"routing differences at gaps < {ROUTE_TOL:g}"] = \
                    all(routing_rule(d) for d in route)
        elif moe:
            checks["a2a_ffn / bwd_a2a_ffn through the backend, expert "
                   "GEMMs on the matmul kernel"] = all(
                p["a2a"] == p["a2a_derived"] and min(min(p["a2a"])) > 0
                for p in per)
            ring = "tp_out" if head["mesh"] == "2x2" else "tp"
            checks[f"every concrete a2a_ffn / bwd_a2a_ffn on {ring}"] = all(
                p["a2a_groups"] == [f"a2a_expert_ffn:{ring}",
                                    f"grad_a2a_expert_ffn:{ring}"]
                for p in per)
            if f32:
                checks[f"routing differences at gaps < {ROUTE_TOL:g}"] = \
                    all(routing_rule(d) for d in route)
        if head["layout"] == "replicated":
            checks["gemm_ar dispatched through the backend as the graphs "
                   "hold it"] = all(
                p["gemm_ar"] == p["gemm_ar_derived"] > 0 for p in per)
        if head["plans"] is not None:
            checks.update(plan_checks(per))
        if held:
            checks[f"grad norm within {TRAIN_RTOL:g}"] = gn_rel <= TRAIN_RTOL
            for q in ("grad", "m", "v"):
                checks[f"every {q} within {TRAIN_RTOL:g} max|ref|"] = all(
                    e[q][0] <= e[q][1] for p in per
                    for e in p["errs"].values())
            checks["params within the first-step bound"] = all(
                e["param"][1] <= 1.0 for p in per
                for e in p["errs"].values())
        worst = {}
        if f32:
            for q in ("grad", "m", "v"):
                worst[q] = max(e[q][0] / e[q][1] for p in per
                               for e in p["errs"].values())
            worst["param_err_over_limit"] = max(
                e["param"][1] for p in per for e in p["errs"].values())
        row = dict({k: v for k, v in head.items()
                    if k not in ("errs", "call_shapes", "norm_shapes",
                                 "flash_shapes", "routing")},
                   rel_to_one_device=rel, grad_norm_rel=gn_rel,
                   one_device=ref_loss, worst_over_bound=worst,
                   elementwise_held=held, routing_differences=route,
                   params_at_sign_bound=[p.get("params_at_sign_bound")
                                         for p in per],
                   wall_s=[p["wall_s"] for p in per],
                   peak_gib=[p["peak_gib"] for p in per], checks=checks)
        rows.append(row)
        log(f"  {run[0]:>7} mb={head['mb']} (asked {run[1]}) {run[2]:>8} "
            f"{head['planner']} mesh {head['mesh']} (topology "
            f"{head['topology']}, dp {head['dp']}), batch {head['batch']}, "
            f"layout {head['layout']}: loss "
            f"{head['loss']:.7f} (one device {ref_loss:.7f}, rel "
            f"{rel:.2e}), grad norm {head['grad_norm']:.7f} (rel "
            f"{gn_rel:.2e}); worst err/bound {json.dumps(worst)}; "
            f"elements at the sign bound {row['params_at_sign_bound']}; per "
            f"rank: matmul {head['matmul_launches']} (graphs "
            f"{head['matmul_derived']}; {json.dumps(head['matmul_layouts'])})"
            f", flash {head['flash_launches']} (graphs "
            f"{head['flash_derived']}), matmul_rmsnorm "
            f"{head['mln_launches']} (graphs {head['mln_derived']}), gemm_ar "
            f"{head['gemm_ar']} (graphs {head['gemm_ar_derived']}), "
            f"overlap_asym {head['overlap_asym']} "
            f"({len(head['cross_direction_pairs'])} cross-direction nodes a "
            f"period); step {max(row['wall_s']):.2f}s (rank 0: started "
            f"{head['startup_s'] or 0.0:.1f}s after the spawn: this module "
            f"at {(head['reached'] or (0.0, 0.0))[0]:.1f}s, torch imported "
            f"in {(head['reached'] or (0.0, 0.0))[1]:.1f}s; the model and "
            f"its shards {head['setup_s']:.1f}s before the first run, launch "
            f"counts derived in {head['derive_s']:.1f}s, held to one device "
            f"in {head.get('errs_s', 0.0):.1f}s, the run {head['run_s']:.1f}s "
            f"in all); peak "
            f"{row['peak_gib']} GiB by rank; wire: {head['wire']}")
        if moe:
            log(f"    routing against one device (choice / slot-only "
                f"differences, worst gap by rank): "
                + json.dumps([[d["choice"], d["slots"], d["worst_gap"]]
                              for d in route])
                + f"; element-wise holds {'made' if held else 'not made'}; "
                + (f"expert_ar nodes {head['expert_ar']} (the whole batch "
                   "routed on every rank, each rank's experts summed by "
                   "the node's all-reduce)" if replicated else
                   f"a2a_ffn, bwd_a2a_ffn [dispatches, matmul launches "
                   f"inside] {json.dumps(head['a2a'])} (graphs "
                   f"{json.dumps(head['a2a_derived'])}) on "
                   f"{json.dumps(head['a2a_groups'])}"))
        if head["plans"] is not None:
            log(f"    perfsim plans (rank 0): {json.dumps(head['plans'])}")
        if auto:
            log(f"    DTensor's collectives a layer (rank 0; the backward "
                f"with the remat recompute's): {json.dumps(head['comm'])}")
        failed += [(run, k) for k, v in checks.items() if not v]
    barrier = [r for r in rows if r["mode"] == "barrier"]
    for r in rows:
        if r["mode"] == "auto" and barrier:
            log(f"  step time auto {r['dtype']} {max(r['wall_s']):.2f}s "
                f"(with the census's dispatch modes on), barrier mb "
                f"{barrier[0]['mb']} {barrier[0]['dtype']} "
                f"{max(barrier[0]['wall_s']):.2f}s: slowest rank, staged "
                "through the host, so not TP speed")
    return rows, failed


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


def serve_matmul_shapes(cfg, tr: dict, world: int = TP_WORLD,
                        ring: Optional[int] = None) -> list:
    """(M, K, N) of every matmul call a rank makes in phase 10, by the serve
    graph's own arithmetic: the gemm_col GEMMs (q, k, v, up, gate) over the
    B·S rows of a step (S 1, chunk − 1, chunk); each gemm_ar's one GEMM over
    those rows (barrier, and cais where S does not split over the ring) or
    the cais ring's partial GEMMs of B·(S/r)/2 rows (S = chunk, the
    bidirectional halves; r the ring, tp_in on a 2D mesh's hierarchical
    gemm_ar)."""
    n, d, dh = world, cfg.d_model, cfg.resolved_head_dim
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    ff = cfg.d_ff // n
    B, C = tr["requests"], tr["chunk"]
    rows = {B * s for s in (1, C - 1, C)}
    ring = {B * (C // (ring or n)) // 2}
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
    """One rank of phase 10. For each (mode, dtype[, planner[, mesh]]) run on
    ``cfg`` (internlm2-1.8b; a "2x2" run on the 2D mesh of the same ranks
    and shards, data axis 1): the scripted steps' logits (kept on rank 0;
    digests on every rank) and the ring Engine's tokens, with the kernels'
    launches (set to 0 just before the run) against the counts derived from
    the optimized serve graphs, the gemm_ar dispatches, every call shape,
    times and peak memory; a perfsim run also its plans' pairings, the
    overlap_asym nodes executed, and the planner's host time by what
    answered each call, and per serve step. Then ``rcfg`` (gemma3-1b cut to
    REPL_LAYERS layers), cais f32, scripted steps only."""
    from repro_torch import plan as plan_mod
    from repro_torch.core import dataflow
    from repro_torch.core import tp as tp_mod
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime, TPConfig
    from repro_torch.sharding import init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {"flat": group}
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
    probe = plan_probe()

    def one_run(lm, cfg, mode, dtype, script_steps, with_engine,
                planner="greedy", mesh="flat"):
        if mesh not in meshes:
            meshes[mesh] = init_mesh(group, **MESHES[mesh])
        _mesh_switch(lm, cfg, meshes[mesh])
        rt = Runtime(compute_dtype=dtype, tp=TPConfig(mode=mode,
                                                      planner=planner))
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
        probe_reset(probe)
        t0 = time.monotonic()
        logits, digests = run_scripted(lm, script_steps, tr["block"],
                                       keep=group.rank == 0)
        _sync(device)
        script_s = time.monotonic() - t0
        plans = None
        if planner == "perfsim":
            cache = plan_mod.default_cache()
            plans = dict(
                pairings=sorted({json.dumps(p.pairing)
                                 for p in probe["plans"]}),
                executed=dict(probe["executed"]),
                host_s=probe_times(probe),
                host_s_per_step=sum(sum(v) for v in probe["times"].values())
                / len(script_steps),
                cache=dict(cache.stats, memo_hits=cache.memo_hits))
        tokens, engine_steps = (engine_tokens(lm, cfg, prompts, tr)
                                if with_engine else (None, 0))
        _sync(device)
        wall = time.monotonic() - t0
        peak = _peak_gib(device)
        launches = (mmk.launches, fa.launches, ar[0])
        del lm.serve_step
        tpc = tp_mod.TPContext.from_config(rt.tp, lm.group)
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
            mode=mode, dtype=dtype, planner=planner, plans=plans, mesh=mesh,
            topology=list(tpc.topology),
            logits=logits, digests=digests,
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
    out = [one_run(lm, cfg, run[0], run[1], steps, True, *run[2:])
           for run in runs]
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
    greedy = {(run[0], run[1]): per for run, per, _ in cases
              if run[2:] in ((), ("greedy",))}
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
        if head.get("plans") is not None:
            # the replicated layout has no gemm_rs/ag_gemm pair to plan
            same = greedy[(head["mode"], head["dtype"])]
            checks.update({
                "logits bitwise equal to the greedy run's": all(
                    p["digests"] == g["digests"] for p, g in zip(per, same)),
                "tokens equal to the greedy run's": all(
                    p["tokens"] == g["tokens"] for p, g in zip(per, same)),
                "plans pair nothing, and nothing paired ran": all(
                    p["plans"]["pairings"] == ["[]"]
                    and not p["plans"]["executed"] for p in per),
            })
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
    import tempfile

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plans_") as root, \
            plan_cache_at(root):
        ranks = run_ranks(serve_tp_rank, TP_WORLD, tr, SERVE_TP_RUNS,
                          prompts, steps, repl_steps, cfg, rcfg,
                          device="cuda", timeout=900)
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
        log(f"  {arch} {row['mode']} {row['dtype']} {row['planner']} mesh "
            f"{row['mesh']} (topology {row['topology']}): "
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
        if row.get("plans") is not None:
            log(f"    {row['planner']} plans (rank 0): "
                + json.dumps(row["plans"]))
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


# ---------------------------------------------------------------------------
# phase 11: MoE (mixtral-8x7b at full width, MOE_LAYERS layers)
# ---------------------------------------------------------------------------


def moe_scripted_steps(cfg, tr: dict) -> list:
    """Phase 11 (a)'s scripted ``serve_step`` schedule over ``tr["requests"]``
    rows, the block tables of :func:`scripted_steps` (the engine's Skv): one
    prefill chunk of ``tr["chunk"]`` tokens for every row, then
    MOE_DECODE_STEPS decode steps; tokens from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 12)
    B, C, W = tr["requests"], tr["chunk"], serve_width(tr)
    bt = np.arange(B * W, dtype=np.int32).reshape(B, W)
    tok = lambda *s: rng.integers(1, cfg.vocab_size, s).astype(np.int32)
    pos = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    steps = [(tok(B, C), (bt, pos, np.full(B, C, np.int32),
                          np.full(B, C - 1, np.int32)))]
    for t in range(MOE_DECODE_STEPS):
        p = C + t
        steps.append((tok(B, 1), (bt, np.full((B, 1), p, np.int32),
                                  np.full(B, p + 1, np.int32),
                                  np.zeros(B, np.int32))))
    return steps


def phase_moe_serve(cfg, fa) -> tuple:
    """Phase 11 (a): ``cfg`` (mixtral-8x7b cut to MOE_LAYERS layers) served on
    one device through ``repro_torch.launch.serve`` (bf16 compute, f32
    params, phase 5's traffic), flash attention once a layer a step (decode
    on split-KV, prefill chunks on wgmma); then the scripted f32 schedule
    (:func:`moe_scripted_steps`) on the card (the kernels) and on the CPU
    (the plain versions): routing compared first, logits within LOGIT_TOL
    for the steps before the first routing difference. Returns (the
    report, phase 17 (a)'s reference: the card's scripted logits, routing
    records and steps, the engine's prompts, tokens and latency report)."""
    import gc

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime

    gc.collect()
    torch.cuda.empty_cache()
    calls = {}
    core = record_calls(ops, calls)
    routes, restore = routing_probe()
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0                            # count the main path only
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        t0 = time.monotonic()
        eng, reqs = serve.main([
            "--arch", MOE_ARCH, "--layers", str(MOE_LAYERS), "--device",
            "cuda", "--requests", str(REQUESTS), "--prompt-len",
            str(PROMPT_MAX), "--prompt-len-min", str(PROMPT_MIN),
            "--max-new", str(MAX_NEW), "--prefill-chunk", str(PREFILL_CHUNK),
            "--block-size", str(BLOCK_SIZE), "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches, variants = fa.launches, dict(fa.launches_by_variant)
        peak = torch.cuda.max_memory_allocated() / 2**30
        report = dict(eng.last_report, steps=eng.steps)
        engine_calls = dict(calls)
        # the scripted f32 schedule: on the card, then on the CPU
        lm = eng.model
        lm.rt = Runtime(compute_dtype="float32")
        steps = moe_scripted_steps(cfg, serve_traffic())
        routes.clear()
        fa.launches = 0
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        t0 = time.monotonic()
        card, _ = run_scripted(lm, steps, BLOCK_SIZE)
        card_s = time.monotonic() - t0
        script = (fa.launches, dict(fa.launches_by_variant))
        card_routes = list(routes)
        routes.clear()
        cpu = LM(cfg, Runtime(compute_dtype="float32"), device="cpu",
                 seed=None)
        cpu.load_state_dict(lm.state_dict())
        del eng, lm
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        want, _ = run_scripted(cpu, steps, BLOCK_SIZE)
        cpu_s = time.monotonic() - t0
        cpu_routes = list(routes)
        del cpu
    finally:
        ops.flash_attention = core
        restore()
    L = cfg.num_layers
    G = cfg.num_heads // cfg.num_kv_heads
    decode = sum(n for key, n in engine_calls.items()
                 if key[1] * G <= fa.SPLIT_MAX_ROWS)
    diff = routing_differences(card_routes, cpu_routes)
    held = len(steps) if diff["first"] is None else diff["first"] // L
    errs = [float(np.abs(c - w).max()) for c, w in zip(card, want)]
    over = [float((np.abs(c - w) / (LOGIT_TOL["atol"] + LOGIT_TOL["rtol"]
                                    * np.abs(w))).max())
            for c, w in zip(card, want)]
    checks = {
        "every request finished": all(
            r.done and len(r.out_tokens) == MAX_NEW for r in reqs),
        "tokens inside the vocabulary": all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
        "engine: flash once a layer a step": launches == report["steps"] * L
        > 0,
        "engine: decode on split-KV, prefill on wgmma": variants == dict(
            splitkv=decode, wgmma=launches - decode, ffma=0)
        and 0 < decode < launches,
        "scripted f32: flash once a layer a step, decode on split-KV, "
        "prefill on ffma": script == (len(steps) * L, dict(
            splitkv=MOE_DECODE_STEPS * L, wgmma=0, ffma=L)),
        "routing: one record a layer a step on both":
            len(card_routes) == len(cpu_routes) == len(steps) * L,
        f"routing differences at gaps < {ROUTE_TOL:g}": routing_rule(diff),
        "finite logits": all(np.isfinite(c).all() for c in card),
        "logits within LOGIT_TOL where the routing agreed": held > 0 and all(
            o <= 1.0 for o in over[:held]),
    }
    log(f"  engine: {len(reqs)} requests in {report['steps']} steps, "
        f"{wall:.2f}s; TTFT p50 {report['ttft_p50_ms']:.1f} ms, per-token "
        f"p50 {report['per_token_p50_ms']:.1f} ms; flash {launches} = "
        f"{report['steps']} x {L} {json.dumps(variants)}; peak {peak:.2f} "
        "GiB")
    log(f"  scripted f32 ({len(steps)} steps: a prefill chunk of "
        f"{PREFILL_CHUNK} for {REQUESTS} rows, {MOE_DECODE_STEPS} decode "
        f"steps): card {card_s:.2f}s, CPU {cpu_s:.2f}s; routing (choice / "
        f"slot-only differences, worst gap): {diff['choice']} / "
        f"{diff['slots']} / {diff['worst_gap']}; logits held for {held} of "
        f"{len(steps)} steps, max |d| by step {json.dumps(errs)}, err / "
        f"LOGIT_TOL {json.dumps(over)}; flash {script[0]} "
        f"{json.dumps(script[1])}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 11 (a): failed {failed}")
    ref = dict(logits=card, routes=card_routes, steps=steps,
               prompts=[r.prompt for r in reqs],
               tokens=[list(r.out_tokens) for r in reqs], report=report)
    return dict(report=report, launches=launches + script[0],
                flash_variants=variants, peak_gib=peak, wall_s=wall,
                routing=diff, logits_held_steps=held, logits_max_abs=errs,
                logits_err_over_tol=over, card_s=card_s, cpu_s=cpu_s,
                call_shapes=sorted([*k, v] for k, v in calls.items())), ref


def phase_moe(fa) -> tuple:
    """Phase 11: (a) :func:`phase_moe_serve`; (b) one training step of the
    same model on TP_WORLD gloo ranks sharing the card against one device
    (:func:`phase_train` with MOE_RUNS), batch MOE_BATCH of MOE_SEQ tokens
    from ``make_batch``, and in the same spawn one at the ragged batch
    MOE_RAGGED_BATCH x MOE_RAGGED_SEQ (MOE_RAGGED_RUNS), each held to its
    own one-device step. Returns (the report, (a)'s reference for phase
    17)."""
    cfg = get_moe_cfg()
    log(f"  {MOE_ARCH} cut to {cfg.num_layers} of 32 layers at full width "
        f"(d {cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads "
        f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, capacity "
        f"factor {cfg.moe.capacity_factor}, group {cfg.moe.group_size}, "
        f"window {cfg.window}): {cfg.param_count() / 1e9:.3f} B parameters")
    log("  (a) one device, the paged Engine")
    serve, ref = phase_moe_serve(cfg, fa)
    log(f"  (b) one training step, {TP_WORLD} gloo ranks (E_loc "
        f"{cfg.moe.num_experts // TP_WORLD}) against one device, batch "
        f"{MOE_BATCH} x {MOE_SEQ}; then, in the same spawn, batch "
        f"{MOE_RAGGED_BATCH} x {MOE_RAGGED_SEQ} (the replicated layout)")
    train = phase_train(cfg, label="phase 11 (b)", quantities=("grad",),
                        legs=[(train_batch(cfg, MOE_SEQ, MOE_BATCH),
                               MOE_RUNS),
                              (train_batch(cfg, MOE_RAGGED_SEQ,
                                           MOE_RAGGED_BATCH),
                               MOE_RAGGED_RUNS)])
    return dict(serve=serve, train=train), ref


# ---------------------------------------------------------------------------
# phase 12: data parallelism and the 2D mesh
# ---------------------------------------------------------------------------


def phase_debug_mesh() -> dict:
    """Phase 12 (c): ``python -m repro_torch.launch.train --arch DEBUG_ARCH
    --smoke --mesh debug`` (8 ranks on the card, data 2 x model 4), barrier,
    cais and with no ``--tp-mode`` (the default ``auto``: DTensor on each
    replica's TP group, its functional collectives staged through the
    host), against ``--mesh none`` (one device, where the TP mode does not
    enter): rank 0's losses, written unrounded by ``--history``, within
    1e-5 of one device's at every step. The four runs go at once (each
    rendezvous in its own directory); their seconds overlap."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    out, failed = {}, []

    def start(mesh: str, mode: Optional[str], root: str) -> tuple:
        path = Path(root) / f"{mode or 'default'}.{mesh}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               DEBUG_ARCH, "--smoke", "--mesh", mesh, "--steps",
               str(DEBUG_STEPS), "--device", "cuda", "--history", str(path)]
        if mode is not None:
            cmd += ["--tp-mode", mode]
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        return cmd, path, proc, time.monotonic()

    def finish(run) -> tuple:
        cmd, path, proc, t0 = run
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        secs = time.monotonic() - t0
        if proc.returncode:
            raise AssertionError(f"phase 12 (c): {' '.join(cmd[2:])} exited "
                                 f"{proc.returncode}:\n{stderr[-3000:]}")
        lines = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
        return [h["loss"] for h in json.loads(path.read_text())], lines, secs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_debug_") as root:
        modes = ("barrier", "cais", None)
        runs = [start("none", "cais", root)] + [
            start("debug", mode, root) for mode in modes]
        try:
            done = [finish(r) for r in runs]
        finally:
            for r in runs:
                if r[2].poll() is None:
                    r[2].kill()
                    r[2].communicate()
        (one, one_lines, one_s), debug = done[0], done[1:]
        log(f"  --mesh none: {json.dumps(one)} ({one_s:.1f}s)")
        for mode, (got, lines, secs) in zip(modes, debug):
            mode = mode or "default (auto)"
            rel = [abs(a - b) / abs(b) for a, b in zip(got, one)]
            checks = {
                f"{DEBUG_STEPS} step lines, rank 0's alone": len(lines)
                == len(one_lines) == DEBUG_STEPS,
                "finite losses": all(x == x and abs(x) < 1e9
                                     for x in got + one),
                "--mesh debug's losses within 1e-5 of --mesh none's":
                    len(rel) == DEBUG_STEPS and max(rel) <= 1e-5,
            }
            log(f"  {mode}: --mesh debug {json.dumps(got)} ({secs:.1f}s, 8 "
                f"ranks); rel {json.dumps(rel)}; rank 0's lines: {lines}")
            out[mode] = dict(debug=got, rel=rel, seconds=secs,
                             checks=checks)
            failed += [(mode, k) for k, v in checks.items() if not v]
    out["none"] = dict(losses=one, seconds=one_s)
    if failed:
        raise AssertionError(f"phase 12 (c): failed {failed}")
    return out


def phase_topology() -> dict:
    """Phase 12: (a) one training step on a data 2 x model 2 mesh (DP_RUNS)
    against one device, then the int8 compressed sum of each replica's
    grads; (b) grouped EP, one training step on the 2D mesh (GEP_RUNS)
    against one device, routing compared first; (c) the launcher's
    ``--mesh debug``."""
    cfg = get_dp_cfg()
    log(f"  (a) {TP_ARCH} cut to {DP_LAYERS} of 24 layers at full width "
        f"({cfg.param_count() / 1e9:.3f} B parameters), data 2 x model 2, "
        f"global batch {DP_BATCH} x {TP_SEQ} (a replica's {DP_BATCH // 2} "
        "rows)")
    dp = phase_train(cfg, train_batch(cfg, TP_SEQ, DP_BATCH), DP_RUNS,
                     "phase 12 (a)", mesh="dp2", compress=True)
    gcfg = get_gep_cfg()
    log(f"  (b) grouped EP: {MOE_ARCH} cut to {GEP_LAYERS} layer at full "
        f"width ({gcfg.param_count() / 1e9:.3f} B parameters) on tp_in 2 x "
        f"tp_out 2, {gcfg.moe.num_experts // 2} whole experts a rank, batch "
        f"{MOE_BATCH} x {MOE_SEQ}")
    gep = phase_train(gcfg, train_batch(gcfg, MOE_SEQ, MOE_BATCH), GEP_RUNS,
                      "phase 12 (b)", quantities=("grad",), mesh="2x2")
    log(f"  (c) python -m repro_torch.launch.train --arch {DEBUG_ARCH} "
        f"--smoke --mesh debug against --mesh none, {DEBUG_STEPS} steps")
    debug = phase_debug_mesh()
    return dict(dp=dp, grouped_ep=gep, debug_mesh=debug)


# ---------------------------------------------------------------------------
# phase 13: TP training past whole blocks (per-sub-layer graphs, ragged S,
# sequence_parallel=False)
# ---------------------------------------------------------------------------


def mla_norm_grads(cfg, batch, device="cuda") -> dict:
    """Phase 13 (a)'s first check, on one device: every MLA layer's grads
    of q_norm, kv_norm, wq_a and wkv_a from ``LM.loss``'s backward with
    matmul_rmsnorm's kernel (its VJP in torch math, ``ops._MatmulRMSNorm``)
    against the same backward with the plain version in the kernel's place,
    within TRAIN_RTOL of the plain grad's max, and not zero; the kernel
    launched twice a layer. Where matmul_rmsnorm has no gradient (its
    kernel writes the output through ctypes) these grads are zero."""
    from repro_torch.kernels import matmul_rmsnorm as mln
    from repro_torch.kernels import ops, ref
    from repro_torch.models import LM
    from repro_torch.runtime import Runtime

    lm = LM(cfg, Runtime(compute_dtype="float32", remat=False), device=device,
            seed=SEED)
    lm.requires_grad_(True)
    tok = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    params = dict(lm.named_parameters())
    names = [f"blocks.{i}.mixer.{leaf}" for i in range(cfg.num_layers)
             for leaf in ("q_norm", "kv_norm", "wq_a", "wkv_a")]

    def grads():
        for p_ in lm.parameters():
            p_.grad = None
        t0 = time.monotonic()
        lm.loss(tok).backward()
        _sync(device)
        return {n: (params[n].grad if params[n].grad is not None
                    else torch.zeros_like(params[n])).detach().clone()
                for n in names}, time.monotonic() - t0

    kernel = ops.matmul_rmsnorm
    ops.matmul_rmsnorm = (lambda a, b, scale, *, eps=1e-6, out_dtype=None:
                          ref.matmul_rmsnorm_ref(a, b, scale, eps, out_dtype))
    try:
        want, plain_s = grads()
    finally:
        ops.matmul_rmsnorm = kernel
    mln.launches = 0
    got, kernel_s = grads()
    launches = mln.launches
    rows = {}
    for n in names:
        bound = TRAIN_RTOL * float(want[n].abs().max())
        err = float((got[n] - want[n]).abs().max())
        rows[n] = dict(err=err, bound=bound,
                       over_bound=err / bound if bound else float("inf"),
                       got_max=float(got[n].abs().max()))
    del lm, params, got, want, tok
    if _on_card(device):
        torch.cuda.empty_cache()
    worst = max(rows, key=lambda n: rows[n]["over_bound"])
    ok = (all(r["err"] <= r["bound"] and r["got_max"] > 0
              for r in rows.values())
          and (launches == 2 * cfg.num_layers or not _on_card(device)))
    log(f"  one device: grads of q_norm, kv_norm, wq_a and wkv_a with the "
        f"kernel against the plain matmul_rmsnorm: worst err/bound "
        f"{rows[worst]['over_bound']:.3e} ({worst}); smallest max|grad| "
        f"{min(r['got_max'] for r in rows.values()):.3e}; kernel launches "
        f"{launches} (2 a layer); backward {kernel_s:.2f}s (plain "
        f"{plain_s:.2f}s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 13 (a): matmul_rmsnorm's grads {rows}, "
                             f"{launches} launches")
    return dict(grads=rows, worst=worst, launches=launches,
                kernel_s=kernel_s, plain_s=plain_s)


def phase_subl() -> dict:
    """Phase 13: (a) minicpm3-4b cut to MLA_TRAIN_LAYERS layers, the norm
    grads of :func:`mla_norm_grads`, then one training step on
    TP_WORLD gloo ranks (MLA_TRAIN_RUNS) held to one device by phase 9's
    rules; (b) internlm2-1.8b cut to RAGGED_LAYERS layers in one spawn: the
    ragged step (RAGGED_RUNS) and the sequence_parallel off and on steps
    (SP_RUNS), each held to its batch's one-device step, the off loss
    within SP_LOSS_RTOL of the on loss and of the one-device loss. The
    references keep their
    gradients alone on the host (m, v and the parameters are AdamW's first
    step of them, :func:`first_step`), a quarter of the bytes."""
    t0 = time.monotonic()
    mcfg = get_mla_train_cfg()
    mbatch = train_batch(mcfg, seq=MLA_TRAIN_SEQ, batch=MLA_TRAIN_BATCH)
    norms = mla_norm_grads(mcfg, mbatch)
    t = time.monotonic()
    mla = phase_train(cfg=mcfg, batch=mbatch, runs=MLA_TRAIN_RUNS,
                      label="phase 13 (a)", quantities=("grad",))
    mla_s = time.monotonic() - t
    log(f"  (a) {mla_s:.1f}s")
    rcfg = get_tp_cfg().scaled(num_layers=RAGGED_LAYERS)
    t = time.monotonic()
    ragged = phase_train(cfg=rcfg, label="phase 13 (b)",
                         quantities=("grad",), legs=[
        (train_batch(rcfg, seq=RAGGED_SEQ), RAGGED_RUNS),
        (train_batch(rcfg), SP_RUNS)])
    ragged_s = time.monotonic() - t
    off, on = (next(r for r in ragged["runs"] if r["batch"][1] == TP_SEQ
                    and r["sequence_parallel"] == flag)
               for flag in (False, True))
    one = off["one_device"]
    rel = max(abs(off["loss"] - x) / abs(x) for x in (on["loss"], one))
    log(f"  (b) {ragged_s:.1f}s; sequence_parallel=False loss "
        f"{off['loss']:.7f} (layout {off['layout']}) against the flag on "
        f"{on['loss']:.7f} (layout {on['layout']}) and one device "
        f"{one:.7f}: rel {rel:.3e}"
        f"{' (bitwise)' if off['loss'] == on['loss'] == one else ''}")
    if not (rel <= SP_LOSS_RTOL and off["layout"] == "gathered"
            and on["layout"] == "sharded"):
        raise AssertionError(f"phase 13 (b): sequence_parallel=False loss "
                             f"rel {rel} (layouts {off['layout']}, "
                             f"{on['layout']})")
    ragged_rows = [r for r in ragged["runs"] if r["batch"][1] == RAGGED_SEQ]
    if not all(r["layout"] == "replicated" for r in ragged_rows):
        raise AssertionError("phase 13 (b): the ragged run was not in the "
                             "replicated layout")
    parts = (mla, ragged)
    total = time.monotonic() - t0
    log(f"  phase 13: {total:.1f}s (norm grads "
        f"{norms['kernel_s'] + norms['plain_s']:.1f}s of backward, (a) "
        f"{mla_s:.1f}s, (b) {ragged_s:.1f}s)")
    return dict(norm_grads=norms, mla=mla, ragged=ragged, sp_rel=rel,
                seconds=dict(total=total, mla=mla_s, ragged=ragged_s),
                matmul_launches=sum(q["matmul_launches"] for q in parts),
                flash_launches=sum(q["flash_launches"] for q in parts),
                mln_launches=sum(q["mln_launches"] for q in parts),
                call_shapes=sorted({tuple(c) for q in parts
                                    for c in q["call_shapes"]}),
                norm_shapes=sorted({tuple(c) for q in parts
                                    for c in q["norm_shapes"]}),
                flash_shapes=sorted({tuple(c) for q in parts
                                     for c in q["flash_shapes"]}))


# ---------------------------------------------------------------------------
# phase 14: the recurrent families (mamba2-130m, recurrentgemma-2b)
# ---------------------------------------------------------------------------


def get_rec_cfg(arch: str, layers: int = 0):
    """``arch`` at its published widths, cut to ``layers`` (0: all)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return cfg.scaled(num_layers=layers) if layers else cfg


def swa_layers(cfg) -> int:
    return sum(k == "swa" for k in cfg.layer_kinds())


def rec_core_case(cfg, B: int, Sq: int, Skv: int, dtype, seed: int):
    """recurrentgemma-2b's attention core as phase 14 calls it: B rows, all
    10 query heads over the one kv head, the 2048 window; a prefill (Sq ==
    Skv) over positions 0..Skv-1, or a decode step (Sq 1) at position
    REC_PROMPT over the ring buffer's Skv keys, the last window
    positions."""
    g = torch.Generator().manual_seed(seed)
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    mk = lambda h, s_: torch.randn(B, s_, h, dh, generator=g).to("cuda",
                                                                 dtype)
    last = REC_PROMPT[HYB_ARCH] if Sq == 1 else Skv - 1
    qpos = torch.arange(last - Sq + 1, last + 1, dtype=torch.int32)
    kpos = torch.arange(last - Skv + 1, last + 1, dtype=torch.int32)
    return dict(q=mk(H, Sq), k=mk(Hkv, Skv), v=mk(Hkv, Skv),
                q_positions=qpos.expand(B, Sq).contiguous().cuda(),
                kv_positions=kpos.expand(B, Skv).contiguous().cuda(),
                window=cfg.window)


def rec_flash_cases() -> list:
    """(name, B, Sq, Skv, dtype) of every flash call phase 14 makes: the
    bf16 serving prefill and decode (REC_REQUESTS rows), the f32 check's
    prefill and decode (REC_CHECK_BATCH rows), and the ring's replicated
    core over the whole sequence (f32)."""
    P, W = REC_PROMPT[HYB_ARCH], get_rec_cfg(HYB_ARCH).window
    B, S = REC_TRAIN_SHAPE[HYB_ARCH]
    bf16, f32 = torch.bfloat16, torch.float32
    return [("rec_prefill", REC_REQUESTS, P, P, bf16),
            ("rec_decode", REC_REQUESTS, 1, W, bf16),
            ("rec_prefill", REC_CHECK_BATCH, REC_CHECK_PROMPT[HYB_ARCH],
             REC_CHECK_PROMPT[HYB_ARCH], f32),
            ("rec_decode", REC_CHECK_BATCH, 1, W, f32),
            ("rec_ring_core", B, S, S, f32)]


def rec_matmul_shapes() -> list:
    """(M, K, N, layout) of every matmul call of phase 14 (c)'s ring steps:
    recurrentgemma-2b's FFNs through sp_ffn (its mixers run replicated,
    with torch's own products; mamba2-130m has no FFN and runs none)."""
    B, S = REC_TRAIN_SHAPE[HYB_ARCH]
    return sp_ffn_matmul_shapes(
        get_rec_cfg(HYB_ARCH, REC_TRAIN_LAYERS[HYB_ARCH]), batch=B, seq=S,
        runs=REC_TRAIN_RUNS[HYB_ARCH])


def phase_rec_reference(arch: str) -> dict:
    """(a)/(b)'s first check: ``arch`` cut to REC_CHECK_LAYERS layers, f32:
    ``LM.prefill`` of REC_CHECK_BATCH prompts of REC_CHECK_PROMPT tokens and
    REC_DECODE_STEPS ``LM.decode_step`` calls on the CPU (plain versions)
    and on the card (the kernels), logits within LOGIT_TOL; the card's
    flash calls recorded."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.runtime import SMOKE

    cfg = get_rec_cfg(arch, REC_CHECK_LAYERS[arch])
    cpu = LM(cfg, SMOKE, device="cpu", seed=SEED)
    gpu = LM(cfg, SMOKE, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (REC_CHECK_BATCH, REC_CHECK_PROMPT[arch])
    ).astype(np.int32))
    t0 = time.monotonic()
    want = prefill_decode(cpu, tokens, REC_DECODE_STEPS)
    cpu_s = time.monotonic() - t0
    calls = {}
    core = record_calls(ops, calls)
    try:
        t0 = time.monotonic()
        got = prefill_decode(gpu, tokens, REC_DECODE_STEPS)
        card_s = time.monotonic() - t0
    finally:
        ops.flash_attention = core
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **LOGIT_TOL)
    del cpu, gpu
    torch.cuda.empty_cache()
    log(f"  {arch} {cfg.num_layers} layers f32, {REC_CHECK_BATCH} x "
        f"{REC_CHECK_PROMPT[arch]}: prefill + {REC_DECODE_STEPS} decode "
        f"logits max|Δ| {err:.3e} within {LOGIT_TOL} (CPU {cpu_s:.1f}s, "
        f"card {card_s:.1f}s)")
    return dict(err=err, cpu_s=cpu_s, card_s=card_s,
                call_shapes=sorted([*k, v] for k, v in calls.items()))


def phase_rec_serve(arch: str, fa) -> dict:
    """``arch`` at full width and depth served through
    ``repro_torch.launch.serve`` (bf16 compute, f32 params; the dense
    engine): REC_REQUESTS prompts of REC_PROMPT tokens, one length group,
    REC_MAX_NEW new tokens, greedy; one prefill and REC_MAX_NEW - 1 decode
    calls; flash once a sliding-window layer a call, the prefill's on
    wgmma and every decode step's on split-KV."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_rec_cfg(arch)
    calls = {}
    core = record_calls(ops, calls)
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0                            # count the main path only
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        t0 = time.monotonic()
        eng, reqs = serve.main([
            "--arch", arch, "--device", "cuda", "--requests",
            str(REC_REQUESTS), "--prompt-len", str(REC_PROMPT[arch]),
            "--prompt-len-min", str(REC_PROMPT[arch]), "--max-new",
            str(REC_MAX_NEW), "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches, variants = fa.launches, dict(fa.launches_by_variant)
    finally:
        ops.flash_attention = core
    if not all(r.done and len(r.out_tokens) == REC_MAX_NEW for r in reqs):
        raise AssertionError(f"{arch}: a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError(f"{arch}: a token outside the vocabulary")
    prefills, decodes = 1, REC_MAX_NEW - 1
    if eng.paged or eng.steps != prefills + decodes:
        raise AssertionError(f"{arch}: {eng.steps} model calls (paged "
                             f"{eng.paged}), expected the dense engine's "
                             f"{prefills} prefill + {decodes} decode")
    n = swa_layers(cfg)
    want = dict(wgmma=n * prefills, splitkv=n * decodes, ffma=0)
    if launches != n * eng.steps or variants != want:
        raise AssertionError(f"{arch}: flash launched {launches} times "
                             f"{variants}, expected {n} layers x "
                             f"{eng.steps} calls {want}")
    rep = dict(eng.last_report)
    rep.update(steps=eng.steps, launches=launches, flash_variants=variants,
               wall_s=wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               params=cfg.param_count(),
               call_shapes=sorted([*k, v] for k, v in calls.items()))
    log(f"  {arch} served {len(reqs)} x {REC_PROMPT[arch]} tokens in "
        f"{eng.steps} model calls ({prefills} prefill + {decodes} decode), "
        f"{wall:.1f}s; TTFT p50 {rep['ttft_p50_ms']:.1f} ms, per-token p50 "
        f"{rep['per_token_p50_ms']:.2f} ms, "
        f"peak {rep['peak_mem_gib']:.2f} GiB; flash {launches} = {n} x "
        f"{eng.steps} {json.dumps(variants)}")
    log("  latency " + json.dumps(rep))
    return rep


def phase_recurrent(fa) -> dict:
    """Phase 14: (a) mamba2-130m and (b) recurrentgemma-2b, each checked
    f32 card against CPU (:func:`phase_rec_reference`) and served at full
    depth in bf16 (:func:`phase_rec_serve`); (c) one training step of each
    on TP_WORLD gloo ranks against one device (phase 9's machinery and
    rules, the references keeping their grads alone on the host)."""
    t0 = time.monotonic()
    out = dict(check={}, serve={}, train={}, seconds={})
    for arch in (SSM_ARCH, HYB_ARCH):
        t = time.monotonic()
        out["check"][arch] = phase_rec_reference(arch)
        out["serve"][arch] = phase_rec_serve(arch, fa)
        out["seconds"][arch] = time.monotonic() - t
    for arch in (HYB_ARCH, SSM_ARCH):
        t = time.monotonic()
        cfg = get_rec_cfg(arch, REC_TRAIN_LAYERS[arch])
        B, S = REC_TRAIN_SHAPE[arch]
        log(f"  (c) {arch} cut to {cfg.num_layers} layers, batch {B} x {S}")
        out["train"][arch] = phase_train(
            cfg=cfg, batch=train_batch(cfg, seq=S, batch=B),
            runs=REC_TRAIN_RUNS[arch], label=f"phase 14 (c) {arch}",
            quantities=("grad",))
        out["seconds"][f"train {arch}"] = time.monotonic() - t
    trains = list(out["train"].values())
    out.update(
        flash_launches=sum(r["launches"] for r in out["serve"].values())
        + sum(q["flash_launches"] for q in trains),
        matmul_launches=sum(q["matmul_launches"] for q in trains),
        call_shapes=sorted({tuple(c) for q in trains
                            for c in q["call_shapes"]}),
        flash_shapes=sorted(
            {tuple(c[:8]) for q in trains for c in q["flash_shapes"]}
            | {tuple(c[:8]) for r in list(out["serve"].values())
               + list(out["check"].values()) for c in r["call_shapes"]}))
    out["seconds"]["total"] = time.monotonic() - t0
    log(f"  phase 14: {out['seconds']['total']:.1f}s "
        f"({json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})})"
        f"; flash {out['flash_launches']}, matmul {out['matmul_launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the enc-dec and VLM families (whisper-tiny, paligemma-3b)
# ---------------------------------------------------------------------------


def pf_flash_cases() -> list:
    """(name, arch, B, Sq, Skv, per_rank, dtype, causal, prefix_len, q0) of
    every flash call phase 15 makes, q0 a decode row's query position (None:
    a prefill, positions 0..Sq-1) and ``per_rank`` a ring rank's heads.
    whisper-tiny: (a) f32 over ENC_CHECK_BATCH rows and (b) bf16 over
    ENC_REQUESTS: the non-causal encoder (1500 frames) and cross-attention
    (the prompt, then a decode row, over 1500 keys), the causal
    self-attention's prefill and decode (a cache of prompt + new tokens).
    paligemma-3b: the prefix-LM cores of (c)'s loss, of (e)'s ring (a
    rank's 2 query heads over the one kv head, f32 ffma and its bf16
    wgmma twin) and of (e)'s one-device step, a bf16 split-KV decode whose
    queries lie inside the prefix; the causal serving cores of (c) (f32)
    and (d) (bf16): prefill over 256 + VLM_PROMPT, decode over the cache."""
    P = get_rec_cfg(VLM_ARCH).num_prefix_tokens
    T, (Bt, St) = P + VLM_PROMPT, VLM_TRAIN_SHAPE
    f32, bf16 = torch.float32, torch.bfloat16
    out = []
    for B, dtype, new in ((ENC_CHECK_BATCH, f32, PF_DECODE_STEPS),
                          (ENC_REQUESTS, bf16, ENC_MAX_NEW)):
        S, F = ENC_PROMPT, get_rec_cfg(ENC_ARCH).encoder.max_source_len
        out += [("enc_encoder", ENC_ARCH, B, F, F, False, dtype, False, 0,
                 None),
                ("enc_self", ENC_ARCH, B, S, S, False, dtype, True, 0, None),
                ("enc_cross", ENC_ARCH, B, S, F, False, dtype, False, 0,
                 None),
                ("enc_self_decode", ENC_ARCH, B, 1, S + new, False, dtype,
                 True, 0, S),
                ("enc_cross_decode", ENC_ARCH, B, 1, F, False, dtype, False,
                 0, 0)]
    out += [("vlm_prefix_check", VLM_ARCH, VLM_CHECK_BATCH, T, T, False,
             f32, True, P, None),
            ("vlm_prefix_ring", VLM_ARCH, Bt, P + St, P + St, True, f32,
             True, P, None),
            ("vlm_prefix_ring", VLM_ARCH, Bt, P + St, P + St, True, bf16,
             True, P, None),
            ("vlm_prefix_step", VLM_ARCH, Bt, P + St, P + St, False, f32,
             True, P, None),
            ("vlm_prefix_decode", VLM_ARCH, 2, 1, T, False, bf16, True, P,
             [P // 2 - 28, P - 1])]
    for B, dtype, new in ((VLM_CHECK_BATCH, f32, PF_DECODE_STEPS),
                          (VLM_REQUESTS, bf16, VLM_MAX_NEW)):
        out += [("vlm_prefill", VLM_ARCH, B, T, T, False, dtype, True, 0,
                 None),
                ("vlm_decode", VLM_ARCH, B, 1, T + new, False, dtype, True,
                 0, T)]
    return out


def pf_core_case(arch: str, B: int, Sq: int, Skv: int, per_rank: bool,
                 dtype, causal: bool, prefix_len: int, q0, seed: int):
    """The attention core of ``arch`` as phase 15 calls it: all heads, or
    a ring rank's (H/TP_WORLD query heads over the kv head they use);
    a prefill over positions 0..Sq-1, or a decode row at q0 (an int, or
    one a batch row) over keys 0..q0 (-1 after: the cache's free slots)
    where causal, over every key where not."""
    cfg = get_rec_cfg(arch)
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if per_rank:
        H, Hkv = H // TP_WORLD, max(Hkv // TP_WORLD, 1)
    g = torch.Generator().manual_seed(seed)
    mk = lambda h, s_: torch.randn(B, s_, h, dh, generator=g).to("cuda",
                                                                 dtype)
    kpos = torch.arange(Skv, dtype=torch.int32).expand(B, Skv).clone()
    if q0 is None:
        qpos = torch.arange(Sq, dtype=torch.int32).expand(B, Sq).clone()
    else:
        q0 = q0 if isinstance(q0, list) else [q0] * B
        qpos = torch.tensor(q0, dtype=torch.int32)[:, None]
        if causal and not prefix_len:
            kpos = torch.where(kpos <= qpos, kpos, -1)
    return dict(q=mk(H, Sq), k=mk(Hkv, Skv), v=mk(Hkv, Skv),
                q_positions=qpos.cuda(), kv_positions=kpos.cuda(), window=0,
                causal=causal, prefix_len=prefix_len)


def checked_masked(rows) -> set:
    """Phase 3's flash rows as (B, Sq, H, dh, Skv, Hkv, dv, dtype, causal,
    prefix_len) keys, as ``record_calls(..., masked=True)`` sees a
    call."""
    return {(r["shape"]["B"], r["shape"]["Sq"], r["shape"]["H"],
             r["shape"]["dh"], r["shape"]["Skv"], r["shape"]["Hkv"],
             r["shape"]["dv"], r["dtype"], r["causal"], r["prefix_len"])
            for r in rows}


def vlm_matmul_shapes(cfg=None, batch: int = VLM_TRAIN_SHAPE[0],
                      seq: int = VLM_TRAIN_SHAPE[1],
                      runs=VLM_TRAIN_RUNS) -> list:
    """(M, K, N, layout) of every matmul call of phase 15 (e)'s ring step,
    whole-block graphs over the P + ``seq`` rows: the forward's cais ring
    steps (gather steps of b·S_r/c rows, c as the cais planner picks it,
    reduce steps of b·S_r/2) through the q, k, v (the one kv head whole on
    every rank), up and gate columns and the o and down rows, and the
    backward's as :func:`train_matmul_shapes` counts them."""
    from repro_torch.core import primitives as prim
    from repro_torch.core.backends import CAISBackend

    cfg = cfg or get_rec_cfg(VLM_ARCH, VLM_TRAIN_LAYERS)
    T = cfg.num_prefix_tokens + seq
    n, d, dh = TP_WORLD, cfg.d_model, cfg.resolved_head_dim
    kv_tp = n if cfg.num_kv_heads % n == 0 else 1
    fq, fkv = cfg.num_heads * dh // n, cfg.num_kv_heads * dh // kv_tp
    ff, s_r = cfg.d_ff // n, T // n
    shapes = set()
    for mode, mb, *_ in runs:
        b = batch // batch_split(batch, mb)
        if mode == "barrier":
            m_ag = m_rs = b * T
        else:
            c = prim._pick_chunks(s_r, CAISBackend.plan_chunks(
                b * T * d * 4, n))
            m_ag, m_rs = b * s_r // c, b * s_r // 2
        shapes |= {(m_ag, d, fq, "nn"), (m_ag, d, fkv, "nn"),
                   (m_ag, d, ff, "nn"), (m_rs, fq, d, "nn"),
                   (m_rs, ff, d, "nn")}
    return sorted(shapes | set(train_matmul_shapes(
        cfg, batch=batch, seq=T, runs=runs)))


def pf_inputs(cfg, B: int, S: int, seed: int) -> dict:
    """A batch of B prompts of S tokens (and their next-token labels) with
    the family's stub-frontend input, standard normal from ``seed``:
    whisper's frame embeddings (B, 1500, d), paligemma's patch embeddings
    (B, 256, 1152)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_enc_dec:
        out["src_embed"] = rng.standard_normal(
            (B, cfg.encoder.max_source_len, cfg.d_model)).astype(np.float32)
    else:
        out["patch_embed"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.vision_width)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def phase_pf_check(cfg, B: int, S: int, grads: bool,
                   device="cuda") -> dict:
    """(a)/(c): ``cfg``'s model in f32 on the CPU (plain versions) and on
    ``device`` (the kernels) from one seed: ``prefill`` of B prompts of S
    tokens with their frontend input and PF_DECODE_STEPS ``decode_step``
    calls, logits within LOGIT_TOL; the loss (the VLM's prefix-LM one)
    within TRAIN_RTOL, and with ``grads`` every grad per tensor within
    TRAIN_RTOL of its max (phase 9's f32 rules); the device's flash calls
    recorded with their masks."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import SMOKE

    cpu = build_model(cfg, SMOKE, device="cpu", seed=SEED)
    dev = build_model(cfg, SMOKE, device=device, seed=None)
    dev.load_state_dict(cpu.state_dict())
    batch = pf_inputs(cfg, B, S, seed=15)
    extras = {k: v for k, v in batch.items() if k.endswith("_embed")}
    out, calls = {}, {}
    for name, m in (("cpu", cpu), ("card", dev)):
        core = record_calls(ops, calls, masked=True) if name == "card" \
            else None
        t0 = time.monotonic()
        try:
            logits = prefill_decode(m, batch["tokens"], PF_DECODE_STEPS,
                                    extras)
            b = {k: v.to(m.device) for k, v in batch.items()}
            m.requires_grad_(grads)
            with torch.set_grad_enabled(grads):
                loss = m.loss(b)
            if grads:
                loss.backward()
            _sync(m.device)
        finally:
            if core is not None:
                ops.flash_attention = core
        out[name] = dict(logits=logits, loss=float(loss.detach()),
                         grads={k: p.grad for k, p in m.named_parameters()}
                         if grads else {}, s=time.monotonic() - t0)
    err = max(float((g - w).abs().max())
              for g, w in zip(out["card"]["logits"], out["cpu"]["logits"]))
    logits_ok = all(torch.allclose(g, w, **LOGIT_TOL) for g, w in
                    zip(out["card"]["logits"], out["cpu"]["logits"]))
    rel = abs(out["card"]["loss"] - out["cpu"]["loss"]) / \
        abs(out["cpu"]["loss"])
    worst = max((float((g.cpu() - out["cpu"]["grads"][k]).abs().max())
                 / (TRAIN_RTOL * float(out["cpu"]["grads"][k].abs().max()))
                 for k, g in out["card"]["grads"].items()), default=0.0)
    checks = {f"logits within {LOGIT_TOL}": logits_ok,
              f"loss within {TRAIN_RTOL:g}": rel <= TRAIN_RTOL,
              f"every grad within {TRAIN_RTOL:g} max|ref|": worst <= 1.0}
    log(f"  {cfg.name} {cfg.num_layers} layers f32, {B} x "
        f"{cfg.num_prefix_tokens + S}: prefill + {PF_DECODE_STEPS} decode "
        f"logits max|d| {err:.3e}; loss {out['card']['loss']:.7f} (CPU "
        f"{out['cpu']['loss']:.7f}, rel {rel:.2e})"
        + (f"; worst grad err / bound {worst:.3f}" if grads else "")
        + f" (CPU {out['cpu']['s']:.1f}s, card {out['card']['s']:.1f}s); "
        f"{json.dumps({k: v for k, v in checks.items()})}")
    del cpu, dev, out
    if _on_card(device):
        torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"{cfg.name}: card against CPU failed "
                             f"{[k for k, v in checks.items() if not v]}")
    return dict(logits_err=err, loss_rel=rel, grad_worst=worst,
                calls=sorted([*k, v] for k, v in calls.items()))


def pf_serve_launches(cfg, new: int) -> dict:
    """The flash calls by variant of one dense-engine batch of ``cfg``
    served for ``new`` tokens: whisper-tiny's prefill runs the encoder, the
    self-attention and the cross-attention of every layer (ffma: dh 64 has
    no wgmma pair) and each decode call the self- and cross-attention
    (split-KV); paligemma-3b's prefill one wgmma call a layer and each
    decode call one split-KV call a layer."""
    L, decodes = cfg.num_layers, new - 1
    if cfg.is_enc_dec:
        return dict(ffma=cfg.encoder.num_layers + 2 * L,
                    splitkv=2 * L * decodes, wgmma=0)
    return dict(wgmma=L, splitkv=L * decodes, ffma=0)


def phase_pf_serve(arch: str, fa, requests: int, prompt: int,
                   new: int) -> dict:
    """(b)/(d): ``arch`` at full width and depth served through
    ``repro_torch.launch.serve`` in bf16 (f32 params; the dense engine):
    ``requests`` prompts of ``prompt`` tokens, one length group, ``new``
    tokens each, greedy; one prefill and new - 1 decode calls, the flash
    launches exactly :func:`pf_serve_launches`'."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_rec_cfg(arch)
    calls = {}
    core = record_calls(ops, calls, masked=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0                            # count the main path only
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        t0 = time.monotonic()
        eng, reqs = serve.main([
            "--arch", arch, "--device", "cuda", "--requests", str(requests),
            "--prompt-len", str(prompt), "--prompt-len-min", str(prompt),
            "--max-new", str(new), "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches, variants = fa.launches, dict(fa.launches_by_variant)
    finally:
        ops.flash_attention = core
    want = pf_serve_launches(cfg, new)
    checks = {
        "every request finished": all(
            r.done and len(r.out_tokens) == new for r in reqs),
        "tokens in the vocabulary": all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
        "dense engine, 1 prefill + new - 1 decode calls":
            not eng.paged and eng.steps == new,
        f"flash launches {sum(want.values())} {json.dumps(want)}":
            launches == sum(want.values()) == sum(calls.values())
            and variants == want}
    rep = dict(eng.last_report)
    rep.update(steps=eng.steps, launches=launches, flash_variants=variants,
               wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated()
               / 2**30, params=cfg.param_count(),
               calls=sorted([*k, v] for k, v in calls.items()))
    behind = (f" behind {cfg.num_prefix_tokens} image tokens"
              if cfg.num_prefix_tokens else "")
    log(f"  {arch} served {len(reqs)} x {prompt} tokens{behind} in "
        f"{eng.steps} model calls, {wall:.1f}s; TTFT p50 "
        f"{rep['ttft_p50_ms']:.1f} ms, per-token p50 "
        f"{rep['per_token_p50_ms']:.2f} ms, peak {rep['peak_mem_gib']:.2f} "
        f"GiB; flash {launches} {json.dumps(variants)}; "
        f"{json.dumps(checks)}")
    log("  latency " + json.dumps({k: v for k, v in rep.items()
                                   if k != "calls"}))
    if not all(checks.values()):
        raise AssertionError(f"{arch} serving failed "
                             f"{[k for k, v in checks.items() if not v]}")
    return rep


def phase_pf(fa) -> dict:
    """Phase 15: (a) whisper-tiny f32 card against CPU and (b) served in
    bf16; (c) paligemma-3b cut to VLM_CHECK_LAYERS f32 card against CPU and
    (d) served at full depth in bf16; (e) one paligemma-3b training step on
    TP_WORLD gloo ranks against one device (phase 9's machinery and rules,
    the reference keeping its grads alone on the host), every flash call
    with the prefix. Returns the launches, the masked flash calls of
    (a)-(d), (e)'s call shapes and the seconds of each part."""
    t0 = time.monotonic()
    out = dict(seconds={})

    def part(name, fn, *a):
        t = time.monotonic()
        log(f"  ({name})")
        out[name] = fn(*a)
        out["seconds"][name] = time.monotonic() - t

    part("a", phase_pf_check, get_rec_cfg(ENC_ARCH), ENC_CHECK_BATCH,
         ENC_PROMPT, True)
    part("b", phase_pf_serve, ENC_ARCH, fa, ENC_REQUESTS, ENC_PROMPT,
         ENC_MAX_NEW)
    part("c", phase_pf_check, get_rec_cfg(VLM_ARCH, VLM_CHECK_LAYERS),
         VLM_CHECK_BATCH, VLM_PROMPT, False)
    part("d", phase_pf_serve, VLM_ARCH, fa, VLM_REQUESTS, VLM_PROMPT,
         VLM_MAX_NEW)
    cfg = get_rec_cfg(VLM_ARCH, VLM_TRAIN_LAYERS)
    B, S = VLM_TRAIN_SHAPE
    part("e", phase_train, cfg, train_batch(cfg, seq=S, batch=B),
         VLM_TRAIN_RUNS, "phase 15 (e)", ("grad",))
    train = out["e"]
    P = cfg.num_prefix_tokens
    out.update(
        flash_launches=out["b"]["launches"] + out["d"]["launches"]
        + train["flash_launches"],
        matmul_launches=train["matmul_launches"],
        call_shapes=train["call_shapes"],
        masked=sorted({tuple(c[:10]) for k in "abcd"
                       for c in out[k]["calls"]}
                      | {(*c[:8], True, P) for c in train["flash_shapes"]}))
    out["seconds"]["total"] = time.monotonic() - t0
    log(f"  phase 15: {out['seconds']['total']:.1f}s "
        f"({json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})})"
        f"; flash {out['flash_launches']}, matmul {out['matmul_launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 16: arctic-480b (served, adafactor) and checkpoint/restart across
# ring layouts
# ---------------------------------------------------------------------------


def get_arctic_cfg(layers: int = ARCTIC_LAYERS):
    """arctic-480b at its published widths, cut to ``layers`` layers."""
    from repro_torch.configs import get_arch

    return get_arch(ARCTIC_ARCH).scaled(num_layers=layers)


def full_core_case(cfg, B: int, S: int, dtype, seed: int):
    """The attention core as one device calls it in a training step: every
    query and kv head of ``cfg``, ``S`` causal positions."""
    g = torch.Generator().manual_seed(seed)
    dh = cfg.resolved_head_dim
    mk = lambda h: torch.randn(B, S, h, dh, generator=g).to("cuda", dtype)
    pos = torch.arange(S, dtype=torch.int32,
                       device="cuda").expand(B, S).contiguous()
    return dict(q=mk(cfg.num_heads), k=mk(cfg.num_kv_heads),
                v=mk(cfg.num_kv_heads), q_positions=pos, kv_positions=pos,
                window=cfg.window)


def arctic_flash_cases() -> list:
    """Phase 16's flash calls for phase 3: arctic-480b served in bf16 (a
    decode step, a prefill chunk), its training core (bf16), and (c)'s
    one-device f32 step of internlm2-1.8b (16 q / 8 kv heads)."""
    arc = get_arctic_cfg()
    B, S = ARCTIC_TRAIN_SHAPE
    bf16 = torch.bfloat16
    return [
        ("arctic_decode", lambda: serving_case(
            arc, 1, q0=[699, 649, 0, 612], ctx=[700, 650, 0, 613],
            dtype=bf16, seed=40)),
        ("arctic_prefill_chunk", lambda: serving_case(
            arc, PREFILL_CHUNK, q0=[640, 0, 0, 512], ctx=[700, 128, 0, 640],
            dtype=bf16, seed=41)),
        ("arctic_train_core", lambda: full_core_case(arc, B, S, bf16, 42)),
        ("ckpt_one_device", lambda: full_core_case(
            get_tp_cfg(), TP_BATCH, TP_SEQ, torch.float32, 43))]


def moe_ring_flash_cases() -> list:
    """Phase 17's flash calls for phase 3: a rank's heads of mixtral-8x7b
    (f32 scripted steps, bf16 engine) and arctic-480b (bf16) served on the
    ring, a decode step and a prefill chunk."""
    out = []
    for i, (cfg, dtypes) in enumerate((
            (get_moe_cfg(), (torch.bfloat16, torch.float32)),
            (get_arctic_cfg(), (torch.bfloat16,)))):
        rank, tag = serve_rank_cfg(cfg), cfg.name.split("-")[0]
        for j, dtype in enumerate(dtypes):
            seed = 50 + 4 * i + 2 * j
            out += [(f"ring_{tag}_decode", functools.partial(
                serving_case, rank, 1, q0=[699, 649, 0, 612],
                ctx=[700, 650, 0, 613], dtype=dtype, seed=seed)),
                (f"ring_{tag}_prefill_chunk", functools.partial(
                    serving_case, rank, PREFILL_CHUNK, q0=[640, 0, 0, 512],
                    ctx=[700, 128, 0, 640], dtype=dtype, seed=seed + 1))]
    return out


def phase_arctic_serve(cfg, fa) -> tuple:
    """Phase 16 (a): arctic-480b cut to ARCTIC_LAYERS served through
    ``launch.serve`` (phase 5's traffic, bf16 compute and parameters,
    greedy): flash once a layer a step, decode steps on split-KV (G = 7
    query rows a kv head), prefill chunks on wgmma. Returns (the report,
    the served model, the engine's prompts, tokens and latency report)."""
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
            "--arch", ARCTIC_ARCH, "--layers", str(ARCTIC_LAYERS),
            "--device", "cuda", "--requests", str(REQUESTS), "--prompt-len",
            str(PROMPT_MAX), "--prompt-len-min", str(PROMPT_MIN),
            "--max-new", str(MAX_NEW), "--prefill-chunk", str(PREFILL_CHUNK),
            "--block-size", str(BLOCK_SIZE), "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches, variants = fa.launches, dict(fa.launches_by_variant)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        ops.flash_attention = core
    lm, report = eng.model, dict(eng.last_report, steps=eng.steps)
    L = cfg.num_layers
    G = cfg.num_heads // cfg.num_kv_heads
    decode = sum(n for key, n in calls.items()
                 if key[1] * G <= fa.SPLIT_MAX_ROWS)
    params = sum(p.numel() for p in lm.parameters())
    checks = {
        "bf16 parameters (the router f32, as JAX's), the published "
        "count": all(p.dtype == (torch.float32 if n.endswith(".router")
                                 else torch.bfloat16)
                     for n, p in lm.named_parameters())
        and params == cfg.param_count(),
        "every request finished": all(
            r.done and len(r.out_tokens) == MAX_NEW for r in reqs),
        "tokens inside the vocabulary": all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
        "flash once a layer a step": launches == eng.steps * L > 0,
        "decode on split-KV, prefill on wgmma": variants == dict(
            splitkv=decode, wgmma=launches - decode, ffma=0)
        and 0 < decode < launches and G == 7,
    }
    nbytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    log(f"  (a) {params / 1e9:.3f} B parameters ({nbytes / 1e9:.2f} GB); "
        f"{len(reqs)} requests in "
        f"{eng.steps} steps, {wall:.2f}s; TTFT p50 "
        f"{report['ttft_p50_ms']:.1f} ms, per-token p50 "
        f"{report['per_token_p50_ms']:.1f} ms; flash {launches} = "
        f"{eng.steps} x {L} {json.dumps(variants)}; peak {peak:.2f} GiB")
    del eng
    engine = dict(prompts=[r.prompt for r in reqs],
                  tokens=[list(r.out_tokens) for r in reqs], report=report)
    return dict(report=report, launches=launches, flash_variants=variants,
                peak_gib=peak, wall_s=wall, params=params, checks=checks,
                call_shapes=sorted([*k, v] for k, v in calls.items())), lm, \
        engine


def adafactor_leaf_check(shape=None, device="cuda") -> dict:
    """Phase 16 (b1): the port's adafactor, alone, on one expert leaf of
    ``shape`` (arctic-480b's w_up: 128 x 7168 x 4864) in bf16 with seeded
    grads, its first step; held against the formula evaluated expert by
    expert in f64 (vr, vc, u, then the RMS of the whole leaf from the f64
    u, then the new parameter): each new bf16 parameter within one bf16 ulp
    (ADA_ULP) and the f32 rounding of its two terms (ADA_F32), vr and vc
    within ADA_STATE_RTOL. The optimizer streams over
    the experts, so its extra memory (the peak past what the parameter,
    grad and state hold) is a few experts' f32 temporaries."""
    from repro_torch.optim import adafactor, constant_schedule

    if shape is None:
        cfg = get_arctic_cfg()
        shape = (cfg.moe.num_experts, cfg.d_model, cfg.d_ff)
    E = shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    p = torch.empty(shape, dtype=torch.bfloat16, device=device)
    g = torch.empty_like(p)
    for e in range(E):          # an expert at a time: no f32 copy of it
        p[e] = 0.02 * torch.randn(shape[1:], generator=gen, device=device)
        g[e] = (1e-3 * (1 + e % 4)) * torch.randn(shape[1:], generator=gen,
                                                  device=device)
    p0 = p.clone()
    opt = adafactor(constant_schedule(ARCTIC_LR))
    state = opt.init({"w": p})
    _sync(device)
    base = torch.cuda.memory_allocated() if _on_card(device) else 0
    _peak_start(device)
    t0 = time.monotonic()
    opt.apply({"w": p}, {"w": g}, state, 0)
    _sync(device)
    apply_s = time.monotonic() - t0
    extra = (torch.cuda.max_memory_allocated() - base) / 2**30 \
        if _on_card(device) else None
    leaf_gb = p.numel() * 4 / 2**30            # one f32 copy of the leaf

    def u64(e):                  # step 0: beta = 1 - 1^-0.8 = 0
        g64 = g[e].double()
        g2 = g64 * g64 + 1e-30
        vr, vc = g2.mean(-1), g2.mean(-2)
        rfac = torch.rsqrt(vr / torch.clamp(vr.mean(), min=1e-30))
        return g64 * rfac[:, None] * torch.rsqrt(vc)[None, :], vr, vc

    t0 = time.monotonic()
    ssq, state_err = 0.0, 0.0
    for e in range(E):
        u, vr, vc = u64(e)
        ssq += float((u * u).sum())
        for got, want in ((state["w"]["vr"][e], vr),
                          (state["w"]["vc"][e], vc)):
            state_err = max(state_err, float(
                ((got.double() - want).abs() / want).max()))
    rms = math.sqrt(ssq / p.numel() + 1e-30)
    denom = max(1.0, rms)                      # clip_threshold 1
    worst, changed = 0.0, 0
    for e in range(E):
        u, _, _ = u64(e)
        p64, step = p0[e].double(), ARCTIC_LR * u / denom
        want = p64 - step
        err = (p[e].double() - want).abs()
        limit = ADA_ULP * want.abs() + ADA_F32 * (p64.abs() + step.abs())
        worst = max(worst, float((err / limit.clamp(min=1e-30)).max()))
        changed += int((p[e] != p0[e]).sum())
    ref_s = time.monotonic() - t0
    out = dict(shape=list(shape), apply_s=apply_s, ref_s=ref_s, rms=rms,
               err_over_ulp=worst, state_rel_err=state_err,
               changed_share=changed / p.numel(), extra_gib=extra,
               leaf_f32_gib=leaf_gb)
    checks = {
        "each new parameter within one bf16 ulp of f64 (+ f32 terms)":
            worst <= 1.0,
        f"vr and vc within {ADA_STATE_RTOL:g} of f64":
            state_err <= ADA_STATE_RTOL,
        "the update changed parameters": changed > 0,
        "extra memory below one f32 copy of the leaf":
            extra is None or extra < leaf_gb,
    }
    log(f"  (b1) adafactor on {tuple(shape)} bf16: apply {apply_s:.2f}s, "
        f"f64 reference {ref_s:.2f}s; RMS(u) {rms:.4f}; err / bound "
        f"{worst:.3f}; vr/vc rel err {state_err:.2e}; changed "
        f"{changed / p.numel():.1%}; extra memory "
        f"{'n/a' if extra is None else f'{extra:.2f} GiB'} (one f32 copy "
        f"of the leaf: {leaf_gb:.1f} GiB)")
    del p, g, p0, state
    if _on_card(device):
        torch.cuda.empty_cache()
    return dict(out, checks=checks)


def fingerprint(t: torch.Tensor) -> tuple:
    """(Σ bits, Σ bits²) of ``t``'s elements read as integers, CHUNK
    elements at a time: any change of an element changes it (short of a
    collision), and no copy of the tensor is kept."""
    bits = t.detach().reshape(-1).view(
        {2: torch.int16, 4: torch.int32}[t.element_size()])
    s1 = s2 = 0
    for lo in range(0, bits.numel(), CHUNK):
        c = bits[lo:lo + CHUNK].to(torch.int64)
        s1 += int(c.sum())
        s2 += int((c * c).sum())
    return s1, s2


def arctic_train_step(lm, cfg, shape=ARCTIC_TRAIN_SHAPE,
                      device="cuda") -> dict:
    """Phase 16 (b2): one adafactor train step of ``lm`` (the served model,
    bf16 parameters, so bf16 grads) on step 0's batch of ``shape``: loss
    and grad norm finite, every parameter changed (its fingerprint), the
    loss on the same batch after the step below the loss before it, flash
    once a layer (remat off; its backward is torch math), on wgmma."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.optim import constant_schedule, make_optimizer
    from repro_torch.train.step import init_state, make_train_step

    B, S = shape
    batch = make_batch(cfg, ShapeConfig("arctic", S, B, "train"), 0,
                       DataConfig(SEED))
    rt = dataclasses.replace(lm.rt, remat=False)
    lm.rt = rt
    opt = make_optimizer(cfg.optimizer, constant_schedule(ARCTIC_LR))
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, rt)
    before = {k: fingerprint(p) for k, p in lm.named_parameters()}
    calls = {}
    core = record_calls(ops, calls)
    try:
        _peak_start(device)
        fa.launches = 0
        fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
        t0 = time.monotonic()
        state, m = step(state, batch)
        _sync(device)
        step_s = time.monotonic() - t0
        launches, variants = fa.launches, dict(fa.launches_by_variant)
        peak = _peak_gib(device)
    finally:
        ops.flash_attention = core
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    unchanged = [k for k, p in lm.named_parameters()
                 if fingerprint(p) == before[k]]
    for p in lm.parameters():
        p.grad = None
    lm.requires_grad_(False)
    del state, step
    with torch.no_grad():
        after = float(lm.loss({k: torch.as_tensor(v).to(device)
                               for k, v in batch.items()}))
    L = cfg.num_layers
    checks = {
        "loss and grad norm finite": math.isfinite(loss)
        and math.isfinite(gnorm) and gnorm > 0,
        "every parameter changed": not unchanged,
        "the loss on the batch fell": after < loss,
        "flash once a layer, on wgmma": launches == L and variants == dict(
            splitkv=0, wgmma=L, ffma=0),
    }
    log(f"  (b2) adafactor step on {B} x {S} (routing groups of "
        f"{cfg.moe.group_size}): loss {loss:.6f} -> {after:.6f} after the "
        f"step, grad norm {gnorm:.4f}, {step_s:.2f}s, peak "
        f"{'n/a' if peak is None else f'{peak:.2f} GiB'}; flash {launches} "
        f"{json.dumps(variants)}; unchanged {unchanged}")
    return dict(loss=loss, loss_after=after, grad_norm=gnorm, step_s=step_s,
                peak_gib=peak, launches=launches, flash_variants=variants,
                checks=checks,
                call_shapes=sorted([*k, v] for k, v in calls.items()))


def ckpt_batches(cfg, batch: int = TP_BATCH, seq: int = TP_SEQ) -> list:
    """Steps 0 and 1's batches of (c) (``make_batch`` keyed on the step, as
    the Trainer draws them)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch

    shape = ShapeConfig("train_4k", seq, batch, "train")
    return [make_batch(cfg, shape, k, DataConfig(SEED)) for k in (0, 1)]


def ckpt_rank(group, cfg, root: str, batches, device="cuda") -> dict:
    """One rank of phase 16 (c): adafactor, CKPT_RUN; step 0, then an
    ``AsyncSaver`` save as step 1 (the shards gathered and the host
    snapshot taken in this thread; world rank 0 writes the files in the
    background while step 1 runs), step 1 with its launches against the
    graphs' (``tp.recording``, ``tp.step_launches``), saved as step 2; then
    the step-1 checkpoint restored into the same state and step 1 again:
    its loss, grad norm and this rank's parameters against the
    uninterrupted step's. Every part timed."""
    from repro_torch.checkpoint import store
    from repro_torch.core import tp as tp_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import adafactor, constant_schedule
    from repro_torch.runtime import Runtime, TPConfig
    from repro_torch.train.step import (init_state, make_train_step,
                                        state_placement)

    torch.backends.cuda.matmul.allow_tf32 = False
    secs = {}
    t0 = time.monotonic()
    mode, mb, dtype = CKPT_RUN
    rt = Runtime(compute_dtype=dtype, remat=False,
                 tp=TPConfig(mode=mode, microbatches=mb))
    lm = build_model(cfg, rt, device=device, seed=SEED, group=group)
    if _on_card(device):
        torch.cuda.empty_cache()      # the whole model drawn for the shards
    opt = adafactor(constant_schedule(TRAIN_LR))
    state = init_state(lm, opt)
    step = make_train_step(lm, opt, rt)
    place = state_placement(lm, opt)
    saver = store.AsyncSaver(root, lm.mesh, place)
    B, S = batches[0]["tokens"].shape
    calls = {}

    def shapes(a, b, _inner=ops.matmul, **k):
        key = (*a.shape, b.shape[1], str(a.dtype).replace("torch.", ""),
               mmk.layout(a, b))
        calls[key] = calls.get(key, 0) + 1
        return _inner(a, b, **k)

    ops.matmul = shapes
    flash_calls = {}
    record_calls(ops, flash_calls)

    def timed(name, fn, *a, **kw):
        t = time.monotonic()
        out = fn(*a, **kw)
        _sync(device)
        secs[name] = time.monotonic() - t
        return out

    def step_one():
        mmk.launches = fa.launches = 0
        with tp_mod.recording() as rec:
            _, m = step(state, batches[1])
        _sync(device)
        derived = tp_mod.step_launches(rec, B, S, cfg.d_model,
                                       rt.dtype.itemsize)
        return (float(m["loss"]), float(m["grad_norm"]),
                (mmk.launches, fa.launches),
                (derived["matmul"], derived["flash"]))

    secs["build"] = time.monotonic() - t0
    timed("step0", step, state, batches[0])
    timed("save1", saver.save, state, 1)
    first = timed("step1", step_one)
    timed("save2", saver.save, state, 2)       # waits for step 1's file
    kept = {k: p.detach().clone() for k, p in lm.named_parameters()}
    _, manifest = timed("restore", store.restore, root, state,
                        placement=place, step=1)
    ckpt = {k: p.detach().clone() for k, p in lm.named_parameters()}
    again = timed("step1_again", step_one)
    bitwise = first[:2] == again[:2] and all(
        torch.equal(kept[k], p.detach()) for k, p in lm.named_parameters())
    ratio = 0.0
    for k, p in lm.named_parameters():
        want = kept[k]
        limit = TRAIN_RTOL * float((want - ckpt[k]).abs().max()) \
            + CKPT_ROUNDING * want.abs()
        ratio = max(ratio, float(((p.detach() - want).abs()
                                  / limit).max()))
    del kept, ckpt
    timed("wait", saver.wait)                  # step 2's file on disk
    return dict(loss=first[0], grad_norm=first[1], launches=first[2],
                derived=first[3], again=again, bitwise=bitwise,
                param_ratio=ratio, seconds=secs,
                restored_step=manifest["step"],
                sharded=sum(1 for k in place if k.startswith("params")),
                opt_sharded=sum(1 for k in place if k.startswith("opt")),
                call_shapes=sorted([*k, v] for k, v in calls.items()),
                flash_shapes=sorted([*k, v] for k, v in flash_calls.items()))


def phase_ckpt(cfg, device="cuda", world: int = TP_WORLD,
               batches=None) -> dict:
    """Phase 16 (c): :func:`ckpt_rank` on ``world`` gloo ranks, then the
    ring's step-1 checkpoint restored on one device and step 1 there: its
    loss and grad norm within F32_LOSS_RTOL / TRAIN_RTOL of the ring's, its
    parameters against the ring's step-2 checkpoint by the CKPT bound; the
    ring's second step 1 from the checkpoint by the same rules (and
    whether it was bitwise). Launches on the ring equal the graphs';
    one device's flash once a layer. One device restores and steps while
    the ring goes on (its step-1 checkpoint is complete once its directory
    exists: the writer renames it into place)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.checkpoint import store
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import build_model
    from repro_torch.optim import adafactor, constant_schedule
    from repro_torch.runtime import Runtime
    from repro_torch.train.step import init_state, make_train_step

    batches = batches or ckpt_batches(cfg)
    root = tempfile.mkdtemp(prefix="ckpt_")
    pool = ThreadPoolExecutor(1)
    try:
        t0 = time.monotonic()
        ring = pool.submit(run_ranks, ckpt_rank, world, cfg, root, batches,
                           device, device=device, timeout=900)
        first = os.path.join(root, "step_00000001")
        while not os.path.isdir(first):
            if ring.done():
                ring.result()              # the ring failed before it
            time.sleep(0.1)
        ckpt_gb = os.path.getsize(os.path.join(first, "arrays.npz")) / 1e9
        t1 = time.monotonic()
        lm = build_model(cfg, Runtime(compute_dtype=CKPT_RUN[2],
                                      remat=False), device=device, seed=None)
        opt = adafactor(constant_schedule(TRAIN_LR))
        state = init_state(lm, opt)
        _, manifest = store.restore(root, state, step=1)
        start = {k: p.detach().clone() for k, p in lm.named_parameters()}
        calls = {}
        core = record_calls(ops, calls)
        try:
            fa.launches = 0
            _, m = make_train_step(lm, opt, lm.rt)(state, batches[1])
            _sync(device)
            launches = fa.launches
        finally:
            ops.flash_attention = core
        one_s = time.monotonic() - t1
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ranks = ring.result()
        ring_s = time.monotonic() - t0
        head = ranks[0]
        whole, _ = store.read(root, 2)
        ratio = 0.0
        for k, p in lm.named_parameters():
            want = torch.as_tensor(whole[f"params::{k}"]).to(device)
            upd = float((want - start[k]).abs().max())
            limit = TRAIN_RTOL * upd + CKPT_ROUNDING * want.abs()
            ratio = max(ratio, float(((p.detach() - want).abs()
                                      / limit).max()))
        del lm, state, whole, start
        if _on_card(device):
            torch.cuda.empty_cache()
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(root, ignore_errors=True)
    rel = lambda a, b: abs(a - b) / abs(b)        # noqa: E731
    checks = {
        "ranks agree": len({(r["loss"], r["grad_norm"]) for r in ranks})
        == 1,
        "ring launches = graphs": all(
            r["launches"] == r["derived"] and min(r["derived"]) > 0
            for r in ranks),
        "the checkpoint restored step 1 on every layout": manifest["step"]
        == 1 and all(r["restored_step"] == 1 for r in ranks),
        "sharded parameters and adafactor state gathered": head["sharded"]
        > 0 and head["opt_sharded"] > 0,
        "one device: loss within F32_LOSS_RTOL of the ring's":
            rel(loss, head["loss"]) <= F32_LOSS_RTOL,
        "one device: grad norm within TRAIN_RTOL":
            rel(gnorm, head["grad_norm"]) <= TRAIN_RTOL,
        "one device: parameters within the bound": ratio <= 1.0,
        "one device: flash once a layer": launches == cfg.num_layers,
        "ring again: loss and grad norm": all(
            rel(r["again"][0], r["loss"]) <= F32_LOSS_RTOL
            and rel(r["again"][1], r["grad_norm"]) <= TRAIN_RTOL
            and r["again"][2:] == (r["launches"], r["derived"])
            for r in ranks),
        "ring again: parameters within the bound": all(
            r["param_ratio"] <= 1.0 for r in ranks),
    }
    bitwise = all(r["bitwise"] for r in ranks)
    log(f"  (c) {world} ranks {ring_s:.1f}s (rank 0: "
        f"{json.dumps({k: round(v, 2) for k, v in head['seconds'].items()})}"
        f"; checkpoint {ckpt_gb:.2f} GB, "
        f"{head['sharded']} parameters and {head['opt_sharded']} adafactor "
        f"tensors gathered); ring step 1 loss {head['loss']:.7f} grad norm "
        f"{head['grad_norm']:.6f}, launches {head['launches']} (graphs "
        f"{head['derived']}); one device from the checkpoint "
        f"{one_s:.1f}s (beside the ring): loss {loss:.7f} (rel {rel(loss, head['loss']):.2e}) "
        f"grad norm {gnorm:.6f} (rel {rel(gnorm, head['grad_norm']):.2e}), "
        f"params err/bound {ratio:.3f}, flash {launches}; ring again from "
        f"the checkpoint: bitwise {bitwise}, params err/bound "
        f"{max(r['param_ratio'] for r in ranks):.3f}")
    return dict(loss=head["loss"], grad_norm=head["grad_norm"], checks=checks,
                one_device=dict(loss=loss, grad_norm=gnorm,
                                param_ratio=ratio, flash_launches=launches),
                bitwise=bitwise, ckpt_gb=ckpt_gb, ring_s=ring_s,
                one_s=one_s,
                matmul_launches=sum(2 * r["launches"][0] for r in ranks),
                flash_launches=sum(2 * r["launches"][1] for r in ranks)
                + launches,
                call_shapes=sorted({tuple(c[:-1]) for r in ranks
                                    for c in r["call_shapes"]}),
                flash_shapes=sorted({tuple(c[:-1]) for r in ranks
                                     for c in r["flash_shapes"]}
                                    | {k for k in calls}))


def scripted_reference(lm, cfg) -> dict:
    """Phase 11 (a)'s scripted schedule (:func:`moe_scripted_steps`) on the
    one-device MoE model ``lm`` in its runtime: the logits and routing
    records phase 17 holds the ring to, and the steps."""
    steps = moe_scripted_steps(cfg, serve_traffic())
    routes, restore = routing_probe()
    try:
        t0 = time.monotonic()
        logits, _ = run_scripted(lm, steps, BLOCK_SIZE)
        _sync(lm.device)
    finally:
        restore()
    log(f"  {cfg.name}: the scripted schedule in {lm.rt.compute_dtype} on "
        f"one device, {time.monotonic() - t0:.2f}s (phase 17's reference)")
    return dict(logits=logits, routes=list(routes), steps=steps)


def phase_arctic(fa) -> tuple:
    """Phase 16: (a) :func:`phase_arctic_serve` and, on the served model
    before (b2) changes it, :func:`scripted_reference` (phase 17 (b)'s
    reference), (b1) :func:`adafactor_leaf_check`, (b2)
    :func:`arctic_train_step` of the served model, (c) :func:`phase_ckpt`;
    each part returns its checks, and the phase fails on the first part
    with a check that did not hold. Returns (the launches, the call shapes
    and the seconds of each part; phase 17 (b)'s reference)."""
    import gc

    t0 = time.monotonic()
    out = dict(seconds={})

    def part(name, fn, *a):
        t = time.monotonic()
        log(f"  ({name})")
        res = fn(*a)
        out["seconds"][name] = time.monotonic() - t
        checks = (res[0] if isinstance(res, tuple) else res)["checks"]
        failed = [k for k, v in checks.items() if not v]
        if failed:
            raise AssertionError(f"phase 16 ({name}): failed {failed}")
        return res

    cfg = get_arctic_cfg()
    out["a"], lm, engine = part("a", phase_arctic_serve, cfg, fa)
    ref = dict(scripted_reference(lm, cfg), **engine)
    gc.collect()
    torch.cuda.empty_cache()
    out["b1"] = part("b1", adafactor_leaf_check)
    out["b2"] = part("b2", arctic_train_step, lm, cfg)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    out["c"] = part("c", phase_ckpt, get_tp_cfg().scaled(
        num_layers=CKPT_LAYERS))
    out.update(
        flash_launches=out["a"]["launches"] + out["b2"]["launches"]
        + out["c"]["flash_launches"],
        matmul_launches=out["c"]["matmul_launches"],
        call_shapes=out["c"]["call_shapes"],
        flash_shapes=sorted({tuple(c[:-1]) for k in ("a", "b2")
                             for c in out[k]["call_shapes"]}
                            | set(out["c"]["flash_shapes"])))
    out["seconds"]["total"] = time.monotonic() - t0
    log(f"  phase 16: {out['seconds']['total']:.1f}s "
        f"({json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})})"
        f"; flash {out['flash_launches']}, matmul {out['matmul_launches']}")
    return out, ref


# ---------------------------------------------------------------------------
# phase 17: MoE serving on a ring (mixtral-8x7b, arctic-480b)
# ---------------------------------------------------------------------------


def moe_ring_rank(group, tr: dict, cases, device="cuda") -> dict:
    """One rank of phase 17. ``cases``: [(name, cfg, runtime, steps,
    prompts, scripted dtype)]: the model drawn from seed SEED on the ring
    in ``runtime`` (ranks sharing a card take turns), then (1) the scripted
    ``serve_step`` schedule ``steps`` in the scripted dtype and (2) the
    paged ``Engine`` in bf16 on ``prompts``. Each run sets the kernels'
    launch counts to 0 just before it and reads them just after, beside
    ``tp.serve_launches`` of the serve graphs it recorded and the expert
    GEMMs those graphs hold; it keeps the routing records (rank 0) and
    their digests, the logits digests (the logits on rank 0), the call
    shapes, the seconds and the peak memory. The model is freed before the
    next case is drawn."""
    import dataclasses
    import gc
    import hashlib

    from repro_torch.core import tp as tp_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.runtime import TPConfig
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    mm_calls, fa_calls = {}, {}

    def shapes(a, b, _inner=ops.matmul, **k):
        key = (*a.shape, b.shape[1], str(a.dtype).replace("torch.", ""))
        mm_calls[key] = mm_calls.get(key, 0) + 1
        return _inner(a, b, **k)

    ops.matmul = shapes
    record_calls(ops, fa_calls)
    routes, _ = routing_probe()
    keep = group.rank == 0

    def digest(record) -> str:
        h = hashlib.sha256()
        for a in record:
            h.update(a.tobytes())
        return h.hexdigest()

    def expert_calls(graph) -> int:
        return sum(getattr(n.fn, "matmul_calls", 0) for n in graph.nodes
                   if n.op in ("custom", "expert_ar"))

    out = {}
    for name, cfg, rt, steps, prompts, dtype in cases:
        t0 = time.monotonic()
        rt = dataclasses.replace(rt, tp=TPConfig(mode="cais"))
        lm = LM(cfg, rt, device=device, seed=SEED, group=group)
        if _on_card(device):
            torch.cuda.empty_cache()    # the whole model drawn for the shards
        res = dict(build_s=time.monotonic() - t0)
        expert_kn = {(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)}
        for run in ("scripted", "engine"):
            lm.rt = dataclasses.replace(
                rt, compute_dtype=dtype if run == "scripted" else "bfloat16")
            routes.clear()
            mm_calls.clear()
            fa_calls.clear()
            _peak_start(device)
            mmk.launches = fa.launches = 0
            mmk.launches_by_variant = dict.fromkeys(mmk.COUNTERS, 0)
            fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
            t0 = time.monotonic()
            with tp_mod.recording() as rec:
                if run == "scripted":
                    logits, digests = run_scripted(lm, steps, tr["block"],
                                                   keep=keep)
                    r = dict(logits=logits, digests=digests)
                else:
                    reqs = [Request(rid=i, prompt=p,
                                    max_new_tokens=tr["max_new"])
                            for i, p in enumerate(prompts)]
                    eng = Engine(lm, cfg, lm.rt, serve_config(tr),
                                 device=lm.device)
                    eng.run(reqs, seed=SEED)
                    r = dict(tokens=[list(q.out_tokens) for q in reqs],
                             finished=all(q.done and len(q.out_tokens)
                                          == tr["max_new"] for q in reqs),
                             report=dict(eng.last_report), steps=eng.steps)
                    del eng         # it holds the model
            _sync(device)
            wall = time.monotonic() - t0
            launches = dict(matmul=mmk.launches, flash=fa.launches)
            decode = sum(tp_mod.flash_calls(g) for _, g, (_, S, _), _
                         in rec.serve if S == 1)
            prefill = sum(tp_mod.flash_calls(g) for _, g, (_, S, _), _
                          in rec.serve if S > 1)
            f32 = lm.rt.compute_dtype == "float32"
            r.update(
                dtype=lm.rt.compute_dtype, wall_s=wall,
                peak_gib=_peak_gib(device), launches=launches,
                derived=tp_mod.serve_launches(rec),
                serve_periods=len(rec.serve),
                matmul_variants=mmk.variant_totals(),
                flash_variants=dict(fa.launches_by_variant),
                flash_expected=dict(splitkv=decode,
                                    wgmma=0 if f32 else prefill,
                                    ffma=prefill if f32 else 0),
                expert_calls=sum(n for (_, k, n_, _), n in mm_calls.items()
                                 if (k, n_) in expert_kn),
                expert_derived=sum(expert_calls(g) for _, g, _, _
                                   in rec.serve),
                experts=tp_mod.serve_experts(cfg, tp_mod.TPContext.from_config(
                    lm.rt.tp, lm.group)),
                routes=list(routes) if keep else None,
                route_digests=[digest(x) for x in routes],
                matmul_shapes=sorted([*k, v] for k, v in mm_calls.items()),
                flash_shapes=sorted([*k, v] for k, v in fa_calls.items()))
            res[run] = r
        del lm
        gc.collect()
        if _on_card(device):
            torch.cuda.empty_cache()
        out[name] = res
    return out


def routed_alike(got, want):
    """Per token of two routing records (:func:`compact_routing`): the same
    two experts, each kept or dropped alike (the slot inside a kept
    buffer changes no token's output)."""
    return ((got[:, 0] == want[:, 0]) & (got[:, 2] == want[:, 2])
            & ((got[:, 1] >= 0) == (want[:, 1] >= 0))
            & ((got[:, 3] >= 0) == (want[:, 3] >= 0)))


def held_rows(got: list, want: list, steps, layers: int) -> list:
    """Per step of ``steps``, the rows whose logits depend only on tokens
    that routed alike in ``got`` and the reference ``want`` (one record a
    layer a step): every token of the row at this step and every earlier
    one in each layer but the last (their K/V reach later layers), and the
    row's last token in the last layer."""
    import numpy as np

    B = steps[0][0].shape[0]
    ok = np.ones(B, bool)
    out = []
    for i, (toks, view) in enumerate(steps):
        for layer in range(layers):
            k = i * layers + layer
            alike = routed_alike(got[k][0], want[k][0]).reshape(B, -1)
            if layer < layers - 1:
                ok &= alike.all(1)
            else:
                out.append(ok & alike[np.arange(B), view[3]])
    return out


def moe_ring_checks(ranks: list, cases, refs: dict, rel_bound: float
                    ) -> tuple:
    """Phase 17's checks on what the ranks returned (:func:`moe_ring_rank`)
    against the one-device references ``refs`` ({name: logits, routes,
    tokens, report}). f32 runs: the routing rule, then the logits within
    LOGIT_TOL for the steps before the first routing difference; bf16
    runs: the routing differences counted, each step's logits within
    ``rel_bound`` over :func:`held_rows`. Every run: routing and logits
    bitwise rank 0's, the launches the recorded graphs'. Returns (rows,
    failed); a check that reads a launch counter says "launches"."""
    import numpy as np

    rows, failed = [], []
    for name, cfg, _, steps, _, _ in cases:
        per = [rk[name] for rk in ranks]
        ref = refs[name]
        L = cfg.num_layers
        E_loc = cfg.moe.num_experts // len(ranks)
        row = dict(model=name, build_s=[p["build_s"] for p in per])
        for run in ("scripted", "engine"):
            rs = [p[run] for p in per]
            head = rs[0]
            f32 = head["dtype"] == "float32"
            n_steps = head["serve_periods"] // -(-L // len(cfg.layer_pattern))
            checks = {
                "routing bitwise equal across ranks": all(
                    r["route_digests"] == head["route_digests"] for r in rs),
                "routing: one record a layer a step":
                    len(head["route_digests"]) == n_steps * L > 0,
                "flash launches: once a layer a step": all(
                    r["launches"]["flash"] == r["derived"]["flash"]
                    == n_steps * L for r in rs),
                "flash launches by variant (decode splitkv; prefill ffma "
                "f32, wgmma bf16)": all(
                    r["flash_variants"] == r["flash_expected"] for r in rs),
                "matmul launches = the recorded serve graphs'": all(
                    r["launches"]["matmul"] == r["derived"]["matmul"] > 0
                    for r in rs),
                "matmul launches by variant (f32 ffma, bf16 wgmma)": all(
                    r["matmul_variants"] == (
                        dict(wgmma=0, ffma=r["launches"]["matmul"]) if f32
                        else dict(wgmma=r["launches"]["matmul"], ffma=0))
                    for r in rs),
                "expert GEMMs: three an owned expert a layer a step, each "
                "through the matmul kernel": all(
                    r["expert_calls"] == r["expert_derived"]
                    == 3 * E_loc * L * n_steps for r in rs),
                "one all-reduce node an MoE layer a step": all(
                    r["derived"]["allreduce"] == n_steps * L for r in rs),
                "every expert computed once over the ring": sorted(
                    e for r in rs for e in range(*r["experts"][:2]))
                == list(range(cfg.moe.num_experts)),
            }
            out = dict(run=run, dtype=head["dtype"], steps=n_steps,
                       wall_s=[r["wall_s"] for r in rs],
                       peak_gib=[r["peak_gib"] for r in rs],
                       launches=head["launches"], derived=head["derived"],
                       flash_variants=head["flash_variants"],
                       matmul_variants=head["matmul_variants"],
                       expert_calls=head["expert_calls"])
            if run == "scripted":
                diff = routing_differences(head["routes"], ref["routes"])
                checks["logits bitwise equal across ranks"] = all(
                    r["digests"] == head["digests"] for r in rs)
                checks["finite logits"] = all(
                    np.isfinite(lg).all() for lg in head["logits"])
                if f32:
                    held = (len(steps) if diff["first"] is None
                            else diff["first"] // L)
                    over = [float((np.abs(g - w) / (
                        LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * np.abs(w))
                        ).max()) for g, w in zip(head["logits"],
                                                 ref["logits"])]
                    checks[f"routing differences at gaps < {ROUTE_TOL:g}"] \
                        = routing_rule(diff)
                    checks["logits within LOGIT_TOL where the routing "
                           "agreed"] = held > 0 and all(
                        o <= 1.0 for o in over[:held])
                    out.update(logits_held_steps=held,
                               logits_err_over_tol=over)
                else:
                    rows_held = held_rows(head["routes"], ref["routes"],
                                          steps, L)
                    rel = [float(np.linalg.norm(g[h] - w[h])
                                 / np.linalg.norm(w[h])) if h.any() else None
                           for g, w, h in zip(head["logits"], ref["logits"],
                                              rows_held)]
                    checks[f"bf16 logits within {rel_bound:.6g} (relative) "
                           "over the rows whose routing agreed, every "
                           "step"] = all(x is not None and x <= rel_bound
                                         for x in rel)
                    out.update(rows_held=[int(h.sum()) for h in rows_held],
                               logits_rel=rel, rel_bound=rel_bound)
                out.update(routing=diff)
            else:
                toks = head["tokens"]
                checks["every request finished"] = all(
                    r["finished"] for r in rs)
                checks["tokens inside the vocabulary"] = all(
                    0 <= t < cfg.vocab_size for q in toks for t in q)
                checks["tokens equal across ranks"] = all(
                    r["tokens"] == toks for r in rs)
                first = [next((i for i, (a, b) in enumerate(zip(g, w))
                               if a != b), None)
                         for g, w in zip(toks, ref["tokens"])]
                out.update(
                    engine_steps=head["steps"],
                    ttft_p50_ms=head["report"]["ttft_p50_ms"],
                    per_token_p50_ms=head["report"]["per_token_p50_ms"],
                    one_device_ttft_p50_ms=ref["report"]["ttft_p50_ms"],
                    one_device_per_token_p50_ms=ref["report"][
                        "per_token_p50_ms"],
                    first_token_difference=first)
            out["checks"] = checks
            row[run] = out
            failed += [(name, run, k) for k, v in checks.items() if not v]
        rows.append(row)
    return rows, failed


def phase_moe_ring(moe_ref: dict, arctic_ref: dict, rel_bound: float
                   ) -> dict:
    """Phase 17: :func:`moe_ring_rank` on TP_WORLD gloo ranks sharing the
    card, spawned once, serving mixtral-8x7b (scripted in f32) and then
    arctic-480b (scripted in bf16), each held by :func:`moe_ring_checks`
    to its one-device reference: phase 11 (a)'s and phase 16's."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.runtime import runtime_for

    gc.collect()
    torch.cuda.empty_cache()
    tr = serve_traffic()
    cases = [("mixtral", get_moe_cfg(), runtime_for(get_arch(MOE_ARCH)),
              moe_ref["steps"], moe_ref["prompts"], "float32"),
             ("arctic", get_arctic_cfg(),
              runtime_for(get_arch(ARCTIC_ARCH)), arctic_ref["steps"],
              arctic_ref["prompts"], "bfloat16")]
    t0 = time.monotonic()
    ranks = run_ranks(moe_ring_rank, TP_WORLD, tr, cases, device="cuda",
                      timeout=900)
    wall = time.monotonic() - t0
    rows, failed = moe_ring_checks(ranks, cases, dict(
        mixtral=moe_ref, arctic=arctic_ref), rel_bound)
    for row in rows:
        log(f"  ({'a' if row['model'] == 'mixtral' else 'b'}) "
            f"{row['model']}: drawn on the ring in "
            f"{max(row['build_s']):.1f}s")
        for run in ("scripted", "engine"):
            r = row[run]
            log(f"    {run} {r['dtype']}: {r['steps']} steps, "
                + ", ".join(f"{k} {json.dumps(r[k])}" for k in (
                    "routing", "logits_held_steps", "logits_err_over_tol",
                    "rows_held", "logits_rel", "rel_bound", "engine_steps",
                    "ttft_p50_ms", "per_token_p50_ms",
                    "one_device_ttft_p50_ms", "one_device_per_token_p50_ms",
                    "first_token_difference") if k in r)
                + f"; per rank: matmul {r['launches']['matmul']} (graphs "
                f"{r['derived']['matmul']}; experts {r['expert_calls']}; "
                f"{json.dumps(r['matmul_variants'])}), flash "
                f"{r['launches']['flash']} {json.dumps(r['flash_variants'])}"
                f", all-reduce nodes {r['derived']['allreduce']}; "
                f"{max(r['wall_s']):.2f}s; peak {r['peak_gib']} GiB by rank")
    if failed:
        raise AssertionError(f"phase 17: failed {failed}")
    total = {k: sum(p[n][run]["launches"][k] for p in ranks
                    for n in ("mixtral", "arctic")
                    for run in ("scripted", "engine"))
             for k in ("matmul", "flash")}
    log(f"  {TP_WORLD} ranks in {wall:.1f}s (spawn and weights included; "
        "gloo stages every hop through the host: correctness, not TP "
        f"speed); launches over all ranks and runs: matmul "
        f"{total['matmul']}, flash {total['flash']}")
    shapes = {k: sorted({tuple(s[:-1]) for p in ranks for n in p
                         for run in ("scripted", "engine")
                         for s in p[n][run][k]})
              for k in ("matmul_shapes", "flash_shapes")}
    return dict(runs=rows, wall_s=wall, matmul_launches=total["matmul"],
                flash_launches=total["flash"], **shapes)


def main() -> int:
    global T_START
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    # four ranks share the card in phases 6, 9, 10 and 11; growable
    # segments keep each one's cached blocks from fragmenting the 80 GB
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.hw import H100
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import matmul_rmsnorm as mln
    from repro_torch.kernels import nvcc, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = T_START = time.monotonic()

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

    log(f"phase 6: {TP_ARCH} LM.loss at full width cut to {TP_LAYERS} "
        f"layers, {TP_WORLD} TP ranks on one card over gloo")
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

    log(f"phase 9: one {TP_ARCH} training step at full width cut to "
        f"{TP_LAYERS} layers, "
        f"{TP_WORLD} TP ranks on one card over gloo, against one device")
    log("  " + smi)
    train = phase_train(runs=TRAIN_RUNS + TRAIN_2D_RUNS)
    checked = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"],
                r["dtype"], r["layout"]) for r in mm_rows}
    unchecked = [("matmul", s) for s in train["call_shapes"]
                 if tuple(s) not in checked]
    unchecked += [("flash_attention", s) for s in train["flash_shapes"]
                  if tuple(s) not in checked_fa]
    if unchecked:
        raise AssertionError(f"phase 9 called kernels at shapes phase 3 did "
                             f"not check: {unchecked}")
    flat = next(r for r in train["runs"] if r["mesh"] == "flat"
                and (r["mode"], r["requested_mb"], r["dtype"], r["planner"])
                == ("cais", 2, "float32", "greedy"))
    for r in train["runs"]:
        if r["mesh"] != "flat":
            log(f"  2D {r['mode']} mb {r['mb']}: loss {r['loss']:.7f}, the "
                f"flat cais mb 2 f32 run's {flat['loss']:.7f} (difference "
                f"{r['loss'] - flat['loss']:.3e})")
    log("  train " + json.dumps(train))

    log(f"phase 10: paged serving of {TP_ARCH} at full width cut to "
        f"{TP_LAYERS} layers, and "
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

    log(f"phase 11: MoE, {MOE_ARCH} at full width cut to {MOE_LAYERS} "
        f"layers: served on one device, and one training step on "
        f"{TP_WORLD} TP ranks on one card over gloo against one device")
    log("  " + smi)
    moe, moe_ref = phase_moe(fa)
    unchecked = [("flash_attention", s) for s in moe["serve"]["call_shapes"]
                 if tuple(s[:-1]) not in checked_fa]
    checked = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"],
                r["dtype"], r["layout"]) for r in mm_rows}
    unchecked += [("matmul", s) for s in moe["train"]["call_shapes"]
                  if tuple(s) not in checked]
    if unchecked:
        raise AssertionError(f"phase 11 called kernels at shapes phase 3 "
                             f"did not check: {unchecked}")
    log("  moe " + json.dumps(moe))

    log("phase 12: data parallelism and the 2D mesh on 4 gloo ranks sharing "
        "the card (and the launcher's 8), against one device")
    log("  " + smi)
    topo = phase_topology()
    unchecked = [(k, s) for k in ("dp", "grouped_ep")
                 for s in topo[k]["call_shapes"] if tuple(s) not in checked]
    if unchecked:
        raise AssertionError(f"phase 12 called matmul at shapes phase 3 did "
                             f"not check: {unchecked}")
    log("  topo " + json.dumps(topo))

    log(f"phase 13: TP training past whole blocks: {MLA_ARCH} (MLA) cut to "
        f"{MLA_TRAIN_LAYERS} layers, and {TP_ARCH} cut to {RAGGED_LAYERS} "
        f"at ragged S and without sequence parallelism, {TP_WORLD} TP ranks "
        "on one card over gloo, against one device")
    log("  " + smi)
    subl = phase_subl()
    checked_mln = {(r["shape"]["M"], r["shape"]["K"], r["shape"]["N"],
                    r["shape"]["ldb"], r["dtype"]) for r in mln_rows}
    unchecked = [("matmul", s_) for s_ in subl["call_shapes"]
                 if tuple(s_) not in checked]
    unchecked += [("matmul_rmsnorm", s_) for s_ in subl["norm_shapes"]
                  if tuple(s_) not in checked_mln]
    unchecked += [("flash_attention", s_) for s_ in subl["flash_shapes"]
                  if tuple(s_) not in checked_fa]
    if unchecked:
        raise AssertionError(f"phase 13 called kernels at shapes phase 3 "
                             f"did not check: {unchecked}")
    log("  subl " + json.dumps(subl))

    log(f"phase 14: the recurrent families: {SSM_ARCH} and {HYB_ARCH} at "
        "full width, f32 card against CPU, served at full depth in bf16, "
        f"and one training step each on {TP_WORLD} TP ranks on one card over "
        "gloo against one device")
    log("  " + smi)
    rec = phase_recurrent(fa)
    unchecked = [("matmul", s_) for s_ in rec["call_shapes"]
                 if tuple(s_) not in checked]
    unchecked += [("flash_attention", s_) for s_ in rec["flash_shapes"]
                  if tuple(s_) not in checked_fa]
    if unchecked:
        raise AssertionError(f"phase 14 called kernels at shapes phase 3 "
                             f"did not check: {unchecked}")
    log("  recurrent " + json.dumps(rec))

    log(f"phase 15: the enc-dec and VLM families: {ENC_ARCH} f32 card "
        f"against CPU and served in bf16; {VLM_ARCH} cut to "
        f"{VLM_CHECK_LAYERS} layers f32 card against CPU, served at full "
        f"depth in bf16, and one training step cut to {VLM_TRAIN_LAYERS} "
        f"layer on {TP_WORLD} TP ranks on one card over gloo against one "
        "device")
    log("  " + smi)
    pf = phase_pf(fa)
    unchecked = [("matmul", s_) for s_ in pf["call_shapes"]
                 if tuple(s_) not in checked]
    unchecked += [("flash_attention", s_) for s_ in pf["masked"]
                  if s_ not in checked_masked(rows)]
    if unchecked:
        raise AssertionError(f"phase 15 called kernels at shapes (flash: "
                             f"and masks) phase 3 did not check: "
                             f"{unchecked}")
    log("  pf " + json.dumps(pf))

    log(f"phase 16: {ARCTIC_ARCH} at full width cut to {ARCTIC_LAYERS} of "
        f"35 layers: served in bf16, adafactor on one expert leaf against "
        f"f64, one adafactor train step; then {TP_ARCH} cut to "
        f"{CKPT_LAYERS} layers: a checkpoint written by {TP_WORLD} TP ranks "
        "on one card over gloo, restored on one device and on the ring")
    log("  " + smi)
    arctic, arctic_ref = phase_arctic(fa)
    unchecked = [("matmul", s_) for s_ in arctic["call_shapes"]
                 if tuple(s_) not in checked]
    unchecked += [("flash_attention", s_) for s_ in arctic["flash_shapes"]
                  if tuple(s_) not in checked_fa]
    if unchecked:
        raise AssertionError(f"phase 16 called kernels at shapes phase 3 "
                             f"did not check: {unchecked}")
    log("  arctic " + json.dumps(arctic))

    # arctic's bf16 bound: the tightest phase 10 held a bf16 ring row to
    rel_bound = min(BF16_LOGIT_FACTOR * s_ for r in serve_tp["runs"]
                    if r["dtype"] == "bfloat16"
                    for s_ in r["one_device_bf16_rel_to_f32"])
    log(f"phase 17: MoE serving on a ring: {MOE_ARCH} cut to {MOE_LAYERS} "
        f"layers (scripted f32, the Engine bf16) and {ARCTIC_ARCH} cut to "
        f"{ARCTIC_LAYERS} layer (bf16), {TP_WORLD} TP ranks on one card over "
        f"gloo, against phases 11 (a) and 16's one device (arctic's logits "
        f"within {rel_bound:.6g} relative)")
    log("  " + smi)
    ring = phase_moe_ring(moe_ref, arctic_ref, rel_bound)
    unchecked = [("matmul", s_) for s_ in ring["matmul_shapes"]
                 if tuple(s_) not in checked_mm]
    unchecked += [("flash_attention", s_) for s_ in ring["flash_shapes"]
                  if tuple(s_) not in checked_fa]
    if unchecked:
        raise AssertionError(f"phase 17 called kernels at shapes phase 3 "
                             f"did not check: {unchecked}")
    log("  moe_ring " + json.dumps(ring))

    log("kernel cases " + json.dumps({"flash_attention": rows,
                                      "matmul": mm_rows,
                                      "matmul_rmsnorm": mln_rows}))
    log(f"chip_smoke: {time.monotonic() - t_start:.1f}s")
    # flash_attention's record reads the paged serving path's most frequent
    # call, a decode step in bf16, with its launches on every path (phases
    # 5, 6, 8, 9, 10 and 11); matmul's reads the ring step that carries most
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
         + serve_tp["flash_launches"] + moe["serve"]["launches"]
         + moe["train"]["flash_launches"] + topo["dp"]["flash_launches"]
         + topo["grouped_ep"]["flash_launches"] + subl["flash_launches"]
         + rec["flash_launches"] + pf["flash_launches"]
         + arctic["flash_launches"] + ring["flash_launches"],
         **record(head)},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:56",
         "launches": tp["matmul_launches"] + train["matmul_launches"]
         + serve_tp["matmul_launches"] + moe["train"]["matmul_launches"]
         + topo["dp"]["matmul_launches"]
         + topo["grouped_ep"]["matmul_launches"] + subl["matmul_launches"]
         + rec["matmul_launches"] + pf["matmul_launches"]
         + arctic["matmul_launches"] + ring["matmul_launches"],
         **record(mm_head)},
        {"name": "matmul_rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_rmsnorm.cu",
         "replaces": "src/repro/kernels/matmul_ln.py:55",
         "launches": mla["launches"]["matmul_rmsnorm"]
         + subl["mln_launches"],
         **record(mln_head)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
