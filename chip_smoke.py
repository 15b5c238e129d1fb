#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bitorch_engine_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bitorch_engine_tpu_torch/csrc`` and
then, failing on the first check that does not hold:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and the kernels' build time;
2. holds each kernel against its plain PyTorch version at the shapes of the
   Llama-3-8B w4 g128 serving path (tolerances below), kernel 1 (the A16
   GEMV on kernel 7's tensor-core body) also at m 1-512 and at w1/w2/w4/w8
   with bf16 and f32 metadata, run twice bit for bit, and once with f32
   activations (its scalar body), kernel 2 bit-equal in bf16 and f32 output
   and in every zero form (sym; asym act-order tensors in the kernel form
   and in DiodeMix's exact form) at those shapes and at every width, N not
   a multiple of 4 included, kernel 3 (the flash forward) also at the
   370M training shape, with the share of its bf16 outputs that differ from
   the plain version (both round ``p`` to bf16 against the running max of
   the reference's key tile);
3. times each kernel, its plain version and, where one exists, the single
   PyTorch call that computes the same function (CUDA events, median of 20
   launches, L2 flushed before each), beside the least time the card could
   take (bytes at 3.35 TB/s, or bf16 operations at 989 TFLOP/s); times
   kernel 1 against kernel 2 + ``torch.matmul`` at m 16-512 (the A16
   crossover), and unsplit against a cluster of 2 along K;
4. runs the serving path at full width (32 layers, random weights from a
   seed): a 256-token prefill of 8 prompts, then 32 greedy decode steps with
   the bucketed attention window, and checks the kernels' launch counts;
   then runs a prefill and 8 decode steps once more under ``torch.profiler``
   and prints, per phase, the device's busy time, its idle share, the
   launches and the kernels with the most device time;
5. the serving slice: holds both paged-attention entry points against their
   plain versions (shuffled page tables, per-slot cache lengths with 0 and
   W - 1, inactive slots on the null page 0; pools bit-equal after the
   write; a second launch bit-equal; the write-back rows on the decode
   kernel split over a cluster, timed at each cluster size; two long
   windows checked on the route ``decode_plan`` picks for them; the
   read-only rows on the chunk kernel (windows 256-1024, a bf16 pool, a
   short last chunk), each also timed on the first kernel) and times
   them beside their bound and a gathered-window
   ``scaled_dot_product_attention`` yardstick; serves a
   mixed queue of 16 requests through ``ContinuousBatcher`` (8 slots, a
   paged pool of 16 pages of 64 per slot, 256-token prefill chunks) on the
   same 32-layer model and checks every request, the freed pool and the
   paged kernels' launch counts; times a decode step dense, paged, and
   paged on the first kernels 1 and 6 at batch 8 and 64;
6. compares prefill + 4 decode steps of a 2-layer full-width model between
   the kernel path and the plain path on the card, over dense and over
   paged caches, and over paged caches with a 512-token prompt prefilled in
   two 256-token chunks as the batcher does (the read-only kernel's launches
   counted);
7. runs the paged logits gate of ``tools/paged_gate.py`` (4 layers, hidden
   2048, 64 forced decode steps, dense against paged);
8. the sub-4-bit slice: holds kernel 5 (the A8 int8 kernel, on the int8
   tensor cores) against its plain version in f32 before ``sx`` and the cast
   (max|d| = 0 at m 8 with bf16 metadata; its activation quantization
   bit-equal) at the MBWQ-2.5 w2 segments and the uniform-w2 Llama-3-8B
   shapes, affine and mid_sym, and at w1 and w4, the MBWQ-2.5 segments also
   at m 1-512 and with f32 metadata, and times it there on both of its
   bodies (the tensor cores and the first, dp4a one); holds kernel 7
   (the fused mixed-bit kernel, bf16 activations on the tensor cores)
   against its plain version at the MBWQ-2.5 A16 projections at m 1-512,
   at w8 / w1 / w2 / w4 mixes with f32 metadata and ragged N, bf16 out, and
   run twice bit for bit, and its f32-activation route once; times both
   beside their bounds, their plain versions, a bf16 ``torch.matmul`` and
   (kernel 7) the per-segment launches it replaces, kernel 7 unsplit
   against a cluster of 2 along K, and kernel 7 at m 16-128 against
   ``mpq_linear`` per segment (its cut-off);
9. runs Llama-2-7B MBWQ-2.5 (25% w4 g64, 75% w2 g128) at full width: a
   256-token prefill of 8 prompts, 32 greedy decode steps in the A8 regime,
   then 32 more after ``prepare_params_for_cuda(..., act_bits_map={2: 16})``
   in the A16 regime, checks the launch counts per step and profiles a few
   steps of each regime;
10. compares prefill + 4 decode steps of a 2-layer MBWQ-2.5 model between
    the kernel path and the plain path on the card, in both regimes, then
    the A8 regime once more per layer (every kernel-5 call bit-equal to its
    plain version on the same input, every kernel-1 call within f32 rel
    1e-5), and prints (not gated) the A8 check on four more prompts with
    kernel 1 on either body;
11. the training slice: holds kernel 4 (the flash-attention backward, dq and
    dk / dv) against its plain version at the training shape (b8, 16 MHA
    heads, s 2048, d 64, causal), a Llama-3-8B GQA shape (32 / 8 heads, d
    128) and a non-causal shape, with the share of bf16 elements that
    differ, and times it beside its bound, its plain version and
    ``scaled_dot_product_attention``'s backward;
12. trains the JAX bench's 370M Llama (``llama_370m_train()``: 24 layers,
    hidden 1024, w4 g128, remat, bf16) at full width with DiodeMix (lr
    1e-4) on seeded tokens (8, 2049): one warm-up step, 3 timed steps with
    every loss checked finite and the launches of kernels 2, 3 and 4 per
    step checked, one step split into forward + backward and the optimizer,
    one profiled step (device busy time, idle share), the peak memory;
13. compares one train step of a 2-layer full-width model between the
    kernel path and the plain path on the card (loss, every grad shadow and
    fp gradient), both from the same weights;
14. the binary / QAT slice: holds kernel 8 (the XNOR-popcount GEMM, on the
    tensor cores' 1-bit products) bit for bit against its plain versions,
    both entries (the sign words; the packed binary linear fused with the
    sign of x + bias_a and the scales, in f32, bf16 and f16, with ties x ==
    -bias_a), at the packed MLP's 1024² (m 1-2048), 4096² (m 1-2048), 8192²
    (m 8) and a ragged shape (K 1000, N 70), measures the 1-bit product's
    issue rate against the int8 one's, and times both entries beside their
    bounds (bytes, or 1-bit operations at 8x the int8 rate; the int8 and
    the first body's popc bounds beside), their plain versions, the bf16 sign matmul
    (``torch.mm`` of the ±1 operands with f32 output) and the packed
    forward's unpack branch as it runs (unpack + that matmul + the scales),
    and prints the m where that branch overtakes the kernel;
15. trains the MNIST example's ``QuantMLP`` (784 → 1024 → 1024 → 10) at 1,
    4 and 8 bits with DiodeMix (lr 1e-3, batch 128, 20 steps on seeded
    synthetic digits; losses finite and falling, the accuracy the train
    step returns), packs it with ``prepare_for_inference`` and serves it at
    batch 8 and 128 (kernel 8's fused entry: exactly one launch per forward
    at 1 bit where ``xnor_route`` takes it; ms, kernel-8 launches and device
    kernels a forward, beside the same forwards on the unpack branch), with
    one profiled train step; trains ``QuantConvNet`` (widths
    64-128-128-256, 32×32×3, batch 128) at 1 and 4 bits for 5 steps, with
    the peak memory.  cuDNN's TF32 flag is on during phases 15-16: the
    port's convolutions must turn it off themselves;
16. the packed MLP's logits through kernel 8 against the plain path on the
    card at batch 8 and 128 (bit-equal), and one binary-MLP train step and one conv-net step
    at 1 and 4 bits on the card against the same step on the CPU from the
    same weights and optimizer state;
17. the checkpoint slice, in a temporary directory removed at its end:
    writes a GPTQ export of Llama-3-8B (HF names, unfused projections, w4
    g128 asym, an act-order ``g_idx`` on every projection, fp16 scales,
    embedding, head and norms; random from a seed) with the port's
    safetensors writer, loads it with ``load_llama_from_safetensors`` into
    the unfused serving configuration (int8 embedding, w4 head padded to
    2048), ``prepare_params_for_cuda(model, bf16)``, runs a 256-token
    prefill of 8 prompts and 32 greedy decode steps (kernel 1 on the
    gathered activations, kernel 2 writing its rows through ``q_perm``: the
    launches and routes counted; a profiled prefill runs no gather,
    index_select or scatter kernel that the same model without ``q_perm``
    does not) and holds the last logits
    against the plain path on the card (2e-2: every projection as ``x @
    dequantize_mpq(qt)`` on its logical weight, so the gather and the
    scatter are held too); times a decode step of the same model with its
    ``q_perm`` stripped and of a freshly built unfused model beside it, and
    profiles the host's Python over decode steps of each; saves the model with
    ``save_checkpoint`` and restores it with ``load_checkpoint`` +
    ``load_jax_params`` into a skeleton on ``meta`` (logits bit-equal);
    holds the act-order routes per layer against their plain versions:
    kernel 1 (m 1, 8, 64; f32 rel <= 1e-3), kernel 2 + the scatter
    (bit-equal), kernel 5 on a w2 tensor in A8 (max|d| = 0), kernel 7 on an
    exl2 tensor with 2-6-bit groups and a random ``q_invperm`` (f32 rel <=
    1e-3), each timed beside the same kernel without the gather; drives
    kernel 5's act-order route through ``mpq_linear`` and kernel 7's exl2
    tensor through an ``MBWQLinear`` layer, launches counted; shows a
    ragged ``g_idx`` on the plain route; and runs the perplexity gate
    (``run_ppl_gate``: a byte-level Llama trained on the card, quantized in
    every configuration of the JAX package's gate) within
    ``tests/test_ppl_gate.py``'s bounds;
18. the MoE slice: holds kernels 1 (m 8) and 2 against their plain
    versions at Mixtral-8x7B's expert shapes (4096 × 14336, 14336 × 4096)
    and its head (4096 × 32768), w4 g128 bf16 metadata, and times them;
    builds ``mixtral_8x7b_serving()`` at full width (32 layers of 8 w4
    experts, top 2, drop-free; random weights from seed 0) and runs phase
    4's serving path and profile on it (833 kernel-1 launches a decode
    step, 833 kernel-2 and 32 kernel-3 launches a prefill, checked exactly;
    no route dropped in any layer of any forward), with the decode step's
    bytes bound and the prefill's operations bound; serves a queue of 8
    requests (prompts 32-256, 16-32 new tokens) through phase 5b's batcher
    run; compares 2 layers between the kernel and the plain path (2e-2),
    counts the routes whose top-k set differs between them, and runs each
    MoE MLP call of the kernel path on the plain path from the same input;
19. the parallel slice (every time labelled "two ranks sharing one card,
    gloo": not a tp speed): holds kernels 1 and 2 (m 8; o and down writing
    the f32 partial) at one tp rank's shard shapes of Llama-3-8B, kernel 3
    at its 16 query / 4 KV heads and kernel 6's write-back form at its 4 KV
    heads against their plain versions and times them; then spawns a world
    of 2 ranks on the card (gloo, kernels already built, joined under a
    deadline).  Each rank probes which collectives gloo takes on CUDA
    tensors, builds ``llama3_8b_serving()`` at full width from seed 0; rank
    0 runs it unsharded (the reference's greedy tokens and logits); both
    serve phase 18c's queue at dp 2 (tokens equal to the unsharded
    batcher's), cut the model with ``shard_llama_params`` and run prefill 8
    × 256 and 32 decode steps forced to the reference's tokens (launches of
    kernels 1, 2 and 3 and the collectives of every pass checked; every
    layer, and the final norm with the gathered head, on the unsharded
    model's input to it within 2e-2 of the unsharded one at prefill and at
    a decode step), profile the prefill and 8 steps (one profiler a pass:
    device busy ms), run ``ring_row_parallel_mpq`` at the o and down shapes
    (2 kernel-1 launches a call, within 1e-2), and serve the queue at tp 2.
    Rank 0 also runs a witness of tp's rounding in one process: the
    unsharded model with o and down summed as two f32 row halves, cast once.
    The tp logits (prefill and every step) and each tp wave's first-token
    logits stay within 2e-2 of the witness's, and of the unsharded ones or
    within 1.5 times the witness's drift from them on the same passes where
    that is larger; a tp request's tokens leave the unsharded ones only
    where the unsharded logits tie within twice that drift;
20. the parallel training slice (every time labelled "two ranks sharing one
    card, gloo": a correctness run, not a parallel speed): holds kernel 2
    at the 370M projections and kernels 3 and 4 at one sp rank's attention
    (the ring's diagonal block, its earlier block without a mask, Ulysses'
    8 of 16 heads over the whole sequence) against their plain versions
    and times them; then spawns a world of 2 ranks on the card.  Each rank
    probes which collectives gloo takes on CUDA tensors (every kind
    ``comm.CUDA_DIRECT`` names must be one), runs the unsharded 370M step
    (8 × 2048 seeded tokens, DiodeMix lr 1e-4, zeros refreshed each step)
    and holds to it, at phase 13's bars (loss rel <= 1e-3, every
    gradient's max|d|/max|ref| <= 3e-2; the ring's gradients
    max(3e-2, 2.5 × the rows witness: the unsharded model's gradients from
    the batch's two row halves, one process)) and with each kernel's
    launches checked exactly: 20a the step at sp 2 with ring and with
    Ulysses attention from two seeds (and, on one (8, 16, 2048, 64) q / k /
    v and output cotangent, Ulysses against kernels 3 and 4 on the whole
    sequence, the ring against its plain version, <= 1% of bf16 outputs
    differing, and both within 4 × kernels 3 and 4's distance from the
    exact f32 attention, outputs and gradients), the packed codes after the
    step counted against the unsharded step's; 20b dp 2 (bit-equal to the
    rows witness), and fsdp 2 given the unsharded gradients (packed codes,
    refreshed zeros and scales bit-equal after the step, the moments holding
    half the rows);
    20c pp 2 (two stages of 12 blocks, 4 microbatches of 2 × 2048, no
    optimizer step); 20d ``mixtral_8x7b_serving()`` at 2 layers and ep 2
    (4 experts a rank), prefill 8 × 256 and 8 decode steps forced to the
    unsharded tokens, logits within 2e-2 of the unsharded model's.  Every
    sub-phase prints its collectives (calls, bytes, ms, staged), each
    rank's device busy ms (``torch.profiler``), peak GiB and wall seconds;
21. tp inside the train step (``phase_tpt``: the 370M step at tp 2 and at
    fsdp 2 × tp 2, Mixtral at tp 2; see its docstring);
22. the entry points: 22a the host bitpack library (``native``) built with
    g++ and bit-equal to the port's torch packing ops at a Llama-3-8B
    projection (4096 × 14336, w2 / w4 / w8, and its signs), each timed;
    22b a seeded fp bf16 HF-layout Llama-3-8B export at full width, cut to
    2 layers (about 3 GiB), quantized by ``tools.cli`` on the card, one
    layer's tensors bit-equal to the CPU's, ``inspect`` listing every
    tensor; 22c the quantize-and-generate twin on that export (int8 KV and
    embedding, w4 head; batch 8, prompt 256, 32 new tokens) under
    ``utils.profiling.trace``: the launches of kernels 1 and 2 read from
    the trace equal the port's launch counters (``generate`` reads the
    whole cache at prefill, as the JAX package's does: no kernel 3), the
    prefill logits within 2e-2 of the plain path and the ids equal to an
    in-process ``generate``; 22d the serve twin on Llama-3-8B at full width and depth
    (paged KV of 64, prefill chunks of 256, 8 slots, 8 requests of 4-512
    prompt tokens): req/s,
    generated tok/s and time to first token, then a traced run whose
    kernel 1, 2, 3 and 6 launches equal the counters; 22e the MNIST, the
    bring-your-own-trainer (its checkpoint reloaded with every tensor
    equal) and the CIFAR twins at their defaults on synthetic data, the
    fine-tune twin for 5 steps unsharded and at tp 2 over two ranks
    sharing the card (the loss falls; every step's loss within 1e-3 of the
    unsharded run's), and the perplexity-gate tool at its smallest
    settings (its JSON and verdict);
23. the fine-tune of a GPTQ-format checkpoint (``phase_ft``): 23a kernels
    1 (m 1-64) and 2 through ``mpq_linear``'s card routes on asym act-order
    tensors at the four 8B projection shapes, each against its plain
    version (kernel 2 bit-equal in every zero form) and against the
    plain asym ``s(q - z)``, the asym route timed beside the sym route,
    and kernels 3 and 4 at the fine-tune's attention shape; 23b a seeded
    GPTQ export of Llama-3-8B (w4 g128 asym, act-order on every
    projection) at full width cut to 4 layers, loaded for training
    (``llama3_8b(asym=True, ...)``), 3 DiodeMix steps at 4 x 1024 with the
    integer zeros refreshed every step (launches of kernels 2, 3, 4, the
    act-order routes and DiodeMix's routes counted exactly: 112 kernel-2
    launches a step, DiodeMix's exact-form 28 among them, none plain; the
    last step profiled; 23b starts under 6 GiB allocated), 16 greedy tokens by ``generate``
    (kernel 1 counted, the last logits within 2e-2 of the plain path), and
    the first step again through the plain versions from the same weights
    (loss rel 1e-3, gradients 3e-2); 23c two ranks sharing the card over
    gloo, 2 layers at 2 x 512: fsdp 2 bit-equal to the unsharded step, tp
    2 against a one-process witness of its split sums (codes off
    counted), a ragged ``g_idx`` down_proj-shaped layer at tp 2 bit-equal
    to the unsharded step at a refresh; 23d ``utils.benchmark``'s
    ``time_op`` on kernel 2 and ``time_fn_pytree`` on a 2-layer decode
    step.

It prints one JSON line describing the kernels and, as its last line,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.

``python3 chip_smoke.py --kernel2-ab PARENT`` runs only the comparison of
kernel 2 with the body it replaced, built from ``PARENT`` (a checkout of
an earlier commit), and with its ``-D`` variants: :func:`phase_kernel2_ab`.
"""

from __future__ import annotations

import copy
import ctypes
import importlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): the bounds' rates
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# no 1-bit rate is published: the 1-bit product (m16n8k256) does 8x the k of
# the int8 one (m16n8k32), and phase 14's probe measures their issue rates
B1_K_PER_INT8_K = 8

SEED = 0
BATCH, PROMPT, CACHE, DECODE_STEPS = 8, 256, 1024, 32
PROFILE_STEPS = 8  # decode steps of the profiled serving run
LAYERS = 32
PROJ_SHAPES = {  # (K, N) of the Llama-3-8B serving projections and padded head
    "qkv": (4096, 6144),
    "o": (4096, 4096),
    "gate_up": (4096, 28672),
    "down": (14336, 4096),
    "head": (4096, 129024),
}
# launches of each projection shape per decode step (kernel 1) or per
# prefill (kernel 2): once per layer, the head once
PER_PASS = {"qkv": LAYERS, "o": LAYERS, "gate_up": LAYERS, "down": LAYERS, "head": 1}
# kernel 1's further checks: rows m at every serving shape (w4 g128, bf16
# metadata), and (w_bit, group size) at a ragged N = 516 with bf16 and f32
# metadata; the A16 crossover sweep against kernel 2 + torch.matmul
KERNEL1_CHECK_M = (1, 8, 16, 64, 256, 512)
KERNEL1_WIDTHS = ((1, 128), (2, 128), (4, 128), (8, 64))
CROSSOVER_M = (16, 32, 64, 128, 256, 512)
TPU_KERNELS = {
    "mpq_matmul_a8": "bitorch_engine_tpu/ops/pallas/dequant_matmul.py:365",
    "mbwq_matmul": "bitorch_engine_tpu/ops/pallas/mbwq_matmul.py:52",
    "mpq_matmul": "bitorch_engine_tpu/ops/pallas/dequant_matmul.py:365",
    "dequant_mpq": "bitorch_engine_tpu/ops/pallas/dequant_matmul.py:789",
    "flash_attention": "bitorch_engine_tpu/ops/pallas/flash_attention.py:75",
    "paged_prefix_attention": "bitorch_engine_tpu/ops/pallas/paged_attention.py:65",
    "paged_prefix_attention_update": "bitorch_engine_tpu/ops/pallas/paged_attention.py:65",
    "flash_attention_bwd": "bitorch_engine_tpu/ops/pallas/flash_attention.py:190",
    "xnor_gemm": "bitorch_engine_tpu/ops/pallas/binary_gemm.py:31",
}
SOURCES = {
    "mpq_matmul_a8": "bitorch_engine_tpu_torch/csrc/quad_matmul.cu",
    "mbwq_matmul": "bitorch_engine_tpu_torch/csrc/mbwq_matmul.cu",
    "mpq_matmul": "bitorch_engine_tpu_torch/csrc/mbwq_matmul.cu",
    "dequant_mpq": "bitorch_engine_tpu_torch/csrc/dequant_matmul.cu",
    "flash_attention": "bitorch_engine_tpu_torch/csrc/flash_attention.cu",
    "paged_prefix_attention": "bitorch_engine_tpu_torch/csrc/paged_attention.cu",
    "paged_prefix_attention_update": "bitorch_engine_tpu_torch/csrc/paged_attention.cu",
    "flash_attention_bwd": "bitorch_engine_tpu_torch/csrc/flash_attention.cu",
    "xnor_gemm": "bitorch_engine_tpu_torch/csrc/binary_gemm.cu",
}

# the serving slice: Llama-3-8B's KV layout (8 KV heads of 128, rep 4), pages of 64
NKV, HD, REP, PAGE = 8, 128, 4, 64
PAGES_PER_SLOT = CACHE // PAGE
# (name, batch, window W, query rows rs, pool dtype, write-back); the first
# rows of each variant are the ones the main path's pass is reckoned from.
# In every row slot 0 has cache_len 0 and slot 1 is an inactive slot on the
# null page 0 (both checked exact)
PAGED_SHAPES = (
    ("decode_b8_w512", 8, 512, REP, "int8", True),
    ("decode_b8_w256", 8, 256, REP, "int8", True),
    ("decode_b8_w1024", 8, 1024, REP, "int8", True),
    ("decode_b64_w256", 64, 256, REP, "int8", True),
    ("decode_b8_w512_bf16", 8, 512, REP, "bf16", True),
    ("chunk_b8_w256_rs1024", 8, 256, REP * 256, "int8", False),
)
# more read-only rows, drawn from their own generator: the serving run's
# later chunks (a wave of 8, 256 tokens of 4 query heads a KV head) at
# windows 512 and 1024, a bf16 pool and a short last chunk
CHUNK_SHAPES = (
    ("chunk_b8_w512_rs1024", 8, 512, REP * 256, "int8", False),
    ("chunk_b8_w1024_rs1024", 8, 1024, REP * 256, "int8", False),
    ("chunk_b8_w256_rs1024_bf16", 8, 256, REP * 256, "bf16", False),
    ("chunk_b8_w256_rs400", 8, 256, REP * 100, "int8", False),
)
CHUNKED_PROMPT = 512  # phase 6's chunked prefill: two chunks of SERVE["prefill_chunk"]
SERVE = dict(num_slots=8, max_len=CACHE, kv_pages=8 * PAGES_PER_SLOT + 1, kv_page_size=PAGE,
             prefill_chunk=256, eos_id=-1)
N_REQUESTS = 16

# the sub-4-bit slice: Llama-2-7B MBWQ-2.5 (bench.py:474-497).  Its
# projections (K, N) with their (w4 g64, w2 g128) segment rows, N padded
# to 2048 (gate|up 22016 → 22528)
MBWQ_PROJ = {
    "qkv": (4096, 12288, 1024, 3072),
    "o": (4096, 4096, 1024, 3072),
    "gate_up": (4096, 22528, 1024, 3072),
    "down": (11008, 4096, 2816, 8192),
}
# kernel 7's further checks: rows m at every MBWQ-2.5 projection, and
# two-segment mixes (w_bit, group size, rows) at a ragged N with their
# metadata dtype: every width, chunks of 4, 2 and 1 words
MBWQ_CHECK_M = (1, 16, 64, 512)
MBWQ_MIXES = (
    ("w8g64_w1g128_n4132_f32meta", ((8, 64, 1024), (1, 128, 3072)), 4132, "float32"),
    ("w2g32_w1g32_n2052", ((2, 32, 2048), (1, 32, 2048)), 2052, "bfloat16"),
    ("w4g16_w2g16_n1028_f32meta", ((4, 16, 1024), (2, 16, 1024)), 1028, "float32"),
)
MBWQ_WINDOW_FLOOR = 128  # the bench's MHA window floor (bench.py:500-506)
MBWQ_PROFILE_STEPS = 4
A8_SPREAD_PROMPTS = 4  # prompts beside the gated one in the A8 check's spread
# kernel 5's shapes (K, N, w_bit, group size): the MBWQ-2.5 w2 segments
# first (the rows the main path is reckoned from), then the uniform-w2
# Llama-3-8B shapes of tools/quad_gate.py, then w1 and w4 at one shape
QUAD_SHAPES = (
    [(f"mbwq_{name}_w2", k2, n, 2, 128) for name, (_, n, _, k2) in MBWQ_PROJ.items()]
    + [(f"w2_{k}x{n}", k, n, 2, 128) for k, n in
       ((4096, 4096), (4096, 6144), (4096, 28672), (14336, 4096), (2048, 512))]
    + [("w1_4096x4096", 4096, 4096, 1, 128), ("w4_4096x4096", 4096, 4096, 4, 128)]
)
# kernel 5's further rows: the MBWQ-2.5 w2 segments at more rows of the A8
# regime, and one shape with f32 metadata
QUAD_CHECK_M = (1, 16, 64, 512)
QUAD_F32_META = ("mbwq_o_w2_f32meta", 3072, 4096, 2, 128)
# the shapes ``quad_route`` keeps on the first (dp4a) body: groups of 16
# codes at w2 and w4.  At 256 groups the f32 sums of the group terms are no
# longer exact in either order (the body's group order, the plain f32
# product's), so these rows are held to rel <= 1e-4, not max|d| = 0
QUAD_DP4A_SHAPES = (("w2_g16_4096x4096", 4096, 4096, 2, 16), ("w4_g16_4096x4096", 4096, 4096, 4, 16))

# the training slice: the bench's 370M fine-tune step (bench.py:616-667)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR = 8, 2048, 24, 3, 1e-4
TRAIN_PROJ = 7  # q, k, v, o, gate, up, down: unfused, as the bench builds them
# kernel 3's shapes (name, b, nh, nkv, s, d), all causal: the 8B prefill
# (FLASH_PREFILL, the row the serving path is reckoned from), a d 64 shape
# and the training shape (FLASH_TRAIN: 48 launches per train step, remat
# runs the forward twice)
FLASH_PREFILL, FLASH_TRAIN = "prefill_b8_nh32_nkv8_s256_d128", "train_b8_nh16_s2048_d64"
FLASH_FWD_SHAPES = (
    (FLASH_PREFILL, BATCH, 32, NKV, PROMPT, HD),
    ("b4_nh16_nkv4_s512_d64", 4, 16, 4, 512, 64),
    (FLASH_TRAIN, TRAIN_BATCH, 16, 16, TRAIN_SEQ, 64),
)
# kernel 3 against its plain version in bf16: both round p against the
# same running max, so only f32 summation order and exp's last bits differ;
# the share of out elements one rounding apart is bounded (the CPU tests
# hold the plain version to the JAX kernel at the same bar)
FWD_DIFFERING_MAX = 1e-2
# kernel 4's shapes (name, b, nh, nkv, s, d, causal): the training shape
# (FLASH_TRAIN, the row the main path is reckoned from) and two others
FLASH_BWD_SHAPES = (
    (FLASH_TRAIN, TRAIN_BATCH, 16, 16, TRAIN_SEQ, 64, True),
    ("gqa_b1_nh32_nkv8_s2048_d128", 1, 32, 8, 2048, 128, True),
    ("noncausal_b2_nh8_s1024_d64", 2, 8, 8, 1024, 64, False),
)

# the binary / QAT slice: the MNIST example's QuantMLP (train_mnist.py:95-145)
# and QuantConvNet at its default widths on CIFAR-shaped inputs
MLP_HIDDEN, MLP_BATCH, MLP_STEPS, MLP_LR = 1024, 128, 20, 1e-3
SERVE_BATCH, SERVE_REPS = 8, 20
CNN_BATCH, CNN_STEPS, CNN_HW = 128, 5, 32
POPC_PER_CLOCK_PER_SM = 16  # 32-bit popc, compute capability 9.0 (CUDA C++ guide)
# kernel 8's shapes (name, m, K, N): the packed MLP's serving forwards first
# (b8 is the row the main path is reckoned from), then the A/B shape list
# of BENCH_NOTES.md:817-835 to m 2048 and a ragged one (K and N)
XNOR_SHAPES = (
    [("mlp_1024_m8", 8, 1024, 1024), ("mlp_1024_m1", 1, 1024, 1024), ("mlp_1024_m16", 16, 1024, 1024),
     ("mlp_1024_m128", 128, 1024, 1024)]
    + [(f"1024_m{m}", m, 1024, 1024) for m in (256, 512, 2048)]
    + [(f"4096_m{m}", m, 4096, 4096) for m in (1, 8, 16, 32, 64, 128, 256, 512, 2048)]
    + [("8192_m8", 8, 8192, 8192), ("ragged_m3_k1000_n70", 3, 1000, 70)]
)
# kernel 8's first (SIMT popcount) body, µs a launch, as PR 10's run read it
# on the H100 (PERF.md §6 row 8; the body is gone): printed in phase 14's
# log beside this run's times, and in no JSON line
XNOR_SIMT_US = {"mlp_1024_m8": 6.768, "4096_m32": 15.8, "4096_m64": 24.7}
XNOR_FORWARD_MS_BEFORE = {8: 0.63}  # the packed MLP's ms a forward at b8 on the first body (PR 10)

# the checkpoint slice (phase 17): Llama-3-8B as a GPTQ export writes it (HF
# names, unfused projections (K, N), w4 g128 asym, act-order g_idx)
CKPT_LAYERS = 32
GPTQ_GROUP = 128
CKPT_PROJ = {"q_proj": (4096, 4096), "k_proj": (4096, 1024), "v_proj": (4096, 1024),
             "o_proj": (4096, 4096), "gate_proj": (4096, 14336), "up_proj": (4096, 14336),
             "down_proj": (14336, 4096)}
# the act-order per-layer checks: two projection shapes, kernel 1 at these rows
ACT_ORDER_SHAPES = (("up_4096x14336", 4096, 14336), ("down_14336x4096", 14336, 4096))
ACT_ORDER_M = (1, 8, 64)
# an exl2 export of Llama-2-7B's gate|up: groups of 128 rows, (bits, groups)
EXL2_SHAPE, EXL2_GROUP = (4096, 22016), 128
EXL2_LAYOUT = ((6, 2), (5, 4), (4, 8), (3, 8), (2, 10))
PPL_GATE = dict(hidden=128, layers=2, steps=250, seq_len=128)  # tests/test_ppl_gate.py's

# the MoE slice (phase 18): Mixtral-8x7B in the bench's MoE serving form at
# its own width.  Kernels 1 and 2 at its expert projections (K, N) and its
# w4 head (vocab 32000 padded to 32768); q|k|v and o are phase 2's shapes
MOE_SHAPES = {"moe_up": (4096, 14336), "moe_down": (14336, 4096), "moe_head": (4096, 32768)}
MOE_EXPERTS = 8
# launches of each shape per decode step (kernel 1) or per prefill (kernel
# 2): every expert runs on every row (drop-free capacity), gate and up at
# the up shape
MOE_PER_PASS = {"qkv": LAYERS, "o": LAYERS, "moe_up": 2 * MOE_EXPERTS * LAYERS,
                "moe_down": MOE_EXPERTS * LAYERS, "moe_head": 1}
MOE_QUEUE = dict(n_requests=8, prompt_lens=(32, 256), new_tokens=(16, 32))  # phase 18c

# the parallel slice (phase 19): Llama-3-8B at tp 2 over torch.distributed,
# the two ranks sharing the one card through gloo.  Kernels 1 and 2 at one
# rank's shard shapes (K, N): q|k|v by heads (16 query + 4 + 4 KV heads of
# 128), o and down by rows (their kernel-1 output the f32 partial), gate|up
# by intermediate features, the head by vocabulary (129024 / 2)
TP = 2
TP_LABEL = "two ranks sharing one card, gloo"
TP_SHAPES = {"tp_qkv": (4096, 3072), "tp_o": (2048, 4096), "tp_gate_up": (4096, 14336),
             "tp_down": (7168, 4096), "tp_head": (4096, 64512)}
TP_ROW_SHAPES = ("tp_o", "tp_down")
TP_PER_PASS = {"tp_qkv": LAYERS, "tp_o": LAYERS, "tp_gate_up": LAYERS, "tp_down": LAYERS,
               "tp_head": 1}
TP_NKV = NKV // TP
TP_FLASH = ("tp_prefill_b8_nh16_nkv4_s256_d128", BATCH, 32 // TP, TP_NKV, PROMPT, HD)
TP_PAGED = (("tp_decode_b8_w512", 8, 512, REP, "int8", True),
            ("tp_decode_b8_w256", 8, 256, REP, "int8", True))
RING_SHAPES = {"ring_o": (4096, 4096), "ring_down": (14336, 4096)}
RING_REPS = 20
TP_WORLD_TIMEOUT, TP_COLLECTIVE_TIMEOUT = 700, 240  # s: the whole world, one collective's wait
TP_WITNESS_SLACK = 1.5  # the end-to-end limits: the witness's drift times this, at least 2e-2

# the parallel training slice (phase 20): two ranks sharing the one card
# through gloo.  The 370M train step (phase 12's model and batch) at sp 2
# (ring and Ulysses), dp 2, fsdp 2 and pp 2 against the unsharded step, and
# Mixtral-8x7B (2 layers) at ep 2 against the unsharded model
PAR = 2
PAR_SEED = SEED + 20
PAR_SEEDS = (PAR_SEED, PAR_SEED + 1)  # 20a runs from both; 20b-20c from the first
TRAIN_SHAPES = {"train_q": (1024, 1024), "train_k": (1024, 1024), "train_v": (1024, 1024),
                "train_o": (1024, 1024), "train_gate": (1024, 2816), "train_up": (1024, 2816),
                "train_down": (2816, 1024)}  # the 370M projections (K, N)
# one sp rank's attention (name, b, nh, nkv, s, d, causal): the ring's
# diagonal and earlier blocks (L/2 queries against L/2 keys), Ulysses' half
# of the heads over the whole sequence
SP_RING_DIAG, SP_RING_OFF, SP_ULYSSES = (
    "sp_ring_diag_b8_nh16_s1024_d64", "sp_ring_off_b8_nh16_s1024_d64", "sp_ulysses_b8_nh8_s2048_d64")
SP_FLASH = (
    (SP_RING_DIAG, TRAIN_BATCH, 16, 16, TRAIN_SEQ // PAR, 64, True),
    (SP_RING_OFF, TRAIN_BATCH, 16, 16, TRAIN_SEQ // PAR, 64, False),
    (SP_ULYSSES, TRAIN_BATCH, 16 // PAR, 16 // PAR, TRAIN_SEQ, 64, True),
)
PP_MICRO = 4  # 4 microbatches of 2 x 2048
EP_LAYERS, EP_STEPS = 2, 8  # Mixtral depth cut to 2 layers; decode steps forced to rank 0's
PAR_WORLD_TIMEOUT, PAR_COLLECTIVE_TIMEOUT = 400, 200  # s: the whole world, one collective's wait
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-3, 3e-2  # phase 13's bars
# 20a's attention witness: each sp form's output and gradients no further
# from the exact f32 attention than this many times kernels 3 and 4 on the
# whole sequence (bf16 rounding of the blocks' partials stays within it; a
# fault, a lost or doubled block, reads orders of magnitude past it)
SP_EXACT_FACTOR = 4.0
# the ring step's gradient bar: max(TRAIN_GRAD_REL, this × the rows
# witness's distance from the unsharded step).  The witness is one rounding
# change (every GEMM on half the rows) and reads 1.678e-2; the ring makes
# two of that kind (the half-position GEMMs, and its bf16 block partials,
# which alone move the gradients 2.868e-2-3.033e-2 from Ulysses'), read
# 1.63-1.76 × the witness on two seeds, and held to the exact values at the
# attention by SP_EXACT_FACTOR
SP_RING_WITNESS_FACTOR = 2.5

# the tp training slice (phase 21): the 370M train step at tp 2 (two ranks
# sharing the card through gloo) and at fsdp 2 x tp 2 (four ranks), and
# Mixtral-8x7B (2 layers) at tp 2.  One tp rank's 370M projections (K, N):
# q, k and v by 8 of the 16 heads, o by their rows, gate and up by 1408 of
# the 2816 intermediate features, down by their rows
TPT_SHAPES = {"tpt_q": (1024, 512), "tpt_k": (1024, 512), "tpt_v": (1024, 512),
              "tpt_o": (512, 1024), "tpt_gate": (1024, 1408), "tpt_up": (1024, 1408),
              "tpt_down": (1408, 1024)}
TPT_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
TPT_ROW = ("o_proj", "down_proj")
# one tp rank's attention (name, b, nh, nkv, s, d, causal): 8 of 16 heads
TPT_FLASH = ("tpt_b8_nh8_s2048_d64", TRAIN_BATCH, 16 // TP, 16 // TP, TRAIN_SEQ, 64, True)
TPT_FSDP_LAYERS = 4  # 21c's depth: the 370M width, 4 of its 24 layers
TPT_WITNESS_FACTOR = 2.5  # 21b's gradient bar: max(TRAIN_GRAD_REL, this x the witness)
TPT_WORLD_TIMEOUT, TPT_FSDP_WORLD_TIMEOUT, TPT_COLLECTIVE_TIMEOUT = 500, 300, 200  # s

# the entry points (phase 22): the native packers at a full-width 8B
# projection; the 8B export cut to 2 layers (depth only) for the CLI and
# the quantize-and-generate twin; the serve twin's queue; the fine-tune
# twin's steps
NATIVE_SHAPE, NATIVE_BITS = (4096, 14336), (2, 4, 8)
ENTRY_LAYERS = 2
# the serve twin as phase 5b serves (a cache of 1024 in pages of 64, chunks
# of 256): prompts of 4-512 tokens, so that some waves take kernel 3 (a
# bucket of 128 or 256) and some are chunked (kernel 6's read-only form)
ENTRY_SERVE = dict(slots=8, requests=8, new_tokens=32, max_len=1024, prompt_len=512)
ENTRY_FINETUNE_STEPS = 5
# kernel wrapper -> the device kernels it launches, as the profiler names
# them (kernel 1's bf16 route runs kernel 7's body; kernel 6's two forms
# are counted together)
ENTRY_DEVICE_KERNELS = {
    "mpq_matmul": ("mbwq_mma_kernel", "mpq_matmul_kernel"),
    "dequant_mpq": ("dequant_kernel",),
    "flash_attention": ("flash_fwd_kernel",),
    "paged_attention": ("paged_decode_kernel", "paged_attention_kernel", "paged_chunk_kernel"),
}


# phase 23: the fine-tune of a GPTQ-format export of Llama-3-8B (w4 g128
# asym, act-order on every projection; zero points centered on the codes'
# mean: phase 17's zero points, one code above it on average, give every
# weight column a common offset, the residual stream one direction, and
# layer 1 attention scores up to 757, a one-hot softmax whose q / k
# gradients are bf16 rounding noise) at full width, cut to FT_LAYERS
# layers for memory; batch FT_BATCH x FT_SEQ, DiodeMix refreshing the
# integer zeros every step; then FT_NEW_TOKENS greedy tokens (kernel 1 at m
# = FT_BATCH).  23a checks kernels 1 and 2 on asym tensors at each 8B
# projection shape (projections of the shape a layer in FT_PER_LAYER)
FT_LAYERS, FT_BATCH, FT_SEQ, FT_STEPS, FT_LR = 4, 4, 1024, 3, 1e-4
FT_PROMPT, FT_NEW_TOKENS = 32, 16
FT_SHAPES = (("qo", 4096, 4096), ("kv", 4096, 1024), ("up", 4096, 14336), ("down", 14336, 4096))
FT_PER_LAYER = {"qo": 2, "kv": 2, "up": 2, "down": 1}
FT_KERNEL1_M = (1, FT_BATCH, 8, 64)
FT_KERNEL1_REL = 1e-5  # kernel 1 against its plain version, f32 (phase 10's per-layer bar)
# against the plain asym s(q - z): the per-projection gate, f32 before any
# cast (docs/DESIGN.md "Numerics gating", tools/quad_gate.py's tol)
ASYM_PLAIN_REL = 1e-4
FT_FLASH = ("ft_b4_nh32_nkv8_s1024_d128", FT_BATCH, 32, NKV, FT_SEQ, HD)
# 23c: ranks sharing the card, 2 layers at batch 2 x 512; a down_proj-shaped
# ragged g_idx layer stepped at an lr that moves its integer zeros
FT_PAR_LAYERS, FT_PAR_BATCH, FT_PAR_SEQ = 2, 2, 512
FT_RAGGED_SHAPE, FT_RAGGED_LR = (14336, 4096), 0.6
FT_WORLD_TIMEOUT = 600  # s
FT_START_GIB = 6  # allocated at 23b's start: the earlier phases hold nothing of theirs


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bucket(n: int, floor: int = 256) -> int:
    """The bench's attention window: smallest power of 2 >= n, at least
    ``floor`` (256 for the GQA models, 128 for Llama-2-7B's MHA)."""
    w = floor
    while w < n:
        w *= 2
    return min(w, CACHE)


def counts_with(**nonzero) -> dict:
    """Every kernel's launch count 0 but those named (each a kernel of
    ``KERNELS``)."""
    from bitorch_engine_tpu_torch.ops.cuda import KERNELS

    unknown = set(nonzero) - set(KERNELS)
    check(not unknown, f"no launch counter for {sorted(unknown)}")
    return {name: nonzero.get(name, 0) for name in KERNELS}


def time_ms(torch, fn, reps: int = 20, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the L2 cache overwritten before each one."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        # keep the device busy (~1 ms) while the host enqueues the timed
        # launch, so a wrapper's host time is not read as device time
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_mpq(torch, name, x, qt):
    """Kernel 1 on ``x`` against its plain version: f32 out within
    max|d|/max|ref| <= 1e-3, a second launch bit-equal (no atomics), and the
    bf16 out bit-equal to the f32 out cast once."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import (
        mpq_matmul, mpq_matmul_ref, mpq_matmul_route,
    )

    got = mpq_matmul(x, qt, torch.float32)
    want = mpq_matmul_ref(x, qt, torch.float32)
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    again = torch.equal(got, mpq_matmul(x, qt, torch.float32))
    cast = torch.equal(mpq_matmul(x, qt, torch.bfloat16), got.to(torch.bfloat16))
    route = mpq_matmul_route(x.dtype, qt)
    log(f"kernel mpq_matmul {name:34s} m={x.shape[0]:<3d} {str(x.dtype)[6:]:8s} {route:6s} "
        f"max|d|={err:.3e} rel={rel:.3e} rerun bit-equal={again} bf16 out = cast of f32 out: {cast}")
    check(rel <= 1e-3, f"kernel 1 {name} m={x.shape[0]}: rel {rel} > 1e-3")
    check(again, f"kernel 1 {name} m={x.shape[0]}: two launches differ")
    check(cast, f"kernel 1 {name} m={x.shape[0]}: bf16 out is not the f32 out cast")
    return dict(check=name, m=x.shape[0], x_dtype=str(x.dtype)[6:], route=route,
                max_abs_err=err, rel_err=rel)


def mpq_weight(torch, gen, k, n, w_bit=4, gs=128, meta=None):
    """A random ``normal × 0.02`` (K, N) weight from ``gen``, quantized and
    brought to the kernels' form with ``meta`` (default bf16) metadata."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import prepare_for_kernel
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq

    w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
    return prepare_for_kernel(quantize_mpq(w, w_bit=w_bit, group_size=gs), meta or torch.bfloat16)


def check_dequant(torch, name, qt):
    """Kernel 2 on ``qt`` bit-equal to its plain version in every zero form
    the tensor has (a sym tensor's one; an asym tensor's kernel form and
    its exact form), writing bf16 and f32; the rows of the checks."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import (
        dequant_mpq, dequant_mpq_ref, zero_form,
    )

    k, n = qt.logical_shape
    rows = []
    for exact in ((False, True) if qt.asym else (False,)):
        form = zero_form(qt, exact)
        # the plain version rounds once to f32, then casts
        want32 = dequant_mpq_ref(qt, torch.float32, exact)
        for dtype in (torch.bfloat16, torch.float32):
            got = dequant_mpq(qt, dtype, exact)
            want = want32.to(dtype)
            equal = torch.equal(got, want)
            err = 0.0 if equal else (got.float() - want.float()).abs().max().item()
            del got, want
            log(f"kernel dequant_mpq {name:22s} K={k} N={n} {form:11s} {str(dtype)[6:]:8s} "
                f"{str(qt.scales.dtype)[6:]} meta{' q_perm' if qt.q_perm is not None else ''}: "
                f"bit-equal={equal}")
            check(equal, f"dequant_mpq {name} {form} {dtype}: max|d| {err} against the plain version")
            rows.append(dict(check=name, form=form, dtype=str(dtype)[6:], q_perm=qt.q_perm is not None,
                             max_abs_err=err))
        del want32
    return rows


def asym_weight(torch, gen, k, n, w_bit=4, gs=128, meta=None):
    """A random ``normal × 0.02`` (K, N) weight from ``gen`` quantized asym
    (packed integer zeros; scales in ``meta``, default bf16) with a random
    ``q_perm``: an act-order GPTQ export's form, as kernel 2 reads it."""
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq

    w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
    qt = quantize_mpq(w, w_bit=w_bit, group_size=gs, asym=True)
    perm = torch.randperm(k, device="cuda", generator=gen).to(torch.int32)
    return qt.replace(scales=qt.scales.to(meta or torch.bfloat16), q_perm=perm)


def mpq_kernel_rows(torch, name, x, qt, flush, out_dtype=None):
    """Kernel 1 on ``x`` and kernel 2 at one (K, N): each against its plain
    version (``check_mpq``; kernel 2 bit-equal in bf16 and f32), then timed beside
    its plain version, ``torch.matmul`` on the bf16 weight (kernel 1) and
    its bound; kernel 1 timed writing ``out_dtype`` (default ``x.dtype``;
    f32 for a row-parallel shard's partial).  Returns (kernel 1's check,
    its row, kernel 2's row)."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import (
        dequant_mpq, dequant_mpq_ref, mpq_matmul, mpq_matmul_ref,
    )

    (k, n), m = qt.logical_shape, x.shape[0]
    main = check_mpq(torch, f"{name} K={k} N={n}", x, qt)
    check_dequant(torch, name, qt)
    w_bf16 = dequant_mpq_ref(qt, torch.bfloat16)
    meta = qt.packed.nbytes + qt.scales.nbytes + qt.zeros.nbytes
    out_bytes = 4 if out_dtype == torch.float32 else 2
    b1, by1 = bound(meta + x.nbytes + m * n * out_bytes, 2 * m * k * n)
    ms = time_ms(torch, lambda: mpq_matmul(x, qt, out_dtype), flush=flush)
    row1 = dict(
        shape=name, K=k, N=n, m=m, max_abs_err=main["max_abs_err"], rel_err=main["rel_err"],
        ms=ms, per_launch_us=ms * 1e3,
        plain_ms=time_ms(torch, lambda: mpq_matmul_ref(x, qt, out_dtype), flush=flush),
        library_ms=time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush),
        bound_ms=b1, bound_by=by1,
    )
    b2, by2 = bound(meta + k * n * 2, 2 * k * n)
    row2 = dict(
        shape=name, K=k, N=n, max_abs_err=0.0, rel_err=0.0,
        ms=time_ms(torch, lambda: dequant_mpq(qt), flush=flush),
        plain_ms=time_ms(torch, lambda: dequant_mpq_ref(qt), flush=flush),
        library_ms=None, bound_ms=b2, bound_by=by2,
    )
    return main, row1, row2


def split_sweep(torch, mbwq_mm, x, segs, flush):
    """The tensor-core body on ``x`` and ``segs`` timed unsplit and as a
    cluster of 2 along K, through its launcher (no wrapper, so no launch
    is counted): the measurement behind ``k_splits``."""
    out = torch.empty((x.shape[0], segs[0].out_features), dtype=x.dtype, device="cuda")
    return {split: time_ms(torch, lambda split=split: mbwq_mm.launch_mma(
        x, segs, out, "split sweep", split), flush=flush) for split in (1, 2)}


def phase_kernels(torch, gen, flush):
    """Phases 2 and 3: every kernel against its plain version, then timed;
    kernel 1's A16 crossover against kernel 2 + ``torch.matmul``."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import (
        dequant_mpq, mpq_matmul, mpq_matmul_route,
    )
    from bitorch_engine_tpu_torch.ops.mpq_linear import MAX_FUSED_ROWS_A16

    # the module (the package's ``mbwq_matmul`` attribute is the wrapper)
    mbwq_mm = importlib.import_module("bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul")

    results = {name: [] for name in TPU_KERNELS}
    kernel1_checks, crossover = [], {}
    # kernel 1's further checks and its crossover draw from their own
    # generator, so the later phases get the inputs they got before these
    # were added (the MBWQ A8 path check moves with its prompt)
    k1_gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    # kernel 2's asym and act-order checks likewise
    k2_gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    # kernel 1 and 2 at the serving shapes (w4 g128, bf16 metadata, m = 8;
    # kernel 1 also at KERNEL1_CHECK_M rows, and timed against kernel 2 +
    # torch.matmul at CROSSOVER_M rows)
    for name, (k, n) in PROJ_SHAPES.items():
        qt = mpq_weight(torch, gen, k, n, 4)
        check(mpq_matmul_route(torch.bfloat16, qt) == "mma", f"kernel 1 {name}: not the mma body")
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        main, row1, row2 = mpq_kernel_rows(torch, name, x, qt, flush)
        kernel1_checks.append(main)
        check_dequant(torch, f"{name} asym act-order", asym_weight(torch, k2_gen, k, n))
        for m in KERNEL1_CHECK_M:
            xm = torch.randn(m, k, device="cuda", generator=k1_gen).to(torch.bfloat16)
            kernel1_checks.append(check_mpq(torch, f"{name} K={k} N={n}", xm, qt))
        if name == "o":  # the f32-activation route: the scalar body
            kernel1_checks.append(check_mpq(torch, f"{name} K={k} N={n} (f32 x)", x.float(), qt))
        row1.update(n_split=1, ms_by_split=split_sweep(torch, mbwq_mm, x, (qt,), flush))
        results["mpq_matmul"].append(row1)
        results["dequant_mpq"].append(row2)
        crossover[name] = {}
        for m in CROSSOVER_M:
            xm = torch.randn(m, k, device="cuda", generator=k1_gen).to(torch.bfloat16)
            crossover[name][m] = dict(
                kernel1_ms=time_ms(torch, lambda: mpq_matmul(xm, qt), flush=flush),
                kernel2_matmul_ms=time_ms(torch, lambda: torch.matmul(xm, dequant_mpq(qt)),
                                          flush=flush))
        del qt

    # kernel 1 and 2 at the other container widths, one small shape each
    for w_bit in (1, 2, 8):
        qt = mpq_weight(torch, gen, 1024, 512, w_bit)
        x = torch.randn(8, 1024, device="cuda", generator=gen).to(torch.bfloat16)
        kernel1_checks.append(check_mpq(torch, f"w{w_bit}g128 K=1024 N=512", x, qt))
        check_dequant(torch, f"w{w_bit}g128", qt)
    # kernel 2 on asym act-order tensors with f32 scales at every width
    for w_bit, n in ((1, 544), (2, 528), (4, 520), (8, 516)):
        check_dequant(torch, f"w{w_bit}g128 asym act-order",
                      asym_weight(torch, k2_gen, 1024, n, w_bit, meta=torch.float32))
    # and kernel 1 at every width, bf16 and f32 metadata, a ragged N, m 1-512
    for w_bit, gs in KERNEL1_WIDTHS:
        for meta in (torch.bfloat16, torch.float32):
            qt = mpq_weight(torch, k1_gen, 1024, 516, w_bit, gs, meta)
            check_dequant(torch, f"w{w_bit}g{gs} N=516", qt)
            for m in KERNEL1_CHECK_M:
                x = torch.randn(m, 1024, device="cuda", generator=k1_gen).to(torch.bfloat16)
                kernel1_checks.append(check_mpq(
                    torch, f"w{w_bit}g{gs} K=1024 N=516 {str(meta)[6:]} meta", x, qt))
        # N not a multiple of 4: kernel 2 a column at a time
        check_dequant(torch, f"w{w_bit}g{gs} ragged", mpq_weight(torch, k2_gen, 1024, 518, w_bit, gs))

    # kernel 3: the prefill's attention, a d = 64 shape and the train shape
    # the train shape draws from its own generator, so the later phases get
    # the inputs they got before it was added
    train_gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for name, b, nh, nkv, s, d in FLASH_FWD_SHAPES:
        g = train_gen if name == FLASH_TRAIN else gen
        results["flash_attention"].append(flash_row(torch, g, name, b, nh, nkv, s, d, flush))
    for name, rows in results.items():
        for r in rows:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {name:16s} {r['shape']:30s} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    for r in results["mpq_matmul"]:
        log(f"kernel 1 {r['shape']:8s} split {r['n_split']}; by cluster size " + "  ".join(
            f"{s}: {v * 1e3:.2f} us" for s, v in r["ms_by_split"].items()))
    # the A16 crossover: the largest m at which kernel 1 wins at every shape
    wins = [m for m in CROSSOVER_M
            if all(c[m]["kernel1_ms"] < c[m]["kernel2_matmul_ms"] for c in crossover.values())]
    for name, c in crossover.items():
        log(f"A16 crossover {name:8s} " + "  ".join(
            f"m={m}: {v['kernel1_ms'] * 1e3:.1f} / {v['kernel2_matmul_ms'] * 1e3:.1f} us"
            for m, v in c.items()) + "  (kernel 1 / kernel 2 + torch.matmul)")
    won = None
    for m in CROSSOVER_M:
        if m not in wins:
            break
        won = m
    log(f"A16 crossover: kernel 1 wins at every shape up to m = {won}; MAX_FUSED_ROWS_A16 = "
        f"{MAX_FUSED_ROWS_A16}")
    extra = dict(kernel1_checks=kernel1_checks, a16_crossover=crossover, a16_kernel1_wins_to=won)
    return results, extra


def flash_row(torch, gen, name, b, nh, nkv, s, d, flush, causal=True):
    """Kernel 3 (causal unless told) on random bf16 q / k / v drawn from ``gen``
    against its plain version (out atol / rtol 1e-2 with at most
    ``FWD_DIFFERING_MAX`` of its bf16 elements differing, lse within 1e-4),
    then timed beside its plain version, SDPA and its bound."""
    from bitorch_engine_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_ref,
    )

    F = torch.nn.functional
    q = torch.randn(b, nh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, nkv, s, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, nkv, s, d, device="cuda", generator=gen).to(torch.bfloat16)
    out, lse = flash_attention(q, k, v, causal)
    ref_out, ref_lse = flash_attention_ref(q, k, v, causal)
    err = (out.float() - ref_out.float()).abs().max().item()
    rel = err / ref_out.float().abs().max().item()
    differing = (out != ref_out).float().mean().item()
    # lse within 1e-4 relative, or 1e-4 absolute where |lse| < 1 (a row
    # whose lse is near 0 has no relative error to speak of)
    lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max().item()
    ok = torch.allclose(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
    log(f"kernel flash_attention {name:30s} max|d out|={err:.3e} rel={rel:.3e} bf16 elements "
        f"differing {differing:.2e}  lse err={lse_err:.3e}")
    check(ok and differing <= FWD_DIFFERING_MAX and lse_err <= 1e-4,
          f"flash_attention {name}: out err {err}, differing {differing}, lse err {lse_err}")
    nbytes = (q.nbytes + k.nbytes + v.nbytes) + out.nbytes + lse.nbytes
    pairs = s * (s + 1) / 2 if causal else s * s
    ops = b * nh * 4 * d * pairs  # QK^T and PV over the visible pairs
    b3, by3 = bound(nbytes, ops)
    row = dict(
        shape=name, causal=causal, max_abs_err=err, rel_err=lse_err, out_rel_err=rel,
        bf16_elements_differing=differing, lse_err=lse_err,
        ms=time_ms(torch, lambda: flash_attention(q, k, v, causal), flush=flush),
        plain_ms=time_ms(torch, lambda: flash_attention_ref(q, k, v, causal), flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), flush=flush),
        bound_ms=b3, bound_by=by3,
    )
    del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return row


def paged_inputs(torch, gen, b, W, rs, pool, slot_pages=PAGES_PER_SLOT, nkv=NKV):
    """Inputs of one paged-attention shape: a shuffled page table read as a
    column slice of the full per-slot table of ``slot_pages`` pages,
    per-slot cache lengths with 0 and W - 1, slot 1 inactive (its row all
    null page 0, length 0); ``nkv`` KV heads of ``HD``."""
    import numpy as np

    rng = np.random.default_rng(b * 7919 + W + rs)
    P = W // PAGE
    pages = b * slot_pages + 1
    shape = (pages, PAGE, nkv * HD)
    dev = dict(device="cuda")
    q = torch.randn(b, nkv, rs, HD, generator=gen, **dev).to(torch.bfloat16)
    if pool == "int8":
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, **dev)
                  for _ in range(2))
        ks, vs = (torch.rand(b, slot_pages * PAGE, nkv, generator=gen, **dev) * 0.02 + 0.01
                  for _ in range(2))
        kn, vn = (torch.randint(-127, 128, (b, nkv * HD), generator=gen, dtype=torch.int8, **dev)
                  for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=gen, **dev).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
        kn, vn = (torch.randn(b, nkv * HD, generator=gen, **dev).to(torch.bfloat16)
                  for _ in range(2))
    full = (rng.permutation(pages - 1) + 1).reshape(b, slot_pages).astype(np.int32)
    clen = rng.integers(1, W, b).astype(np.int32)
    clen[0], clen[-1] = 0, W - 1
    full[1], clen[1] = 0, 0
    table = torch.from_numpy(full).cuda()[:, :P]
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, table=table, kn=kn, vn=vn,
                clen=torch.from_numpy(clen).cuda(), clen_np=clen)


def paged_route(torch, pa, a, update):
    """The kernel the wrapper picks for ``a`` and its cluster size."""
    b, nkv, rs, hd = a["q"].shape
    P = a["table"].shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernel = pa.kernel_route(b, nkv, rs, hd, P, PAGE, update, sms)
    if kernel == "paged_decode_kernel":
        return kernel, pa.decode_plan(b, nkv, rs, hd, P, PAGE, sms)[1]
    return kernel, 1


def check_paged(torch, name, a, update):
    """One paged-attention launch on ``a`` (``paged_inputs``) against its
    plain version: acc max|d|/max|ref| <= 5e-3, m and l <= 1e-4 on the live
    slots, empty slots exact, the pools bit-equal after the write (the
    read-only form leaves them as they were), a second launch bit-equal.
    Returns (acc max|d|, acc rel, m rel, l rel, pools equal, rerun equal);
    the pools are left as they were."""
    from bitorch_engine_tpu_torch.ops.cuda import paged_attention as pa

    sm = 1.0 / math.sqrt(HD)
    args = (a["q"], a["kp"], a["vp"], a["ks"], a["vs"], a["table"], a["clen"])
    kp0, vp0 = a["kp"].clone(), a["vp"].clone()
    kernel, n_split = paged_route(torch, pa, a, update)
    if update:
        got = pa.paged_prefix_attention_update(*args, a["kn"], a["vn"], sm_scale=sm)
        kp_got, vp_got = a["kp"].clone(), a["vp"].clone()
        a["kp"].copy_(kp0)
        a["vp"].copy_(vp0)
        again = pa.paged_prefix_attention_update(*args, a["kn"], a["vn"], sm_scale=sm)
        rerun = (all(torch.equal(x, y) for x, y in zip(got, again))
                 and torch.equal(a["kp"], kp_got) and torch.equal(a["vp"], vp_got))
        a["kp"].copy_(kp0)
        a["vp"].copy_(vp0)
        want = pa.paged_prefix_attention_update_ref(*args, a["kn"], a["vn"], sm)
        pools_equal = (torch.equal(kp_got[1:], a["kp"][1:])
                       and torch.equal(vp_got[1:], a["vp"][1:])
                       and not torch.equal(kp_got[1:], kp0[1:]))
        a["kp"].copy_(kp0)
        a["vp"].copy_(vp0)
    else:
        got = pa.paged_prefix_attention(*args, sm_scale=sm)
        again = pa.paged_prefix_attention(*args, sm_scale=sm)
        rerun = all(torch.equal(x, y) for x, y in zip(got, again))
        want = pa.paged_prefix_attention_ref(*args, sm)
        pools_equal = torch.equal(a["kp"], kp0) and torch.equal(a["vp"], vp0)
    torch.cuda.synchronize()
    live = a["clen"] > 0
    acc_err = (got[0] - want[0]).abs().max().item()
    acc_rel = acc_err / want[0].abs().max().item()

    def rel(i):
        return ((got[i][live] - want[i][live]).abs().max() / want[i][live].abs().max()).item()

    m_rel, l_rel = rel(1), rel(2)
    empty_ok = bool((got[1][~live] == pa.MASK).all() and (got[2][~live] == 0).all()
                    and (got[0][~live] == 0).all())
    log(f"kernel paged {name:22s} {kernel}, split {n_split}: "
        f"acc max|d|/max|ref|={acc_rel:.3e} m rel={m_rel:.3e} l rel={l_rel:.3e} empty slots "
        f"exact={empty_ok} pools bit-equal={pools_equal} rerun bit-equal={rerun}")
    check(acc_rel <= 5e-3 and m_rel <= 1e-4 and l_rel <= 1e-4 and empty_ok and pools_equal,
          f"paged attention {name}: acc {acc_rel}, m {m_rel}, l {l_rel}, "
          f"empty {empty_ok}, pools {pools_equal}")
    check(rerun, f"paged attention {name}: two launches differ")
    return acc_err, acc_rel, m_rel, l_rel, pools_equal, rerun


def paged_row(torch, a, name, W, pool, update, flush):
    """One paged-attention shape (``paged_inputs``) checked (``check_paged``)
    and timed beside its plain version, its bound and a yardstick (SDPA over
    the window already gathered and dequantized to bf16: no page walk, no
    dequantisation, no write).  Returns (the row, the kernel's launcher)."""
    from bitorch_engine_tpu_torch.ops.cuda import paged_attention as pa

    F = torch.nn.functional
    sm = 1.0 / math.sqrt(HD)
    b, nkv, rs, _ = a["q"].shape
    args = (a["q"], a["kp"], a["vp"], a["ks"], a["vs"], a["table"], a["clen"])
    kernel_name, n_split = paged_route(torch, pa, a, update)
    acc_err, acc_rel, m_rel, l_rel, pools_equal, rerun = check_paged(torch, name, a, update)
    # bound: q, the valid K / V rows and their scales, the table, the
    # outputs, and the new rows read and written; dots at the bf16 rate
    elt = 1 if pool == "int8" else 2
    nv = int(sum(min(int(c), W) for c in a["clen_np"]))
    nbytes = (a["q"].nbytes + 2 * nv * nkv * HD * elt + (2 * nv * nkv * 4 if pool == "int8" else 0)
              + b * (W // PAGE) * 4 + b * 4 + b * nkv * rs * (HD + 2) * 4
              + (4 * b * nkv * HD * elt if update else 0))
    bms, bby = bound(nbytes, 4 * nv * nkv * rs * HD)

    def window(pool_, scale):
        g = pool_[a["table"].long()].reshape(b, W, nkv, HD).float()
        if scale is not None:
            g = g * scale[:, :W, :, None]
        return g.to(torch.bfloat16).transpose(1, 2).contiguous()

    kd, vd = window(a["kp"], a["ks"]), window(a["vp"], a["vs"])
    s = rs // REP
    qs = a["q"].reshape(b, nkv, REP, s, HD).reshape(b, nkv * REP, s, HD)
    mask = (torch.arange(W, device="cuda") < a["clen"][:, None])[:, None, None, :]
    if update:
        kernel = lambda: pa.paged_prefix_attention_update(*args, a["kn"], a["vn"], sm_scale=sm)
        plain = lambda: pa.paged_prefix_attention_update_ref(*args, a["kn"], a["vn"], sm)
    else:
        kernel = lambda: pa.paged_prefix_attention(*args, sm_scale=sm)
        plain = lambda: pa.paged_prefix_attention_ref(*args, sm)
    row = dict(
        shape=name, b=b, W=W, rs=rs, pool=pool, nkv=nkv, max_abs_err=acc_err, rel_err=acc_rel,
        m_rel=m_rel, l_rel=l_rel, pools_bit_equal=pools_equal, rerun_bit_equal=rerun,
        pages=W // PAGE, kernel=kernel_name, n_split=n_split,
        ms=time_ms(torch, kernel, flush=flush),
        plain_ms=time_ms(torch, plain, flush=flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask, enable_gqa=True), flush=flush),
        bound_ms=bms, bound_by=bby,
    )
    return row, kernel


def phase_paged_kernels(torch, gen, flush):
    """Phase 5a: both paged-attention entry points against their plain
    versions (``check_paged``), then timed, at the serving slice's shapes;
    the write-back rows run the decode kernel split over a cluster of
    ``window_splits`` blocks, also checked at 1, 2 and 8 query rows a KV
    head; the read-only rows run the chunk kernel, also timed on the first
    kernel (``paged_attention_kernel``, through ``first_kernels``)."""
    from bitorch_engine_tpu_torch.ops.cuda import paged_attention as pa

    results = {"paged_prefix_attention": [], "paged_prefix_attention_update": []}
    # the rows added later draw from their own generator: the later phases
    # keep their inputs
    chunk_gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    for (name, b, W, rs, pool, update), row_gen in (
            [(row, gen) for row in PAGED_SHAPES] + [(row, chunk_gen) for row in CHUNK_SHAPES]):
        a = paged_inputs(torch, row_gen, b, W, rs, pool)
        row, kernel = paged_row(torch, a, name, W, pool, update, flush)
        decode = row["kernel"] == "paged_decode_kernel"
        by_split = {}  # the decode kernel with each cluster size forced
        for split in (1, 2, 4) if decode else ():
            if split <= W // PAGE:
                with mock.patch.object(pa, "window_splits", lambda *_, split=split, **__: split):
                    by_split[split] = time_ms(torch, kernel, flush=flush)
        first_ms = None  # the read-only form on its first kernel, in turns with the chunk kernel
        if not update:
            with first_kernels():
                check(paged_route(torch, pa, a, update)[0] == "paged_attention_kernel",
                      f"paged attention {name}: first_kernels did not reroute")
                first_ms = time_ms(torch, kernel, flush=flush)
        key = "paged_prefix_attention_update" if update else "paged_prefix_attention"
        results[key].append(dict(row, ms_by_split=by_split, first_kernel_ms=first_ms))
        del a
    # the decode kernel at the other query-row counts it takes (MHA's 1, and
    # 2 and 8 query heads a KV head), checked, not timed; their inputs come
    # from their own generator, so the later phases keep theirs
    rows_gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for rs in (1, 2, 8):
        for pool in ("int8", "bf16"):
            a = paged_inputs(torch, rows_gen, BATCH, 512, rs, pool)
            check_paged(torch, f"decode_b8_w512_rs{rs}_{pool}", a, True)
            del a
    # the write-back route at long windows, checked, not timed: a full card
    # whose 8K windows overflow one block's shared memory takes a cluster of
    # 2, and 8 rows over 32K positions (no cluster of <= 4 fits) the
    # row-tiled kernel
    for name, b, W, rs, want in (("decode_b17_w8192", 17, 8192, REP, ("paged_decode_kernel", 2)),
                                 ("decode_b3_w32768_rs8", 3, 32768, 8,
                                  ("paged_attention_kernel", 1))):
        a = paged_inputs(torch, rows_gen, b, W, rs, "int8", slot_pages=W // PAGE)
        route = paged_route(torch, pa, a, True)
        check(route == want, f"paged attention {name}: route {route}, not {want}")
        check_paged(torch, name, a, True)
        del a
    for name, rows in results.items():
        for r in rows:
            first = ("" if r["first_kernel_ms"] is None else
                     f"; on the first kernel (paged_attention_kernel) {r['first_kernel_ms']:.4f} ms")
            log(f"time {name:30s} {r['shape']:26s} {r['kernel']} split {r['n_split']} kernel "
                f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  sdpa-on-gathered-window "
                f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}){first}"
                + ("; by cluster size " + "  ".join(f"{s}: {v * 1e3:.2f} us"
                                                     for s, v in r["ms_by_split"].items())
                   if r["ms_by_split"] else ""))
    torch.cuda.empty_cache()
    return results


def build_model(torch, num_layers, seed, config="llama3_8b_serving"):
    """A serving model (``config`` names its factory in ``models.llama``) at
    ``num_layers``, random from ``seed``, in the kernels' form."""
    from bitorch_engine_tpu_torch.models import llama
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    cfg = getattr(llama, config)(max_seq_len=CACHE, num_layers=num_layers)
    model = llama.LlamaModel(cfg, device="cuda", seed=seed)
    return prepare_params_for_cuda(model, meta_dtype=torch.bfloat16)


def paged_caches(torch, cfg, batch, cache=CACHE):
    """Paged caches with every slot's pages allocated for ``cache`` positions."""
    from bitorch_engine_tpu_torch.models.paged_kv import PageAllocator, init_paged_kv_caches

    per_slot = cache // PAGE
    alloc = PageAllocator(batch * per_slot + 1, PAGE, batch, per_slot)
    for slot in range(batch):
        check(alloc.alloc(slot, cache), "page allocation")
    caches = init_paged_kv_caches(cfg, batch * per_slot + 1, PAGE, batch, per_slot, device="cuda")
    caches[0].page_table.copy_(torch.from_numpy(alloc.table))
    return caches


def serve(torch, model, prompt, steps, on_prefill=None, forced=None, paged=False, floor=256):
    """prefill (window 0) + greedy decode steps with the bucketed window,
    over dense or paged caches; returns (last logits, generated tokens
    (b, steps + 1))."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches, prefill

    if paged:
        caches = paged_caches(torch, model.cfg, BATCH)
    else:
        caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda")
    logits, caches = prefill(model, prompt, caches)
    last = logits[:, -1]
    if on_prefill is not None:
        on_prefill(logits)
    tok = torch.argmax(last, dim=-1) if forced is None else forced[:, 0]
    toks = [tok]
    for i in range(steps):
        pos = PROMPT + i
        last, caches = decode_step(model, tok[:, None], caches, pos, attn_window=bucket(pos + 1, floor))
        tok = torch.argmax(last, dim=-1) if forced is None else forced[:, i + 1]
        toks.append(tok)
    return last, torch.stack(toks, dim=1)


def serve_chunked(torch, model, prompt, steps, forced=None):
    """The batcher's chunked prefill (``ContinuousBatcher._prefill_chunked``)
    over paged caches: chunk j of ``SERVE["prefill_chunk"]`` tokens at
    cache_len j·C, window 0 for the first and the bucketed window of its
    prefix after (the read-only kernel reads it), then greedy decode steps;
    returns (last logits, generated tokens (b, steps + 1))."""
    from bitorch_engine_tpu_torch.models.llama import decode_step

    caches = paged_caches(torch, model.cfg, BATCH)
    n, C = prompt.shape[1], SERVE["prefill_chunk"]
    with torch.no_grad():
        for j in range(n // C):
            base = j * C
            positions = (base + torch.arange(C, device="cuda")).expand(BATCH, C)
            logits, caches = model(prompt[:, base : base + C], positions=positions, kv_caches=caches,
                                   cache_len=base, attn_window=0 if j == 0 else bucket(base))
    last = logits[:, -1]
    tok = torch.argmax(last, dim=-1) if forced is None else forced[:, 0]
    toks = [tok]
    for i in range(steps):
        pos = n + i
        last, caches = decode_step(model, tok[:, None], caches, pos, attn_window=bucket(pos + 1))
        tok = torch.argmax(last, dim=-1) if forced is None else forced[:, i + 1]
        toks.append(tok)
    return last, torch.stack(toks, dim=1)


def profile_serve(torch, model, prompt, steps):
    """The serving loop once more under ``torch.profiler``: one profiler
    over the prefill, a second over the decode steps."""
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    profs = [profiler() for _ in range(2)]
    marks = []

    def switch(_logits):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        profs[0].stop()
        profs[1].start()
        marks.append(time.perf_counter())

    profs[0].start()
    t0 = time.perf_counter()
    serve(torch, model, prompt, steps, on_prefill=switch)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    profs[1].stop()
    out = dict(prefill=device_summary(profs[0], marks[0] - t0, 1),
               decode=device_summary(profs[1], t_end - marks[1], steps))
    for phase, r in out.items():
        log(f"profile {phase}: wall {r['wall_ms_per_call']:.2f} ms/call (profiled), device busy "
            f"{r['device_busy_ms_per_call']:.2f} ms/call, idle share {r['idle_share']:.3f}, "
            f"{r['launches_per_call']:.0f} launches/call")
        for kern in r["top_kernels"]:
            log(f"  {kern['ms_per_call']:8.3f} ms  {kern['launches_per_call']:6.1f}x  {kern['name']}")
    return out


def phase_e2e(torch, gen, model, proj=4 * LAYERS + 1, label="e2e"):
    """Phase 4 (and 18b): the full-width serving path, with the launch
    counts: ``proj`` projection launches per pass (kernel 1 per decode
    step, kernel 2 per prefill), one flash launch per layer per prefill."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    layers = model.cfg.num_layers
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    serve(torch, model, prompt, 2)  # warm-up (cuBLAS heuristics, allocator)
    torch.cuda.synchronize()

    marks = {}

    def at_prefill(logits):
        torch.cuda.synchronize()
        marks["prefill"] = time.perf_counter()
        marks["counts_prefill"] = launch_counts()
        check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")

    reset_launch_counts()
    t0 = time.perf_counter()
    last, toks = serve(torch, model, prompt, DECODE_STEPS, on_prefill=at_prefill)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = launch_counts()
    prefill_ms = (marks["prefill"] - t0) * 1e3
    step_ms = (t_end - marks["prefill"]) * 1e3 / DECODE_STEPS
    pre = marks["counts_prefill"]
    log(f"{label} launches at prefill {pre}; over the run {counts}")
    check(pre == counts_with(dequant_mpq=proj, flash_attention=layers),
          f"{label} prefill launches {pre}")
    check(counts == counts_with(mpq_matmul=proj * DECODE_STEPS, dequant_mpq=proj,
                                flash_attention=layers), f"{label} run launches {counts}")
    check(bool(torch.isfinite(last).all()), "decode logits are not finite")
    check(bool(((toks >= 0) & (toks < model.cfg.vocab_size)).all()), "token ids out of range")
    e2e = dict(
        prefill_ms=prefill_ms, prefill_tok_s=BATCH * PROMPT / prefill_ms * 1e3,
        decode_ms_per_step=step_ms, decode_tok_s=BATCH / step_ms * 1e3,
        batch=BATCH, prompt=PROMPT, decode_steps=DECODE_STEPS, cache=CACHE,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"{label} prefill {prefill_ms:.2f} ms ({e2e['prefill_tok_s']:.0f} tok/s); decode "
        f"{step_ms:.3f} ms/step ({e2e['decode_tok_s']:.1f} tok/s), batch {BATCH}")
    profiled = profile_serve(torch, model, prompt, PROFILE_STEPS)
    # the profiled run's wall is inflated by the profiler's host cost; this
    # divides its device time by the unprofiled run's step time instead
    profiled["decode"]["idle_share_estimate_unprofiled"] = (
        1.0 - profiled["decode"]["device_busy_ms_per_call"] / step_ms)
    e2e["profile"] = profiled
    torch.cuda.empty_cache()
    return counts, e2e


def phase_serving(torch, model, n_requests=N_REQUESTS, prompt_lens=(32, 512), new_tokens=(16, 64)):
    """Phase 5b (and 18c): the serving slice's main path: a mixed queue of
    ``n_requests`` seeded requests (prompt lengths and new tokens drawn
    uniformly from the closed ranges given) through ContinuousBatcher over
    the paged cache, on the full-width model."""
    import numpy as np

    from bitorch_engine_tpu_torch.models.generate import ContinuousBatcher
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    rng = np.random.default_rng(SEED)
    (p_lo, p_hi), (n_lo, n_hi) = prompt_lens, new_tokens
    queue = [(rng.integers(0, vocab, int(rng.integers(p_lo, p_hi + 1))).tolist(),
              int(rng.integers(n_lo, n_hi + 1)))
             for _ in range(n_requests)]
    # warm-up (allocator, cuBLAS heuristics): one chunked wave, a few steps
    warm = ContinuousBatcher(model, **SERVE)
    for prompt, _ in queue[:8]:
        warm.submit(prompt, max_new_tokens=4)
    warm.run()
    del warm

    finite = []
    hook = model.register_forward_hook(lambda mod, inp, out: finite.append(torch.isfinite(out[0]).all()))
    b = ContinuousBatcher(model, **SERVE)
    reqs = []
    for prompt, n_new in queue:
        b.submit(prompt, max_new_tokens=n_new)
        reqs.append(b.queue[-1])
    tally = {"decode_steps": 0, "chunks_after_first": 0, "waves": 0}
    first_token_s = {}
    inner = dict(decode=b._decode, chunked=b._prefill_chunked, slots=b._prefill_slots,
                 admit=b._admit)

    def decode(*a):
        tally["decode_steps"] += 1
        return inner["decode"](*a)

    def chunked(padded, *a):
        tally["waves"] += 1
        tally["chunks_after_first"] += padded.shape[1] // SERVE["prefill_chunk"] - 1
        return inner["chunked"](padded, *a)

    def slots(*a):
        tally["waves"] += 1
        return inner["slots"](*a)

    def admit():
        inner["admit"]()  # ends in a host read of the first tokens
        now = time.perf_counter()
        for r in reqs:
            if r.generated and r.uid not in first_token_s:
                first_token_s[r.uid] = now - t0

    b._decode, b._prefill_chunked, b._prefill_slots, b._admit = decode, chunked, slots, admit
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    done = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    hook.remove()
    for name in ("_decode", "_prefill_chunked", "_prefill_slots", "_admit"):
        # the wrappers close over b: the cycle held the batcher and its model
        # (Mixtral's 23 GiB from phase 18 on) until a collection ran
        delattr(b, name)

    check(len(done) == n_requests, f"serving: {len(done)} of {n_requests} requests returned")
    for r, (_, n_new) in zip(done, queue):
        check(len(r.generated) == n_new and all(0 <= t < vocab for t in r.generated),
              f"serving: request {r.uid} returned {len(r.generated)} ids, wanted {n_new} in range")
    check(bool(torch.stack(finite).all()), "serving: non-finite logits")
    check(len(b.allocator.free) == SERVE["kv_pages"] - 1 and not b.allocator.table.any(),
          "serving: pages not all returned after run()")
    want_wb = layers * tally["decode_steps"]
    want_ro = layers * tally["chunks_after_first"]
    chunked = max(len(p) for p, _ in queue) > SERVE["prefill_chunk"]
    log(f"serving launches {counts}; decode steps {tally['decode_steps']}, prefill chunks "
        f"after the first {tally['chunks_after_first']}")
    check(counts["paged_prefix_attention_update"] == want_wb,
          f"serving: write-back kernel launched {counts['paged_prefix_attention_update']} != {want_wb}")
    check(counts["paged_prefix_attention"] == want_ro and (want_ro > 0) == chunked,
          f"serving: read-only kernel launched {counts['paged_prefix_attention']} != {want_ro}")
    generated = sum(n for _, n in queue)
    ttft = sorted(first_token_s.values())
    out = dict(
        requests=n_requests, wall_s=wall, requests_per_s=n_requests / wall,
        generated_tokens=generated, generated_tok_s=generated / wall,
        prompt_tokens=sum(len(p) for p, _ in queue),
        ttft_median_ms=statistics.median(ttft) * 1e3, ttft_max_ms=ttft[-1] * 1e3,
        admission_waves=tally["waves"], decode_steps=tally["decode_steps"],
        decode_ms_per_step_incl_admission=wall * 1e3 / max(1, tally["decode_steps"]),
        chunks_after_first=tally["chunks_after_first"], launches=counts, config=SERVE,
    )
    log(f"serving: {n_requests} requests in {wall:.3f} s ({out['requests_per_s']:.3f} req/s, "
        f"{out['generated_tok_s']:.1f} generated tok/s), median time to first token "
        f"{out['ttft_median_ms']:.1f} ms, {tally['decode_steps']} decode steps, "
        f"{tally['waves']} admission waves")
    return counts, out


@contextmanager
def first_kernels():
    """Run kernel 1 on its first (scalar) body for bf16 activations too, and
    both forms of kernel 6 on its first kernel (``paged_attention_kernel``,
    no split, f32 FMAs): the paged path as it ran before the tensor-core
    bodies, the split decode kernel and the chunk kernel."""
    from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as dm
    from bitorch_engine_tpu_torch.ops.cuda import paged_attention as pa

    with mock.patch.object(dm, "mpq_matmul_route", lambda x_dtype, qt: "scalar"), \
            mock.patch.object(pa, "kernel_route", lambda *a, **k: "paged_attention_kernel"):
        yield


def phase_paged_vs_dense(torch, model):
    """Phase 5c: one decode step with dense and with paged caches at batch 8
    (window 512) and 64 (window 256), in turns dense, paged, first, first,
    paged, dense, where "first" is the paged step on the first kernels 1
    and 6 (``first_kernels``); device busy per step of each, profiled."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches

    cfg = model.cfg
    out = {}
    arm_names = ("dense", "paged", "paged_first_kernels")
    for batch, window, clen in ((8, 512, 300), (64, 256, 200)):
        arms = {"dense": init_kv_caches(cfg, batch, CACHE, device="cuda"),
                "paged": paged_caches(torch, cfg, batch)}
        arms["paged_first_kernels"] = arms["paged"]
        tok = torch.ones((batch, 1), dtype=torch.long, device="cuda")

        @contextmanager
        def kernels_of(arm):
            if arm == "paged_first_kernels":
                with first_kernels():
                    yield
            else:
                yield

        def timed(arm, steps=8):
            with kernels_of(arm):
                for _ in range(2):
                    decode_step(model, tok, arms[arm], clen, attn_window=window)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    decode_step(model, tok, arms[arm], clen, attn_window=window)
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps

        def busy(arm, steps=4):
            """Device busy ms per step and the largest kernels, profiled."""
            from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

            with kernels_of(arm), profiler() as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    decode_step(model, tok, arms[arm], clen, attn_window=window)
                torch.cuda.synchronize()
            return device_summary(prof, time.perf_counter() - t0, steps, top=4)

        ms = {arm: [] for arm in arm_names}
        for arm in ("dense", "paged", "paged_first_kernels", "paged_first_kernels", "paged", "dense"):
            ms[arm].append(timed(arm))
        prof = {arm: busy(arm) for arm in arm_names}
        r = dict(window=window, cache_len=clen, runs=ms, profile=prof)
        for arm in arm_names:
            r[f"{arm}_ms"] = statistics.mean(ms[arm])
            r[f"{arm}_busy_ms"] = prof[arm]["device_busy_ms_per_call"]
            r[f"{arm}_launches"] = prof[arm]["launches_per_call"]
        r["paged_over_dense"] = r["paged_ms"] / r["dense_ms"]
        r["paged_over_dense_busy"] = r["paged_busy_ms"] / r["dense_busy_ms"]
        out[f"b{batch}"] = r
        log(f"paged vs dense decode b{batch} window {window}: dense {r['dense_ms']:.3f} ms/step, "
            f"paged {r['paged_ms']:.3f} ms/step, ratio {r['paged_over_dense']:.4f}, paged on the "
            f"first kernels 1 and 6 {r['paged_first_kernels_ms']:.3f} ms/step (runs {ms}); device busy "
            f"dense {r['dense_busy_ms']:.3f} / paged {r['paged_busy_ms']:.3f} / paged on the first "
            f"kernels {r['paged_first_kernels_busy_ms']:.3f} ms/step, launches/step dense "
            f"{r['dense_launches']:.0f} / paged {r['paged_launches']:.0f} / first "
            f"{r['paged_first_kernels_launches']:.0f}")
        for arm in arm_names:
            for kern in prof[arm]["top_kernels"]:
                log(f"  {arm} {kern['ms_per_call']:8.3f} ms  {kern['launches_per_call']:6.1f}x  "
                    f"{kern['name']}")
        del arms
        torch.cuda.empty_cache()
    return out


@contextmanager
def plain_kernels():
    """Route the model's and the optimizer's nine kernel calls to their
    plain versions (the flash forward and backward inside the autograd
    Function, the dequant in the linears' backward and in DiodeMix, the
    packed binary linear's fused XNOR GEMM)."""
    from bitorch_engine_tpu_torch.models import llama
    from bitorch_engine_tpu_torch.ops import binary_linear, mbwq_linear, mpq_linear
    from bitorch_engine_tpu_torch.ops.cuda.binary_gemm import binary_packed_linear_ref
    from bitorch_engine_tpu_torch.ops.cuda import paged_attention as pa
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import dequant_mpq_ref, mpq_matmul_ref
    from bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul import mbwq_matmul_ref
    from bitorch_engine_tpu_torch.ops.cuda.quad_matmul import mpq_matmul_a8_ref

    # the module (the package's ``flash_attention`` attribute is the wrapper)
    fa = importlib.import_module("bitorch_engine_tpu_torch.ops.cuda.flash_attention")
    with mock.patch.object(mpq_linear, "mpq_matmul", mpq_matmul_ref), \
            mock.patch.object(mpq_linear, "mpq_matmul_a8", mpq_matmul_a8_ref), \
            mock.patch.object(mbwq_linear, "mbwq_matmul", mbwq_matmul_ref), \
            mock.patch.object(mpq_linear, "dequant_mpq", dequant_mpq_ref), \
            mock.patch.object(fa, "flash_attention", fa.flash_attention_ref), \
            mock.patch.object(fa, "flash_attention_bwd", fa.flash_attention_bwd_ref), \
            mock.patch.object(llama, "paged_prefix_attention", pa.paged_prefix_attention_ref), \
            mock.patch.object(llama, "paged_prefix_attention_update",
                              pa.paged_prefix_attention_update_ref), \
            mock.patch.object(binary_linear, "binary_packed_linear", binary_packed_linear_ref):
        yield


def phase_path_check(torch, gen):
    """Phase 6: 2 layers at full width, kernel path against plain path,
    both fed the kernel path's tokens, over dense and over paged caches
    (a whole-prompt prefill), and over paged caches with a 512-token prompt
    prefilled in two chunks as the batcher does (``serve_chunked``: the
    second chunk reads its prefix through the read-only kernel); each
    followed by 4 decode steps."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = build_model(torch, 2, SEED + 1)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    # the chunked check's prompt from its own generator: the later phases
    # keep their inputs
    chunk_gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    long_prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, CHUNKED_PROMPT), device="cuda",
                                generator=chunk_gen)
    chunks_after_first = CHUNKED_PROMPT // SERVE["prefill_chunk"] - 1

    def run(cache, forced=None):
        if cache == "paged_chunked":
            return serve_chunked(torch, model, long_prompt, 4, forced=forced)
        return serve(torch, model, prompt, 4, forced=forced, paged=cache == "paged")

    rels = {}
    for cache in ("dense", "paged", "paged_chunked"):
        reset_launch_counts()
        got, toks = run(cache)
        launched = launch_counts()
        reset_launch_counts()
        with plain_kernels():
            want, _ = run(cache, forced=toks)
        torch.cuda.synchronize()
        check(all(n == 0 for n in launch_counts().values()), "the plain path launched a kernel")
        if cache != "dense":
            check(launched["paged_prefix_attention_update"] == 2 * 4,
                  f"{cache} path check: write-back launches {launched}")
            want_ro = 2 * chunks_after_first if cache == "paged_chunked" else 0
            check(launched["paged_prefix_attention"] == want_ro,
                  f"{cache} path check: read-only launches {launched['paged_prefix_attention']} "
                  f"!= {want_ro}")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        log(f"path check ({cache} caches, 2 layers, prefill + 4 decode steps): "
            f"max|d logits|/max|logits| = {rel:.3e}")
        check(rel <= 2e-2, f"path check {cache}: {rel} > 2e-2")
        rels[cache] = rel
    del model
    torch.cuda.empty_cache()
    return rels


def phase_paged_gate(torch, gen):
    """Phase 7: tools/paged_gate.py on the card: 64 decode steps of one
    forced token stream through dense and paged caches (window 256 < the
    512 allocation, so the paged steps take the write-back kernel); the
    largest max|d logits| / max|dense logits| of a step must stay under
    the JAX gate's 2.5e-2."""
    from bitorch_engine_tpu_torch.models.llama import (
        LlamaConfig, LlamaModel, decode_step, init_kv_caches,
    )
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    steps, batch, cache, window, tol = 64, 8, 512, 256, 2.5e-2
    cfg = LlamaConfig(vocab_size=1024, hidden_size=2048, intermediate_size=4096, num_layers=4,
                      num_heads=16, num_kv_heads=4, max_seq_len=cache, w_bit=4, group_size=128,
                      kv_cache_dtype="int8", dtype=torch.bfloat16)
    model = prepare_params_for_cuda(LlamaModel(cfg, device="cuda", seed=SEED + 2), torch.bfloat16)
    dense = init_kv_caches(cfg, batch, cache, device="cuda")
    paged = paged_caches(torch, cfg, batch, cache)
    toks = torch.randint(0, cfg.vocab_size, (steps, batch, 1), device="cuda", generator=gen)
    reset_launch_counts()
    rels = []
    for i in range(steps):
        ld, _ = decode_step(model, toks[i], dense, i, attn_window=window)
        lp, _ = decode_step(model, toks[i], paged, i, attn_window=window)
        rels.append((ld - lp).abs().max() / (ld.abs().max() + 1e-9))
    max_rel = torch.stack(rels).max().item()
    launched = launch_counts()["paged_prefix_attention_update"]
    log(f"paged logits gate: max rel {max_rel:.4e} over {steps} steps (tol {tol}); "
        f"write-back launches {launched}")
    check(launched == cfg.num_layers * steps, f"paged gate: {launched} write-back launches")
    check(max_rel < tol, f"paged logits gate: {max_rel} >= {tol}")
    del model, dense, paged
    torch.cuda.empty_cache()
    return dict(max_rel=max_rel, steps=steps, tol=tol)

@contextmanager
def first_quad_body():
    """Run kernel 5 on its first body (``quad_matmul_kernel``, CUDA-core
    dp4a) at every shape."""
    from bitorch_engine_tpu_torch.ops.cuda import quad_matmul as qm

    with mock.patch.object(qm, "quad_route", lambda *a, **k: "dp4a"):
        yield


def check_quad(torch, name, x, qt, exact):
    """Kernel 5 on ``x`` against its plain version, the f32 accumulator
    before ``sx`` and the cast: max|d|/max|ref| <= 1e-4, and max|d| = 0 and
    the bf16 output bit-equal where ``exact``; a second launch bit-equal.
    Returns (max|d|, rel)."""
    from bitorch_engine_tpu_torch.ops.cuda import quad_matmul as qm

    got = qm.mpq_matmul_a8(x, qt, accumulator=True)
    want = qm.mpq_matmul_a8_ref(x, qt, accumulator=True)
    again = torch.equal(got, qm.mpq_matmul_a8(x, qt, accumulator=True))
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    # where the accumulator is exact, the output (times sx, cast) is too
    out_equal = not exact or torch.equal(qm.mpq_matmul_a8(x, qt), qm.mpq_matmul_a8_ref(x, qt))
    check(rel <= 1e-4 and (err == 0 or not exact) and again and out_equal,
          f"kernel 5 {name} m={x.shape[0]}: max|d| {err}, rel {rel}, rerun equal {again}, "
          f"bf16 out equal {out_equal}")
    return err, rel


def phase_quad_kernels(torch, gen, flush):
    """Phase 8a: kernel 5 against its plain version in f32 before ``sx``
    and the cast (``check_quad``: max|d|/max|ref| <= 1e-4, tools/quad_gate.py's
    bar, and max|d| = 0 at every bf16-metadata row at m 8, where both
    bodies are exact) with its activation quantization bit-equal, affine and
    mid_sym, on the body ``quad_route`` picks and on the first body (dp4a),
    then timed (the affine weights, which the MBWQ quantizer makes) on both;
    the MBWQ-2.5 w2 segments also at ``QUAD_CHECK_M`` rows and one shape
    with f32 metadata, checked on the routed body and timed on both; and the
    ``QUAD_DP4A_SHAPES``, which ``quad_route`` sends to the first body,
    checked at m 8 (rel <= 1e-4, reruns bit-equal) and timed."""
    from bitorch_engine_tpu_torch.ops.cuda import quad_matmul as qm
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import dequant_mpq_ref, prepare_for_kernel
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq

    def weights(w, w_bit, gs, meta=torch.bfloat16):
        """The mid_sym and affine kernel-form tensors of ``w`` (mid_sym needs
        codes on both sides of the midpoint: not at 1 bit)."""
        out = {}
        for mid in (True, False) if w_bit > 1 else (False,):
            qt = prepare_for_kernel(quantize_mpq(w, w_bit=w_bit, group_size=gs, mid_sym=mid),
                                    meta, act_bits=8)
            check(qt.act_bits == 8 and qt.zeros_mid == mid, f"kernel 5: regime {qt}")
            out[mid] = qt
        return out

    def timed_row(name, x, qts, k, n, w_bit, gs, errs, **extra):
        qt = qts[False]
        meta = qt.packed.nbytes + qt.scales.nbytes + qt.zeros.nbytes
        m = x.shape[0]
        bms, bby = bound(meta + x.nbytes + m * n * 2, 2 * m * k * n, INT8_OPS_PER_S)
        with first_quad_body():
            first_ms = time_ms(torch, lambda: qm.mpq_matmul_a8(x, qt), flush=flush)
        return dict(
            shape=name, K=k, N=n, w_bit=w_bit, group_size=gs, m=m,
            body=qm.quad_route(w_bit, gs), meta=str(qt.scales.dtype)[6:],
            max_abs_err=max(e for e, _ in errs.values()), rel_err=max(r for _, r in errs.values()),
            rel_err_affine=errs[False][1], rel_err_mid_sym=errs.get(True, (None, None))[1],
            ms=time_ms(torch, lambda: qm.mpq_matmul_a8(x, qt), flush=flush),
            first_body_ms=first_ms, **extra, bound_ms=bms, bound_by=bby,
        )

    def log_errs(name, k, n, w_bit, gs, m, errs, extra=""):
        log(f"kernel mpq_matmul_a8 {name:18s} K={k} N={n} w{w_bit} g{gs} m={m:<3d} "
            f"{qm.quad_route(w_bit, gs)} {extra}" + "  ".join(
                f"{'mid_sym' if mid else 'affine'} max|d|={e:.3e} rel={r:.3e}"
                for mid, (e, r) in sorted(errs.items())))

    rows, more = [], []
    for name, k, n, w_bit, gs in QUAD_SHAPES:
        w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        qx, sx = qm.quantize_activations(x, w_bit)
        rqx, rsx = qm.quantize_activations_ref(x)
        q_equal = (torch.equal(qx, qm.kernel_order(rqx, w_bit).to(torch.int8))
                   and torch.equal(sx, rsx[:, 0]))
        check(q_equal, f"kernel 5 {name}: activation codes or sx differ")
        # affine last, the tensor that is timed
        qts = weights(w, w_bit, gs)
        errs = {mid: check_quad(torch, name, x, qt, exact=True) for mid, qt in qts.items()}
        log_errs(name, k, n, w_bit, gs, 8, errs, f"qx/sx bit-equal={q_equal}  ")
        with first_quad_body():  # the first body at the same bar
            first_errs = {mid: check_quad(torch, name, x, qt, exact=True) for mid, qt in qts.items()}
            log_errs(name, k, n, w_bit, gs, 8, first_errs)
        w_bf16 = dequant_mpq_ref(qts[False], torch.bfloat16)
        rows.append(timed_row(
            name, x, qts, k, n, w_bit, gs, errs, qx_bit_equal=q_equal,
            first_body_max_abs_err=max(e for e, _ in first_errs.values()),
            plain_ms=time_ms(torch, lambda: qm.mpq_matmul_a8_ref(x, qts[False]), flush=flush),
            library_ms=None,
            yardstick_ms=time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush)))
        del w, qts, w_bf16
    # the further rows draw from their own generator: the later phases keep
    # their inputs
    quad_gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    further = [(f"mbwq_{p}_w2", k2, n, 2, 128, torch.bfloat16, QUAD_CHECK_M)
               for p, (_, n, _, k2) in MBWQ_PROJ.items()]
    name, k, n, w_bit, gs = QUAD_F32_META
    further.append((name, k, n, w_bit, gs, torch.float32, (8,) + QUAD_CHECK_M))
    for name, k, n, w_bit, gs, meta, ms_ in further:
        qts = weights(torch.randn(k, n, device="cuda", generator=quad_gen) * 0.02, w_bit, gs, meta)
        for m in ms_:
            x = torch.randn(m, k, device="cuda", generator=quad_gen).to(torch.bfloat16)
            errs = {mid: check_quad(torch, name, x, qt, exact=False) for mid, qt in qts.items()}
            log_errs(name, k, n, w_bit, gs, m, errs)
            more.append(timed_row(name, x, qts, k, n, w_bit, gs, errs))
        del qts
    for name, k, n, w_bit, gs in QUAD_DP4A_SHAPES:
        check(qm.quad_route(w_bit, gs) == "dp4a", f"kernel 5 {name}: routed to {qm.quad_route(w_bit, gs)}")
        qts = weights(torch.randn(k, n, device="cuda", generator=quad_gen) * 0.02, w_bit, gs)
        x = torch.randn(8, k, device="cuda", generator=quad_gen).to(torch.bfloat16)
        errs = {mid: check_quad(torch, name, x, qt, exact=False) for mid, qt in qts.items()}
        log_errs(name, k, n, w_bit, gs, 8, errs)
        more.append(timed_row(name, x, qts, k, n, w_bit, gs, errs))
        del qts
    for r in rows + more:
        extra = ("" if "plain_ms" not in r else
                 f"  plain {r['plain_ms']:.4f} ms  yardstick torch.matmul(bf16 weight) "
                 f"{r['yardstick_ms']:.4f} ms")
        log(f"time mpq_matmul_a8 {r['shape']:18s} m={r['m']:<3d} {r['meta']:8s} {r['body']} "
            f"{r['ms'] * 1e3:.2f} us  first body (dp4a) {r['first_body_ms'] * 1e3:.2f} us{extra}  "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    # where the tensor-core body takes the call, it must not lose to the first body
    slower = [(r["shape"], r["m"]) for r in rows + more
              if r["body"] == "mma" and r["ms"] > r["first_body_ms"]]
    log(f"kernel 5: rows where the tensor-core body is slower than the first body: {slower}")
    torch.cuda.empty_cache()
    return rows, more


def mbwq_weight(torch, gen, k, n):
    """A random MBWQ-2.5 weight (K, N) in the kernel form, bf16 metadata."""
    from bitorch_engine_tpu_torch.models.llama import llama2_7b_mbwq_serving
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import prepare_for_kernel
    from bitorch_engine_tpu_torch.ops.mbwq_linear import quantize_mbwq, strategy_dict

    cfg = llama2_7b_mbwq_serving()
    strategy = strategy_dict(cfg.mbwq_strategy, cfg.group_size)
    qt = quantize_mbwq(torch.randn(k, n, device="cuda", generator=gen) * 0.02, strategy)
    return qt.replace(segments=tuple(prepare_for_kernel(s, torch.bfloat16) for s in qt.segments))


def check_mbwq(torch, name, x, qt):
    """Kernel 7 on ``x`` against its plain version: f32 out within
    max|d|/max|ref| <= 1e-3, a second launch bit-equal (no atomics), and the
    bf16 out bit-equal to the f32 out cast once."""
    from bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul import mbwq_matmul, mbwq_matmul_ref

    got = mbwq_matmul(x, qt, torch.float32)
    want = mbwq_matmul_ref(x, qt, torch.float32)
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    again = torch.equal(got, mbwq_matmul(x, qt, torch.float32))
    cast = torch.equal(mbwq_matmul(x, qt, torch.bfloat16), got.to(torch.bfloat16))
    log(f"kernel mbwq_matmul {name:34s} m={x.shape[0]:<3d} {str(x.dtype)[6:]:8s} max|d|={err:.3e} "
        f"rel={rel:.3e} rerun bit-equal={again} bf16 out = cast of f32 out: {cast}")
    check(rel <= 1e-3, f"kernel 7 {name} m={x.shape[0]}: rel {rel} > 1e-3")
    check(again, f"kernel 7 {name} m={x.shape[0]}: two launches differ")
    check(cast, f"kernel 7 {name} m={x.shape[0]}: bf16 out is not the f32 out cast")
    return dict(check=name, m=x.shape[0], x_dtype=str(x.dtype)[6:], max_abs_err=err, rel_err=rel)


def phase_mbwq_kernels(torch, gen, flush):
    """Phase 8b: kernel 7 against its plain version (``check_mbwq``) at the
    MBWQ-2.5 A16 projections, m = 8 (the rows the main path is reckoned
    from) and ``MBWQ_CHECK_M``; at ``MBWQ_MIXES``; once with f32
    activations (the scalar body); timed at m = 8 beside its bound, its plain
    version, the per-segment path it replaces (``mpq_linear`` per segment on
    the sliced activations, and the add: kernel 1 per segment at m = 8) and
    a bf16 ``torch.matmul`` on the stacked weight; unsplit against a cluster
    of 2 along K (``split_sweep``); and at m 16-128 against that per-segment
    path, the route ``mbwq_linear`` takes where kernel 7 does not run
    (kernel 1 per segment to ``MAX_FUSED_ROWS_A16`` rows, then kernel 2 +
    matmul): the measurement behind kernel 7's cut-off.
    Returns the timed rows, every check and the largest m at which kernel 7
    wins at every projection."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import prepare_for_kernel
    from bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul import k_splits, mbwq_matmul, mbwq_matmul_ref
    from bitorch_engine_tpu_torch.ops.mbwq_linear import dequantize_mbwq
    from bitorch_engine_tpu_torch.ops.mpq_linear import MAX_FUSED_ROWS_A16, mpq_linear
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq
    from bitorch_engine_tpu_torch.qtensor import MBWQTensor

    mbwq_mm = importlib.import_module("bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul")
    rows, checks = [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k7_gen = torch.Generator(device="cuda").manual_seed(SEED + 12)  # the crossover's own inputs
    for name, (k, n, k4, k2) in MBWQ_PROJ.items():
        qt = mbwq_weight(torch, gen, k, n)
        segs = [(s.w_bit, s.group_size, s.in_features) for s in qt.segments]
        check(segs == [(4, 64, k4), (2, 128, k2)], f"kernel 7 {name}: segments {segs}")
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        main = check_mbwq(torch, f"{name} K={k} N={n}", x, qt)
        checks.append(main)
        for m in MBWQ_CHECK_M:
            xm = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
            checks.append(check_mbwq(torch, f"{name} K={k} N={n}", xm, qt))
        # the stacked weight in segment order, bf16 (the yardstick's operand)
        w_bf16 = dequantize_mbwq(qt.replace(q_perm=None), torch.bfloat16)

        def per_segment(xm):  # the A16 form past the crossover
            out, off = None, 0
            for seg in qt.segments:
                part = mpq_linear(xm[:, off : off + seg.in_features], seg)
                out = part if out is None else out + part
                off += seg.in_features
            return out

        crossover = {}
        for m in (16, 32, 64, 128):
            xm = torch.randn(m, k, device="cuda", generator=k7_gen).to(torch.bfloat16)
            crossover[m] = dict(kernel7_ms=time_ms(torch, lambda: mbwq_matmul(xm, qt), flush=flush),
                                per_segment_ms=time_ms(torch, lambda: per_segment(xm), flush=flush))
        meta = sum(s.packed.nbytes + s.scales.nbytes + s.zeros.nbytes for s in qt.segments)
        bms, bby = bound(meta + x.nbytes + 8 * n * 2, 2 * 8 * k * n)
        ms = time_ms(torch, lambda: mbwq_matmul(x, qt), flush=flush)
        rows.append(dict(
            shape=name, K=k, N=n, m=8, n_split=k_splits(n, 8, sms), crossover=crossover,
            segments=segs, max_abs_err=main["max_abs_err"],
            rel_err=main["rel_err"], ms=ms, per_launch_us=ms * 1e3,
            ms_by_split=split_sweep(torch, mbwq_mm, x, qt.segments, flush),
            plain_ms=time_ms(torch, lambda: mbwq_matmul_ref(x, qt), flush=flush),
            per_segment_ms=time_ms(torch, lambda: per_segment(x), flush=flush),
            library_ms=time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush),
            bound_ms=bms, bound_by=bby,
        ))
        if name == "o":  # the f32-activation route: the scalar body
            checks.append(check_mbwq(torch, f"{name} K={k} N={n} (f32 x)", x.float(), qt))
        del qt, w_bf16
    for label, spec, n, meta_name in MBWQ_MIXES:
        meta_dtype = getattr(torch, meta_name)
        segs = tuple(
            prepare_for_kernel(quantize_mpq(torch.randn(k, n, device="cuda", generator=gen) * 0.02,
                                            w_bit, gs), meta_dtype)
            for w_bit, gs, k in spec
        )
        qt = MBWQTensor(segments=segs)
        k = sum(s.in_features for s in segs)
        for m in (8,) + MBWQ_CHECK_M:
            xm = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
            checks.append(check_mbwq(torch, label, xm, qt))
        del qt
    k7_wins = None  # the largest m at which kernel 7 wins at every projection
    for m in rows[0]["crossover"]:
        if not all(r["crossover"][m]["kernel7_ms"] < r["crossover"][m]["per_segment_ms"]
                   for r in rows):
            break
        k7_wins = m
    log(f"kernel 7 crossover: kernel 7 wins at every projection up to m = {k7_wins}; "
        f"MAX_FUSED_ROWS_A16 = {MAX_FUSED_ROWS_A16}")
    for r in rows:
        log(f"time mbwq_matmul {r['shape']:8s} split {r['n_split']} kernel {r['ms']:.4f} ms  "
            f"per-segment mpq_linear + add {r['per_segment_ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"torch.matmul(bf16 weight) {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); crossover " + "  ".join(
                f"m={m}: {c['kernel7_ms'] * 1e3:.1f} / {c['per_segment_ms'] * 1e3:.1f} us"
                for m, c in r["crossover"].items()) + " (kernel 7 / mpq_linear per segment); "
            "by cluster size " + "  ".join(
                f"{sp}: {v * 1e3:.2f} us" for sp, v in r["ms_by_split"].items()))
    torch.cuda.empty_cache()
    return rows, checks, k7_wins


def build_mbwq_model(torch, num_layers, seed):
    """Llama-2-7B MBWQ-2.5 in the bench's serving form, random weights from
    ``seed``, prepared for the A8 regime (w2 segments → kernel 5)."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, llama2_7b_mbwq_serving
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    cfg = llama2_7b_mbwq_serving(max_seq_len=CACHE, num_layers=num_layers)
    model = LlamaModel(cfg, device="cuda", seed=seed)
    return prepare_params_for_cuda(model, meta_dtype=torch.bfloat16, act_bits_map={2: 8})


def set_regime(torch, model, act_bits: int):
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    prepare_params_for_cuda(model, meta_dtype=torch.bfloat16, act_bits_map={2: act_bits})


def profile_steps(torch, model, tok, caches, pos, steps):
    """``steps`` decode steps from ``pos`` under ``torch.profiler``."""
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    from bitorch_engine_tpu_torch.models.llama import decode_step

    torch.cuda.synchronize()
    with profiler() as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            decode_step(model, tok, caches, pos + i, attn_window=bucket(pos + i + 1, MBWQ_WINDOW_FLOOR))
        torch.cuda.synchronize()
    return device_summary(prof, time.perf_counter() - t0, steps)


def phase_mbwq_e2e(torch, gen, model):
    """Phase 9: the MBWQ-2.5 model at full width: prefill, 32 A8 decode
    steps, the flip to A16, 32 A16 decode steps on the same cache; launch
    counts per step; a few profiled steps of each regime."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches, prefill
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = model.cfg
    proj = 4 * LAYERS
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    serve(torch, model, prompt, 2, floor=MBWQ_WINDOW_FLOOR)  # warm-up
    set_regime(torch, model, 16)
    serve(torch, model, prompt, 2, floor=MBWQ_WINDOW_FLOOR)
    set_regime(torch, model, 8)
    torch.cuda.synchronize()

    caches = init_kv_caches(cfg, BATCH, CACHE, device="cuda")
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = prefill(model, prompt, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = launch_counts()
    check(bool(torch.isfinite(logits).all()), "MBWQ prefill logits are not finite")
    check(pre == counts_with(dequant_mpq=2 * proj + 1, flash_attention=LAYERS),
          f"MBWQ prefill launches {pre}")
    tok = torch.argmax(logits[:, -1], dim=-1)
    toks, pos, out = [tok], PROMPT, {}
    for regime, act_bits in (("a8", 8), ("a16", 16)):
        set_regime(torch, model, act_bits)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            last, caches = decode_step(model, tok[:, None], caches, pos,
                                       attn_window=bucket(pos + 1, MBWQ_WINDOW_FLOOR))
            tok = torch.argmax(last, dim=-1)
            toks.append(tok)
            pos += 1
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
        counts = launch_counts()
        if regime == "a8":
            want = counts_with(mpq_matmul_a8=proj * DECODE_STEPS, mpq_matmul=(proj + 1) * DECODE_STEPS)
        else:
            want = counts_with(mbwq_matmul=proj * DECODE_STEPS, mpq_matmul=DECODE_STEPS)
        log(f"MBWQ {regime} launches over {DECODE_STEPS} steps {counts}")
        check(counts == want, f"MBWQ {regime} launches {counts} != {want}")
        check(bool(torch.isfinite(last).all()), f"MBWQ {regime} decode logits are not finite")
        prof = profile_steps(torch, model, tok[:, None], caches, pos, MBWQ_PROFILE_STEPS)
        prof["idle_share_estimate_unprofiled"] = 1.0 - prof["device_busy_ms_per_call"] / step_ms
        out[regime] = dict(decode_ms_per_step=step_ms, decode_tok_s=BATCH / step_ms * 1e3,
                           launches=counts, profile=prof)
        log(f"MBWQ {regime}: decode {step_ms:.3f} ms/step ({BATCH / step_ms * 1e3:.1f} tok/s), "
            f"profiled: device busy {prof['device_busy_ms_per_call']:.3f} ms/step, idle share "
            f"{prof['idle_share']:.3f} (unprofiled estimate "
            f"{prof['idle_share_estimate_unprofiled']:.3f}), {prof['launches_per_call']:.0f} "
            f"launches/step")
        for kern in prof["top_kernels"]:
            log(f"  {kern['ms_per_call']:8.3f} ms  {kern['launches_per_call']:6.1f}x  {kern['name']}")
    toks = torch.stack(toks, dim=1)
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "MBWQ token ids out of range")
    out.update(prefill_ms=prefill_ms, prefill_tok_s=BATCH * PROMPT / prefill_ms * 1e3,
               prefill_launches=pre, batch=BATCH, prompt=PROMPT, decode_steps=DECODE_STEPS,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"MBWQ prefill {prefill_ms:.2f} ms ({out['prefill_tok_s']:.0f} tok/s); peak "
        f"{out['peak_gib']:.2f} GiB")
    del caches
    torch.cuda.empty_cache()
    return out


def phase_mbwq_path_check(torch, gen):
    """Phase 10: 2 layers at MBWQ-2.5 width, kernel path against plain path
    on the card, both regimes, the plain path fed the kernel path's tokens."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = build_mbwq_model(torch, 2, SEED + 3)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    rels = {}
    for regime, act_bits in (("a8", 8), ("a16", 16)):
        set_regime(torch, model, act_bits)
        reset_launch_counts()
        got, toks = serve(torch, model, prompt, 4, floor=MBWQ_WINDOW_FLOOR)
        launched = launch_counts()
        reset_launch_counts()
        with plain_kernels():
            want, _ = serve(torch, model, prompt, 4, forced=toks, floor=MBWQ_WINDOW_FLOOR)
        torch.cuda.synchronize()
        check(all(n == 0 for n in launch_counts().values()), "the plain path launched a kernel")
        key = "mpq_matmul_a8" if regime == "a8" else "mbwq_matmul"
        check(launched[key] == 2 * 4 * 4, f"MBWQ path check {regime}: launches {launched}")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        log(f"MBWQ path check ({regime}, 2 layers, prefill + 4 decode steps): "
            f"max|d logits|/max|logits| = {rel:.3e}")
        check(rel <= 2e-2, f"MBWQ path check {regime}: {rel} > 2e-2")
        rels[regime] = rel
    rels["a8_layers"] = a8_layer_check(torch, model, prompt)
    rels["a8_spread"] = a8_spread(torch, model, prompt)
    del model
    torch.cuda.empty_cache()
    return rels


def a8_layer_check(torch, model, prompt):
    """The A8 path check per layer: the gated prompt served once more in the
    A8 regime with every call of kernel 5 (the w2 segments) and kernel 1
    (the w4 segments and the head) also run through its plain version on
    the same input.  Kernel 5's outputs must be bit-equal, kernel 1's f32
    outputs within max|d|/max|ref| <= 1e-5: the end-to-end check's error
    then comes from the next layer's int8 codes, not from a kernel."""
    from bitorch_engine_tpu_torch.ops import mpq_linear
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import mpq_matmul_ref
    from bitorch_engine_tpu_torch.ops.cuda.quad_matmul import mpq_matmul_a8_ref

    kernel5, kernel1 = mpq_linear.mpq_matmul_a8, mpq_linear.mpq_matmul
    k5_diffs, k1_rels = [], []

    def kernel5_checked(x, qt, *args, **kwargs):
        out = kernel5(x, qt, *args, **kwargs)
        k5_diffs.append((out.float() - mpq_matmul_a8_ref(x, qt, *args, **kwargs).float()).abs().max().item())
        return out

    def kernel1_checked(x, qt, *args, **kwargs):
        got = kernel1(x, qt, out_dtype=torch.float32)
        want = mpq_matmul_ref(x, qt, out_dtype=torch.float32)
        k1_rels.append(((got - want).abs().max() / want.abs().max()).item())
        return kernel1(x, qt, *args, **kwargs)

    set_regime(torch, model, 8)
    with mock.patch.object(mpq_linear, "mpq_matmul_a8", kernel5_checked), \
            mock.patch.object(mpq_linear, "mpq_matmul", kernel1_checked):
        serve(torch, model, prompt, 4, floor=MBWQ_WINDOW_FLOOR)
    out = dict(kernel5_calls=len(k5_diffs), kernel5_max_abs_diff=max(k5_diffs, default=None),
               kernel1_calls=len(k1_rels), kernel1_max_rel=max(k1_rels, default=None))
    log(f"MBWQ path check (a8) per layer: kernel 5 {out['kernel5_calls']} calls, max|d| "
        f"{out['kernel5_max_abs_diff']} (bar 0); kernel 1 {out['kernel1_calls']} calls, f32 max "
        f"rel {out['kernel1_max_rel']:.3e} (bar 1e-5)")
    check(out["kernel5_calls"] > 0 and out["kernel1_calls"] > 0, f"A8 per-layer check: {out}")
    check(out["kernel5_max_abs_diff"] == 0, f"A8 per-layer check: kernel 5 differs {out}")
    check(out["kernel1_max_rel"] <= 1e-5, f"A8 per-layer check: kernel 1 {out}")
    return out


def a8_spread(torch, model, prompt):
    """The A8 path check on the gated prompt and ``A8_SPREAD_PROMPTS`` more,
    with kernel 1 (the w4 segments and the head) on either body: printed,
    not gated, to show how far the check moves with the prompt and with
    kernel 1's f32 summation order."""
    from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as dm

    set_regime(torch, model, 8)
    spread_gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    prompts = [prompt] + [
        torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=spread_gen)
        for _ in range(A8_SPREAD_PROMPTS)]
    out = {}
    for body in ("mma", "scalar"):
        out[body] = []
        for p in prompts:
            with mock.patch.object(dm, "mpq_matmul_route", lambda x_dtype, qt, body=body: body):
                got, toks = serve(torch, model, p, 4, floor=MBWQ_WINDOW_FLOOR)
            with plain_kernels():
                want, _ = serve(torch, model, p, 4, forced=toks, floor=MBWQ_WINDOW_FLOOR)
            out[body].append(((got - want).abs().max() / want.abs().max()).item())
        log(f"MBWQ path check (a8) by prompt, kernel 1 on the {body} body (the first prompt is "
            f"the gated one; not gated): " + "  ".join(f"{r:.3e}" for r in out[body]))
    return out


def flash_bwd_row(torch, gen, name, b, nh, nkv, s, d, causal, flush):
    """Kernel 4 on random bf16 operands drawn from ``gen`` against its plain
    version (max|d|/max|ref| <= 1e-2 for each of dq, dk, dv, bf16 out),
    then timed beside its bound, its plain version and SDPA's backward (its
    forward + backward less its forward)."""
    from bitorch_engine_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    )

    F = torch.nn.functional
    q, do = (torch.randn(b, nh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, nkv, s, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    errs, rels, diff = {}, {}, {}
    for part, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[part] = (g.float() - w.float()).abs().max().item()
        rels[part] = errs[part] / w.float().abs().max().item()
        diff[part] = (g != w).float().mean().item()
        check(bool(torch.isfinite(g).all()), f"kernel 4 {name}: {part} not finite")
    log(f"kernel flash_attention_bwd {name:28s} max|d|/max|ref| " + "  ".join(
        f"{p}={r:.3e}" for p, r in rels.items()) + "  bf16 elements differing " + "  ".join(
        f"{p}={f:.2e}" for p, f in diff.items()))
    check(all(r <= 1e-2 for r in rels.values()), f"kernel 4 {name}: rel {rels} > 1e-2")
    del got, want

    pairs = s * (s + 1) / 2 if causal else s * s
    ops = b * nh * 10 * d * pairs  # five products: q k^T, do v^T, dv, dk, dq
    nbytes = (q.nbytes + k.nbytes + v.nbytes + out.nbytes + lse.nbytes + do.nbytes
              + q.nbytes + k.nbytes + v.nbytes)
    bms, bby = bound(nbytes, ops)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=nkv != nh)

    sdpa_fwd_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do),
                              flush=flush)
    sdpa_fwd_ms = time_ms(torch, sdpa, flush=flush)
    row = dict(
        shape=name, b=b, nh=nh, nkv=nkv, s=s, d=d, causal=causal,
        max_abs_err=max(errs.values()), rel_err=max(rels.values()), rel=rels,
        bf16_elements_differing=diff,
        ms=time_ms(torch, lambda: flash_attention_bwd(q, k, v, out, lse, do, causal), flush=flush),
        plain_ms=time_ms(torch, lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, causal),
                         reps=5, flush=flush),
        library_ms=sdpa_fwd_bwd_ms - sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
        sdpa_fwd_ms=sdpa_fwd_ms, bound_ms=bms, bound_by=bby,
    )
    del q, k, v, do, out, lse, qs, ks, vs
    torch.cuda.empty_cache()
    log(f"time flash_attention_bwd {row['shape']:28s} kernel {row['ms']:.4f} ms  plain "
        f"{row['plain_ms']:.4f} ms  sdpa backward {row['library_ms']:.4f} ms (fwd+bwd "
        f"{row['sdpa_fwd_bwd_ms']:.4f} - fwd {row['sdpa_fwd_ms']:.4f})  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def phase_flash_bwd_kernels(torch, gen, flush):
    """Phase 11: kernel 4 at ``FLASH_BWD_SHAPES`` (``flash_bwd_row``)."""
    return [flash_bwd_row(torch, gen, *shape, flush) for shape in FLASH_BWD_SHAPES]


def build_train_model(torch, num_layers, seed, **overrides):
    """The bench's 370M training configuration (``overrides`` on top),
    random weights from ``seed``, in training mode."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, llama_370m_train
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    cfg = llama_370m_train(num_layers=num_layers, **overrides)
    return prepare_for_training(LlamaModel(cfg, device="cuda", seed=seed))


def lm_loss(model, toks):
    """The bench's loss: next-token cross entropy over the batch."""
    from bitorch_engine_tpu_torch.training import cross_entropy_loss

    logits, _ = model(toks[:, :-1])
    return cross_entropy_loss(logits, toks[:, 1:])


def phase_train(torch, gen):
    """Phase 12: the training path at full width: warm-up, timed steps with
    the launch counts, one split step, one profiled step."""
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import make_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_train_model(torch, TRAIN_LAYERS, SEED)
    torch.cuda.synchronize()
    n_params = sum(m.grad_shadow.numel() for m in model.modules()
                   if getattr(m, "grad_shadow", None) is not None)
    log(f"train model: 370M Llama w4 g128, {TRAIN_LAYERS} layers, remat, built in "
        f"{time.perf_counter() - t0:.1f} s, {n_params} quantized weights, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    vocab = model.cfg.vocab_size
    toks = torch.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1), device="cuda", generator=gen)
    step = make_train_step(model, lm_loss, DiodeHyperParams(lr=TRAIN_LR))
    warm = float(step(toks)["loss"])
    check(math.isfinite(warm), f"train warm-up loss {warm}")

    per_step = counts_with(dequant_mpq=4 * TRAIN_PROJ * TRAIN_LAYERS, flash_attention=2 * TRAIN_LAYERS,
                           flash_attention_bwd=2 * TRAIN_LAYERS)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = float(step(toks)["loss"])  # the host reads the loss: the step has ended
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = launch_counts()
    log(f"train launches over {TRAIN_STEPS} steps {counts}")
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(counts == {k: TRAIN_STEPS * v for k, v in per_step.items()},
          f"train launches {counts} != {TRAIN_STEPS} x {per_step}")

    # one step split: forward + backward, then DiodeMix
    opt = step.optimizer
    opt.zero_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm_loss(model, toks).backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    split = dict(fwd_bwd_ms=(t1 - t0) * 1e3, optimizer_ms=(time.perf_counter() - t1) * 1e3)

    with profiler() as prof:
        t0 = time.perf_counter()
        float(step(toks)["loss"])
    prof_summary = device_summary(prof, time.perf_counter() - t0, 1, top=10)
    ms = statistics.median(step_ms)
    out = dict(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, layers=TRAIN_LAYERS, lr=TRAIN_LR, quantized_weights=n_params,
        warmup_loss=warm, losses=losses, step_ms=step_ms, ms_per_step=ms,
        train_tok_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3, split=split,
        launches=counts, launches_per_step=per_step,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, profile=prof_summary,
    )
    out["profile"]["idle_share_estimate_unprofiled"] = 1.0 - prof_summary["device_busy_ms_per_call"] / ms
    log(f"train: {ms:.2f} ms/step (steps {', '.join(f'{t:.2f}' for t in step_ms)}), "
        f"{out['train_tok_s']:.0f} train tok/s, losses {losses} (warm-up {warm:.4f}); forward + "
        f"backward {split['fwd_bwd_ms']:.2f} ms, DiodeMix {split['optimizer_ms']:.2f} ms; peak "
        f"{out['peak_gib']:.2f} GiB")
    log(f"profile train step: wall {prof_summary['wall_ms_per_call']:.2f} ms (profiled), device busy "
        f"{prof_summary['device_busy_ms_per_call']:.2f} ms, idle share {prof_summary['idle_share']:.3f} "
        f"(unprofiled estimate {out['profile']['idle_share_estimate_unprofiled']:.3f}), "
        f"{prof_summary['launches_per_call']:.0f} launches")
    for kern in prof_summary["top_kernels"]:
        log(f"  {kern['ms_per_call']:8.3f} ms  {kern['launches_per_call']:6.1f}x  {kern['name']}")
    del model, step, opt, toks
    torch.cuda.empty_cache()
    return counts, out


def phase_train_path_check(torch, gen):
    """Phase 13: one train step of 2 full-width layers on the kernel path
    and, from a copy of the same weights, on the plain path (loss rel
    <= 1e-3; every grad shadow's and fp parameter's max|d|/max|ref| <=
    3e-2: bf16 activations and their gradients round at other points)."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import make_train_step

    kernel_model = build_train_model(torch, 2, SEED + 4)
    plain_model = copy.deepcopy(kernel_model)
    toks = torch.randint(0, kernel_model.cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device="cuda",
                         generator=gen)
    hp = DiodeHyperParams(lr=TRAIN_LR)
    reset_launch_counts()
    got = float(make_train_step(kernel_model, lm_loss, hp)(toks)["loss"])
    launched = launch_counts()
    check(launched == counts_with(dequant_mpq=4 * TRAIN_PROJ * 2, flash_attention=4,
                                  flash_attention_bwd=4), f"train path check launches {launched}")
    reset_launch_counts()
    with plain_kernels():
        want = float(make_train_step(plain_model, lm_loss, hp)(toks)["loss"])
    torch.cuda.synchronize()
    check(all(n == 0 for n in launch_counts().values()), "the plain training path launched a kernel")
    loss_rel = abs(got - want) / abs(want)
    grads = dict(plain_model.named_parameters())
    grad_rel = {}
    for name, p in kernel_model.named_parameters():
        ref = grads[name].grad
        grad_rel[name] = ((p.grad.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    worst = max(grad_rel, key=grad_rel.get)
    codes_equal = sum(bool(torch.equal(a, b)) for (n, a), (_, b) in zip(
        kernel_model.named_buffers(), plain_model.named_buffers()) if n.endswith("packed"))
    log(f"train path check (2 layers, one step): loss {got:.6f} vs plain {want:.6f}, rel "
        f"{loss_rel:.3e}; max grad rel {grad_rel[worst]:.3e} ({worst}) over {len(grad_rel)} "
        f"gradients; packed tensors equal after the step {codes_equal} of {2 * TRAIN_PROJ}")
    check(loss_rel <= 1e-3, f"train path check: loss rel {loss_rel} > 1e-3")
    check(grad_rel[worst] <= 3e-2, f"train path check: {worst} grad rel {grad_rel[worst]} > 3e-2")
    del kernel_model, plain_model
    torch.cuda.empty_cache()
    return dict(loss=got, plain_loss=want, loss_rel=loss_rel, max_grad_rel=grad_rel[worst],
                worst=worst, grad_rel=grad_rel, packed_equal=codes_equal)


def b1_rate(torch, sms, flush):
    """The 1-bit products' peak for kernel 8's operation bound: the card's
    issue rate of ``mma...m16n8k256.b1.and.popc`` against that of the int8
    ``m16n8k32`` (``csrc/binary_gemm.cu`` ``bte_mma_rate_probe``, 8 warps a
    block, 4 blocks an SM), times 8 (its k per product) and the published
    int8 rate; a ratio under 1 is taken as 1, so the bound never rests on
    a rate below the int8 one's per k."""
    from bitorch_engine_tpu_torch.ops.cuda import _build
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import _stream

    probe = _build.function("binary_gemm", "bte_mma_rate_probe",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p])
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    per_s = {}
    for kind, b1 in (("int8", 0), ("b1", 1)):
        def launch():
            _build.check("binary_gemm", probe(b1, blocks, iters, out.data_ptr(),
                                              _stream(out.device)), "mma rate probe")
        per_s[kind] = blocks * 8 * iters * 8 / (time_ms(torch, launch, reps=5, flush=flush) / 1e3)
    ratio = per_s["b1"] / per_s["int8"]
    rate = dict(int8_mma_per_s=per_s["int8"], b1_mma_per_s=per_s["b1"], b1_vs_int8_issue=ratio,
                b1_ops_per_s=B1_K_PER_INT8_K * INT8_OPS_PER_S * max(1.0, ratio))
    log(f"mma issue rate probe: int8 m16n8k32 {per_s['int8'] / 1e12:.4f} T products/s "
        f"({per_s['int8'] * 2 * 16 * 8 * 32 / 1e12:.1f} TOP/s), b1 m16n8k256 and.popc "
        f"{per_s['b1'] / 1e12:.4f} T products/s ({per_s['b1'] * 2 * 16 * 8 * 256 / 1e12:.1f} TOP/s): "
        f"b1 / int8 issue {ratio:.4f}; the 1-bit bound's rate {rate['b1_ops_per_s'] / 1e12:.0f} TOP/s")
    return rate


def phase_xnor_kernels(torch, gen, flush):
    """Phase 14: kernel 8's two entries bit for bit against their plain
    versions (the words entry, and the fused packed linear in f32, bf16
    and f16 with ties x == -bias_a), then timed beside their bounds (bytes,
    or 1-bit operations at the rate ``b1_rate`` sets; the int8 and the
    first body's popc bounds beside), the plain version, the bare bf16
    sign matmul and the packed forward's unpack branch as it runs; the m
    where that branch overtakes the kernel."""
    from bitorch_engine_tpu_torch.ops import binary_linear, packing
    from bitorch_engine_tpu_torch.ops.binary_linear import sign_pm1
    from bitorch_engine_tpu_torch.ops.cuda.binary_gemm import (
        binary_packed_linear, binary_packed_linear_ref, xnor_gemm, xnor_gemm_ref, xnor_plan,
    )
    from bitorch_engine_tpu_torch.qtensor import BinaryQTensor

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    popc_per_s = sms * POPC_PER_CLOCK_PER_SM * clock_mhz * 1e6
    rate = b1_rate(torch, sms, flush)
    b1_per_s = rate["b1_ops_per_s"]
    log(f"kernel 8 bounds: 1-bit products {b1_per_s / 1e12:.0f} TOP/s (2 m N K operations), bytes at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; beside them int8 {INT8_OPS_PER_S / 1e12:.0f} TOP/s and "
        f"the first body's popc {sms} SMs x {POPC_PER_CLOCK_PER_SM}/clock x {clock_mhz:.0f} MHz = "
        f"{popc_per_s / 1e12:.3f} Tpopc/s")
    rows = []
    for name, m, k, n in XNOR_SHAPES:
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(n, k, device="cuda", generator=gen)
        bias = torch.randn(k, device="cuda", generator=gen) * 0.1
        x[0, : k // 2] = -bias[: k // 2]  # sign(0) = +1
        sa = torch.rand((), device="cuda", generator=gen) + 0.5
        sw = torch.rand((), device="cuda", generator=gen) * 0.1
        xw = packing.pack_signs(packing.pad_to_multiple(x, 1, 32, value=-1.0)[0])
        ww = packing.pack_signs(packing.pad_to_multiple(w, 1, 32, value=-1.0)[0])
        got, want = xnor_gemm(xw, ww, k), xnor_gemm_ref(xw, ww, k)
        fused, fused_want = (binary_packed_linear(x, ww, sa, bias, sw, k),
                             binary_packed_linear_ref(x, ww, sa, bias, sw, k))
        equal = dict(words=bool(torch.equal(got, want)), fused=bool(torch.equal(fused, fused_want)))
        err = max((got - want).abs().max().item(), (fused - fused_want).abs().max().item())
        for dt in (torch.bfloat16, torch.float16):  # activations, bias_a and scales in dt
            args = (x.to(dt), ww, sa.to(dt), bias.to(dt), sw.to(dt), k)
            lo, lo_want = binary_packed_linear(*args), binary_packed_linear_ref(*args)
            equal[f"fused_{str(dt)[6:]}"] = bool(torch.equal(lo, lo_want))
            err = max(err, (lo.float() - lo_want.float()).abs().max().item())
        equal["rerun"] = bool(torch.equal(xnor_gemm(xw, ww, k), got))
        plan = xnor_plan(m, n, ww.shape[1], sms, True)
        log(f"kernel xnor_gemm {name:20s} m={m} K={k} N={n}  plan {plan}  bit-equal {equal} "
            f"max|d|={err}")
        check(all(equal.values()), f"kernel 8 {name}: not bit-equal to the plain version {equal}")
        kw = ww.shape[1]
        t_bytes = (xw.nbytes + ww.nbytes + m * n * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / b1_per_s * 1e3
        # the fused entry reads x, bias_a, the scales and the words once, writes out in x's dtype
        t_fused_bytes = (x.nbytes + bias.nbytes + 8 + ww.nbytes + m * n * 4) / HBM_BYTES_PER_S * 1e3
        x_bf = sign_pm1(x).to(torch.bfloat16)
        w_bf = packing.unpack_signs(ww, torch.bfloat16)[:, :k].contiguous()
        qt = BinaryQTensor(data=ww, scale_w=sw, packed=True, in_features=k)

        def unpack_branch():  # the packed forward's TPU branch, as binary_linear runs it
            with mock.patch.object(binary_linear, "xnor_route", lambda *args: "unpack"):
                return binary_linear.binary_linear(x, qt, sa, bias)

        unpack_out = unpack_branch()
        check(bool(torch.equal(unpack_out, fused)), f"kernel 8 {name}: the unpack branch differs")
        # a BinaryLinear(dtype=float16)'s forward: the route takes the fused entry
        half = (x.half(), qt, sa.half(), bias.half())
        before = binary_packed_linear.launches
        lo = binary_linear.binary_linear(*half)
        check(binary_packed_linear.launches == before + 1, f"kernel 8 {name}: f16 not routed to it")
        with mock.patch.object(binary_linear, "xnor_route", lambda *args: "unpack"):
            check(bool(torch.equal(lo, binary_linear.binary_linear(*half))),
                  f"kernel 8 {name}: the f16 unpack branch differs")
        rows.append(dict(
            shape=name, m=m, K=k, N=n, plan=plan, max_abs_err=err, rel_err=err, bit_equal=equal,
            ms=time_ms(torch, lambda: xnor_gemm(xw, ww, k), flush=flush),
            fused_ms=time_ms(torch, lambda: binary_packed_linear(x, ww, sa, bias, sw, k), flush=flush),
            plain_ms=time_ms(torch, lambda: xnor_gemm_ref(xw, ww, k), reps=5, flush=flush),
            fused_plain_ms=time_ms(torch, lambda: binary_packed_linear_ref(x, ww, sa, bias, sw, k),
                                   reps=5, flush=flush),
            library_ms=None,
            yardstick_ms=time_ms(torch, lambda: torch.mm(x_bf, w_bf.T, out_dtype=torch.float32),
                                 flush=flush),
            unpack_ms=time_ms(torch, unpack_branch, reps=5, flush=flush),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_bytes_ms=t_bytes, bound_b1_ms=t_ops,
            bound_int8_ms=2 * m * n * k / INT8_OPS_PER_S * 1e3,
            bound_popc_ms=m * n * kw / popc_per_s * 1e3,
            fused_bound_ms=max(t_fused_bytes, t_ops),
            fused_bound_by="bytes" if t_fused_bytes >= t_ops else "operations",
        ))
        del x, w, xw, ww, x_bf, w_bf, got, want, fused, lo, lo_want, unpack_out
    torch.cuda.empty_cache()
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(torch, lambda: one.add_(1), flush=flush)
    log(f"kernel 8 at small m is a launch's fixed cost: one 1-element add timed the same way "
        f"takes {floor_ms:.4f} ms")
    for r in rows:
        simt = (f"  first body {XNOR_SIMT_US[r['shape']] / 1e3:.6f} ms (PR 10's run)"
                if r["shape"] in XNOR_SIMT_US else "")
        log(f"time xnor_gemm {r['shape']:20s} words {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.0%} of "
            f"bound)  fused {r['fused_ms']:.4f} ms ({r['fused_bound_ms'] / r['fused_ms']:.0%})  "
            f"plain {r['plain_ms']:.4f} / {r['fused_plain_ms']:.4f} ms{simt}  bf16 sign matmul "
            f"{r['yardstick_ms']:.4f} ms  unpack branch {r['unpack_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}; bytes {r['bound_bytes_ms']:.5f}, 1-bit "
            f"{r['bound_b1_ms']:.5f}, int8 {r['bound_int8_ms']:.5f}, popc {r['bound_popc_ms']:.5f}; "
            f"fused {r['fused_bound_ms']:.5f} ({r['fused_bound_by']}))")
    crossover = {}
    for side in ("1024", "4096"):
        big = sorted((r for r in rows if r["N"] == int(side) and r["K"] == int(side)),
                     key=lambda r: r["m"])
        over = [r["m"] for r in big if r["unpack_ms"] < r["fused_ms"]]
        crossover[side] = min(over) if over else None
        log(f"kernel 8 at {side}^2: the unpack branch overtakes the fused kernel at m = "
            f"{crossover[side]} (m tried: {[r['m'] for r in big]}; xnor_route takes the kernel "
            f"for every m whose rows fit)")
    return rows, dict(unpack_overtakes_at_m=crossover, launch_floor_ms=floor_ms, b1_rate=rate)


def synthetic_batches(torch, gen, shape, n_batches, batch, noise):
    """Seeded class-prototype data (``train_mnist.synthetic_digits``'s
    recipe, any input shape), made on the card: ``n_batches`` of
    ``(x, labels)``."""
    protos = torch.randn(10, *shape, device="cuda", generator=gen)
    out = []
    for _ in range(n_batches):
        y = torch.randint(0, 10, (batch,), device="cuda", generator=gen)
        out.append((protos[y] + torch.randn(batch, *shape, device="cuda", generator=gen) * noise, y))
    return out


def qat_loss(model, batch):
    """The MNIST example's loss: cross entropy, with the accuracy as aux."""
    from bitorch_engine_tpu_torch.training import accuracy, cross_entropy_loss

    logits = model(batch[0])
    return cross_entropy_loss(logits, batch[1]), accuracy(logits, batch[1])


def _train(torch, model, batches, lr=MLP_LR):
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import make_train_step

    step = make_train_step(model, qat_loss, DiodeHyperParams(lr=lr))
    losses, accs, step_ms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        out = step(b)
        losses.append(float(out["loss"]))  # the host reads the loss: the step has ended
        step_ms.append((time.perf_counter() - t0) * 1e3)
        accs.append(float(out["aux"]))
    return step, losses, accs, step_ms


def phase_qat_e2e(torch, gen):
    """Phase 15: QuantMLP at 1, 4 and 8 bits trained, packed and served at
    full width; QuantConvNet at 1 and 4 bits trained."""
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    from bitorch_engine_tpu_torch.models.cnn import QuantConvNet
    from bitorch_engine_tpu_torch.models.mlp import QuantMLP
    from bitorch_engine_tpu_torch.ops import binary_linear
    from bitorch_engine_tpu_torch.ops.binary_linear import xnor_route
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_inference, prepare_for_training

    out = {"mlp": {}, "cnn": {}}
    for bits in (1, 4, 8):
        torch.cuda.reset_peak_memory_stats()
        data = synthetic_batches(torch, gen, (28, 28), MLP_STEPS + 2, MLP_BATCH, 0.8)
        reset_launch_counts()
        model = prepare_for_training(QuantMLP(hidden=MLP_HIDDEN, bits=bits, seed=SEED,
                                              sample=data[0][0]))
        step, losses, accs, step_ms = _train(torch, model, data[:MLP_STEPS])
        train_counts = launch_counts()
        check(all(math.isfinite(v) for v in losses), f"MLP w{bits} losses {losses}")
        check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
              f"MLP w{bits} losses do not fall: {losses}")
        check(train_counts == counts_with(), f"MLP w{bits} training launched {train_counts}")
        prof_summary = None
        if bits == 1:
            with profiler() as prof:
                t0 = time.perf_counter()
                float(step(data[MLP_STEPS])["loss"])
            prof_summary = device_summary(prof, time.perf_counter() - t0, 1, top=6)
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        prepare_for_inference(model)
        x8, x128 = data[-1][0][:SERVE_BATCH], data[-1][0]
        model(x8), model(x128)  # warm-up
        serve = {}
        for batch, x in ((SERVE_BATCH, x8), (MLP_BATCH, x128)):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(SERVE_REPS):
                logits = model(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / SERVE_REPS
            counts = launch_counts()
            # the packed forward takes kernel 8's fused entry where the route says so
            fused = bits == 1 and xnor_route(batch, MLP_HIDDEN, MLP_HIDDEN) == "kernel"
            want = counts_with(binary_packed_linear=SERVE_REPS if fused else 0)
            check(counts == want, f"MLP w{bits} serving b{batch}: launches {counts} != {want}")
            check(logits.shape == (batch, 10) and bool(torch.isfinite(logits).all()),
                  f"MLP w{bits} b{batch} logits")
            serve[batch] = dict(ms_per_forward=ms, launches=counts["binary_packed_linear"],
                                words_launches=counts["xnor_gemm"])
            if bits == 1:  # the packed forward's device kernels, all of them
                with profiler() as prof:
                    t0 = time.perf_counter()
                    for _ in range(SERVE_REPS):
                        model(x)
                    torch.cuda.synchronize()
                fwd = device_summary(prof, time.perf_counter() - t0, SERVE_REPS, top=4)
                serve[batch].update(device_launches_per_forward=fwd["launches_per_call"],
                                    device_busy_ms_per_forward=fwd["device_busy_ms_per_call"])
                # the same forwards on the unpack branch (the port's route above
                # 16 rows with the first body), for the same-run comparison
                with mock.patch.object(binary_linear, "xnor_route", lambda *args: "unpack"):
                    model(x)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(SERVE_REPS):
                        model(x)
                    torch.cuda.synchronize()
                    serve[batch]["unpack_ms_per_forward"] = (time.perf_counter() - t0) * 1e3 / SERVE_REPS
                    with profiler() as prof:
                        t0 = time.perf_counter()
                        for _ in range(SERVE_REPS):
                            model(x)
                        torch.cuda.synchronize()
                fwd = device_summary(prof, time.perf_counter() - t0, SERVE_REPS, top=4)
                serve[batch]["unpack_device_launches_per_forward"] = fwd["launches_per_call"]
        acc = float((model(x128).argmax(-1) == data[-1][1]).float().mean())
        out["mlp"][bits] = dict(losses=losses, train_acc=accs, step_ms=step_ms,
                                ms_per_step=statistics.median(step_ms), peak_train_gib=peak_train,
                                serve=serve, packed_acc_b128=acc, profile=prof_summary)
        log(f"QuantMLP w{bits}: {statistics.median(step_ms):.3f} ms/step (median of {MLP_STEPS}), "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, train acc {accs[-1]:.3f}; acc on a held-out "
            f"batch {acc:.3f}; peak {peak_train:.3f} GiB")
        for batch, r in serve.items():
            before = XNOR_FORWARD_MS_BEFORE.get(batch) if bits == 1 else None
            profiled = ("" if bits != 1 else
                        f" and {r['device_launches_per_forward']:.1f} device kernels a forward, "
                        f"device busy {r['device_busy_ms_per_forward']:.4f} ms a forward (profiled); "
                        f"on the unpack branch {r['unpack_ms_per_forward']:.4f} ms and "
                        f"{r['unpack_device_launches_per_forward']:.1f} device kernels a forward")
            log(f"  packed forward b{batch}: {r['ms_per_forward']:.4f} ms a forward"
                f"{'' if before is None else f' (on the first body: {before} ms)'}, "
                f"{r['launches'] / SERVE_REPS:g} kernel-8 launches a forward{profiled}")
        if prof_summary is not None:
            log(f"profile QuantMLP w1 train step: wall {prof_summary['wall_ms_per_call']:.3f} ms "
                f"(profiled), device busy {prof_summary['device_busy_ms_per_call']:.3f} ms, idle share "
                f"{prof_summary['idle_share']:.3f}, {prof_summary['launches_per_call']:.0f} launches")
        del model, step, data
    for bits in (1, 4):
        torch.cuda.reset_peak_memory_stats()
        data = synthetic_batches(torch, gen, (CNN_HW, CNN_HW, 3), CNN_STEPS, CNN_BATCH, 1.0)
        reset_launch_counts()
        model = prepare_for_training(QuantConvNet(bits=bits, seed=SEED, sample=data[0][0]))
        step, losses, accs, step_ms = _train(torch, model, data)
        check(all(math.isfinite(v) for v in losses), f"conv net w{bits} losses {losses}")
        check(launch_counts() == counts_with(), f"conv net w{bits} launched {launch_counts()}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        out["cnn"][bits] = dict(losses=losses, step_ms=step_ms,
                                ms_per_step=statistics.median(step_ms[1:]), peak_gib=peak)
        log(f"QuantConvNet w{bits} (64-128-128-256, {CNN_HW}x{CNN_HW}x3, b{CNN_BATCH}): "
            f"{statistics.median(step_ms[1:]):.2f} ms/step (median of steps 2-{CNN_STEPS}; first "
            f"{step_ms[0]:.1f}), losses {[round(v, 4) for v in losses]}, peak {peak:.3f} GiB")
        del model, step, data
    torch.cuda.empty_cache()
    return out


def phase_qat_path_check(torch, gen):
    """Phase 16: the packed MLP's logits through kernel 8 against the plain
    path on the card at b8 and b128 (bit-equal); one train step of the binary MLP and of
    the conv net at 1 and 4 bits on the card against the same step on the
    CPU from the same weights and optimizer state (the MLP: loss rel <=
    1e-4; the conv nets: loss rel <= 1e-2 at 1 bit, where LayerNorm ties
    over integer conv outputs may take either sign, 1e-4 at 4 bits)."""
    from bitorch_engine_tpu_torch.models.cnn import QuantConvNet
    from bitorch_engine_tpu_torch.models.mlp import QuantMLP
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import make_train_step
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_inference, prepare_for_training

    res = {}
    (x, y), = synthetic_batches(torch, gen, (28, 28), 1, MLP_BATCH, 0.8)
    model = prepare_for_inference(QuantMLP(hidden=MLP_HIDDEN, bits=1, seed=SEED + 5, sample=x))
    for batch in (SERVE_BATCH, MLP_BATCH):
        reset_launch_counts()
        got = model(x[:batch])
        one = counts_with(binary_packed_linear=1)
        check(launch_counts() == one, f"packed path check b{batch} launches {launch_counts()}")
        with plain_kernels():
            want = model(x[:batch])
        torch.cuda.synchronize()
        check(launch_counts() == one, "the plain packed path launched a kernel")
        res[f"packed_logits_bit_equal_b{batch}"] = bool(torch.equal(got, want))
        log(f"path check packed binary MLP b{batch}: kernel 8 vs plain logits bit-equal "
            f"{res[f'packed_logits_bit_equal_b{batch}']}")
        check(res[f"packed_logits_bit_equal_b{batch}"],
              f"packed MLP logits b{batch}: kernel 8 differs from the plain path")

    def card_vs_cpu(name, model, batch, bar):
        cpu_model = copy.deepcopy(model).to("cpu")
        step = make_train_step(model, qat_loss, DiodeHyperParams(lr=MLP_LR))
        cpu_step = make_train_step(cpu_model, qat_loss, DiodeHyperParams(lr=MLP_LR))
        # the CPU optimizer starts from the card's moments (the binary
        # regime's random initial exp_avg_s)
        cpu_step.optimizer.load_state_dict(step.optimizer.state_dict())
        loss = float(step(batch)["loss"])
        cpu_loss = float(cpu_step(tuple(t.cpu() for t in batch))["loss"])
        rel = abs(loss - cpu_loss) / abs(cpu_loss)
        codes = [(n, a, b) for (n, a), (_, b) in zip(model.named_buffers(), cpu_model.named_buffers())
                 if n.endswith(".data")]
        differ = sum(int((a.cpu() != b).sum()) for _, a, b in codes)
        total = sum(a.numel() for _, a, _ in codes)
        log(f"path check {name}: one train step on the card {loss:.6f} vs the CPU {cpu_loss:.6f}, "
            f"rel {rel:.3e} (bar {bar:g}); quantized codes differing after it {differ} of {total}")
        check(rel <= bar, f"{name}: loss rel {rel} > {bar}")
        check(differ <= 1e-2 * total, f"{name}: {differ} of {total} codes differ")
        return dict(loss=loss, cpu_loss=cpu_loss, rel=rel, codes_differing=differ, codes=total)

    model = prepare_for_training(QuantMLP(hidden=MLP_HIDDEN, bits=1, seed=SEED + 6, sample=x))
    res["mlp_w1_train_step"] = card_vs_cpu("binary MLP", model, (x, y), 1e-4)
    (cx, cy), = synthetic_batches(torch, gen, (CNN_HW, CNN_HW, 3), 1, 16, 1.0)
    for bits, bar in ((1, 1e-2), (4, 1e-4)):
        net = prepare_for_training(QuantConvNet(bits=bits, seed=SEED + 7, sample=cx))
        res[f"cnn_w{bits}_train_step"] = card_vs_cpu(f"conv net w{bits} (b16)", net, (cx, cy), bar)
    del model, net
    torch.cuda.empty_cache()
    return res


def gptq_projection(torch, gen, perm_gen, k, n, w_bit=4, gs=GPTQ_GROUP, centered=False):
    """A GPTQ export of one projection (K, N), HF layout: random code words,
    packed zero points within 2 of the middle code, fp16 scales of about
    2 / sqrt(K) over the code range, and an act-order ``g_idx``, a seeded
    permutation of ``arange(K) // gs``.  ``centered``: zero points of mean
    ``(2^w_bit - 1) / 2``, the random codes' mean (``mid - 1`` or ``mid``),
    so that the weights have no common offset."""
    from bitorch_engine_tpu_torch.ops import packing

    g = k // gs
    qweight = torch.randint(-2**31, 2**31, (k * w_bit // 32, n), device="cuda", generator=gen,
                            dtype=torch.int64).to(torch.int32)
    mid = 2 ** (w_bit - 1)
    zeros = torch.randint(mid - 1, mid + 1 if centered else mid + 3, (g, n), device="cuda",
                          generator=gen, dtype=torch.int32)
    step = 2.0 / math.sqrt(k) / 2 ** w_bit
    scales = ((0.5 + torch.rand(g, n, device="cuda", generator=gen)) * step).to(torch.float16)
    g_idx = (torch.arange(k) // gs)[torch.randperm(k, generator=perm_gen)].to(torch.int32)
    return dict(qweight=qweight, qzeros=packing.pack_cols(zeros, w_bit), scales=scales,
                g_idx=g_idx.cuda())


def write_gptq_checkpoint(torch, path, layers, seed, centered=False):
    """Llama-3-8B as a GPTQ export (HF names, unfused projections, w4 g128
    asym, act-order on every projection, fp16 embedding, head and norms), all
    drawn from ``seed``, written with the port's safetensors writer
    (``centered``: see :func:`gptq_projection`).  Returns its bytes."""
    from bitorch_engine_tpu_torch.utils.ingest import save_safetensors

    gen = torch.Generator(device="cuda").manual_seed(seed)
    perm_gen = torch.Generator().manual_seed(seed)
    h, vocab = 4096, 128256
    t = {"model.embed_tokens.weight": (torch.randn(vocab, h, device="cuda", generator=gen)
                                       * 0.02).half(),
         "lm_head.weight": (torch.randn(vocab, h, device="cuda", generator=gen) * 0.02).half(),
         "model.norm.weight": (1 + 0.05 * torch.randn(h, device="cuda", generator=gen)).half()}
    for i in range(layers):
        p = f"model.layers.{i}."
        for name, (k, n) in CKPT_PROJ.items():
            block = "self_attn" if name in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
            for field, v in gptq_projection(torch, gen, perm_gen, k, n,
                                            centered=centered).items():
                t[f"{p}{block}.{name}.{field}"] = v
        for norm in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{norm}.weight"] = (1 + 0.05 * torch.randn(h, device="cuda", generator=gen)).half()
    save_safetensors(path, t, metadata={"format": "pt", "quant": "gptq w4 g128 desc_act"})
    return sum(v.numel() * v.element_size() for v in t.values())


def ckpt_counts():
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts
    from bitorch_engine_tpu_torch.ops.mpq_linear import act_order_counts

    return {**launch_counts(), **{f"act_order_{k}": v for k, v in act_order_counts.items()}}


def reset_ckpt_counts():
    from bitorch_engine_tpu_torch.ops.cuda import reset_launch_counts
    from bitorch_engine_tpu_torch.ops.mpq_linear import act_order_counts

    reset_launch_counts()
    for key in act_order_counts:
        act_order_counts[key] = 0


@contextmanager
def plain_mpq_forward():
    """Every MPQ projection's forward as ``x @ dequantize_mpq(qt)`` in f32 on
    the logical weight, cast: the route, the gather and the scatter
    bypassed."""
    import torch
    from bitorch_engine_tpu_torch.ops import mpq_linear
    from bitorch_engine_tpu_torch.ops.quant import dequantize_mpq

    def plain(x, qt, out_dtype=None):
        return (x.float() @ dequantize_mpq(qt, torch.float32)).to(out_dtype or x.dtype)

    with mock.patch.object(mpq_linear, "_mpq_forward", plain):
        yield


def decode_step_ms(torch, model, prompt):
    """Wall ms a greedy decode step, over ``DECODE_STEPS`` steps after the
    prefill of ``prompt``."""
    marks = {}

    def at_prefill(_logits):
        torch.cuda.synchronize()
        marks["t"] = time.perf_counter()

    serve(torch, model, prompt, DECODE_STEPS, on_prefill=at_prefill)
    torch.cuda.synchronize()
    return (time.perf_counter() - marks["t"]) * 1e3 / DECODE_STEPS


def host_profile(torch, model, prompt, steps=PROFILE_STEPS):
    """``cProfile`` over ``steps`` greedy decode steps after an unprofiled
    prefill (``utils.profiling.host_profile``): the wall ms a step under
    the profiler and, per Python function, its calls, own ms and
    cumulative ms a step."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches, prefill
    from bitorch_engine_tpu_torch.utils import profiling

    caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda")
    logits, caches = prefill(model, prompt, caches)
    tok = torch.argmax(logits[:, -1], dim=-1)

    def decode():
        nonlocal tok, caches
        for i in range(steps):
            pos = PROMPT + i
            last, caches = decode_step(model, tok[:, None], caches, pos, attn_window=bucket(pos + 1))
            tok = torch.argmax(last, dim=-1)

    return profiling.host_profile(decode, steps)


# the projection's host path, read per call in the decode step's profile:
# the layer's forward, the route, the act-order gather, kernel 1's wrapper
HOST_PATH = ("linear.py", "mpq_linear.py", "dequant_matmul.py:176(mpq_matmul)",
             "mbwq_matmul.py:157(launch_mma)", "index_select")


def host_cost(prof, pairs, top=10):
    """Host profiles side by side (``prof``: name -> :func:`host_profile`'s
    result): per run the wall and the Python's own ms a step and the
    projection's host path (:data:`HOST_PATH`) per call, and for each
    ``(base, other)`` of ``pairs`` the functions whose own time a step grows
    most from ``base`` to ``other``."""
    none = (0, 0, 0)
    out = {name: dict(wall_ms_per_step=w,
                      python_own_ms_per_step=sum(r[1] for r in rows.values()),
                      path={fn: dict(calls=r[0], own_ms=r[1], cum_ms=r[2],
                                     cum_us_per_call=r[2] * 1e3 / r[0])
                            for fn, r in rows.items()
                            if r[0] and any(key in fn for key in HOST_PATH)})
           for name, (w, rows) in prof.items()}
    for name, r in out.items():
        log(f"host profile {name}: {r['wall_ms_per_step']:.2f} ms/step under cProfile, "
            f"Python own time {r['python_own_ms_per_step']:.2f} ms/step; the projection's path "
            "(calls a step, cumulative ms a step, us a call):")
        for fn, p in sorted(r["path"].items(), key=lambda kv: -kv[1]["cum_ms"]):
            log(f"  {p['calls']:6.0f} {p['cum_ms']:8.3f} ms {p['cum_us_per_call']:8.2f} us  {fn}")
    for base, other in pairs:
        a, b = prof[base][1], prof[other][1]
        grew = sorted(set(a) | set(b), key=lambda fn: b.get(fn, none)[1] - a.get(fn, none)[1],
                      reverse=True)[:top]
        rows = [dict(fn=fn, calls=(a.get(fn, none)[0], b.get(fn, none)[0]),
                     own_ms=(a.get(fn, none)[1], b.get(fn, none)[1])) for fn in grew]
        out[f"grew_{base}_to_{other}"] = rows
        log(f"host profile: the functions whose own time a step grew most, {base} -> {other}")
        for r in rows:
            log(f"  {r['own_ms'][0]:8.3f} -> {r['own_ms'][1]:8.3f} ms, calls {r['calls'][0]:.0f} -> "
                f"{r['calls'][1]:.0f}  {r['fn']}")
    return out


# device kernels that move rows by an index (torch's gathers, index_select,
# scatters), matched in their names
GATHER_KERNEL_KEYS = ("index", "gather", "scatter")


def prefill_kernels(torch, model, prompt):
    """Two prefills of ``prompt`` under one ``torch.profiler`` (through
    ``utils.profiling``) on a schedule: the first a warm-up it records and
    drops (a trace's first kernels can go missing: one read counted 222 of
    kernel 2's 225 launches), the second read.  Every device kernel's
    launches and ms by name in the second, and the launch counters over it."""
    from bitorch_engine_tpu_torch.models.llama import init_kv_caches, prefill
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda")
    torch.cuda.synchronize()
    with profiler(schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        prefill(model, prompt, caches)
        torch.cuda.synchronize()
        prof.step()
        reset_launch_counts()
        t0 = time.perf_counter()
        prefill(model, prompt, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        prof.step()
    table = {}
    for k in device_summary(prof, wall, 1, top=None)["top_kernels"]:
        launches, ms = table.get(k["name"], (0.0, 0.0))
        table[k["name"]] = (launches + k["launches_per_call"], ms + k["ms_per_call"])
    return table, counts


def gather_check(torch, model, prompt, kernel2_launches):
    """The act-order prefill's device kernels against the same model's with
    ``q_perm`` stripped: kernel 2 launched ``kernel2_launches`` times in
    each and traced as often (a trace that lost a kernel fails the check,
    since its tables could then differ or agree by chance), and no gather,
    index_select or scatter kernel beside it that the stripped model does
    not run too (kernel 2 writes the rows in place)."""
    out = {}
    for name in ("act_order", "stripped"):
        with q_perm_stripped(model) if name == "stripped" else nullcontext():
            table, counts = prefill_kernels(torch, model, prompt)
        k2 = [v for kname, v in table.items() if "dequant_kernel" in kname]
        out[name] = dict(
            kernel2_launches=counts["dequant_mpq"],
            kernel2_traced=sum(v[0] for v in k2), kernel2_ms=sum(v[1] for v in k2),
            gathers={kname: v[0] for kname, v in table.items()
                     if any(key in kname.lower() for key in GATHER_KERNEL_KEYS)})
        log(f"act-order prefill kernels ({name}): kernel 2 {out[name]['kernel2_launches']} "
            f"launches ({out[name]['kernel2_traced']:.0f} traced), {out[name]['kernel2_ms']:.3f} ms; "
            f"row-moving kernels {out[name]['gathers']}")
        check(out[name]["kernel2_launches"] == kernel2_launches,
              f"act-order prefill ({name}): {out[name]['kernel2_launches']} kernel-2 launches")
        check(out[name]["kernel2_traced"] == out[name]["kernel2_launches"],
              f"act-order prefill ({name}): the trace holds {out[name]['kernel2_traced']:.0f} of "
              f"kernel 2's {out[name]['kernel2_launches']} launches (it lost kernels)")
    check(out["act_order"]["gathers"] == out["stripped"]["gathers"],
          "the act-order prefill runs gather / index_select / scatter kernels beside kernel 2")
    return out


@contextmanager
def q_perm_stripped(model):
    """Every MPQ projection of ``model`` without its ``q_perm`` (the stored
    rows as they are: other numbers, the same kernels and bytes), restored
    on exit."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear

    saved = [(mod, mod.qweight) for mod in model.modules()
             if isinstance(mod, MPQLinear) and mod.q_perm is not None]
    try:
        for mod, qt in saved:
            mod.set_qweight(qt.replace(q_perm=None))
        yield model
    finally:
        for mod, qt in saved:
            mod.set_qweight(qt)


def phase_ckpt_e2e(torch, gen, tmp):
    """Phase 17a: the act-order Llama-3-8B checkpoint written, loaded with
    ``load_llama_from_safetensors`` into the unfused serving configuration,
    ``prepare_params_for_cuda(model, bf16)``, then prefill 8 x 256 + 32
    greedy decode steps with the launch, gather and scatter counts, and a
    profiled prefill + ``PROFILE_STEPS`` decode steps as phase 4's; the
    kernel path's last logits against the plain path on the same weights
    (forced tokens) at phase 6's 2e-2, the plain path's projections
    through :func:`plain_mpq_forward`; the decode step timed beside the same
    model without ``q_perm`` and a freshly built unfused model, each
    profiled on the host.  Returns the model and the run's numbers."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, llama3_8b_serving, tiny_llama
    from bitorch_engine_tpu_torch.models.llama_loader import load_llama_from_safetensors
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    # the process's first model built on ``meta`` imports torch's meta
    # kernels (seconds, once): paid here, outside the timed load
    t0 = time.perf_counter()
    LlamaModel(tiny_llama(), device="meta")
    log(f"first meta-device build: {time.perf_counter() - t0:.1f} s")
    path = str(pathlib.Path(tmp) / "llama3_8b_gptq_act_order.safetensors")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = write_gptq_checkpoint(torch, path, CKPT_LAYERS, SEED + 17)
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cfg = llama3_8b_serving(fuse_qkv=False, fuse_gate_up=False, max_seq_len=CACHE,
                            num_layers=CKPT_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load_llama_from_safetensors(path, cfg, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prepare_params_for_cuda(model, torch.bfloat16)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0 - load_s
    gib = torch.cuda.memory_allocated() / 2**30
    qt = model.layer_0.mlp.down_proj.qweight
    check(qt.q_perm is not None and qt.g_idx is None and qt.scales.dtype == torch.bfloat16,
          "the loaded projections are not canonicalized act-order tensors in kernel form")
    log(f"checkpoint: Llama-3-8B GPTQ w4 g128 act-order, {CKPT_LAYERS} layers, "
        f"{nbytes / 2**30:.2f} GiB written in {write_s:.1f} s ({tmp}); loaded in {load_s:.1f} s "
        f"+ prepare_params_for_cuda {prepare_s:.1f} s, {gib:.2f} GiB allocated "
        f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f})")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    serve(torch, model, prompt, 2)  # warm-up
    torch.cuda.synchronize()
    marks = {}

    def at_prefill(logits):
        torch.cuda.synchronize()
        marks["t"] = time.perf_counter()
        marks["counts"] = ckpt_counts()
        check(bool(torch.isfinite(logits).all()), "act-order prefill logits are not finite")

    reset_ckpt_counts()
    t0 = time.perf_counter()
    last, toks = serve(torch, model, prompt, DECODE_STEPS, on_prefill=at_prefill)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    run = ckpt_counts()
    pre = marks["counts"]
    dec = {k: run[k] - pre[k] for k in run}
    proj = 7 * CKPT_LAYERS
    log(f"checkpoint e2e counts at prefill {pre}; per decode step "
        f"{ {k: v / DECODE_STEPS for k, v in dec.items() if v} }")
    check(pre == {**counts_with(dequant_mpq=proj + 1, flash_attention=CKPT_LAYERS),
                  "act_order_gather": 0, "act_order_scatter": proj, "act_order_plain": 0},
          f"act-order prefill counts {pre}")
    check(dec == {**counts_with(mpq_matmul=(proj + 1) * DECODE_STEPS),
                  "act_order_gather": proj * DECODE_STEPS, "act_order_scatter": 0,
                  "act_order_plain": 0}, f"act-order decode counts {dec}")
    check(bool(torch.isfinite(last).all()), "act-order decode logits are not finite")
    prefill_ms = (marks["t"] - t0) * 1e3
    step_ms = (t_end - marks["t"]) * 1e3 / DECODE_STEPS
    profiled = profile_serve(torch, model, prompt, PROFILE_STEPS)
    profiled["decode"]["idle_share_estimate_unprofiled"] = (
        1.0 - profiled["decode"]["device_busy_ms_per_call"] / step_ms)
    profiled["prefill_gathers"] = gather_check(torch, model, prompt, proj + 1)
    decode = decode_breakdown(torch, model, prompt, cfg)
    reset_ckpt_counts()
    with plain_kernels(), plain_mpq_forward():
        want, _ = serve(torch, model, prompt, DECODE_STEPS, forced=toks)
    torch.cuda.synchronize()
    check(all(n == 0 for n in ckpt_counts().values()),
          f"the plain path launched a kernel or took an act-order route {ckpt_counts()}")
    rel = ((last - want).abs().max() / want.abs().max()).item()
    log(f"checkpoint e2e: prefill {prefill_ms:.2f} ms, decode {step_ms:.3f} ms/step (batch {BATCH}); "
        f"path check (prefill + {DECODE_STEPS} decode steps, {CKPT_LAYERS} layers): "
        f"max|d logits|/max|logits| = {rel:.3e}")
    check(rel <= 2e-2, f"act-order path check: {rel} > 2e-2")
    out = dict(layers=CKPT_LAYERS, checkpoint_gib=nbytes / 2**30, write_s=write_s, load_s=load_s,
               prepare_s=prepare_s, allocated_gib=gib, prefill_ms=prefill_ms,
               decode_ms_per_step=step_ms, path_check_rel=rel, profile=profiled,
               decode_breakdown=decode,
               per_prefill={k: v for k, v in pre.items() if v},
               per_step={k: v / DECODE_STEPS for k, v in dec.items() if v})
    return model, prompt, out


def decode_breakdown(torch, model, prompt, cfg):
    """The act-order decode step's wall time taken apart, in one run: the
    loaded model (``act_order``), the same model with ``q_perm`` stripped
    (``stripped``: no gathers, the same kernels and bytes) and a freshly
    built unfused model of the same configuration (``built``), timed in the
    order act_order, stripped, built, built, stripped, act_order; then each
    profiled on the host."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    built = prepare_params_for_cuda(LlamaModel(cfg, device="cuda", seed=SEED + 19), torch.bfloat16)
    runs = {"act_order": [], "stripped": [], "built": []}
    for name in ("act_order", "stripped", "built", "built", "stripped", "act_order"):
        if name == "stripped":
            with q_perm_stripped(model):
                runs[name].append(decode_step_ms(torch, model, prompt))
        else:
            runs[name].append(decode_step_ms(torch, built if name == "built" else model, prompt))
    out = {name: dict(runs_ms=r, ms=statistics.median(r)) for name, r in runs.items()}
    log("act-order decode taken apart, ms/step (runs in the order act_order, stripped, built, "
        "built, stripped, act_order): " + "; ".join(
            f"{k} {v['ms']:.2f} {[round(x, 2) for x in v['runs_ms']]}" for k, v in out.items()))
    prof = {"act_order": host_profile(torch, model, prompt)}
    with q_perm_stripped(model):
        prof["stripped"] = host_profile(torch, model, prompt)
    prof["built"] = host_profile(torch, built, prompt)
    out["host"] = host_cost(prof, (("stripped", "act_order"), ("built", "stripped")))
    del built
    torch.cuda.empty_cache()
    return out


def phase_ckpt_roundtrip(torch, model, prompt, tmp):
    """Phase 17c: ``save_checkpoint`` of the loaded model, ``load_checkpoint``
    (no template) into a skeleton on ``meta`` through ``load_jax_params``:
    the prefill's last logits and one decode step's bit-equal."""
    from bitorch_engine_tpu_torch.models.llama import (
        LlamaModel, decode_step, init_kv_caches, prefill,
    )
    from bitorch_engine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from bitorch_engine_tpu_torch.utils.convert import load_jax_params

    def logits_of(m):
        caches = init_kv_caches(m.cfg, BATCH, CACHE, device="cuda")
        logits, caches = prefill(m, prompt, caches)
        last = logits[:, -1]
        tok = torch.argmax(last, dim=-1)[:, None]
        step, _ = decode_step(m, tok, caches, PROMPT, attn_window=bucket(PROMPT + 1))
        return last, step

    before = logits_of(model)
    path = str(pathlib.Path(tmp) / "ckpt")
    t0 = time.perf_counter()
    save_checkpoint(path, model)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = load_jax_params(LlamaModel(model.cfg, device="meta"), load_checkpoint(path),
                               device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    after = logits_of(restored)
    equal = all(torch.equal(a, b) for a, b in zip(before, after))
    log(f"checkpoint round trip: saved in {save_s:.1f} s, loaded into a meta skeleton in "
        f"{load_s:.1f} s; prefill and decode logits bit-equal: {equal}")
    check(equal, "checkpoint round trip: logits differ")
    del restored
    torch.cuda.empty_cache()
    return dict(save_s=save_s, load_s=load_s, bit_equal=equal)


def record_bytes(qt):
    """The bytes of an MPQ record's tensors (codes, metadata, row map)."""
    return sum(t.nbytes for t in (qt.packed, qt.scales, qt.zeros, qt.q_perm, qt.g_idx)
               if t is not None)


def act_order_tensor(torch, gen, perm_gen, k, n, w_bit, act_bits=16, ingested=False):
    """An ingested act-order GPTQ tensor in kernel form (bf16 metadata);
    with ``ingested``, also the tensor as ingested (asym, f32 scales),
    first."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import prepare_for_kernel
    from bitorch_engine_tpu_torch.utils.ingest import mpq_from_gptq

    qt = mpq_from_gptq(**gptq_projection(torch, gen, perm_gen, k, n, w_bit), device="cuda")
    check(qt.q_perm is not None, "the act-order tensor was not canonicalized")
    kform = prepare_for_kernel(qt, torch.bfloat16, act_bits)
    return (qt, kform) if ingested else kform


def exl2_tensor(torch, gen, k, n):
    """An exl2 export (K, N): groups of EXL2_GROUP rows at the widths of
    ``EXL2_LAYOUT``, random code words and scale codes, a random
    ``q_invperm``, ingested by ``mbwq_from_exl2``."""
    from bitorch_engine_tpu_torch.utils.ingest import mbwq_from_exl2

    groups = sum(ng for _, ng in EXL2_LAYOUT)
    check(groups * EXL2_GROUP == k, "exl2 layout does not cover K")
    q_groups, qrow = [], 0
    for bits, ng in EXL2_LAYOUT:
        for _ in range(ng):
            q_groups += [bits, qrow]
            qrow += EXL2_GROUP * bits // 32
    q_weight = torch.randint(-2**31, 2**31, (qrow, n), device="cuda", generator=gen,
                             dtype=torch.int64).to(torch.int32)
    q_scale = torch.randint(-2**31, 2**31, (groups, n // 8), device="cuda", generator=gen,
                            dtype=torch.int64).to(torch.int32)
    q_scale_max = (0.5 + torch.rand(groups, device="cuda", generator=gen)) * 0.02 / math.sqrt(k)
    invperm = torch.randperm(k, device="cuda", generator=gen).to(torch.int32)
    return mbwq_from_exl2(q_weight, q_scale, q_scale_max, torch.tensor(q_groups), invperm,
                          device="cuda")


def phase_ckpt_kernels(torch, gen, flush):
    """Phase 17b: the act-order routes per layer, each against its plain
    version on the card: kernel 1 on the gathered activations (f32 rel <=
    1e-3 before the cast), kernel 2 writing its rows through ``q_perm``
    (bit-equal to ``dequantize_mpq``, and to its plain version in every
    zero form of the tensor in kernel form and as ingested), kernel 5 on a
    w2 tensor in A8 (max|d| = 0), kernel 7 on an exl2 tensor with odd
    widths and a random ``q_invperm`` (f32 rel <= 1e-3), each timed beside
    the same kernel on the tensor without ``q_perm`` (the gather, or kernel
    2's row map, is the difference); a ragged ``g_idx``
    shown to take the plain route.  Kernel 5's act-order route and kernel
    7's exl2 tensor are also driven through their entry points
    (``mpq_linear``, an ``MBWQLinear`` layer), the counts set to 0 just
    before and read just after: ``route_launches``."""
    from bitorch_engine_tpu_torch.layers.linear import MBWQLinear
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import (
        dequant_mpq, mpq_matmul, mpq_matmul_ref, prepare_for_kernel,
    )
    from bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul import mbwq_matmul, mbwq_matmul_ref
    from bitorch_engine_tpu_torch.ops.cuda.quad_matmul import mpq_matmul_a8, mpq_matmul_a8_ref
    from bitorch_engine_tpu_torch.ops import mpq_linear as ml
    from bitorch_engine_tpu_torch.ops.mbwq_linear import dequantize_mbwq, gather_activations
    from bitorch_engine_tpu_torch.ops.quant import dequantize_mpq
    from bitorch_engine_tpu_torch.utils.ingest import mpq_from_gptq

    perm_gen = torch.Generator().manual_seed(SEED + 18)
    out = {"mpq_matmul": [], "dequant_mpq": [], "mpq_matmul_a8": [], "mbwq_matmul": [],
           "route_launches": {"mpq_matmul_a8": 0, "mbwq_matmul": 0}}
    for name, k, n in ACT_ORDER_SHAPES:
        ingested, qt = act_order_tensor(torch, gen, perm_gen, k, n, 4, ingested=True)
        check_dequant(torch, f"act-order {name}", qt)
        check_dequant(torch, f"act-order {name} as ingested", ingested)
        del ingested
        stored = ml._stored(qt)
        for m in ACT_ORDER_M:
            x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
            got = mpq_matmul(ml._gather(x, qt), stored, torch.float32)
            want = mpq_matmul_ref(x, qt, torch.float32)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            row = dict(shape=name, m=m, max_abs_err=err, rel_err=rel)
            if m == 8:
                w_bf16 = dequantize_mpq(qt, torch.bfloat16)
                bms, bby = bound(record_bytes(qt) + x.nbytes + m * n * 2, 2 * m * k * n)
                row.update(
                    ms=time_ms(torch, lambda: mpq_matmul(ml._gather(x, qt), stored), flush=flush),
                    kernel_ms=time_ms(torch, lambda: mpq_matmul(x, stored), flush=flush),
                    gather_ms=time_ms(torch, lambda: ml._gather(x, qt), flush=flush),
                    plain_ms=time_ms(torch, lambda: mpq_matmul_ref(x, qt), flush=flush),
                    library_ms=time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush),
                    bound_ms=bms, bound_by=bby)
                del w_bf16
            out["mpq_matmul"].append(row)
            log(f"act-order kernel 1 {name} m={m}: max|d|={err:.3e} rel={rel:.3e}" + (
                f"; gather + kernel {row['ms'] * 1e3:.2f} us, kernel alone {row['kernel_ms'] * 1e3:.2f}"
                f" us, gather {row['gather_ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.1f} us, "
                f"torch.matmul {row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us"
                if m == 8 else ""))
            check(rel <= 1e-3, f"act-order kernel 1 {name} m={m}: rel {rel} > 1e-3")
        for dtype in (torch.bfloat16, torch.float32):
            got = ml.reconstruct_weight(qt, dtype)
            equal = torch.equal(got, dequantize_mpq(qt, dtype))
            row = dict(shape=name, dtype=str(dtype)[6:], bit_equal=equal, max_abs_err=0.0 if equal
                       else (got.float() - dequantize_mpq(qt, torch.float32)).abs().max().item())
            if dtype == torch.bfloat16:
                bms, bby = bound(record_bytes(qt) + k * n * 2, 0)
                row.update(ms=time_ms(torch, lambda: ml.reconstruct_weight(qt, dtype), flush=flush),
                           kernel_ms=time_ms(torch, lambda: dequant_mpq(stored, dtype), flush=flush),
                           plain_ms=time_ms(torch, lambda: dequantize_mpq(qt, dtype), flush=flush),
                           library_ms=None, bound_ms=bms, bound_by=bby)
            out["dequant_mpq"].append(row)
            log(f"act-order kernel 2 (rows through q_perm) {name} {row['dtype']}: bit-equal to "
                f"dequantize_mpq {equal}" + (
                f"; {row['ms'] * 1e3:.2f} us, without the row map {row['kernel_ms'] * 1e3:.2f} us, plain "
                f"{row['plain_ms'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.2f} us"
                if "ms" in row else ""))
            check(equal, f"act-order kernel 2 {name} {dtype}: not bit-equal to dequantize_mpq")
        del qt, stored
        q8 = act_order_tensor(torch, gen, perm_gen, k, n, 2, act_bits=8)
        check(q8.act_bits == 8, "the w2 act-order tensor is not in the A8 regime")
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        got = mpq_matmul_a8(ml._gather(x, q8), ml._stored(q8), accumulator=True)
        want = mpq_matmul_a8_ref(x, q8, accumulator=True)
        err = (got - want).abs().max().item()
        bms, bby = bound(record_bytes(q8) + x.nbytes + 8 * n * 2, 2 * 8 * k * n, INT8_OPS_PER_S)
        out["mpq_matmul_a8"].append(dict(
            shape=name, m=8, max_abs_err=err, rel_err=err / want.abs().max().item(),
            ms=time_ms(torch, lambda: mpq_matmul_a8(ml._gather(x, q8), ml._stored(q8)), flush=flush),
            kernel_ms=time_ms(torch, lambda: mpq_matmul_a8(x, ml._stored(q8)), flush=flush),
            plain_ms=time_ms(torch, lambda: mpq_matmul_a8_ref(x, q8), flush=flush),
            library_ms=None, bound_ms=bms, bound_by=bby))
        r5 = out["mpq_matmul_a8"][-1]
        log(f"act-order kernel 5 (w2 g128 A8) {name} m=8: max|d| = {err:.3e} (bar 0); "
            f"gather + kernel {r5['ms'] * 1e3:.2f} us, kernel alone {r5['kernel_ms'] * 1e3:.2f} us, "
            f"plain {r5['plain_ms'] * 1e3:.1f} us, bound {r5['bound_ms'] * 1e3:.2f} us")
        check(err == 0, f"act-order kernel 5 {name}: max|d| {err} != 0")
        # the route a user's call takes: mpq_linear gathers, then kernel 5
        reset_ckpt_counts()
        y = ml.mpq_linear(x, q8)
        counts = {key: v for key, v in ckpt_counts().items() if v}
        check(counts == {"mpq_matmul_a8": 1, "act_order_gather": 1},
              f"act-order A8 mpq_linear {name}: counts {counts}")
        check(torch.equal(y, mpq_matmul_a8(ml._gather(x, q8), ml._stored(q8))),
              f"act-order A8 mpq_linear {name}: not the gathered kernel-5 output")
        out["route_launches"]["mpq_matmul_a8"] += counts["mpq_matmul_a8"]
        del q8
    k, n = EXL2_SHAPE
    qt = exl2_tensor(torch, gen, k, n)
    widths = tuple((s.quant_bits, s.w_bit) for s in qt.segments)
    check(qt.q_perm is not None and {b for b, _ in widths} == {2, 3, 4, 5, 6},
          f"the exl2 tensor's segments {widths}")
    for meta in (torch.float32, torch.bfloat16):
        qk = qt.replace(segments=tuple(prepare_for_kernel(s, meta) for s in qt.segments))
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        got = mbwq_matmul(gather_activations(x, qk), qk, torch.float32)
        want = x.float() @ dequantize_mbwq(qk, torch.float32)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        row = dict(shape=f"exl2_gate_up_{k}x{n}", meta=str(meta)[6:], m=8, segments=widths,
                   max_abs_err=err, rel_err=rel)
        if meta == torch.bfloat16:
            w_bf16 = dequantize_mbwq(qk, torch.bfloat16)
            nbytes = sum(record_bytes(s) for s in qk.segments) + qk.q_perm.nbytes
            bms, bby = bound(nbytes + x.nbytes + 8 * n * 2, 2 * 8 * k * n)
            row.update(ms=time_ms(torch, lambda: mbwq_matmul(gather_activations(x, qk), qk),
                                  flush=flush),
                       kernel_ms=time_ms(torch, lambda: mbwq_matmul(x, qk), flush=flush),
                       plain_ms=time_ms(torch, lambda: mbwq_matmul_ref(gather_activations(x, qk), qk),
                                        flush=flush),
                       library_ms=time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush),
                       bound_ms=bms, bound_by=bby)
            del w_bf16
        out["mbwq_matmul"].append(row)
        log(f"exl2 kernel 7 {k}x{n} {row['meta']} metadata, segments (bits, container) {widths}, "
            f"m=8: max|d|={err:.3e} rel={rel:.3e}" + (
                f"; gather + kernel {row['ms'] * 1e3:.2f} us, kernel alone {row['kernel_ms'] * 1e3:.2f} us, "
                f"plain {row['plain_ms'] * 1e3:.1f} us, torch.matmul {row['library_ms'] * 1e3:.2f} us, "
                f"bound {row['bound_ms'] * 1e3:.2f} us" if "ms" in row else ""))
        check(rel <= 1e-3, f"exl2 kernel 7 ({meta}): rel {rel} > 1e-3")
    # the route a user's call takes: an MBWQLinear layer holding the exl2
    # tensor (bf16 metadata) gathers by q_perm, then kernel 7
    layer = MBWQLinear(k, n, dtype=torch.bfloat16, qweight=qk)
    reset_ckpt_counts()
    y = layer(x)
    counts = {key: v for key, v in ckpt_counts().items() if v}
    check(counts == {"mbwq_matmul": 1}, f"exl2 MBWQLinear: counts {counts}")
    check(torch.equal(y, mbwq_matmul(gather_activations(x, qk), qk)),
          "exl2 MBWQLinear: not the gathered kernel-7 output")
    out["route_launches"]["mbwq_matmul"] += counts["mbwq_matmul"]
    log(f"entry-point routes: act-order A8 mpq_linear and exl2 MBWQLinear at m 8, launches "
        f"{out['route_launches']}")
    del qt, qk, layer
    # a ragged g_idx: past both kernels, the plain dequantize on the card
    tensors = gptq_projection(torch, gen, perm_gen, 4096, 4096)
    g_idx = torch.arange(4096, device="cuda") // GPTQ_GROUP
    g_idx[GPTQ_GROUP : GPTQ_GROUP + 4] = 0
    tensors["g_idx"] = g_idx[torch.randperm(4096, generator=perm_gen).cuda()].to(torch.int32)
    ragged = mpq_from_gptq(**tensors, device="cuda")
    check(ragged.g_idx is not None and ragged.q_perm is None, "the ragged tensor kept no g_idx")
    x = torch.randn(8, 4096, device="cuda", generator=gen).to(torch.bfloat16)
    reset_ckpt_counts()
    y = ml.mpq_linear(x, ragged)
    counts = {k: v for k, v in ckpt_counts().items() if v}
    log(f"ragged g_idx, m 8: counts {counts} (the plain route)")
    check(counts == {"act_order_plain": 1}, f"ragged g_idx counts {counts}")
    check(bool(torch.isfinite(y).all()), "ragged g_idx output not finite")
    out["ragged_counts"] = counts
    torch.cuda.empty_cache()
    return out


def phase_ppl_gate(torch):
    """Phase 17d: the port's perplexity gate on the card
    (``run_ppl_gate(hidden=128, layers=2, steps=250, seq_len=128)``), held to
    ``tests/test_ppl_gate.py``'s bounds."""
    from bitorch_engine_tpu_torch.models.eval import run_ppl_gate

    reset_ckpt_counts()
    t0 = time.perf_counter()
    out = run_ppl_gate(**PPL_GATE, device="cuda")
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in ckpt_counts().items() if v}
    log(f"perplexity gate ({seconds:.1f} s, launches {counts}):")
    for key, v in out.items():
        log(f"  {key} {v:.5f}")
    bounds = {
        "ppl_fp < 30": out["ppl_fp"] < 30,
        "rel_delta_w4g64 < 0.15": out["rel_delta_w4g64"] < 0.15,
        "rel_delta_w2g32 < 1.0": out["rel_delta_w2g32"] < 1.0,
        "rel_delta_mbwq_2p5 < 0.8": out["rel_delta_mbwq_2p5"] < 0.8,
        "0 < w4g64 < mbwq_2p5 < w2g32": 0.0 < out["rel_delta_w4g64"] < out["rel_delta_mbwq_2p5"]
        < out["rel_delta_w2g32"],
        "|bf16meta - w4g64| < 0.02": abs(out["rel_delta_w4g64_bf16meta"]
                                         - out["rel_delta_w4g64"]) < 0.02,
    }
    for what, ok in bounds.items():
        check(ok, f"perplexity gate: {what} does not hold")
    check(counts.get("dequant_mpq", 0) > 0 and counts.get("mpq_matmul_a8", 0) > 0,
          f"the gate's quantized arms launched kernels {counts}")
    return dict(out, seconds=seconds, launches=counts)


def phase_ckpt(torch, gen):
    """Phase 17, the checkpoint slice: 17a-d in a temporary directory that is
    removed at the end, whatever the outcome."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        model, prompt, e2e = phase_ckpt_e2e(torch, gen, tmp)
        e2e["roundtrip"] = phase_ckpt_roundtrip(torch, model, prompt, tmp)
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    kernels = phase_ckpt_kernels(torch, gen, flush)
    del flush
    torch.cuda.empty_cache()
    e2e["ppl_gate"] = phase_ppl_gate(torch)
    return e2e, kernels


def phase_moe_kernels(torch, flush):
    """Phase 18a: kernels 1 (m 8) and 2 at Mixtral's expert shapes and head,
    w4 g128 bf16 metadata, against their plain versions and timed (inputs
    from their own generator)."""
    moe_gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    rows = {"mpq_matmul": [], "dequant_mpq": []}
    for name, (k, n) in MOE_SHAPES.items():
        qt = mpq_weight(torch, moe_gen, k, n, 4)
        x = torch.randn(8, k, device="cuda", generator=moe_gen).to(torch.bfloat16)
        _, row1, row2 = mpq_kernel_rows(torch, name, x, qt, flush)
        rows["mpq_matmul"].append(row1)
        rows["dequant_mpq"].append(row2)
        log(f"time moe {name:9s} K={k} N={n}: kernel 1 {row1['ms']:.4f} ms (plain "
            f"{row1['plain_ms']:.4f}, torch.matmul {row1['library_ms']:.4f}, bound "
            f"{row1['bound_ms']:.4f}); kernel 2 {row2['ms']:.4f} ms (plain {row2['plain_ms']:.4f}, "
            f"bound {row2['bound_ms']:.4f})")
        del qt, x
    torch.cuda.empty_cache()
    return rows


def moe_bounds(torch, model):
    """The least time of one Mixtral decode step at batch 8 (bytes: every
    quantized weight and router read once, each step's valid int8 KV
    positions and scales) and of one 8 x 256 prefill (bf16 operations: every
    expert on every row, the head on every position, causal attention)."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.models.llama import QuantMoEMLP

    cfg = model.cfg
    lins = [m.qweight for m in model.modules() if isinstance(m, MPQLinear)]
    weight_bytes = sum(qt.packed.nbytes + qt.scales.nbytes + qt.zeros.nbytes for qt in lins)
    weight_bytes += sum(m.router.nbytes for m in model.modules() if isinstance(m, QuantMoEMLP))
    # a cached position: int8 k and v codes and their f32 scales, every layer
    kv_per_pos = cfg.num_layers * cfg.num_kv_heads * 2 * (cfg.head_dim + 4)
    kv_pos = sum(PROMPT + i + 1 for i in range(DECODE_STEPS)) / DECODE_STEPS
    decode_ms, decode_by = bound(weight_bytes + BATCH * kv_pos * kv_per_pos, 0.0)
    tokens = BATCH * PROMPT
    attn = cfg.num_layers * BATCH * cfg.num_heads * 4 * cfg.head_dim * PROMPT * (PROMPT + 1) / 2
    ops = 2 * tokens * sum(qt.in_features * qt.out_features for qt in lins)
    prefill_ms, prefill_by = bound(weight_bytes, ops + attn)
    return dict(decode_bound_ms=decode_ms, decode_bound_by=decode_by, weight_bytes=weight_bytes,
                prefill_bound_ms=prefill_ms, prefill_bound_by=prefill_by,
                prefill_ops=ops + attn)


def phase_moe_e2e(torch, gen):
    """Phase 18b-c: Mixtral-8x7B at full width and all 32 layers (random
    weights, seed 0): phase 4's serving run and profile (the launches
    checked exactly, every layer's dropped share 0 in every forward), the
    decode step's bound, then a short mixed queue through the batcher."""
    from bitorch_engine_tpu_torch.models.llama import moe_losses

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(torch, LAYERS, SEED, "mixtral_8x7b_serving")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gib = torch.cuda.memory_allocated() / 2**30
    cfg = model.cfg
    log(f"MoE model: Mixtral-8x7B w4 g128, {cfg.num_layers} layers x {cfg.moe_num_experts} "
        f"experts (top {cfg.moe_top_k}), built in {build_s:.1f} s, {gib:.2f} GiB allocated")
    # every kernel-1 (decode) or kernel-2 (prefill) launch of a pass: q|k|v,
    # o and the experts' gate, up and down in each layer, then the head
    proj = cfg.num_layers * (2 + 3 * cfg.moe_num_experts) + 1
    check(proj == sum(MOE_PER_PASS.values()), f"MoE launches per pass {proj}")
    dropped = []
    hook = model.register_forward_hook(
        lambda mod, inp, out: dropped.append(torch.stack(moe_losses(mod)["moe_dropped"])))
    counts, e2e = phase_e2e(torch, gen, model, proj=proj, label="MoE e2e")
    hook.remove()
    drops = torch.stack(dropped)
    check(drops.shape == (len(dropped), cfg.num_layers) and bool((drops == 0).all()),
          f"MoE: routes dropped under drop-free capacity ({drops.max().item()})")
    e2e.update(moe_bounds(torch, model), build_s=build_s, gib_allocated=gib,
               forwards_checked_dropped_0=len(dropped))
    log(f"MoE decode {e2e['decode_ms_per_step']:.2f} ms/step (wall) against a bound of "
        f"{e2e['decode_bound_ms']:.3f} ms ({e2e['weight_bytes'] / 2**30:.2f} GiB of weights); "
        f"prefill {e2e['prefill_ms']:.2f} ms against {e2e['prefill_bound_ms']:.2f} "
        f"({e2e['prefill_bound_by']}); no route dropped in {len(dropped)} forwards")
    _, e2e["serving"] = phase_serving(torch, model, **MOE_QUEUE)
    del model
    torch.cuda.empty_cache()
    return counts, e2e


def phase_moe_path_check(torch, gen):
    """Phase 18d: 2 Mixtral layers at full width, kernel path against plain
    path on the card (prefill + 4 decode steps, the plain side fed the
    kernel path's tokens), the (forward, layer, token) routes whose top-k
    set differs between them counted; then each MoE MLP call of the kernel
    path run once more on the plain path from the same input, which tells a
    route flip from a kernel error."""
    from bitorch_engine_tpu_torch.models.llama import QuantMoEMLP
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.ops.moe import route

    model = build_model(torch, 2, SEED + 18, "mixtral_8x7b_serving")
    path_gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                           generator=path_gen)
    mlps = [m for m in model.modules() if isinstance(m, QuantMoEMLP)]
    routes = []

    def record(mod, inp):
        x2 = inp[0].reshape(-1, inp[0].shape[-1])
        routes.append(route(x2, mod.router, mod.cfg.moe_top_k)[1].sort(dim=-1).values)

    hooks = [m.register_forward_pre_hook(record) for m in mlps]
    reset_launch_counts()
    got, toks = serve(torch, model, prompt, 4)
    launched = launch_counts()
    kernel_routes, routes = routes, []
    reset_launch_counts()
    with plain_kernels():
        want, _ = serve(torch, model, prompt, 4, forced=toks)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    check(all(n == 0 for n in launch_counts().values()), "the plain path launched a kernel")
    proj = 2 * (2 + 3 * MOE_EXPERTS) + 1
    check(launched == counts_with(mpq_matmul=4 * proj, dequant_mpq=proj, flash_attention=2),
          f"MoE path check launches {launched}")
    flips = sum(int((a != b).any(dim=-1).sum()) for a, b in zip(kernel_routes, routes, strict=True))
    n_routes = sum(a.shape[0] for a in kernel_routes)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"MoE path check (2 layers, prefill + 4 decode steps): max|d logits|/max|logits| = "
        f"{rel:.3e}; top-k sets differing in {flips} of {n_routes} (token, layer) routes")

    # per layer: the plain MoE MLP on the kernel path's own input
    layer_rels = {"prefill": [], "decode": []}

    def plain_again(mod, inp, out):
        with plain_kernels():
            ref = mod.forward(inp[0])
        phase = "prefill" if inp[0].shape[1] > 1 else "decode"
        layer_rels[phase].append(((out - ref).float().abs().max() / ref.float().abs().max()).item())

    hooks = [m.register_forward_hook(plain_again) for m in mlps]
    serve(torch, model, prompt, 4)
    for h in hooks:
        h.remove()
    per_layer = {phase: max(v) for phase, v in layer_rels.items()}
    log(f"MoE path check per layer (the plain MoE MLP on the kernel path's input): max rel "
        f"prefill {per_layer['prefill']:.3e} (kernel 2 is bit-equal), decode "
        f"{per_layer['decode']:.3e} over {sum(map(len, layer_rels.values()))} calls")
    check(max(per_layer.values()) <= 2e-2, f"MoE per-layer check: {per_layer} > 2e-2")
    check(rel <= 2e-2, f"MoE path check: {rel} > 2e-2 ({flips} route flips)")
    del model
    torch.cuda.empty_cache()
    return dict(rel=rel, route_flips=flips, routes=n_routes, per_layer_max_rel=per_layer)


def phase_moe(torch, gen):
    """Phase 18, the MoE slice: 18a-d."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    rows = phase_moe_kernels(torch, flush)
    del flush
    counts, e2e = phase_moe_e2e(torch, gen)
    e2e["path_check"] = phase_moe_path_check(torch, gen)
    return rows, counts, e2e


def phase_tp_kernels(torch, flush):
    """Phase 19, the parent's part: kernels 1 and 2 at one tp rank's shard
    shapes (m 8; o and down writing the f32 partial), kernel 3 at its 16
    query / 4 KV heads and kernel 6's write-back form at its 4 KV heads,
    each against its plain version, then timed (the card to itself)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    rows = {"mpq_matmul": [], "dequant_mpq": [], "flash_attention": [],
            "paged_prefix_attention_update": []}
    for name, (k, n) in TP_SHAPES.items():
        qt = mpq_weight(torch, gen, k, n, 4)
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        out_dtype = torch.float32 if name in TP_ROW_SHAPES else None
        _, row1, row2 = mpq_kernel_rows(torch, name, x, qt, flush, out_dtype)
        rows["mpq_matmul"].append(row1)
        rows["dequant_mpq"].append(row2)
        del qt
    rows["flash_attention"].append(flash_row(torch, gen, *TP_FLASH, flush))
    for name, b, W, rs, pool, update in TP_PAGED:
        a = paged_inputs(torch, gen, b, W, rs, pool, nkv=TP_NKV)
        rows["paged_prefix_attention_update"].append(
            paged_row(torch, a, name, W, pool, update, flush)[0])
        del a
    for name, rs in rows.items():
        for r in rs:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {name:16s} {r['shape']:34s} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    torch.cuda.empty_cache()
    return rows


def probe_collectives(torch, mesh):
    """Which collectives gloo runs on CUDA tensors as they are (each one
    refused up front raises ``RuntimeError`` on every rank alike); the port
    stages the kinds ``parallel.comm.CUDA_DIRECT`` leaves out.  Point to
    point is not probed: gloo's send reads a CUDA pointer as host memory."""
    import torch.distributed as dist

    group, t = mesh.groups["tp"], torch.arange(4.0, device="cuda")
    tries = {
        "all_reduce": lambda: dist.all_reduce(t.clone(), group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(TP)], t,
                                              group=group),
        "broadcast": lambda: dist.broadcast(t.clone(), src=mesh.ranks["tp"][0], group=group),
    }
    out = {}
    for kind, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[kind] = "takes CUDA tensors"
        except RuntimeError as e:
            out[kind] = "refused: " + str(e).strip().splitlines()[0][:160]
    # one decode step's row-parallel all-reduce (8 × 4096 f32), ms a call:
    # gloo on the CUDA tensor, and staged through pinned host memory
    x = torch.zeros(BATCH, 4096, device="cuda")
    host = torch.empty(x.shape, pin_memory=True)

    def staged():
        host.copy_(x)
        dist.all_reduce(host, group=group)
        x.copy_(host)

    for name, fn in (("direct", lambda: dist.all_reduce(x, group=group)), ("staged", staged)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RING_REPS):
            fn()
        torch.cuda.synchronize()
        out[f"all_reduce_128KB_ms_{name}"] = (time.perf_counter() - t0) * 1e3 / RING_REPS
    return out


def tp_queue(vocab):
    """Phase 19c's seeded queue (phase 18c's sizes): (prompt, new tokens)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 19)
    q = MOE_QUEUE
    (p_lo, p_hi), (n_lo, n_hi) = q["prompt_lens"], q["new_tokens"]
    return [(rng.integers(0, vocab, int(rng.integers(p_lo, p_hi + 1))).tolist(),
             int(rng.integers(n_lo, n_hi + 1))) for _ in range(q["n_requests"])]


def run_queue(torch, model, queue, mesh=None, capture=False):
    """The queue through ``ContinuousBatcher`` (phase 5b's configuration)
    on ``mesh``: ids per request, wall, launches, collectives, decode steps
    and, with ``capture``, each admission wave's first-token logits."""
    from bitorch_engine_tpu_torch.models.generate import ContinuousBatcher
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.parallel.comm import reset_comm_counts

    b = ContinuousBatcher(model, mesh=mesh, **SERVE)
    waves, tally = [], {"decode_steps": 0}
    inner = dict(decode=b._decode, chunked=b._prefill_chunked, slots=b._prefill_slots)

    def decode(*a):
        tally["decode_steps"] += 1
        return inner["decode"](*a)

    def wave(kind):
        def run(*a):
            logits = inner[kind](*a)
            if capture:
                waves.append(logits.float().cpu())
            return logits
        return run

    b._decode, b._prefill_chunked, b._prefill_slots = decode, wave("chunked"), wave("slots")
    for prompt, n_new in queue:
        b.submit(prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    reset_launch_counts()
    if mesh is not None:
        reset_comm_counts(mesh)
    t0 = time.perf_counter()
    done = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("_decode", "_prefill_chunked", "_prefill_slots"):
        delattr(b, name)  # the wrappers close over b: a cycle would hold its caches
    return dict(ids=[r.generated for r in done], waves=waves, wall_s=wall,
                launches={k: v for k, v in launch_counts().items() if v},
                comm=copy.deepcopy(mesh.comm_counts) if mesh is not None else {},
                decode_steps=tally["decode_steps"])


def tp_serve(torch, model, prompt, steps, mesh=None, forced=None, records=None, busy=None):
    """Phase 4's loop (prefill 8 × 256, decode with the bucketed window,
    dense caches) returning the logits of the prefill's last position and
    of every step (f32), and the tokens (greedy, or ``forced``); with
    ``records`` each pass's wall ms, launches and collectives appended;
    with ``busy`` each pass run under its own ``torch.profiler`` and its
    device busy ms appended."""
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches, prefill
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.parallel.comm import reset_comm_counts

    # the caches split over a tp or dp mesh; an ep mesh holds them whole
    cache_mesh = None if mesh is None or "ep" in mesh.shape else mesh
    caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda", mesh=cache_mesh)
    logits_seq, toks = [], []
    for i in range(steps + 1):
        torch.cuda.synchronize()
        if records is not None:
            reset_launch_counts()
            if mesh is not None:
                reset_comm_counts(mesh)
        prof = None
        if busy is not None:
            prof = profiler()
            prof.start()
        t0 = time.perf_counter()
        if i == 0:
            logits, caches = prefill(model, prompt, caches)
            last = logits[:, -1]
        else:
            pos = PROMPT + i - 1
            last, caches = decode_step(model, toks[-1][:, None], caches, pos,
                                       attn_window=bucket(pos + 1))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
            busy.append(device_summary(prof, wall_s, 1)["device_busy_ms_per_call"])
        if records is not None:
            records.append(dict(
                step=i, wall_ms=wall_s * 1e3,
                launches={k: v for k, v in launch_counts().items() if v},
                comm=copy.deepcopy(mesh.comm_counts) if mesh is not None else {}))
        logits_seq.append(last.float())
        toks.append(torch.argmax(last, dim=-1) if forced is None else forced[:, i])
    return logits_seq, torch.stack(toks, dim=1)


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def token_agreement(got_ids, want_ids) -> float:
    same = [a == b for got, want in zip(got_ids, want_ids) for a, b in zip(got, want)]
    return sum(same) / len(same)


def split_rows(torch, model):
    """The witness of tp's rounding, in one process: ``model`` (unsharded)
    with o and down computed as the ranks of a tp 2 world compute them, in
    place.  Each is cut into its TP row shards by ``row_shard`` (the cut
    ``shard_llama_params`` makes), each shard's product written in f32 by
    the same kernel on the same shard shapes, the partials summed in f32
    in rank order and cast once.  ``set_split(model, False)`` puts the
    whole projections back in the path (the unsharded model)."""
    from bitorch_engine_tpu_torch.models.llama_sharding import row_shard
    from bitorch_engine_tpu_torch.ops.mpq_linear import mpq_linear
    from bitorch_engine_tpu_torch.parallel.mesh import Mesh

    ranks = {"dp": (0,), "fsdp": (0,), "tp": tuple(range(TP))}
    meshes = [Mesh(shape={"dp": 1, "fsdp": 1, "tp": TP}, rank=i,
                   groups={a: None for a in ranks}, ranks=dict(ranks, dp=(i,), fsdp=(i,)))
              for i in range(TP)]

    class SplitRows(torch.nn.Module):
        def __init__(self, whole, where):
            super().__init__()
            self.whole, self.split = whole, True
            self.parts = torch.nn.ModuleList(row_shard(whole, m, "tp", where) for m in meshes)

        def forward(self, x):
            if not self.split:
                return self.whole(x)
            k, acc = self.parts[0].qweight.in_features, None
            for i, p in enumerate(self.parts):
                rows = getattr(p, "tp_rows", None)  # an act-order shard's logical rows
                xi = x[..., i * k:(i + 1) * k] if rows is None else x.index_select(-1, rows)
                part = mpq_linear(xi.contiguous().to(p.dtype), p.qweight, out_dtype=torch.float32)
                acc = part if acc is None else acc + part
            return acc.to(self.whole.dtype or x.dtype)

    for li, layer in enumerate(model.layers):
        layer.attn.o_proj = SplitRows(layer.attn.o_proj, f"layer_{li}/attn/o_proj")
        layer.mlp.down_proj = SplitRows(layer.mlp.down_proj, f"layer_{li}/mlp/down_proj")
    return model


def set_split(model, on: bool):
    for layer in model.layers:
        layer.attn.o_proj.split = layer.mlp.down_proj.split = on


def divergence_margins(torch, model, queue, want_ids, got_ids):
    """For each request whose tokens ``got_ids`` leave ``want_ids`` (the
    unsharded batcher's), the unsharded ``model``'s logits where they part
    (the prompt and the tokens both agreed on, padded to the batcher's
    power-of-2 bucket; causal, so the padding reads nothing back): the
    margin of the unsharded pick over the other, and max|logits|.  A token
    may flip only where that margin is within the logits' drift."""
    out = []
    for r, ((prompt, _), want, got) in enumerate(zip(queue, want_ids, got_ids)):
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if j is None:
            continue
        ids = prompt + want[:j]
        n = 8
        while n < len(ids):
            n *= 2
        toks = torch.zeros((1, n), dtype=torch.int64, device="cuda")
        toks[0, :len(ids)] = torch.tensor(ids, device="cuda")
        logits = model(toks)[0][0, len(ids) - 1]
        out.append(dict(request=r, at=j, want=want[j], got=got[j],
                        margin=float(logits[want[j]] - logits[got[j]]),
                        max_abs=float(logits.abs().max())))
    return out


def layer_io(torch, model, prompt, tok):
    """Every layer's input and output (bf16) and the logits in a prefill of
    ``prompt`` and one decode step of ``tok`` (b,) on ``model``."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches, prefill

    io = {"prefill": [], "decode": []}
    phase = ["prefill"]
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: io[phase[0]].append((inp[0].clone(), out[0].clone())))
        for layer in model.layers]
    try:
        caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda")
        logits, caches = prefill(model, prompt, caches)
        phase[0] = "decode"
        last, _ = decode_step(model, tok[:, None], caches, PROMPT, attn_window=bucket(PROMPT + 1))
    finally:
        for h in hooks:
            h.remove()
    io["logits"] = {"prefill": logits.float(), "decode": last.float()}
    return io


def per_layer_rel(torch, model, io, mesh):
    """Each layer of the tp model run on the unsharded model's input to it
    (a prefill from an empty cache at window 0, then one decode step over
    that cache), and its final norm and head (the shares gathered) on the
    unsharded last layer's output, against the unsharded model's:
    max|d|/max|ref| per layer, the head last.  Rounding does not pile up
    over the layers here, so a fault in any one layer or in the head's
    gather stands out."""
    from bitorch_engine_tpu_torch.models.llama import init_kv_caches

    caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda", mesh=mesh)
    pos_pre = torch.arange(PROMPT, device="cuda").expand(BATCH, PROMPT)
    pos_dec = torch.full((BATCH, 1), PROMPT, device="cuda")
    rels = {"prefill": [], "decode": []}
    for i, layer in enumerate(model.layers):
        x, want = io["prefill"][i]
        got, _ = layer(x, pos_pre, caches[i], 0, 0)
        rels["prefill"].append(rel_err(got.float(), want.float()))
        x, want = io["decode"][i]
        got, _ = layer(x, pos_dec, caches[i], PROMPT, bucket(PROMPT + 1))
        rels["decode"].append(rel_err(got.float(), want.float()))
    for phase_ in ("prefill", "decode"):
        want = io["logits"][phase_]
        got = model.logits(io[phase_][-1][1]).reshape(want.shape)
        rels[phase_].append(rel_err(got, want))
    return rels


def tp_rank():
    """One rank of phase 19's world (two ranks on the one card, gloo):

    * 19a: build ``llama3_8b_serving()`` at full width from seed 0 (rank 0
      first runs it unsharded: the reference's greedy tokens and logits),
      cut it to this rank's part with ``shard_llama_params``, run prefill
      8 × 256 and 32 decode steps forced to the reference's tokens, with
      each pass's launches and collectives, and profile a few steps;
    * 19b: ``ring_row_parallel_mpq`` at the o and down shapes (m 8)
      against the unsharded kernel 1;
    * 19c: phase 18c's queue through the batcher at dp 2 (both ranks still
      unsharded) and at tp 2, against rank 0's unsharded run.

    Returns one JSON string (``json``) of its numbers."""
    import torch
    import torch.distributed as dist

    from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import mpq_matmul
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.parallel.comm import reset_comm_counts
    from bitorch_engine_tpu_torch.parallel.overlap import ring_row_parallel_mpq, ring_shards

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    mesh_tp, mesh_dp = make_mesh(tp=TP), make_mesh(dp=TP)
    out = dict(rank=rank, probe=probe_collectives(torch, mesh_tp))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    t0 = time.perf_counter()
    model = build_model(torch, LAYERS, SEED)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    vocab = model.cfg.vocab_size
    prompt = torch.randint(0, vocab, (BATCH, PROMPT), device="cuda", generator=gen)
    queue = tp_queue(vocab)

    # the unsharded references and the witness of tp's rounding, on rank 0
    forced = torch.zeros((BATCH, DECODE_STEPS + 1), dtype=torch.int64)
    if rank == 0:
        tp_serve(torch, model, prompt, 2)  # warm-up
        ref_logits, ref_toks = tp_serve(torch, model, prompt, DECODE_STEPS)
        forced.copy_(ref_toks.cpu())
        ref_queue = run_queue(torch, model, queue, capture=True)
        out["ref_queue"] = {k: ref_queue[k] for k in ("ids", "wall_s", "launches", "decode_steps")}
        witness = split_rows(torch, build_model(torch, LAYERS, SEED))
        set_split(witness, False)
        same_logits, _ = tp_serve(torch, witness, prompt, 2, forced=ref_toks)
        out["witness_unsplit_equal"] = all(
            torch.equal(a, b) for a, b in zip(same_logits, ref_logits[:3]))
        set_split(witness, True)
        wit_logits, _ = tp_serve(torch, witness, prompt, DECODE_STEPS, forced=ref_toks)
        out["witness_rel_errs"] = [rel_err(g, w) for g, w in zip(wit_logits, ref_logits)]
        out["witness_greedy_agreement"] = float(
            (torch.stack([lg.argmax(-1) for lg in wit_logits], 1) == ref_toks).float().mean())
        wit_queue = run_queue(torch, witness, queue, capture=True)
        out["witness_wave_rel_errs"] = [rel_err(g, w) for g, w
                                        in zip(wit_queue["waves"], ref_queue["waves"])]
        out["witness_token_agreement"] = token_agreement(wit_queue["ids"], ref_queue["ids"])
        set_split(witness, False)
        del same_logits
    dist.broadcast(forced, src=0)
    forced = forced.cuda()
    with torch.no_grad():
        io = layer_io(torch, model, prompt, forced[:, 0])  # the same on every rank

    # 19c at dp 2: every rank holds the whole model and serves its slots
    dp = run_queue(torch, model, queue, mesh=mesh_dp)
    out["dp_queue"] = {k: dp[k] for k in ("ids", "wall_s", "launches", "comm", "decode_steps")}
    if rank == 0:
        out["dp_tokens_equal"] = dp["ids"] == ref_queue["ids"]

    # 19a: this rank's part of the model
    t0 = time.perf_counter()
    shard_llama_params(model, mesh_tp)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["shard_s"] = time.perf_counter() - t0
    out["gib_after_shard"] = torch.cuda.memory_allocated() / 2**30
    tp_serve(torch, model, prompt, 2, mesh=mesh_tp, forced=forced)  # warm-up
    records = []
    logits, toks = tp_serve(torch, model, prompt, DECODE_STEPS, mesh=mesh_tp, forced=forced,
                            records=records)
    out["records"] = records
    out["logits_checksums"] = [float(lg.double().sum()) for lg in logits]
    with torch.no_grad():
        out["per_layer_rel"] = per_layer_rel(torch, model, io, mesh_tp)
    del io
    if rank == 0:
        out["step_rel_errs"] = [rel_err(g, w) for g, w in zip(logits, ref_logits)]
        out["step_rel_errs_vs_witness"] = [rel_err(g, w) for g, w in zip(logits, wit_logits)]
        out["steps_equal_witness"] = sum(torch.equal(g, w) for g, w in zip(logits, wit_logits))
        out["greedy_agreement"] = float(
            (torch.stack([lg.argmax(-1) for lg in logits], 1) == forced[:, :DECODE_STEPS + 1])
            .float().mean())
        del ref_logits, wit_logits
    del logits
    out["busy_ms"] = []  # the prefill's and PROFILE_STEPS decode steps', each profiled alone
    tp_serve(torch, model, prompt, PROFILE_STEPS, mesh=mesh_tp, forced=forced, busy=out["busy_ms"])

    # 19b: the ring at the o and down shapes
    ring = []
    for name, (k, n) in RING_SHAPES.items():
        qt = mpq_weight(torch, gen, k, n, 4)
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        shards = ring_shards(qt, mesh_tp)
        torch.cuda.synchronize()
        reset_launch_counts()
        reset_comm_counts(mesh_tp)
        y = ring_row_parallel_mpq(x, qt, mesh_tp, shards=shards)
        torch.cuda.synchronize()
        launches = launch_counts()["mpq_matmul"]
        comm = copy.deepcopy(mesh_tp.comm_counts)
        want = mpq_matmul(x, qt, torch.float32)
        walls = []
        for _ in range(RING_REPS):
            t0 = time.perf_counter()
            ring_row_parallel_mpq(x, qt, mesh_tp, shards=shards)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        t_one = time_ms(torch, lambda: mpq_matmul(x, qt))
        ring.append(dict(shape=name, K=k, N=n, m=8, launches=launches, comm=comm,
                         rel_err=rel_err(y.float(), want), wall_ms=statistics.median(walls),
                         unsharded_kernel1_ms=t_one))
        del qt, shards
    out["ring"] = ring

    # 19c at tp 2
    tp = run_queue(torch, model, queue, mesh=mesh_tp, capture=True)
    out["tp_queue"] = {k: tp[k] for k in ("ids", "wall_s", "launches", "comm", "decode_steps")}
    if rank == 0:
        out["tp_wave_rel_errs"] = [rel_err(g, w) for g, w in zip(tp["waves"], ref_queue["waves"])]
        out["tp_wave_rel_errs_vs_witness"] = [rel_err(g, w) for g, w
                                              in zip(tp["waves"], wit_queue["waves"])]
        out["tp_token_agreement"] = token_agreement(tp["ids"], ref_queue["ids"])
        out["tp_token_agreement_vs_witness"] = token_agreement(tp["ids"], wit_queue["ids"])
        with torch.no_grad():
            out["tp_divergences"] = divergence_margins(torch, witness, queue, ref_queue["ids"],
                                                       tp["ids"])
            out["witness_divergences"] = divergence_margins(torch, witness, queue,
                                                            ref_queue["ids"], wit_queue["ids"])
        del witness
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return {"json": json.dumps(out)}


def phase_tp(torch):
    """Phase 19: the parallel slice.  19's kernel rows in this process, then
    the 2-rank world (``tp_rank``), spawned with the kernels already built,
    joined under a deadline; its numbers printed, per rank and per pass, and
    held to their checks."""
    from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    rows = phase_tp_kernels(torch, flush)
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = [json.loads(str(r["json"])) for r in launch_world(
        "chip_smoke:tp_rank", TP, timeout=TP_WORLD_TIMEOUT,
        collective_timeout=TP_COLLECTIVE_TIMEOUT)]
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    fails = []  # every number is printed before the checks are read

    def expect(ok, what):
        if not ok:
            fails.append(what)

    log(f"19 ({TP_LABEL}): world of {TP} ran {world_s:.1f} s; collectives on CUDA tensors: "
        f"{r0['probe']}")
    for r in ranks:
        log(f"19a rank {r['rank']}: built in {r['build_s']:.1f} s, sharded in {r['shard_s']:.2f} s, "
            f"{r['gib_after_shard']:.2f} GiB after, peak {r['peak_gib']:.2f} GiB")
        for rec in r["records"]:
            comm = "  ".join(f"{k} {c['calls']}x {c['ms']:.2f} ms ({c['staged']} staged)"
                             for k, c in sorted(rec["comm"].items()))
            log(f"19a rank {r['rank']} {'prefill' if rec['step'] == 0 else 'step ' + str(rec['step'])}: "
                f"wall {rec['wall_ms']:.2f} ms, launches {rec['launches']}; {comm}")
        busy = r["busy_ms"]
        log(f"19a rank {r['rank']} device busy (each pass profiled alone): prefill {busy[0]:.2f} ms; "
            f"decode steps 1-{PROFILE_STEPS} " + " ".join(f"{b:.2f}" for b in busy[1:])
            + f" ms (mean {statistics.mean(busy[1:]):.2f})")
    for phase_, rels in r0["per_layer_rel"].items():
        log(f"19a per layer on the unsharded input ({phase_}; the last: final norm and head): max "
            f"{max(rels):.3e}; " + " ".join(f"{e:.1e}" for e in rels))
        expect(max(rels) <= 2e-2, f"19a: a tp layer or the head ({phase_}) reads {max(rels)} > "
               "2e-2 from the unsharded one on the same input")
    # the end-to-end limit: the path checks' 2e-2, or what the witness (the
    # unsharded model summing o and down as two f32 row halves, in one
    # process) drifts from the unsharded model on the same passes, with half
    # again for tp's own placement of the rounding, whichever is larger
    errs, w_errs = r0["step_rel_errs"], r0["witness_rel_errs"]
    limit_a = max(2e-2, TP_WITNESS_SLACK * max(w_errs))
    log(f"19a witness (o and down summed as {TP} f32 row halves, one process) vs unsharded: "
        f"prefill {w_errs[0]:.3e}, decode max {max(w_errs[1:]):.3e}, greedy picks agreeing "
        f"{r0['witness_greedy_agreement']:.4f}; with its split off it equals the unsharded model: "
        f"{r0['witness_unsplit_equal']}")
    log(f"19a tp vs unsharded: max|d logits|/max|logits| prefill {errs[0]:.3e}, decode max "
        f"{max(errs[1:]):.3e} (limit {limit_a:.3e}); the tp model's greedy pick equals the forced "
        f"token in {r0['greedy_agreement']:.4f} of positions; tp vs witness max "
        f"{max(r0['step_rel_errs_vs_witness']):.3e}, {r0['steps_equal_witness']} of "
        f"{DECODE_STEPS + 1} passes bit-equal")
    expect(r0["witness_unsplit_equal"], "19a: the witness without its split is not the unsharded model")
    expect(max(errs) <= limit_a, f"19a: tp logits {max(errs)} > {limit_a} from the unsharded ones")
    expect(max(r0["step_rel_errs_vs_witness"]) <= 2e-2,
           f"19a: tp logits {max(r0['step_rel_errs_vs_witness'])} > 2e-2 from the witness's")
    expect(ranks[0]["logits_checksums"] == ranks[1]["logits_checksums"],
          "19a: the two ranks' logits differ")
    proj = 4 * LAYERS + 1
    for r in ranks:
        recs = r["records"]
        expect(recs[0]["launches"] == {"dequant_mpq": proj, "flash_attention": LAYERS},
              f"19a rank {r['rank']} prefill launches {recs[0]['launches']}")
        for rec in recs[1:]:
            expect(rec["launches"] == {"mpq_matmul": proj},
                  f"19a rank {r['rank']} step {rec['step']} launches {rec['launches']}")
            expect(rec["comm"]["all_reduce"]["calls"] == 2 * LAYERS
                  and rec["comm"]["all_gather"]["calls"] == 1,
                  f"19a rank {r['rank']} step {rec['step']} collectives {rec['comm']}")
    for r in ranks:
        for ring in r["ring"]:
            log(f"19b rank {r['rank']} {ring['shape']} K={ring['K']} N={ring['N']} m 8: rel "
                f"{ring['rel_err']:.3e}, {ring['launches']} kernel-1 launches, wall "
                f"{ring['wall_ms']:.3f} ms a call ({TP_LABEL}; unsharded kernel 1 "
                f"{ring['unsharded_kernel1_ms']:.4f} ms), collectives {ring['comm']}")
            expect(ring["launches"] == TP and ring["rel_err"] <= 1e-2,
                  f"19b rank {r['rank']} {ring['shape']}: {ring['launches']} launches, "
                  f"rel {ring['rel_err']}")
    ref_q = r0["ref_queue"]
    log(f"19c unsharded: {len(ref_q['ids'])} requests in {ref_q['wall_s']:.2f} s, "
        f"{ref_q['decode_steps']} decode steps")
    for key in ("dp_queue", "tp_queue"):
        for r in ranks:
            q = r[key]
            log(f"19c {key[:2]} 2 rank {r['rank']}: {q['wall_s']:.2f} s ({TP_LABEL}), "
                f"{q['decode_steps']} decode steps, launches {q['launches']}, collectives "
                + "  ".join(f"{k} {c['calls']}x {c['ms']:.1f} ms ({c['staged']} staged)"
                            for k, c in sorted(q["comm"].items())))
        expect(ranks[0][key]["ids"] == ranks[1][key]["ids"], f"19c {key}: the ranks' tokens differ")
    waves, w_waves = r0["tp_wave_rel_errs"], r0["witness_wave_rel_errs"]
    limit_c = max(2e-2, TP_WITNESS_SLACK * max(w_waves))
    log(f"19c dp 2 tokens equal to the unsharded batcher's: {r0['dp_tokens_equal']}")
    log(f"19c tp 2 vs unsharded: first-token logits per wave "
        + " ".join(f"{e:.3e}" for e in waves) + f" (limit {limit_c:.3e}; witness "
        + " ".join(f"{e:.3e}" for e in w_waves) + "; tp vs witness "
        + " ".join(f"{e:.3e}" for e in r0["tp_wave_rel_errs_vs_witness"]) + ")")
    log(f"19c tokens agreeing with the unsharded batcher's: tp {r0['tp_token_agreement']:.4f}, "
        f"witness {r0['witness_token_agreement']:.4f}; tp with the witness "
        f"{r0['tp_token_agreement_vs_witness']:.4f}")
    expect(r0["dp_tokens_equal"], "19c: dp 2 tokens differ from the unsharded batcher's")
    expect(max(waves) <= limit_c, f"19c: tp first-token logits {max(waves)} > {limit_c}")
    expect(max(r0["tp_wave_rel_errs_vs_witness"]) <= 2e-2,
           f"19c: tp first-token logits {max(r0['tp_wave_rel_errs_vs_witness'])} > 2e-2 from "
           "the witness's")
    # a request's tokens may leave the unsharded ones only where the
    # unsharded logits nearly tie: within twice the logits' allowed drift
    tie = 2 * max(limit_a, limit_c)
    for who in ("tp", "witness"):
        for d in r0[f"{who}_divergences"]:
            log(f"19c {who} request {d['request']} leaves the unsharded tokens at {d['at']}: "
                f"{d['want']} -> {d['got']}, unsharded margin {d['margin']:.4f} of max|logits| "
                f"{d['max_abs']:.3f} ({d['margin'] / d['max_abs']:.3e}; a tie within {tie:.3e})")
    expect(all(d["margin"] <= tie * d["max_abs"] for d in r0["tp_divergences"]),
           f"19c: a tp token leaves the unsharded ones where they do not tie: "
           f"{r0['tp_divergences']}")
    tp_q = r0["tp_queue"]
    expect(tp_q["launches"].get("paged_prefix_attention_update") == LAYERS * tp_q["decode_steps"],
          f"19c tp: write-back launches {tp_q['launches']} for {tp_q['decode_steps']} steps")
    check(not fails, "; ".join(fails))
    summary = dict(
        label=TP_LABEL, world_s=world_s, probe=r0["probe"], step_rel_errs=errs,
        greedy_agreement=r0["greedy_agreement"], per_layer_rel=r0["per_layer_rel"],
        limits=dict(e2e=limit_a, waves=limit_c, tie=tie),
        witness={k: r0[k] for k in r0 if k.startswith("witness_")},
        vs_witness=dict(steps=r0["step_rel_errs_vs_witness"],
                        steps_bit_equal=r0["steps_equal_witness"],
                        waves=r0["tp_wave_rel_errs_vs_witness"],
                        tokens=r0["tp_token_agreement_vs_witness"]),
        tp_divergences=r0["tp_divergences"], ring=[r["ring"] for r in ranks],
        busy_ms=[r["busy_ms"] for r in ranks], dp_tokens_equal=r0["dp_tokens_equal"],
        tp_token_agreement=r0["tp_token_agreement"], tp_wave_rel_errs=r0["tp_wave_rel_errs"],
        queues={key: [{k: v for k, v in r[key].items() if k != "ids"} for r in ranks]
                for key in ("dp_queue", "tp_queue")},
        unsharded_queue={k: v for k, v in ref_q.items() if k != "ids"},
        peak_gib=[r["peak_gib"] for r in ranks])
    return rows, dict(ranks=ranks, summary=summary)


def sp_launches(kind, coord):
    """Kernel launches of one sp rank's train step (sp 2; remat runs every
    forward twice): kernel 2 four times a projection (forward, recompute,
    backward, DiodeMix); kernels 3 and 4 once a layer per attention block,
    one for Ulysses, ``coord + 1`` for the ring (the blocks of later shards
    are skipped)."""
    blocks = 1 if kind == "ulysses" else coord + 1
    return counts_with(dequant_mpq=4 * TRAIN_PROJ * TRAIN_LAYERS,
                       flash_attention=2 * TRAIN_LAYERS * blocks,
                       flash_attention_bwd=2 * TRAIN_LAYERS * blocks)


def pp_launches():
    """One pp rank's forward + backward (no optimizer step): its 12 blocks
    over 4 microbatches, kernel 2 three times a projection, kernels 3 and 4
    twice a block."""
    per = TRAIN_LAYERS // PAR * PP_MICRO
    return counts_with(dequant_mpq=3 * TRAIN_PROJ * per, flash_attention=2 * per,
                       flash_attention_bwd=2 * per)


def phase_par_kernels(torch, flush):
    """Phase 20, the parent's part: kernel 2 at the 370M projections and
    kernels 3 and 4 at one sp rank's attention (``SP_FLASH``) against their
    plain versions, then timed (the card to itself)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = {"dequant_mpq": [], "flash_attention": [], "flash_attention_bwd": []}
    for name, (k, n) in TRAIN_SHAPES.items():
        qt = mpq_weight(torch, gen, k, n, 4)
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        rows["dequant_mpq"].append(mpq_kernel_rows(torch, name, x, qt, flush)[2])
        del qt
    for name, b, nh, nkv, s, d, causal in SP_FLASH:
        rows["flash_attention"].append(flash_row(torch, gen, name, b, nh, nkv, s, d, flush, causal))
        rows["flash_attention_bwd"].append(
            flash_bwd_row(torch, gen, name, b, nh, nkv, s, d, causal, flush))
    for name, rs in rows.items():
        for r in rs:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {name:19s} {r['shape']:32s} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    torch.cuda.empty_cache()
    return rows


def probe_train_collectives(torch, mesh):
    """Which collectives of the training layouts gloo runs on CUDA tensors as
    they are (bf16 and f32; a refusal raises ``RuntimeError`` on every rank
    alike); each kind of ``parallel.comm.CUDA_DIRECT['gloo']`` must be one."""
    import torch.distributed as dist

    group, out = mesh.group("sp"), {}
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.arange(8.0, device="cuda").to(dtype)
        tries = {
            "all_reduce": lambda: dist.all_reduce(t.clone(), group=group),
            "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(PAR)], t,
                                                  group=group),
            "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(t), t, group=group),
            "broadcast": lambda: dist.broadcast(t.clone(), src=mesh.ranks["sp"][0], group=group),
        }
        for kind, fn in tries.items():
            key = f"{kind}_{str(dtype)[6:]}"
            try:
                fn()
                torch.cuda.synchronize()
                out[key] = "takes CUDA tensors"
            except RuntimeError as e:
                out[key] = "refused: " + str(e).strip().splitlines()[0][:160]
    return out


def grad_rels(model, ref_grads, names=None):
    """max|d|/max|ref| of each gradient of ``model`` (those ``names``, else
    every one ``ref_grads`` holds) against the unsharded step's."""
    params = dict(model.named_parameters())
    out = {}
    for name in names or ref_grads:
        ref, g = ref_grads[name], params[name].grad
        out[name] = float("inf") if g is None else (
            (g.float() - ref).abs().max() / ref.abs().max()).item()
    return out


def packed_state(model):
    """Every packed, zeros and scales buffer of the quantized layers."""
    return {n: b for n, b in model.named_buffers() if n.endswith(("packed", "zeros", "scales"))}


def comm_text(comm):
    """One line of a rank's collectives by kind (``parallel.comm`` counts)."""
    return "  ".join(f"{k} {c['calls']}x {c['bytes'] / 2**20:.1f} MiB {c['ms']:.1f} ms "
                     f"({c['staged']} staged)" for k, c in sorted(comm.items()))


def par_loss(mesh):
    """The bench's next-token loss on a ``(tokens, labels)`` batch, this
    rank's share of the global mean with a mesh."""
    from bitorch_engine_tpu_torch.training import cross_entropy_loss

    def loss_fn(model, batch):
        logits, _ = model(batch[0])
        return cross_entropy_loss(logits, batch[1], mesh)

    return loss_fn


@contextmanager
def par_record(torch, rec, meshes=(), profiled=True):
    """Around one sub-phase's measured pass: launches, collectives (per
    kind over ``meshes``), wall s, peak GiB and, under ``torch.profiler``,
    device busy ms, into ``rec``."""
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.parallel.comm import reset_comm_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for m in meshes:
        reset_comm_counts(m)
    prof = profiler() if profiled else None
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        rec["busy_ms"] = device_summary(prof, wall, 1)["device_busy_ms_per_call"]
    rec["wall_s"] = wall
    rec["launches"] = {k: v for k, v in launch_counts().items() if v}
    comm = {}
    for m in meshes:
        for kind, c in m.comm_counts.items():
            acc = comm.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0, "staged": 0})
            for key in acc:
                acc[key] += c[key]
    rec["comm"] = comm
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30


def exact_attention(torch, q, k, v, do):
    """Causal attention in f32 and its gradients against ``do`` (autograd
    through the softmax), one batch row at a time: the exact values 20a's
    bf16 paths are held to."""
    L, scale = q.shape[2], q.shape[-1] ** -0.5
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    parts = [[] for _ in range(4)]
    for bi in range(q.shape[0]):
        qq, kk, vv = (t[bi].float().requires_grad_() for t in (q, k, v))
        p = torch.softmax(((qq @ kk.transpose(-1, -2)) * scale).masked_fill(~mask, float("-inf")),
                          dim=-1)
        o = p @ vv
        o.backward(do[bi].float())
        for acc, t in zip(parts, (o.detach(), qq.grad, kk.grad, vv.grad)):
            acc.append(t)
        del p, o
    return [torch.stack(acc) for acc in parts]


def sp_attention_checks(torch, mesh):
    """20a at the attention: ring and Ulysses on one (8, 16, 2048, 64) bf16
    q / k / v and output cotangent split over sp, outputs and gradients
    gathered, against kernels 3 and 4 on the whole sequence and (the ring's
    output) against its plain version on the same shards.  On the first sp
    rank, the witness that tells rounding from a fault: each path's output
    and gradients against the exact f32 attention (``exact_attention``),
    beside kernels 3 and 4's own distance from it."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.ops.cuda.flash_attention import flash_attention_diff
    from bitorch_engine_tpu_torch.parallel.comm import all_gather
    from bitorch_engine_tpu_torch.parallel.ring_attention import ring_attention
    from bitorch_engine_tpu_torch.parallel.ulysses import ulysses_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    b, h, L, d = TRAIN_BATCH, 16, TRAIN_SEQ, 64
    q, k, v, do = (torch.randn(b, h, L, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    i, n = mesh.coord("sp"), mesh.size("sp")

    def cut(t):
        return t[:, :, i * L // n : (i + 1) * L // n].contiguous()

    def run(fn, ins, cot):
        """(out, dq, dk, dv) of ``fn`` and its kernel-3 launches."""
        ins = [t.detach().clone().requires_grad_() for t in ins]
        reset_launch_counts()
        o = fn(*ins)
        torch.cuda.synchronize()
        launches = launch_counts()["flash_attention"]
        o.backward(cot)
        return [o.detach()] + [t.grad for t in ins], launches

    names = ("out", "dq", "dk", "dv")
    full, _ = run(flash_attention_diff, (q, k, v), do)
    out = {}
    exact = exact_attention(torch, q, k, v, do) if i == 0 else None
    if exact is not None:
        out["kernel_vs_exact"] = {nm: rel_err(f.float(), e) for nm, f, e in zip(names, full, exact)}
    for kind, fn in (("ulysses", ulysses_attention), ("ring", ring_attention)):
        parts, launches = run(lambda *t: fn(*t, mesh), [cut(t) for t in (q, k, v)], cut(do))
        got = [all_gather(mesh, t, "sp", dim=2) for t in parts]
        torch.cuda.synchronize()
        rec = dict(launches=launches,
                   equal=bool(torch.equal(got[0], full[0])),
                   differing=(got[0] != full[0]).float().mean().item(),
                   rel=rel_err(got[0].float(), full[0].float()),
                   close=bool(torch.allclose(got[0].float(), full[0].float(), atol=1e-2, rtol=1e-2)),
                   grads_equal=all(torch.equal(g, f) for g, f in zip(got[1:], full[1:])),
                   grad_rel={nm: rel_err(g.float(), f.float())
                             for nm, g, f in zip(names[1:], got[1:], full[1:])})
        if exact is not None:
            rec["vs_exact"] = {nm: rel_err(g.float(), e) for nm, g, e in zip(names, got, exact)}
        if kind == "ring":
            with plain_kernels():
                plain = all_gather(mesh, ring_attention(*(cut(t) for t in (q, k, v)), mesh), "sp",
                                   dim=2)
            rec["vs_plain_differing"] = (got[0] != plain).float().mean().item()
            rec["vs_plain_rel"] = rel_err(got[0].float(), plain.float())
        out[kind] = rec
        del parts, got
    del q, k, v, do, full, exact
    torch.cuda.empty_cache()
    return out


def par_grads(model):
    """The f32 gradients of ``model``'s trainable tensors, by name."""
    return {n: p.grad.float().clone() for n, p in model.named_parameters() if p.requires_grad}


def rows_witness(torch, model, batch):
    """The one-process witness of the half-row GEMMs, with no collective:
    the unsharded model's gradients from the batch's two row halves, each
    half's summed cross entropy over the whole batch's label count, summed
    in f32 and cast as ``training.sum_gradients`` casts them.  That is what
    a dp 2 step computes, so dp must equal it bit for bit; its distance
    from the unsharded step is what running every GEMM on half the rows
    alone moves the gradients.  Leaves the model's gradients cleared."""
    import torch.nn.functional as F

    toks, labels = batch
    half = toks.shape[0] // 2
    count = (labels != -100).sum().float()
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    acc, loss = {}, None
    for r in range(2):
        model.zero_grad(set_to_none=True)
        logits, _ = model(toks[r * half : (r + 1) * half])
        share = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                labels[r * half : (r + 1) * half].reshape(-1).long(),
                                reduction="sum") / count
        share.backward()
        loss = share.detach() if loss is None else loss + share.detach()
        for n, p in params:
            g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
            acc[n] = g if r == 0 else acc[n] + g
        del logits, share
    model.zero_grad(set_to_none=True)
    return dict(loss=float(loss), grads={n: acc[n].to(p.dtype).float() for n, p in params})


def par_ref(torch, hp, seed, witness=False):
    """The unsharded step from ``seed``'s weights and batch (every rank
    alike) and, with ``witness``, first the rows witness from the same
    weights: ``(batch, ref, rec)``."""
    from bitorch_engine_tpu_torch.training import make_train_step

    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, 32000, (TRAIN_BATCH, TRAIN_SEQ + 1), device="cuda", generator=gen)
    batch = (toks[:, :-1].contiguous(), toks[:, 1:].contiguous())
    t0 = time.perf_counter()
    model = build_train_model(torch, TRAIN_LAYERS, seed)
    rows = rows_witness(torch, model, batch) if witness else None
    zeros = {n: b.clone() for n, b in packed_state(model).items() if n.endswith("zeros")}
    rec = {}
    with par_record(torch, rec, profiled=False):
        rec["loss"] = float(make_train_step(model, par_loss(None), hp)(batch)["loss"])
    after = packed_state(model)
    ref = dict(loss=rec["loss"], after={n: b.clone() for n, b in after.items()},
               grads=par_grads(model), rows=rows)
    rec["build_and_step_s"] = time.perf_counter() - t0
    rec["zeros_refreshed"] = sum(not torch.equal(b, after[n]) for n, b in zeros.items())
    if rows is not None:
        rels = {n: rel_err(rows["grads"][n], g) for n, g in ref["grads"].items()}
        worst = max(rels, key=rels.get)
        rec["rows_witness"] = dict(loss_rel=abs(rows["loss"] - ref["loss"]) / abs(ref["loss"]),
                                   grad_rel=rels[worst], worst=worst)
    del model
    torch.cuda.empty_cache()
    return batch, ref, rec


def par_train_step(torch, rec, ref, model, mesh, meshes, batch, hp, against=None):
    """One train step through ``make_train_step(mesh=)`` (profiled), its
    loss and every gradient against the unsharded step's, and the packed
    tensors after it against the unsharded step's.  ``against``: other
    gradients by name (a witness's, another step's) whose distance is
    recorded too.  Returns the step's f32 gradients."""
    from bitorch_engine_tpu_torch.training import make_train_step

    step = make_train_step(model, par_loss(mesh), hp, mesh=mesh)
    with par_record(torch, rec, meshes):
        rec["loss"] = float(step(batch)["loss"])
    rec["loss_rel"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
    rels = grad_rels(model, ref["grads"])
    rec["worst"] = max(rels, key=rels.get)
    rec["grad_rel"] = rels[rec["worst"]]
    if against is not None:
        params = dict(model.named_parameters())
        rels = grad_rels(model, against)
        worst = max(rels, key=rels.get)
        rec["against"] = dict(grad_rel=rels[worst], worst=worst, tensors=len(against),
                              equal=sum(bool(torch.equal(params[n].grad.float(), g))
                                        for n, g in against.items()))
    rec["codes_differing"] = sum(int((b != ref["after"][n]).sum()) for n, b
                                 in packed_state(model).items() if n.endswith("packed"))
    rec["codes_total"] = sum(b.numel() * 32 // 4 for n, b in packed_state(model).items()
                             if n.endswith("packed"))
    del step
    return par_grads(model)


def par_rank():
    """One rank of phase 20's world (two ranks on the one card, gloo), each
    sub-phase against the unsharded 370M step both ranks run first from the
    same weights and batch (``ref``):

    * 20a: sp 2, ring and Ulysses, at the attention (``sp_attention_checks``)
      and as a train step, from ``PAR_SEEDS``' weights and batches;
    * 20b: dp 2 (a train step, also against rank 0's rows witness,
      ``rows_witness``) and fsdp 2 (forward and backward on the
      whole batch, the unsharded step's gradients put in their place, the
      DiodeMix step with each rank's half of the rows);
    * 20c: pp 2, the 24 blocks as 2 stages of 12 over 4 microbatches
      (``models.llama.pipeline_forward``), loss and gradients;
    * 20d: Mixtral-8x7B at 2 layers, ep 2 (4 experts a rank), prefill 8 ×
      256 and ``EP_STEPS`` decode steps forced to rank 0's unsharded tokens.

    Returns one JSON string (``json``) of its numbers."""
    import torch
    import torch.distributed as dist

    from bitorch_engine_tpu_torch.models.llama import pipeline_forward
    from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.parallel import make_axes_mesh, make_mesh
    from bitorch_engine_tpu_torch.training import cross_entropy_loss, make_train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    mesh_sp, mesh_dp = make_axes_mesh(sp=PAR), make_mesh(dp=PAR, tp=1)
    mesh_fsdp, mesh_pp = make_mesh(fsdp=PAR, tp=1), make_axes_mesh(pp=PAR)
    mesh_ep = make_axes_mesh(ep=PAR)
    out = dict(rank=rank, probe=probe_train_collectives(torch, mesh_sp))
    # zeros refreshed every step: the fsdp step gathers refreshed zeros too
    hp = DiodeHyperParams(lr=TRAIN_LR, zeros_update_interval=1)

    # the unsharded step, on every rank (the same weights, batch and kernels);
    # the first sp rank also runs the rows witness of the first seed
    batch, ref, out["ref"] = par_ref(torch, hp, PAR_SEED, witness=rank == 0)
    sums = torch.tensor([float(ref["loss"]), sum(float(g.double().sum()) for g in ref["grads"].values())],
                        dtype=torch.float64)
    both = [torch.empty_like(sums) for _ in range(PAR)]
    dist.all_gather(both, sums)
    out["ref_ranks_equal"] = bool(torch.equal(both[0], both[1]))

    # 20a: sequence parallelism, from each seed's weights and batch; the
    # Ulysses step's gradients also against the ring step's (the two differ
    # only in the attention)
    out["sp_attention"] = sp_attention_checks(torch, mesh_sp)
    for seed in PAR_SEEDS:
        tag = "" if seed == PAR_SEED else f"_seed{seed}"
        seed_batch, seed_ref = batch, ref
        if tag:
            seed_batch, seed_ref, out[f"ref{tag}"] = par_ref(torch, hp, seed)
        ring_grads = None
        for kind in ("ring", "ulysses"):
            rec = {}
            model = build_train_model(torch, TRAIN_LAYERS, seed, sequence_parallel=kind,
                                      sp_mesh=mesh_sp)
            grads = par_train_step(torch, rec, seed_ref, model, mesh_sp, [mesh_sp], seed_batch, hp,
                                   against=ring_grads)
            ring_grads = grads if kind == "ring" else None
            rec["expected"] = {k: v for k, v in sp_launches(kind, mesh_sp.coord("sp")).items() if v}
            out[f"sp_{kind}{tag}"] = rec
            del model, grads
            torch.cuda.empty_cache()
        if tag:
            del seed_batch, seed_ref

    # 20b: dp 2 (against the rows witness too), then fsdp 2
    rec = {}
    model = build_train_model(torch, TRAIN_LAYERS, PAR_SEED)
    rows = ref.pop("rows")
    par_train_step(torch, rec, ref, model, mesh_dp, [mesh_dp], batch, hp,
                   against=None if rows is None else rows["grads"])
    if rows is not None:
        rec["against"]["loss_equal"] = rows["loss"] == rec["loss"]
    rec["expected"] = {k: v for k, v in sp_launches("ulysses", 0).items() if v}
    out["dp"] = rec
    del model, rows
    torch.cuda.empty_cache()
    rec = {}
    model = build_train_model(torch, TRAIN_LAYERS, PAR_SEED)
    step = make_train_step(model, par_loss(mesh_fsdp), hp, mesh=mesh_fsdp)
    opt = step.optimizer
    params = dict(model.named_parameters())
    with par_record(torch, rec, [mesh_fsdp]):
        opt.zero_grad()
        loss = par_loss(mesh_fsdp)(model, batch)
        loss.backward()
        rec["loss"] = float(loss)
        rec["grads_equal_unsharded"] = sum(bool(torch.equal(params[n].grad.float(), g))
                                           for n, g in ref["grads"].items())
        for n, g in ref["grads"].items():  # the same gradients as the unsharded step
            params[n].grad.copy_(g)
        zeros = {n: b.clone() for n, b in packed_state(model).items() if n.endswith("zeros")}
        opt.step()
    rec["zeros_refreshed"] = sum(not torch.equal(b, dict(model.named_buffers())[n])
                                 for n, b in zeros.items())
    rec["zeros"] = len(zeros)
    rec["row_gathers_expected"] = 2 * len(opt.mpq) + len(opt.splits) - len(opt.mpq)
    rec["grads"] = len(ref["grads"])
    rec["loss_rel"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
    after = packed_state(model)
    rec["buffers_differing"] = {n: int((b != ref["after"][n]).sum()) for n, b in after.items()
                                if not torch.equal(b, ref["after"][n])}
    rec["buffers"] = len(after)
    moments = opt.state["layer_0.attn.q_proj"]["exp_avg_l"]
    rec["moment_rows"] = [moments.shape[0], model.layer_0.attn.q_proj.qweight.in_features]
    rec["expected"] = {k: v for k, v in sp_launches("ulysses", 0).items() if v}
    out["fsdp"] = rec
    del model, step, opt, params, after, moments, zeros
    torch.cuda.empty_cache()

    # 20c: pp 2
    rec = {}
    model = build_train_model(torch, TRAIN_LAYERS, PAR_SEED)
    with par_record(torch, rec, [mesh_pp]):
        loss = cross_entropy_loss(pipeline_forward(model, batch[0], mesh_pp,
                                                   num_microbatches=PP_MICRO), batch[1])
        loss.backward()
        rec["loss"] = float(loss)
    rec["loss_rel"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
    per = TRAIN_LAYERS // PAR
    mine = [f"layer_{i}." for i in range(mesh_pp.coord("pp") * per, (mesh_pp.coord("pp") + 1) * per)]
    names = [n for n in ref["grads"] if not n.startswith("layer_") or n.startswith(tuple(mine))]
    rels = grad_rels(model, ref["grads"], names)
    rec["worst"] = max(rels, key=rels.get)
    rec["grad_rel"], rec["grads"] = rels[rec["worst"]], len(names)
    rec["others_without_grad"] = all(p.grad is None for n, p in model.named_parameters()
                                     if p.requires_grad and n not in names)
    rec["expected"] = {k: v for k, v in pp_launches().items() if v}
    out["pp"] = rec
    del model, loss
    ref.clear()
    torch.cuda.empty_cache()

    # 20d: ep 2 on Mixtral, 2 layers
    model = build_model(torch, EP_LAYERS, SEED, config="mixtral_8x7b_serving")
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    forced = torch.zeros((BATCH, EP_STEPS + 1), dtype=torch.int64)
    rec = {}
    if rank == 0:
        want, want_toks = tp_serve(torch, model, prompt, EP_STEPS)
        forced.copy_(want_toks.cpu())
    dist.broadcast(forced, src=0)
    forced = forced.cuda()
    shard_llama_params(model, mesh_ep)
    rec["experts_a_layer"] = len(model.layer_0.mlp.experts)
    records = []
    with par_record(torch, rec, [mesh_ep]):
        got, _ = tp_serve(torch, model, prompt, EP_STEPS, mesh=mesh_ep, forced=forced,
                          records=records)
    rec["records"] = records
    rec["expected"] = {"mpq_matmul": EP_LAYERS * (2 + 3 * MOE_EXPERTS // PAR) + 1}
    rec["checksums"] = [float(g.double().sum()) for g in got]
    if rank == 0:
        rec["rel_errs"] = [rel_err(g, w) for g, w in zip(got, want)]
        rec["passes_equal"] = sum(bool(torch.equal(g, w)) for g, w in zip(got, want))
    out["ep"] = rec
    return {"json": json.dumps(out)}


def phase_par(torch):
    """Phase 20: the parallel training slice.  20's kernel rows in this
    process, then the 2-rank world (``par_rank``), spawned with the kernels
    already built, joined under a deadline; its numbers printed per rank
    and sub-phase, then held to their checks."""
    from bitorch_engine_tpu_torch.parallel.comm import CUDA_DIRECT
    from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    rows = phase_par_kernels(torch, flush)
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = [json.loads(str(r["json"])) for r in launch_world(
        "chip_smoke:par_rank", PAR, timeout=PAR_WORLD_TIMEOUT,
        collective_timeout=PAR_COLLECTIVE_TIMEOUT)]
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    fails = []

    def expect(ok, what):
        if not ok:
            fails.append(what)

    def report(key, label):
        for r in ranks:
            rec = r[key]
            busy = f"busy {rec['busy_ms']:.1f} ms, " if "busy_ms" in rec else ""
            log(f"{label} rank {r['rank']}: wall {rec['wall_s']:.2f} s ({TP_LABEL}), {busy}"
                f"peak {rec['peak_gib']:.2f} GiB, launches {rec['launches']} (expected "
                f"{rec.get('expected')}); {comm_text(rec['comm'])}")

    log(f"20 ({TP_LABEL}): world of {PAR} ran {world_s:.1f} s; collectives on CUDA tensors: "
        f"{r0['probe']}")
    for kind in CUDA_DIRECT["gloo"]:
        expect(all(r0["probe"][f"{kind}_{dt}"] == "takes CUDA tensors" for dt in ("float32", "bfloat16")),
               f"20: comm.CUDA_DIRECT names {kind} for gloo, which the probe refused")
    for r in ranks:
        for key in [k for k in r if k.startswith("ref") and isinstance(r[k], dict)]:
            rec = r[key]
            log(f"20 rank {r['rank']} unsharded step ({key}): loss {rec['loss']:.6f}, "
                f"{rec['build_and_step_s']:.1f} s built and stepped; launches {rec['launches']}; "
                f"zeros refreshed in {rec['zeros_refreshed']} buffers")
    expect(r0["ref_ranks_equal"], "20: the two ranks' unsharded steps differ")
    w = r0["ref"]["rows_witness"]
    ring_bar = max(TRAIN_GRAD_REL, SP_RING_WITNESS_FACTOR * w["grad_rel"])
    log(f"20 rows witness (one process, the batch's two row halves, f32 sum) vs the unsharded "
        f"step: loss rel {w['loss_rel']:.3e}, max grad rel {w['grad_rel']:.3e} ({w['worst']}); "
        f"the ring steps' gradient bar max({TRAIN_GRAD_REL}, {SP_RING_WITNESS_FACTOR} x witness) "
        f"= {ring_bar:.3e}")

    for kind in ("ulysses", "ring"):
        for r in ranks:
            a = r["sp_attention"][kind]
            plain = (f", vs its plain version {a['vs_plain_differing']:.2e} of bf16 outputs differing "
                     f"(rel {a['vs_plain_rel']:.3e})" if kind == "ring" else "")
            log(f"20a {kind} attention rank {r['rank']} (8 x 16 heads x 2048, gathered) vs kernel 3 "
                f"on the whole sequence: bit-equal {a['equal']}, {a['differing']:.2e} of bf16 outputs "
                f"differing, rel {a['rel']:.3e}{plain}; {a['launches']} kernel-3 launches")
            log(f"20a {kind} attention rank {r['rank']} gradients vs kernel 4 on the whole sequence: "
                f"bit-equal {a['grads_equal']}, max|d|/max|ref| "
                + ", ".join(f"{nm} {x:.3e}" for nm, x in a["grad_rel"].items()))
            expect(a["close"], f"20a {kind} attention rank {r['rank']}: not within 1e-2 of kernel 3")
            if kind == "ring":
                expect(a["vs_plain_differing"] <= FWD_DIFFERING_MAX,
                       f"20a ring attention rank {r['rank']}: {a['vs_plain_differing']} of outputs "
                       "differ from its plain version")
            else:
                expect(a["differing"] <= FWD_DIFFERING_MAX,
                       f"20a Ulysses attention rank {r['rank']}: {a['differing']} of outputs differ")
    exact = r0["sp_attention"]["kernel_vs_exact"]
    log("20a witness, against the exact f32 attention (max|d|/max|exact|): kernels 3 + 4 on the "
        "whole sequence " + ", ".join(f"{nm} {x:.3e}" for nm, x in exact.items()))
    for kind in ("ulysses", "ring"):
        got = r0["sp_attention"][kind]["vs_exact"]
        log(f"20a witness: {kind} " + ", ".join(
            f"{nm} {x:.3e} ({x / exact[nm]:.2f}x the kernels')" for nm, x in got.items()))
        for nm, x in got.items():
            expect(x <= SP_EXACT_FACTOR * exact[nm],
                   f"20a {kind} attention {nm}: {x} from the exact values, over {SP_EXACT_FACTOR} x "
                   f"kernels 3 + 4's {exact[nm]}")
    steps = [("sp_ring", "20a sp 2 ring"), ("sp_ulysses", "20a sp 2 Ulysses")]
    steps += [(f"{key}_seed{seed}", f"{label}, seed {seed}") for seed in PAR_SEEDS[1:]
              for key, label in list(steps)]
    for key, label in steps + [("dp", "20b dp 2"), ("pp", "20c pp 2")]:
        report(key, label)
        for r in ranks:
            rec = r[key]
            codes = (f"; packed codes differing from the unsharded step's after it "
                     f"{rec['codes_differing']} of {rec['codes_total']}" if "codes_differing" in rec else "")
            log(f"{label} rank {r['rank']}: loss {rec['loss']:.6f} (rel {rec['loss_rel']:.3e}), max grad "
                f"rel {rec['grad_rel']:.3e} ({rec['worst']}){codes}")
            if "against" in rec:
                a = rec["against"]
                what = "the rows witness" if key == "dp" else "the ring step's"
                log(f"{label} rank {r['rank']} gradients vs {what}: {a['equal']} of {a['tensors']} "
                    f"bit-equal, max grad rel {a['grad_rel']:.3e} ({a['worst']})"
                    + (f", loss equal {a['loss_equal']}" if "loss_equal" in a else ""))
            if key == "dp" and r["rank"] == 0:
                a = rec["against"]
                expect(a["equal"] == a["tensors"] and a["loss_equal"],
                       f"20b dp: {a['tensors'] - a['equal']} gradients (worst {a['worst']}, "
                       f"{a['grad_rel']}) or the loss off the rows witness")
            bar = ring_bar if key.startswith("sp_ring") else TRAIN_GRAD_REL
            expect(rec["loss_rel"] <= TRAIN_LOSS_REL, f"{label} rank {r['rank']}: loss rel {rec['loss_rel']}")
            expect(rec["grad_rel"] <= bar,
                   f"{label} rank {r['rank']}: {rec['worst']} grad rel {rec['grad_rel']} > {bar}")
            expect(rec["launches"] == rec["expected"],
                   f"{label} rank {r['rank']}: launches {rec['launches']} != {rec['expected']}")
        if key == "pp":
            expect(all(r["pp"]["others_without_grad"] for r in ranks),
                   "20c: a rank holds gradients of the other stage's blocks")
    report("fsdp", "20b fsdp 2")
    for r in ranks:
        rec = r["fsdp"]
        log(f"20b fsdp 2 rank {r['rank']}: loss {rec['loss']:.6f} (rel {rec['loss_rel']:.3e}); its own "
            f"gradients bit-equal to the unsharded step's: {rec['grads_equal_unsharded']} of "
            f"{rec['grads']}; given those, packed / zeros / scales differing after the step: "
            f"{rec['buffers_differing'] or 'none'} of {rec['buffers']} buffers; moments keep "
            f"{rec['moment_rows'][0]} of {rec['moment_rows'][1]} rows")
        gathers = rec["comm"].get("all_gather", {}).get("calls", 0)
        log(f"20b fsdp 2 rank {r['rank']}: zeros refreshed in {rec['zeros_refreshed']} of "
            f"{rec['zeros']} buffers; {gathers} row all-gathers (expected "
            f"{rec['row_gathers_expected']}: packed words and zeros of each MPQ weight, fp rows)")
        expect(not rec["buffers_differing"], f"20b fsdp rank {r['rank']}: {rec['buffers_differing']}")
        expect(rec["zeros_refreshed"] > 0, f"20b fsdp rank {r['rank']}: no zeros refreshed")
        expect(gathers == rec["row_gathers_expected"],
               f"20b fsdp rank {r['rank']}: {gathers} all-gathers != {rec['row_gathers_expected']}")
        expect(rec["moment_rows"][0] * PAR == rec["moment_rows"][1], "20b fsdp: moments not row-cut")
        expect(rec["launches"] == rec["expected"],
               f"20b fsdp rank {r['rank']}: launches {rec['launches']} != {rec['expected']}")
    report("ep", "20d ep 2")
    ep_pass = counts_with(mpq_matmul=EP_LAYERS * (2 + 3 * MOE_EXPERTS // PAR) + 1)
    ep_prefill = counts_with(dequant_mpq=EP_LAYERS * (2 + 3 * MOE_EXPERTS // PAR) + 1,
                             flash_attention=EP_LAYERS)
    for r in ranks:
        rec = r["ep"]
        recs = rec["records"]
        log(f"20d ep 2 rank {r['rank']}: {rec['experts_a_layer']} experts a layer; prefill launches "
            f"{recs[0]['launches']}, a decode step {recs[1]['launches']}; "
            f"prefill {comm_text(recs[0]['comm'])}")
        expect(rec["experts_a_layer"] == MOE_EXPERTS // PAR, "20d: experts not split")
        expect(recs[0]["launches"] == {k: v for k, v in ep_prefill.items() if v},
               f"20d rank {r['rank']} prefill launches {recs[0]['launches']}")
        for one in recs[1:]:
            expect(one["launches"] == {k: v for k, v in ep_pass.items() if v},
                   f"20d rank {r['rank']} step {one['step']} launches {one['launches']}")
    log(f"20d ep 2 vs unsharded: logits max|d|/max|ref| prefill {r0['ep']['rel_errs'][0]:.3e}, decode "
        f"max {max(r0['ep']['rel_errs'][1:]):.3e}; {r0['ep']['passes_equal']} of {EP_STEPS + 1} passes "
        "bit-equal")
    expect(max(r0["ep"]["rel_errs"]) <= 2e-2, f"20d: ep logits {max(r0['ep']['rel_errs'])} > 2e-2")
    expect(ranks[0]["ep"]["checksums"] == ranks[1]["ep"]["checksums"], "20d: the ranks' logits differ")
    check(not fails, "; ".join(fails))
    summary = dict(label=TP_LABEL, world_s=world_s, probe=r0["probe"],
                   sp_attention=[r["sp_attention"] for r in ranks],
                   **{key: [{k: v for k, v in r[key].items() if k != "records"} for r in ranks]
                      for key in ("ref", "dp", "fsdp", "pp", "ep") + tuple(k for k, _ in steps)
                      + tuple(f"ref_seed{seed}" for seed in PAR_SEEDS[1:])})
    return rows, dict(ranks=ranks, summary=summary)


def phase_tpt_kernels(torch, flush):
    """Phase 21, the parent's part: kernel 2 at one tp rank's 370M
    projections (``TPT_SHAPES``) and kernels 3 and 4 at one tp rank's
    attention (``TPT_FLASH``) against their plain versions, then timed
    (the card to itself)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    rows = {"dequant_mpq": [], "flash_attention": [], "flash_attention_bwd": []}
    for name, (k, n) in TPT_SHAPES.items():
        qt = mpq_weight(torch, gen, k, n, 4)
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        rows["dequant_mpq"].append(mpq_kernel_rows(torch, name, x, qt, flush)[2])
        del qt
    name, b, nh, nkv, s, d, causal = TPT_FLASH
    rows["flash_attention"].append(flash_row(torch, gen, name, b, nh, nkv, s, d, flush, causal))
    rows["flash_attention_bwd"].append(flash_bwd_row(torch, gen, name, b, nh, nkv, s, d, causal,
                                                     flush))
    for name, rs in rows.items():
        for r in rs:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {name:19s} {r['shape']:32s} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    torch.cuda.empty_cache()
    return rows


def split_cols(torch, model):
    """The column half of 21b's witness, in place on the unsharded
    ``model``: q, k, v, gate and up each as its ``TP`` column shards
    (``column_shard``, the cut ``shard_llama_params`` makes: heads, or
    intermediate features), their outputs concatenated, so that the
    backward sums the input's cotangent from the shards' partials as the
    tp ranks' all-reduce does."""
    from bitorch_engine_tpu_torch.models.llama_sharding import column_shard

    class SplitCols(torch.nn.Module):
        def __init__(self, whole, where):
            super().__init__()
            n = whole.qweight.out_features // TP
            self.parts = torch.nn.ModuleList(column_shard(whole, [(i * n, n)], where)
                                             for i in range(TP))

        def forward(self, x):
            return torch.cat([p(x) for p in self.parts], dim=-1)

    for li, layer in enumerate(model.layers):
        for parent, names in ((layer.attn, TPT_COLUMN[:3]), (layer.mlp, TPT_COLUMN[3:])):
            for name in names:
                setattr(parent, name, SplitCols(getattr(parent, name), f"layer_{li}/{name}"))
    return model


def tpt_witness(torch, batch, ref):
    """21b's one-process witness of tp's rounding: the unsharded model from
    ``PAR_SEED``'s weights with both of tp 2's split sums (``split_cols``,
    ``split_rows``), one forward and backward on the batch; its loss and
    its gradients' distance from the unsharded step's (each shard's
    gradient put back in its place)."""
    model = split_rows(torch, split_cols(torch, build_train_model(torch, TRAIN_LAYERS, PAR_SEED)))
    loss = par_loss(None)(model, batch)
    loss.backward()
    grads = {}
    for li, layer in enumerate(model.layers):
        for parent, names in ((layer.attn, ("q_proj", "k_proj", "v_proj", "o_proj")),
                              (layer.mlp, ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                mod = getattr(parent, name)
                dim = 0 if name in TPT_ROW else 1
                where = f"layer_{li}.{'attn' if parent is layer.attn else 'mlp'}.{name}.grad_shadow"
                grads[where] = torch.cat([p.grad_shadow.grad.float() for p in mod.parts], dim=dim)
    for name, p in model.named_parameters():
        if name in ref["grads"] and name not in grads:
            grads[name] = p.grad.float()
    rels = {n: rel_err(g, ref["grads"][n]) for n, g in grads.items()}
    worst = max(rels, key=rels.get)
    out = dict(loss_rel=abs(float(loss.detach()) - ref["loss"]) / abs(ref["loss"]), grad_rel=rels[worst],
               worst=worst, tensors=len(rels), of=len(ref["grads"]))
    del model, loss, grads
    torch.cuda.empty_cache()
    return out


def tp_share(name, t, coord):
    """The part of the unsharded tensor ``name`` (a parameter, grad shadow
    or buffer of the 370M model) that tp rank ``coord`` holds: columns of
    q, k, v, gate and up, rows of o and down (a packed tensor's words, the
    zeros' and scales' groups), the rest whole."""
    proj = name.split(".")[-2] if name.count(".") >= 2 else ""
    if proj in TPT_COLUMN:
        n = t.shape[1] // TP
        return t[:, coord * n : (coord + 1) * n]
    if proj in TPT_ROW:
        k = t.shape[0] // TP
        return t[coord * k : (coord + 1) * k]
    return t


def tpt_rank():
    """One rank of phase 21's two-rank world (the card shared, gloo):

    * 21b: the unsharded 370M step on every rank (``par_ref``) and, on rank
      0, the split-sum witness (``tpt_witness``); then the model cut by
      ``shard_llama_params`` and trained one step by ``make_train_step`` on
      the same tp 2 mesh: its loss, each gradient against the unsharded
      step's share (``tp_share``), the packed codes after the step;
    * 21d: Mixtral-8x7B at 2 layers cut over tp 2 (every expert's gate and
      up by columns, down by rows), prefill 8 × 256 and ``EP_STEPS`` decode
      steps forced to rank 0's unsharded tokens.

    Returns one JSON string (``json``) of its numbers."""
    import torch
    import torch.distributed as dist

    from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.training import make_train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    mesh = make_mesh(tp=TP)
    coord = mesh.coord("tp")
    out = dict(rank=rank)
    hp = DiodeHyperParams(lr=TRAIN_LR, zeros_update_interval=1)

    # 21b: tp 2 against the unsharded step (every rank) and the witness (rank 0)
    batch, ref, out["ref"] = par_ref(torch, hp, PAR_SEED)
    if rank == 0:
        out["witness"] = tpt_witness(torch, batch, ref)
    rec = {}
    model = shard_llama_params(build_train_model(torch, TRAIN_LAYERS, PAR_SEED), mesh)
    step = make_train_step(model, par_loss(mesh), hp, mesh=mesh)
    with par_record(torch, rec, [mesh]):
        rec["loss"] = float(step(batch)["loss"])
    rec["loss_rel"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
    params = dict(model.named_parameters())
    rels = {n: rel_err(params[n].grad.float(), tp_share(n, g, coord))
            for n, g in ref["grads"].items()}
    rec["worst"] = max(rels, key=rels.get)
    rec["grad_rel"], rec["grads"] = rels[rec["worst"]], len(rels)
    after = packed_state(model)
    rec["codes_differing"] = sum(int((b != tp_share(n, ref["after"][n], coord)).sum())
                                 for n, b in after.items() if n.endswith("packed"))
    rec["codes_total"] = sum(b.numel() * 32 // 4 for n, b in after.items() if n.endswith("packed"))
    rec["zeros_max_rel"] = max(rel_err(b.float(), tp_share(n, ref["after"][n], coord).float())
                               for n, b in after.items() if n.endswith("zeros"))
    rec["heads"] = [model.layer_0.attn.n_heads, model.layer_0.attn.n_kv_heads]
    rec["moment_shape"] = list(step.optimizer.state["layer_0.mlp.down_proj"]["exp_avg_l"].shape)
    rec["expected"] = {k: v for k, v in sp_launches("ulysses", 0).items() if v}
    out["tp"] = rec
    del model, step, params, after, ref
    torch.cuda.empty_cache()

    # 21d: Mixtral at tp 2, 2 layers
    model = build_model(torch, EP_LAYERS, SEED, config="mixtral_8x7b_serving")
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    forced = torch.zeros((BATCH, EP_STEPS + 1), dtype=torch.int64)
    rec = {}
    if rank == 0:
        want, want_toks = tp_serve(torch, model, prompt, EP_STEPS)
        forced.copy_(want_toks.cpu())
    dist.broadcast(forced, src=0)
    forced = forced.cuda()
    shard_llama_params(model, mesh)
    expert = model.layer_0.mlp.experts[0]
    rec["expert_shapes"] = [list(getattr(expert, p).qweight.logical_shape)
                            for p in ("gate", "up", "down")]
    records = []
    with par_record(torch, rec, [mesh]):
        got, _ = tp_serve(torch, model, prompt, EP_STEPS, mesh=mesh, forced=forced,
                          records=records)
    rec["records"] = records
    rec["checksums"] = [float(g.double().sum()) for g in got]
    if rank == 0:
        rec["rel_errs"] = [rel_err(g, w) for g, w in zip(got, want)]
        rec["passes_equal"] = sum(bool(torch.equal(g, w)) for g, w in zip(got, want))
    out["moe"] = rec
    return {"json": json.dumps(out)}


def tpt_fsdp_rank():
    """One rank of phase 21c's four-rank world (the card shared, gloo): the
    370M width at ``TPT_FSDP_LAYERS`` layers cut over the tp axis of one
    fsdp 2 × tp 2 mesh, one step on the whole batch with the zeros
    refreshed, twice from the same weights: tp 2 alone (``make_train_step``
    without a mesh: every moment on its rank) and fsdp 2 × tp 2 (each fsdp
    rank's share of its tp shard's moments).  Every packed code, zero and
    parameter after the step compared."""
    import torch

    from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.training import make_train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(fsdp=2, tp=TP)
    hp = DiodeHyperParams(lr=TRAIN_LR, zeros_update_interval=1)
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    toks = torch.randint(0, 32000, (TRAIN_BATCH, TRAIN_SEQ + 1), device="cuda", generator=gen)
    batch = (toks[:, :-1].contiguous(), toks[:, 1:].contiguous())
    out, states = dict(rank=mesh.rank, coords=[mesh.coord("fsdp"), mesh.coord("tp")]), {}
    for key, step_mesh in (("tp", None), ("fsdp_tp", mesh)):
        model = shard_llama_params(build_train_model(torch, TPT_FSDP_LAYERS, PAR_SEED), mesh)
        zeros = {n: b.clone() for n, b in model.named_buffers() if n.endswith("zeros")}
        step = make_train_step(model, par_loss(mesh), hp, mesh=step_mesh)
        rec = {}
        with par_record(torch, rec, [mesh], profiled=False):
            rec["loss"] = float(step(batch)["loss"])
        bufs = dict(model.named_buffers())
        rec["zeros_refreshed"] = sum(not torch.equal(b, bufs[n]) for n, b in zeros.items())
        rec["splits"] = {n: list(s) for n, s in step.optimizer.splits.items()
                         if n.startswith("layer_0.")}
        states[key] = {n: t.detach().clone() for n, t in
                       list(model.named_buffers()) + list(model.named_parameters())
                       if not n.endswith("grad_shadow")}
        out[key] = rec
        del model, step, zeros, bufs
        torch.cuda.empty_cache()
    a, b = states["tp"], states["fsdp_tp"]
    out["tensors"] = len(a)
    out["differing"] = {n: int((a[n] != b[n]).sum()) for n in a if not torch.equal(a[n], b[n])}
    out["codes"] = sum(t.numel() * 32 // 4 for n, t in a.items() if n.endswith("packed"))
    return {"json": json.dumps(out)}


def phase_tpt(torch):
    """Phase 21: tp inside the train step.  21a's kernel rows in this
    process; then 21b + 21d in a two-rank world (``tpt_rank``) and 21c in a
    four-rank world (``tpt_fsdp_rank``), each spawned with the kernels
    already built and joined under its deadline; their numbers printed per
    rank, then held to their checks."""
    from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    rows = phase_tpt_kernels(torch, flush)
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = [json.loads(str(r["json"])) for r in launch_world(
        "chip_smoke:tpt_rank", TP, timeout=TPT_WORLD_TIMEOUT,
        collective_timeout=TPT_COLLECTIVE_TIMEOUT)]
    world_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsdp_ranks = [json.loads(str(r["json"])) for r in launch_world(
        "chip_smoke:tpt_fsdp_rank", 2 * TP, timeout=TPT_FSDP_WORLD_TIMEOUT,
        collective_timeout=TPT_COLLECTIVE_TIMEOUT)]
    fsdp_world_s = time.perf_counter() - t0
    r0 = ranks[0]
    fails = []

    def expect(ok, what):
        if not ok:
            fails.append(what)

    log(f"21 ({TP_LABEL}): world of {TP} ran {world_s:.1f} s; world of {2 * TP} (fsdp 2 x tp 2, "
        f"{TPT_FSDP_LAYERS} layers) ran {fsdp_world_s:.1f} s")
    for r in ranks:
        rec = r["ref"]
        log(f"21 rank {r['rank']} unsharded step: loss {rec['loss']:.6f}, "
            f"{rec['build_and_step_s']:.1f} s built and stepped; launches {rec['launches']}")
    w = r0["witness"]
    bar = max(TRAIN_GRAD_REL, TPT_WITNESS_FACTOR * w["grad_rel"])
    log(f"21b witness (one process, tp 2's column and row split sums) vs the unsharded step: loss "
        f"rel {w['loss_rel']:.3e}, max grad rel {w['grad_rel']:.3e} ({w['worst']}, {w['tensors']} "
        f"of {w['of']} tensors); the tp step's gradient bar max({TRAIN_GRAD_REL}, "
        f"{TPT_WITNESS_FACTOR} x witness) = {bar:.3e}")
    expect(w["tensors"] == w["of"], "21b witness: a gradient missing")
    for r in ranks:
        rec = r["tp"]
        log(f"21b tp 2 rank {r['rank']}: wall {rec['wall_s']:.2f} s ({TP_LABEL}), busy "
            f"{rec['busy_ms']:.1f} ms, peak {rec['peak_gib']:.2f} GiB, launches {rec['launches']} "
            f"(expected {rec['expected']}); {comm_text(rec['comm'])}")
        log(f"21b tp 2 rank {r['rank']}: {rec['heads'][0]} query / {rec['heads'][1]} KV heads; loss "
            f"{rec['loss']:.6f} (rel {rec['loss_rel']:.3e}), max grad rel {rec['grad_rel']:.3e} "
            f"({rec['worst']}, {rec['grads']} tensors, each against its share of the unsharded "
            f"step's); packed codes differing from the unsharded step's share after it "
            f"{rec['codes_differing']} of {rec['codes_total']}; zeros max rel "
            f"{rec['zeros_max_rel']:.3e}; down_proj moments {rec['moment_shape']}")
        expect(rec["loss_rel"] <= TRAIN_LOSS_REL, f"21b rank {r['rank']}: loss rel {rec['loss_rel']}")
        expect(rec["grad_rel"] <= bar,
               f"21b rank {r['rank']}: {rec['worst']} grad rel {rec['grad_rel']} > {bar}")
        expect(rec["launches"] == rec["expected"],
               f"21b rank {r['rank']}: launches {rec['launches']} != {rec['expected']}")
        expect(rec["heads"] == [16 // TP, 16 // TP], f"21b rank {r['rank']}: heads {rec['heads']}")
    f0 = fsdp_ranks[0]
    for r in fsdp_ranks:
        for key, label in (("tp", "tp 2 alone"), ("fsdp_tp", "fsdp 2 x tp 2")):
            rec = r[key]
            log(f"21c {label} rank {r['rank']} (fsdp {r['coords'][0]}, tp {r['coords'][1]}): wall "
                f"{rec['wall_s']:.2f} s, peak {rec['peak_gib']:.2f} GiB, loss {rec['loss']:.6f}, "
                f"launches {rec['launches']}, zeros refreshed in {rec['zeros_refreshed']} buffers; "
                f"{comm_text(rec['comm'])}")
        log(f"21c rank {r['rank']}: layer 0's fsdp shares {r['fsdp_tp']['splits']}; after the step "
            f"{len(r['differing'])} of {r['tensors']} tensors differ from tp 2 alone "
            f"({r['differing'] or 'none'}; {r['codes']} codes)")
        expect(not r["differing"], f"21c rank {r['rank']}: {r['differing']}")
        expect(r["fsdp_tp"]["loss"] == r["tp"]["loss"], f"21c rank {r['rank']}: losses differ")
        expect(r["fsdp_tp"]["zeros_refreshed"] > 0, f"21c rank {r['rank']}: no zeros refreshed")
        expect(r["fsdp_tp"]["splits"].get("layer_0.mlp.down_proj", [None])[0] == 1,
               f"21c rank {r['rank']}: down_proj's share is not its columns")
        want = counts_with(dequant_mpq=4 * TRAIN_PROJ * TPT_FSDP_LAYERS,
                           flash_attention=2 * TPT_FSDP_LAYERS,
                           flash_attention_bwd=2 * TPT_FSDP_LAYERS)
        for key in ("tp", "fsdp_tp"):
            expect(r[key]["launches"] == {k: v for k, v in want.items() if v},
                   f"21c {key} rank {r['rank']}: launches {r[key]['launches']}")
    pass_n = EP_LAYERS * (2 + 3 * MOE_EXPERTS) + 1
    moe_step = counts_with(mpq_matmul=pass_n)
    moe_prefill = counts_with(dequant_mpq=pass_n, flash_attention=EP_LAYERS)
    for r in ranks:
        rec = r["moe"]
        recs = rec["records"]
        log(f"21d Mixtral tp 2 rank {r['rank']}: expert shards (gate, up, down) "
            f"{rec['expert_shapes']}; prefill launches {recs[0]['launches']}, a decode step "
            f"{recs[1]['launches']}; prefill {comm_text(recs[0]['comm'])}; a decode step "
            f"{comm_text(recs[1]['comm'])}; peak {rec['peak_gib']:.2f} GiB")
        expect(recs[0]["launches"] == {k: v for k, v in moe_prefill.items() if v},
               f"21d rank {r['rank']} prefill launches {recs[0]['launches']}")
        for one in recs[1:]:
            expect(one["launches"] == {k: v for k, v in moe_step.items() if v},
                   f"21d rank {r['rank']} step {one['step']} launches {one['launches']}")
    log(f"21d Mixtral tp 2 vs unsharded: logits max|d|/max|ref| prefill "
        f"{r0['moe']['rel_errs'][0]:.3e}, decode max {max(r0['moe']['rel_errs'][1:]):.3e}; "
        f"{r0['moe']['passes_equal']} of {EP_STEPS + 1} passes bit-equal")
    expect(max(r0["moe"]["rel_errs"]) <= 2e-2,
           f"21d: tp logits {max(r0['moe']['rel_errs'])} > 2e-2")
    expect(ranks[0]["moe"]["checksums"] == ranks[1]["moe"]["checksums"],
           "21d: the ranks' logits differ")
    check(not fails, "; ".join(fails))
    summary = dict(label=TP_LABEL, world_s=world_s, fsdp_world_s=fsdp_world_s, witness=w, bar=bar,
                   ref=[r["ref"] for r in ranks], tp=[r["tp"] for r in ranks],
                   fsdp=fsdp_ranks, moe=[{k: v for k, v in r["moe"].items()} for r in ranks],
                   fsdp_layers=TPT_FSDP_LAYERS, f0_tensors=f0["tensors"])
    return rows, dict(ranks=ranks, summary=summary)


# ---------------------------------------------------------------------------
# Phase 22: the entry points (the native packers, the CLI, the twins of
# examples/ and the perplexity-gate tool)
# ---------------------------------------------------------------------------


def traced_launches(table) -> dict:
    """Launches per kernel wrapper read from a trace table
    (``utils.profiling.device_op_table``), by the device kernels each
    wrapper launches (:data:`ENTRY_DEVICE_KERNELS`)."""
    import re

    return {name: sum(row["count"] for row in table
                      if any(re.search(rf"\b{k}\b", row["key"]) for k in kernels))
            for name, kernels in ENTRY_DEVICE_KERNELS.items()}


def counted_launches(counts) -> dict:
    """The port's launch counters in :func:`traced_launches`' terms (kernel
    6's two forms as one)."""
    out = {name: counts[name] for name in ENTRY_DEVICE_KERNELS if name in counts}
    out["paged_attention"] = (counts["paged_prefix_attention"]
                              + counts["paged_prefix_attention_update"])
    return out


@contextmanager
def quiet():
    """The twins' own printing (8 rows of ids, every step) into a buffer."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        yield buf


@contextmanager
def traced_run(torch, tmp, name):
    """Around one run: the launch counters from 0 and ``utils.profiling
    .trace`` into ``<tmp>/<name>``; fills ``out`` with the seconds, the
    counted and the traced launches after it."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.utils import profiling

    logdir = str(pathlib.Path(tmp) / name)
    out = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        yield out
    out["seconds"] = time.perf_counter() - t0
    out["counted"] = counted_launches(launch_counts())
    t0 = time.perf_counter()
    table = profiling.device_op_table(logdir, top=None)
    out["traced"] = traced_launches(table)
    out["trace_read_s"] = time.perf_counter() - t0
    out["trace_mib"] = sum(p.stat().st_size for p in pathlib.Path(logdir).rglob("*")) / 2**20
    out["device_kernels"] = len(table)


def check_traced(what, run, launched):
    """Every kernel's launches read from the trace equal its counter; those
    in ``launched`` ran."""
    log(f"{what}: launches counted {run['counted']}, read from the trace {run['traced']} "
        f"({run['trace_mib']:.1f} MiB trace read in {run['trace_read_s']:.1f} s)")
    for name in launched:
        check(run["counted"][name] > 0, f"{what}: kernel {name} was not launched")
    for name, n in run["counted"].items():
        check(run["traced"][name] == n,
              f"{what}: the trace holds {run['traced'][name]} launches of {name}, the counter {n}")


def phase_entry_native(torch):
    """22a: the host bitpack library at a full-width 8B projection, bit for
    bit against the port's torch packing ops (on the card), each timed."""
    import numpy as np

    from bitorch_engine_tpu_torch import native
    from bitorch_engine_tpu_torch.ops import packing

    t0 = time.perf_counter()
    check(native.available(), "native: the bitpack library did not build or load")
    out = {"build_s": time.perf_counter() - t0, "shape": list(NATIVE_SHAPE)}
    rng = np.random.default_rng(SEED + 22)
    k, n = NATIVE_SHAPE

    def host(fn):
        t0 = time.perf_counter()
        r = fn()
        return r, (time.perf_counter() - t0) * 1e3

    def card(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    for w_bit in NATIVE_BITS:
        codes = rng.integers(0, 2**w_bit, (k, n), dtype=np.uint8)
        codes_t = torch.from_numpy(codes).to("cuda", torch.int32)
        packing.unpack_rows(packing.pack_rows(codes_t, w_bit), w_bit)  # warm-up
        packed, pack_ms = host(lambda: native.pack_gptq_codes(codes, w_bit))
        want, torch_pack_ms = card(lambda: packing.pack_rows(codes_t, w_bit))
        check(np.array_equal(packed, want.cpu().numpy()), f"native: pack_gptq_codes w{w_bit}")
        unpacked, unpack_ms = host(lambda: native.unpack_gptq_codes(packed, w_bit))
        packed_t = torch.from_numpy(packed).cuda()
        back, torch_unpack_ms = card(lambda: packing.unpack_rows(packed_t, w_bit))
        check(np.array_equal(unpacked, codes) and np.array_equal(back.cpu().numpy(), codes),
              f"native: unpack_gptq_codes w{w_bit}")
        out[f"w{w_bit}"] = dict(pack_ms=pack_ms, torch_pack_ms=torch_pack_ms, unpack_ms=unpack_ms,
                                torch_unpack_ms=torch_unpack_ms)
        del codes_t, packed_t, want, back
    x = rng.standard_normal((k, n), dtype=np.float32)
    x_t = torch.from_numpy(x).cuda()
    packing.pack_signs(x_t)
    signs, signs_ms = host(lambda: native.pack_signs(x))
    want, torch_signs_ms = card(lambda: packing.pack_signs(x_t))
    check(np.array_equal(signs.view(np.int32), want.cpu().numpy()), "native: pack_signs")
    out["signs"] = dict(pack_ms=signs_ms, torch_pack_ms=torch_signs_ms)
    for key in [f"w{b}" for b in NATIVE_BITS]:
        r = out[key]
        log(f"22a native {key} at {k} x {n}: pack {r['pack_ms']:.2f} ms (torch on the card "
            f"{r['torch_pack_ms']:.2f}), unpack {r['unpack_ms']:.2f} ms (torch "
            f"{r['torch_unpack_ms']:.2f}); bit-equal")
    log(f"22a native pack_signs at {k} x {n}: {signs_ms:.2f} ms (torch on the card "
        f"{torch_signs_ms:.2f}); bit-equal")
    return out


def write_fp_export(torch, path, layers, seed):
    """A seeded fp bf16 HF-layout Llama-3-8B (embedding, untied head, norms,
    ``layers`` unfused blocks at full width) through the port's writer;
    returns its GiB."""
    from bitorch_engine_tpu_torch.models.llama import llama3_8b
    from bitorch_engine_tpu_torch.utils.ingest import save_safetensors

    cfg = llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, hd = cfg.hidden_size, cfg.head_dim

    def rand(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16).cpu()

    t = {"model.embed_tokens.weight": rand(cfg.vocab_size, d),
         "lm_head.weight": rand(cfg.vocab_size, d),
         "model.norm.weight": torch.ones(d, dtype=torch.bfloat16)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = (1 + rand(d, scale=0.1).float()).to(torch.bfloat16)
        t[p + "post_attention_layernorm.weight"] = torch.ones(d, dtype=torch.bfloat16)
        for name, (o, k) in {
            "self_attn.q_proj": (cfg.num_heads * hd, d),
            "self_attn.k_proj": (cfg.num_kv_heads * hd, d),
            "self_attn.v_proj": (cfg.num_kv_heads * hd, d),
            "self_attn.o_proj": (d, cfg.num_heads * hd),
            "mlp.gate_proj": (cfg.intermediate_size, d),
            "mlp.up_proj": (cfg.intermediate_size, d),
            "mlp.down_proj": (d, cfg.intermediate_size),
        }.items():
            t[p + name + ".weight"] = rand(o, k)
    save_safetensors(path, t)
    return sum(v.numel() * v.element_size() for v in t.values()) / 2**30


def phase_entry_cli(torch, tmp):
    """22b: the seeded 2-layer export quantized by ``tools.cli`` on the card;
    one layer's tensors quantized on the CPU equal it bit for bit;
    ``inspect`` lists every tensor."""
    from bitorch_engine_tpu_torch.tools import cli
    from bitorch_engine_tpu_torch.utils.ingest import load_safetensors, save_safetensors

    fp, q = str(pathlib.Path(tmp) / "fp.safetensors"), str(pathlib.Path(tmp) / "q.safetensors")
    t0 = time.perf_counter()
    gib = write_fp_export(torch, fp, ENTRY_LAYERS, SEED + 22)
    out = dict(layers=ENTRY_LAYERS, fp_gib=gib, write_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with quiet() as buf:
        check(cli.main(["quantize", "--input", fp, "--output", q]) == 0, "cli quantize on the card")
    out["quantize_cuda_s"] = time.perf_counter() - t0
    out["quantized_gib"] = pathlib.Path(q).stat().st_size / 2**30
    log(f"22b cli: {buf.getvalue().strip()}")
    # one layer on the CPU
    layer = {k: v for k, v in load_safetensors(fp).items() if k.startswith("model.layers.0.")}
    fp1, q1 = str(pathlib.Path(tmp) / "fp1.safetensors"), str(pathlib.Path(tmp) / "q1.safetensors")
    save_safetensors(fp1, layer)
    t0 = time.perf_counter()
    with quiet():
        check(cli.main(["quantize", "--input", fp1, "--output", q1, "--device", "cpu"]) == 0,
              "cli quantize on the CPU")
    out["quantize_cpu_one_layer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with quiet():
        check(cli.main(["quantize", "--input", fp1, "--output", q1 + ".cuda"]) == 0,
              "cli quantize of one layer on the card")
    out["quantize_cuda_one_layer_s"] = time.perf_counter() - t0
    got, want = load_safetensors(q), load_safetensors(q1)
    for name, w in want.items():
        g = got[name]
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
              f"cli: {name} from the card differs from the CPU's")
    out["cpu_equal_tensors"] = len(want)
    with quiet() as buf:
        check(cli.main(["inspect", "--input", q]) == 0, "cli inspect")
    lines = buf.getvalue().splitlines()
    check(len(lines) == len(got) + 1 and [ln.split()[0] for ln in lines[:-1]] == sorted(got),
          "cli inspect does not list every tensor")
    out["tensors"] = len(got)
    log(f"22b cli: wrote the fp export ({gib:.2f} GiB, {ENTRY_LAYERS} layers) in "
        f"{out['write_s']:.1f} s; quantized on the card in {out['quantize_cuda_s']:.1f} s "
        f"({out['quantized_gib']:.2f} GiB, {len(got)} tensors); one layer on the CPU "
        f"{out['quantize_cpu_one_layer_s']:.1f} s, on the card "
        f"{out['quantize_cuda_one_layer_s']:.1f} s, {len(want)} tensors bit-equal; inspect "
        f"lists {len(lines) - 1} tensors, '{lines[-1]}'")
    return fp, out


def phase_entry_generate(torch, fp, tmp):
    """22c: the quantize-and-generate twin on 22b's export (its config cut
    to the export's depth), traced; then the same model's prefill logits
    against the plain path and its ids against an in-process ``generate``."""
    import numpy as np

    from bitorch_engine_tpu_torch.models import llama
    from bitorch_engine_tpu_torch.models.generate import generate
    from bitorch_engine_tpu_torch.models.llama import init_kv_caches, prefill
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from examples_torch.llm import quantize_and_generate as qg

    rng = np.random.default_rng(SEED + 23)
    rows = rng.integers(0, 128256, (BATCH, PROMPT))
    argv = ["--checkpoint", fp, "--config", "llama3-8b", "--int8-kv", "--int8-embed",
            "--head-bits", "4", "--max-new-tokens", str(DECODE_STEPS),
            "--prompt-ids", ";".join(",".join(str(t) for t in r) for r in rows)]
    full = llama.llama3_8b
    with mock.patch.object(llama, "llama3_8b", lambda **kw: full(num_layers=ENTRY_LAYERS, **kw)):
        with traced_run(torch, tmp, "generate") as run, quiet() as buf:
            ids = qg.main(argv)
        # generate reads the whole cache at prefill, as the JAX package's
        # does (models/generate.py): kernel 3 is not on its path
        check_traced("22c quantize_and_generate", run, ("mpq_matmul", "dequant_mpq"))
        check(run["counted"] == dict(mpq_matmul=15 * (DECODE_STEPS - 1), dequant_mpq=15,
                                     flash_attention=0, paged_attention=0),
              "22c: launches are not 15 kernel-2 a prefill and 15 kernel-1 a decode step")
        printed = buf.getvalue().splitlines()
        check(len(printed) == BATCH and printed[0] == f"generated ids: {ids[0].tolist()}",
              "22c: the twin's printed ids")
        model, prompt, _ = qg.build(argv)
    check(ids.shape == (BATCH, PROMPT + DECODE_STEPS)
          and np.array_equal(ids[:, :PROMPT], rows), "22c: ids shape / prompt")
    cfg = model.cfg
    check(cfg.num_layers == ENTRY_LAYERS and cfg.hidden_size == 4096
          and cfg.vocab_size == 128256, "22c: the model is not the 8B at the export's depth")
    want_ids = generate(model, prompt, max_new_tokens=DECODE_STEPS).cpu().numpy()
    check(np.array_equal(ids, want_ids), "22c: the twin's ids differ from an in-process generate")

    def last_logits():
        caches = init_kv_caches(cfg, BATCH, PROMPT, device="cuda")
        with torch.no_grad():
            logits, _ = prefill(model, prompt, caches)
        return logits[:, -1].float()

    got = last_logits()
    reset_launch_counts()
    with plain_kernels():
        want = last_logits()
    check(all(v == 0 for v in launch_counts().values()), "22c: the plain path launched a kernel")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(bool(torch.isfinite(got).all()) and rel <= 2e-2,
          f"22c: prefill logits {rel} from the plain path (> 2e-2)")
    out = dict(run, rel_err=rel, ids_equal=True, first_ids=ids[0, PROMPT:PROMPT + 8].tolist())
    log(f"22c quantize_and_generate ({ENTRY_LAYERS}-layer 8B export, b{BATCH}, prompt {PROMPT}, "
        f"{DECODE_STEPS} new tokens, int8 KV and embedding, w4 head): {run['seconds']:.1f} s "
        f"traced (load + generate), ids equal to generate(); prefill logits {rel:.3e} from the "
        f"plain path")
    del model
    torch.cuda.empty_cache()
    return out


def phase_entry_serve(torch, tmp):
    """22d: the serve twin at full width and depth (Llama-3-8B, paged KV of
    64, prefill chunks of 256, 8 slots, 8 seeded requests of 4-512 prompt
    tokens): one run timed (req/s, tok/s, time to first token), one
    traced."""
    import numpy as np

    from bitorch_engine_tpu_torch.models.generate import ContinuousBatcher
    from examples_torch.llm import serve as sv

    argv = ["--model", "llama3_8b", "--page-size", "64", "--prefill-chunk", "256"]
    for key, v in ENTRY_SERVE.items():
        argv += ["--" + key.replace("_", "-"), str(v)]
    first, start = {}, {}
    run_, admit_ = ContinuousBatcher.run, ContinuousBatcher._admit

    def run(self):
        start["t"] = time.perf_counter()
        return run_(self)

    def admit(self):
        pending = list(self.queue)
        admit_(self)  # ends in a host read of the first tokens
        now = time.perf_counter()
        for r in pending:
            if r.generated and r.uid not in first:
                first[r.uid] = now - start["t"]

    t0 = time.perf_counter()
    with mock.patch.object(ContinuousBatcher, "run", run), \
            mock.patch.object(ContinuousBatcher, "_admit", admit), quiet() as buf:
        timed = sv.main(argv)
    timed_s = time.perf_counter() - t0
    n_req = ENTRY_SERVE["requests"]
    gen = timed["generated"]
    check(gen.shape == (n_req, ENTRY_SERVE["new_tokens"]) and (gen >= 0).all()
          and (gen < 128256).all(), f"22d: generated ids {gen.shape}")
    check(len(first) == n_req, f"22d: {len(first)} of {n_req} requests got a first token")
    ttft = sorted(first.values())
    out = dict(ENTRY_SERVE, seconds=timed["seconds"], requests_per_s=n_req / timed["seconds"],
               generated_tok_s=timed["tok_s"], ttft_median_ms=statistics.median(ttft) * 1e3,
               ttft_max_ms=ttft[-1] * 1e3, twin_s=timed_s, printed=buf.getvalue().splitlines()[0])
    with traced_run(torch, tmp, "serve") as traced, quiet():
        again = sv.main(argv)
    check(np.array_equal(again["generated"], gen), "22d: the traced run's ids differ")
    check_traced("22d serve", traced, ("mpq_matmul", "dequant_mpq", "flash_attention",
                                        "paged_attention"))
    out["traced"] = traced
    log(f"22d serve (llama3_8b, 32 layers, {n_req} requests of 4-{ENTRY_SERVE['prompt_len']} "
        f"prompt tokens, {ENTRY_SERVE['slots']} slots, pages of 64, chunks of 256): "
        f"{out['requests_per_s']:.3f} req/s, {out['generated_tok_s']:.1f} "
        f"generated tok/s, median time to first token {out['ttft_median_ms']:.1f} ms (max "
        f"{out['ttft_max_ms']:.1f}); the twin with its build {timed_s:.1f} s; traced run "
        f"{traced['seconds']:.1f} s, ids equal")
    return out


def phase_entry_small(torch):
    """22e: the small twins at their defaults (synthetic data: no sklearn on
    this machine), the fine-tune twin unsharded and at tp 2 over two ranks
    sharing the card (gloo: a correctness run), the perplexity-gate tool at
    its smallest settings."""
    import numpy as np

    from bitorch_engine_tpu_torch.tools import ppl_gate
    from examples_torch.cifar import train_cifar
    from examples_torch.llm import finetune
    from examples_torch.mnist import train_lightning_style, train_mnist

    out = {}

    def timed(name, fn):
        """``fn()``'s result (a dict; an array of losses as ``losses``) with
        its seconds and last printed line, kept as ``out[name]``."""
        t0 = time.perf_counter()
        with quiet() as buf:
            r = fn()
        r = r if isinstance(r, dict) else {"losses": np.asarray(r).tolist()}
        r.update(seconds=time.perf_counter() - t0, last_line=buf.getvalue().splitlines()[-1])
        log(f"22e {name}: {r['last_line']} ({r['seconds']:.1f} s)")
        out[name] = r
        return r

    m = timed("train_mnist", lambda: train_mnist.main([]))
    check(np.isfinite(m["loss"]) and m["test_acc"] > 0.5, f"22e train_mnist: {m}")
    with tempfile.TemporaryDirectory() as run_dir:
        lt = timed("train_lightning_style", lambda: train_lightning_style.main(["--out", run_dir]))
        check((pathlib.Path(run_dir) / "metrics.csv" / "metrics.csv").exists()
              and (pathlib.Path(run_dir) / "metrics.jsonl" / "metrics.jsonl").exists(),
              "22e train_lightning_style: no logs")
    check(lt["reload_max_abs_diff"] == 0.0 and lt["reload_tensors"] == 9,
          f"22e train_lightning_style: the reloaded checkpoint differs {lt}")
    c = timed("train_cifar", lambda: train_cifar.main([]))
    check(np.isfinite(c["loss"]), f"22e train_cifar: {c}")
    steps = str(ENTRY_FINETUNE_STEPS)
    one = np.asarray(timed("finetune", lambda: finetune.main(["--steps", steps]))["losses"])
    two = np.asarray(timed("finetune_tp2", lambda: finetune.main(["--steps", steps, "--mesh",
                                                                   "1,2"]))["losses"])
    rel = np.abs(two - one) / np.abs(one)
    out["finetune_tp2"]["loss_rel"] = rel.tolist()
    log(f"22e finetune: losses {np.round(one, 5).tolist()}; tp 2 ({TP_LABEL}) "
        f"{np.round(two, 5).tolist()}, max rel {rel.max():.3e}")
    check(np.isfinite(one).all() and one[-1] < one[0], f"22e finetune: the loss does not fall {one}")
    check(two[-1] < two[0] and rel.max() <= TRAIN_LOSS_REL,
          f"22e finetune tp 2: loss rel {rel.max()} > {TRAIN_LOSS_REL}")
    with quiet() as buf:
        t0 = time.perf_counter()
        gate = ppl_gate.main(["--hidden", "128", "--layers", "1", "--steps", "1"])
        gate_s = time.perf_counter() - t0
    text = buf.getvalue()
    failed = ppl_gate.failures(gate)
    verdict = text.splitlines()[-1]
    check(json.loads(text[: text.rindex("}") + 1]) == gate
          and verdict.startswith("PPL GATE FAILED" if failed else "PPL GATE PASSED"),
          "22e ppl_gate: its JSON or verdict")
    out["ppl_gate"] = dict(seconds=gate_s, verdict=verdict, rel_delta_w4g64=gate["rel_delta_w4g64"],
                           ppl_fp=gate["ppl_fp"])
    log(f"22e ppl_gate (hidden 128, 1 layer, 1 step): {verdict} ({gate_s:.1f} s)")
    return out


def phase_entry(torch):
    """Phase 22: 22a-22e, the export in a temporary directory removed at
    its end."""
    t_start = time.perf_counter()
    out = {"native": phase_entry_native(torch)}
    with tempfile.TemporaryDirectory() as tmp:
        fp, out["cli"] = phase_entry_cli(torch, tmp)
        out["generate"] = phase_entry_generate(torch, fp, tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["serve"] = phase_entry_serve(torch, tmp)
    torch.cuda.empty_cache()
    out["small"] = phase_entry_small(torch)
    out["seconds"] = time.perf_counter() - t_start
    log(f"22: the entry points ran {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 23: fine-tune a GPTQ-format checkpoint (asym act-order MPQ weights
# through kernels 1-4 and DiodeMix, alone, under fsdp and under tp), and the
# timing helpers of utils/benchmark.py
# ---------------------------------------------------------------------------


def ft_config(torch, layers):
    """The fine-tune's training configuration: Llama-3-8B at full width,
    cut to ``layers``, asym projections loaded unfused (act-order), a bf16
    embedding tied to the head, remat."""
    from bitorch_engine_tpu_torch.models.llama import llama3_8b

    return llama3_8b(num_layers=layers, asym=True, quantize_embed=False, head_w_bit=None,
                     fuse_qkv=False, fuse_gate_up=False, dtype=torch.bfloat16, remat=True)


def load_ft_model(torch, path, layers):
    """The GPTQ export at ``path`` loaded into :func:`ft_config` on the card,
    prepared for training."""
    from bitorch_engine_tpu_torch.models.llama_loader import load_llama_from_safetensors
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    return prepare_for_training(load_llama_from_safetensors(path, ft_config(torch, layers), torch.bfloat16,
                                                            device="cuda"))


def ft_projections(model):
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear

    return [(n, m) for n, m in model.named_modules() if isinstance(m, MPQLinear)]


def ft_counts():
    """The launch counters, the act-order routes and DiodeMix's MPQ
    reconstruction routes."""
    from bitorch_engine_tpu_torch.optim.diode import update_counts

    return {**ckpt_counts(), **{f"diode_{k}": v for k, v in update_counts.items()}}


def reset_ft_counts():
    from bitorch_engine_tpu_torch.optim.diode import update_counts

    reset_ckpt_counts()
    for key in update_counts:
        update_counts[key] = 0


def asym_tensor(torch, gen, perm_gen, k, n):
    """A GPTQ export's projection (``gptq_projection``: w4 g128 asym, an
    act-order ``g_idx``) ingested as the loader ingests it: asym, f32
    scales, ``q_perm``."""
    from bitorch_engine_tpu_torch.utils.ingest import mpq_from_gptq

    p = gptq_projection(torch, gen, perm_gen, k, n, centered=True)
    return mpq_from_gptq(p["qweight"], p["qzeros"], p["scales"], p["g_idx"], device="cuda")


def phase_ft_kernels(torch, flush):
    """Phase 23a: kernels 1 (m 1 / 8 / 64) and 2 through ``mpq_linear``'s
    card routes on asym act-order tensors at the 8B projection shapes,
    each against its plain version (kernel 1 on the same rewritten tensor,
    f32 within ``FT_KERNEL1_REL``; kernel 2 bit-equal in every zero form,
    bf16 and f32, on the asym tensor and on it in kernel form) and against
    the plain asym ``s·(q − z)`` (f32, pre-cast, within ``ASYM_PLAIN_REL``;
    kernel 2's exact form, DiodeMix's, bit-equal to it); the asym route
    (kernel 1's rewrite and gather included) timed beside the sym route on
    the same tensor already in kernel form, kernel 2's exact f32 form
    beside the plain ``dequantize_mpq`` it replaced in DiodeMix; kernels 3
    and 4 at the fine-tune's attention shape."""
    from bitorch_engine_tpu_torch.ops import mpq_linear as ml
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import (
        dequant_mpq, dequant_mpq_ref, mpq_matmul_ref, prepare_for_kernel,
    )
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bitorch_engine_tpu_torch.ops.quant import _unpermute, dequantize_mpq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    perm_gen = torch.Generator().manual_seed(SEED + 23)
    rows = {"mpq_matmul": [], "dequant_mpq": [], "flash_attention": [], "flash_attention_bwd": []}
    for name, k, n in FT_SHAPES:
        qt = asym_tensor(torch, gen, perm_gen, k, n)
        sym = prepare_for_kernel(qt)  # the same tensor already in kernel form: the sym route
        kform = ml._kernel_form(qt)
        plain_w = dequantize_mpq(qt, torch.float32)  # s·(q − z), logical rows
        meta = kform.packed.nbytes + kform.scales.nbytes + kform.zeros.nbytes
        for m in FT_KERNEL1_M:
            x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
            reset_launch_counts()
            got = ml.mpq_linear(x, qt, out_dtype=torch.float32)
            check(launch_counts()["mpq_matmul"] == 1, f"23a {name} m={m}: kernel 1 did not launch")
            want = mpq_matmul_ref(ml._gather(x, qt), kform, torch.float32)
            rel = rel_err(got, want)
            plain = x.float() @ plain_w
            plain_rel = rel_err(got, plain)
            log(f"23a kernel 1 asym {name} K={k} N={n} m={m}: vs its plain version on the kernel "
                f"form max|d|/max|ref| {rel:.3e}; vs the plain asym s(q - z) {plain_rel:.3e}")
            check(rel <= FT_KERNEL1_REL, f"23a kernel 1 {name} m={m}: rel {rel} > {FT_KERNEL1_REL}")
            check(plain_rel <= ASYM_PLAIN_REL,
                  f"23a kernel 1 {name} m={m}: {plain_rel} from s(q - z) > {ASYM_PLAIN_REL}")
            w_bf16 = dequant_mpq_ref(sym.replace(q_perm=None), torch.bfloat16)
            b1, by1 = bound(meta + x.nbytes + m * n * 2, 2 * m * k * n)
            rows["mpq_matmul"].append(dict(
                shape=f"ft_{name}_m{m}", K=k, N=n, m=m, max_abs_err=(got - want).abs().max().item(),
                rel_err=rel, plain_asym_rel=plain_rel,
                ms=time_ms(torch, lambda: ml.mpq_linear(x, qt), flush=flush),
                sym_ms=time_ms(torch, lambda: ml.mpq_linear(x, sym), flush=flush),
                plain_ms=time_ms(torch, lambda: mpq_matmul_ref(ml._gather(x, qt), kform),
                                 flush=flush),
                library_ms=time_ms(torch, lambda: torch.matmul(ml._gather(x, qt), w_bf16),
                                   flush=flush),
                bound_ms=b1, bound_by=by1))
            del x, got, want, plain
        reset_launch_counts()
        got = ml.reconstruct_weight(qt, torch.bfloat16)
        check(launch_counts()["dequant_mpq"] == 1, f"23a {name}: kernel 2 did not launch")
        want = _unpermute(dequant_mpq_ref(kform, torch.bfloat16), qt.q_perm)
        equal = torch.equal(got, want)
        check_dequant(torch, f"23a {name} asym", qt)
        check_dequant(torch, f"23a {name} sym", sym)
        plain_rel = rel_err(ml.reconstruct_weight(qt, torch.float32), plain_w)
        reset_launch_counts()
        exact = ml.reconstruct_weight(qt, torch.float32, exact_asym=True)
        check(launch_counts()["dequant_mpq"] == 1, f"23a {name}: the exact form did not launch")
        exact_equal = torch.equal(exact, plain_w)
        log(f"23a kernel 2 asym {name} K={k} N={n}: bit-equal to the stored rows' kernel form "
            f"scattered back {equal}; f32 vs the plain asym s(q - z) max|d|/max|ref| "
            f"{plain_rel:.3e}; the exact form (DiodeMix's) bit-equal to s(q - z) {exact_equal}")
        check(equal, f"23a kernel 2 {name}: not bit-equal to its plain version")
        check(exact_equal, f"23a kernel 2 {name}: the exact form is not s(q - z)")
        check(plain_rel <= ASYM_PLAIN_REL, f"23a kernel 2 {name}: {plain_rel} > {ASYM_PLAIN_REL}")
        nbytes = record_bytes(qt)
        b2, by2 = bound(nbytes + k * n * 2, 0)
        rows["dequant_mpq"].append(dict(
            shape=f"ft_{name}", K=k, N=n, max_abs_err=0.0, rel_err=0.0, plain_asym_rel=plain_rel,
            ms=time_ms(torch, lambda: ml.reconstruct_weight(qt, torch.bfloat16), flush=flush),
            sym_ms=time_ms(torch, lambda: ml.reconstruct_weight(sym, torch.bfloat16), flush=flush),
            kernel_alone_ms=time_ms(torch, lambda: dequant_mpq(ml._stored(qt)), flush=flush),
            plain_ms=time_ms(torch, lambda: dequant_mpq_ref(qt), flush=flush),
            library_ms=None, bound_ms=b2, bound_by=by2))
        # DiodeMix's reconstruction: the exact form in f32 (before: the plain
        # dequantize_mpq, which is its plain version)
        b3, by3 = bound(nbytes + k * n * 4, 0)
        rows["dequant_mpq"].append(dict(
            shape=f"ft_{name}_exact_f32", K=k, N=n, max_abs_err=0.0, rel_err=0.0,
            plain_asym_rel=0.0,
            ms=time_ms(torch, lambda: ml.reconstruct_weight(qt, torch.float32, exact_asym=True),
                       flush=flush),
            sym_ms=time_ms(torch, lambda: ml.reconstruct_weight(sym, torch.float32), flush=flush),
            plain_ms=time_ms(torch, lambda: dequantize_mpq(qt, torch.float32), flush=flush),
            library_ms=None, bound_ms=b3, bound_by=by3))
        del exact
        del qt, sym, kform, plain_w, got, want
        torch.cuda.empty_cache()
    fgen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    name, b, nh, nkv, s, d = FT_FLASH
    rows["flash_attention"].append(flash_row(torch, fgen, name, b, nh, nkv, s, d, flush))
    rows["flash_attention_bwd"].append(flash_bwd_row(torch, fgen, name, b, nh, nkv, s, d, True,
                                                     flush))
    for kname, rs in rows.items():
        for r in rs:
            sym = f"  sym route {r['sym_ms']:.4f} ms" if "sym_ms" in r else ""
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {kname:19s} {r['shape']:24s} kernel {r['ms']:.4f} ms{sym}  plain "
                f"{r['plain_ms']:.4f} ms  library {lib} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    torch.cuda.empty_cache()
    return rows


def ft_state(model):
    """Every tensor of ``model`` but the grad shadows, cloned."""
    return {n: t.detach().clone() for n, t in
            list(model.named_buffers()) + list(model.named_parameters())
            if not n.endswith("grad_shadow")}


def codes_differing(torch, a, b):
    """Packed codes (w4, by rows) and integer zeros (by columns) that differ
    between the states ``a`` and ``b``, and their totals."""
    from bitorch_engine_tpu_torch.ops import packing

    out = dict(codes=0, codes_total=0, zeros=0, zeros_total=0)
    for n, t in a.items():
        if n.endswith("packed"):
            x, y = packing.unpack_rows(t, 4), packing.unpack_rows(b[n], 4)
            out["codes"] += int((x != y).sum())
            out["codes_total"] += x.numel()
        elif n.endswith("zeros"):
            x, y = packing.unpack_cols(t, 4), packing.unpack_cols(b[n], 4)
            out["zeros"] += int((x != y).sum())
            out["zeros_total"] += x.numel()
    return out


def forced_logits(torch, model, seq, plen):
    """``generate``'s passes with its tokens forced to ``seq``: the prefill
    of ``seq[:, :plen]``, then a decode step a token; the last logits."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches

    b, total = seq.shape
    caches = init_kv_caches(model.cfg, b, total, device="cuda")
    logits, caches = model(seq[:, :plen], kv_caches=caches, cache_len=0)
    last = logits[:, -1]
    for i in range(total - plen - 1):
        last, caches = decode_step(model, seq[:, plen + i : plen + i + 1], caches, plen + i)
    return last


def phase_ft_e2e(torch, tmp):
    """Phase 23b: the GPTQ export (``write_gptq_checkpoint``: w4 g128 asym,
    act-order on every projection) at ``FT_LAYERS`` layers, loaded into
    :func:`ft_config`, prepared for training, ``FT_STEPS`` DiodeMix steps
    (lr ``FT_LR``, the integer zeros refreshed every step) at ``FT_BATCH`` x
    ``FT_SEQ`` with remat, the last one profiled, then ``FT_NEW_TOKENS``
    greedy tokens by ``generate``.  Checked: finite losses; each step's
    launches (kernels 2, 3, 4), act-order routes and DiodeMix routes; the
    first step against the same step through the plain versions on the
    card from the same weights and moments; the generation's last logits
    against the plain path."""
    from bitorch_engine_tpu_torch.models.generate import generate
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import make_train_step
    from bitorch_engine_tpu_torch.utils.profiling import device_summary, profiler

    held = torch.cuda.memory_allocated() / 2**30
    log(f"23b starts with {held:.2f} GiB allocated")
    check(held < FT_START_GIB, f"23b starts with {held:.2f} GiB allocated (an earlier phase's "
          f"tensors held; the bar is {FT_START_GIB} GiB)")
    path = str(pathlib.Path(tmp) / "llama3_8b_gptq_asym_finetune.safetensors")
    t0 = time.perf_counter()
    nbytes = write_gptq_checkpoint(torch, path, FT_LAYERS, SEED + 23, centered=True)
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load_ft_model(torch, path, FT_LAYERS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    projs = ft_projections(model)
    n_proj = len(projs)
    check(n_proj == 7 * FT_LAYERS and all(
        m.qweight.asym and m.q_perm is not None and m.g_idx is None and m.grad_shadow is not None
        for _, m in projs), "23b: the loaded projections are not asym act-order tensors in training")
    n_q = sum(m.grad_shadow.numel() for _, m in projs)
    log(f"23b GPTQ export: Llama-3-8B w4 g128 asym act-order, {FT_LAYERS} layers, "
        f"{nbytes / 2**30:.2f} GiB written in {write_s:.1f} s; loaded for training in {load_s:.1f} s, "
        f"{n_q} quantized weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    toks = torch.randint(0, model.cfg.vocab_size, (FT_BATCH, FT_SEQ + 1), device="cuda",
                         generator=gen)
    start = ft_state(model)
    hp = DiodeHyperParams(lr=FT_LR, zeros_update_interval=1)
    step = make_train_step(model, lm_loss, hp)
    # kernel 2: forward, remat and backward, then DiodeMix's exact form,
    # each writing its rows through q_perm
    per_step = {**counts_with(dequant_mpq=4 * n_proj, flash_attention=2 * FT_LAYERS,
                              flash_attention_bwd=2 * FT_LAYERS),
                "act_order_gather": 0, "act_order_scatter": 4 * n_proj, "act_order_plain": 0,
                "diode_kernel": n_proj, "diode_plain": 0}
    losses, step_ms, counts = [], [], []
    prof_summary = grads = after1 = None
    for i in range(FT_STEPS):
        torch.cuda.synchronize()
        reset_ft_counts()
        prof = profiler() if i == FT_STEPS - 1 else None
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        losses.append(float(step(toks)["loss"]))  # the host reads the loss: the step has ended
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            prof.stop()
            prof_summary = device_summary(prof, step_ms[-1] / 1e3, 1, top=8)
        counts.append(ft_counts())
        if i == 0:
            grads, after1 = par_grads(model), ft_state(model)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"23b fine-tune: losses {losses}; step ms {[round(t, 2) for t in step_ms]} (the last one "
        f"profiled); per step {counts[0]} (expected {per_step}); peak {peak:.2f} GiB")
    log(f"23b profiled step: wall {prof_summary['wall_ms_per_call']:.2f} ms, device busy "
        f"{prof_summary['device_busy_ms_per_call']:.2f} ms, idle share "
        f"{prof_summary['idle_share']:.3f}, {prof_summary['launches_per_call']:.0f} launches")
    for kern in prof_summary["top_kernels"]:
        log(f"  {kern['ms_per_call']:8.3f} ms  {kern['launches_per_call']:6.1f}x  {kern['name']}")
    check(all(math.isfinite(x) for x in losses), f"23b losses {losses}")
    for i, c in enumerate(counts):
        check(c == per_step, f"23b step {i + 1} counts {c} != {per_step}")
    moved = codes_differing(torch, after1, start)
    log(f"23b after step 1: {moved['codes']} of {moved['codes_total']} codes and {moved['zeros']} "
        f"of {moved['zeros_total']} integer zeros moved")

    # the generation: greedy, kernel 1 at m = FT_BATCH for every projection
    prompt = torch.randint(0, model.cfg.vocab_size, (FT_BATCH, FT_PROMPT), device="cuda",
                           generator=gen)
    torch.cuda.synchronize()
    reset_ft_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        seq = generate(model, prompt, FT_NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = {k: v for k, v in ft_counts().items() if v}
    want_k1 = n_proj * (FT_NEW_TOKENS - 1)
    with torch.no_grad():
        last = forced_logits(torch, model, seq, FT_PROMPT)
        reset_ft_counts()
        with plain_kernels(), plain_mpq_forward():
            want = forced_logits(torch, model, seq, FT_PROMPT)
    torch.cuda.synchronize()
    plain_counts = {k: v for k, v in ft_counts().items() if v}
    gen_rel = rel_err(last, want)
    log(f"23b generate: {FT_NEW_TOKENS} tokens at batch {FT_BATCH} after a {FT_PROMPT}-token "
        f"prompt in {gen_s:.2f} s; counts {gen_counts} (kernel 1 expected {want_k1}); last logits "
        f"vs the plain path max|d|/max|ref| {gen_rel:.3e}; the last tokens equal the forced "
        f"run's argmax: {torch.equal(torch.argmax(last, -1), seq[:, -1])}")
    check(gen_counts.get("mpq_matmul", 0) == want_k1,
          f"23b generate: {gen_counts.get('mpq_matmul', 0)} kernel-1 launches != {want_k1}")
    check(not plain_counts, f"23b the plain generation launched a kernel {plain_counts}")
    check(bool(torch.isfinite(last).all()) and gen_rel <= 2e-2, f"23b generate: rel {gen_rel}")

    # step 1 again through the plain versions, from the same weights and moments
    del step
    torch.cuda.empty_cache()
    with torch.no_grad():
        for n, t in list(model.named_buffers()) + list(model.named_parameters()):
            if n in start:
                t.copy_(start[n])
    step = make_train_step(model, lm_loss, hp)
    reset_ft_counts()
    with plain_kernels():
        plain_loss = float(step(toks)["loss"])
    torch.cuda.synchronize()
    launched = {k: v for k, v in ft_counts().items() if v and k in counts_with()}
    check(not launched, f"23b the plain step launched a kernel {launched}")
    loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    rels = grad_rels(model, grads)
    worst = max(rels, key=rels.get)
    off = codes_differing(torch, ft_state(model), after1)
    log(f"23b step 1 vs the plain versions on the card: loss {losses[0]:.6f} vs {plain_loss:.6f} "
        f"(rel {loss_rel:.3e}); max grad rel {rels[worst]:.3e} ({worst}, {len(rels)} tensors); "
        f"after DiodeMix {off['codes']} of {off['codes_total']} codes and {off['zeros']} of "
        f"{off['zeros_total']} integer zeros differ")
    check(loss_rel <= TRAIN_LOSS_REL, f"23b plain check: loss rel {loss_rel}")
    check(rels[worst] <= TRAIN_GRAD_REL, f"23b plain check: {worst} grad rel {rels[worst]}")
    out = dict(layers=FT_LAYERS, batch=FT_BATCH, seq=FT_SEQ, lr=FT_LR, export_gib=nbytes / 2**30,
               write_s=write_s, load_s=load_s, quantized_weights=n_q, losses=losses,
               step_ms=step_ms, per_step=per_step, peak_gib=peak, profile=prof_summary,
               moved_step1=moved, generate=dict(seconds=gen_s, counts=gen_counts, rel=gen_rel),
               plain_check=dict(loss_rel=loss_rel, grad_rel=rels[worst], worst=worst, **off))
    del model, step, start, after1, grads, toks
    torch.cuda.empty_cache()
    return out


def ft_share(name, t, coord, rows):
    """The part of the unsharded tensor ``name`` that tp rank ``coord``
    holds: halves of the columns of q, k, v, gate and up; of o and down
    the stored rows' half (packed words, zeros' and scales' groups) and,
    for a grad shadow, its logical rows ``rows[name]`` (``tp_rows``)."""
    proj = name.split(".")[-2] if name.count(".") >= 2 else ""
    if proj in TPT_COLUMN:
        n = t.shape[1] // TP
        return t[:, coord * n : (coord + 1) * n]
    if proj in TPT_ROW:
        if name.endswith("grad_shadow"):
            return t[rows[name]]
        k = t.shape[0] // TP
        return t[coord * k : (coord + 1) * k]
    return t


def ft_witness(torch, path, batch, ref):
    """23c's one-process witness of tp 2's rounding: the unsharded model
    with both of tp 2's split sums (``split_cols``, ``split_rows``: an
    act-order row shard reads its ``tp_rows`` of the activation), one
    forward and backward; its loss and gradients against the unsharded
    step's (each shard's gradient put back in its logical place)."""
    model = split_rows(torch, split_cols(torch, load_ft_model(torch, path, FT_PAR_LAYERS)))
    loss = par_loss(None)(model, batch)
    loss.backward()
    grads = {}
    for li, layer in enumerate(model.layers):
        for parent, names in ((layer.attn, ("q_proj", "k_proj", "v_proj", "o_proj")),
                              (layer.mlp, ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                mod = getattr(parent, name)
                where = f"layer_{li}.{'attn' if parent is layer.attn else 'mlp'}.{name}.grad_shadow"
                if name in TPT_ROW:
                    rows = torch.cat([p.tp_rows for p in mod.parts])
                    parts = torch.cat([p.grad_shadow.grad.float() for p in mod.parts])
                    grads[where] = torch.empty_like(parts).index_copy_(0, rows, parts)
                else:
                    grads[where] = torch.cat([p.grad_shadow.grad.float() for p in mod.parts], dim=1)
    for name, p in model.named_parameters():
        if name in ref["grads"] and name not in grads:
            grads[name] = p.grad.float()
    rels = {n: rel_err(g, ref["grads"][n]) for n, g in grads.items()}
    worst = max(rels, key=rels.get)
    out = dict(loss_rel=abs(float(loss.detach()) - ref["loss"]) / abs(ref["loss"]),
               grad_rel=rels[worst], worst=worst, tensors=len(rels), of=len(ref["grads"]))
    del model, loss, grads
    torch.cuda.empty_cache()
    return out


def ragged_layer(torch):
    """A ``down_proj``-shaped (14336 x 4096) asym w4 g128 GPTQ tensor whose
    act-order ``g_idx`` has unequal groups (rows moved between groups, drawn
    from the seed), in an ``MPQLinear`` prepared for training, and a
    gradient whose sign is constant down each column (so that the refresh
    moves integer zeros)."""
    from bitorch_engine_tpu_torch.layers.linear import MPQLinear
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training
    from bitorch_engine_tpu_torch.utils.ingest import mpq_from_gptq

    k, n = FT_RAGGED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    perm_gen = torch.Generator().manual_seed(SEED + 25)
    p = gptq_projection(torch, gen, perm_gen, k, n, centered=True)
    g = k // GPTQ_GROUP
    counts = torch.full((g,), GPTQ_GROUP, dtype=torch.int64)
    for _ in range(16):
        a, b = torch.randperm(g, generator=perm_gen)[:2].tolist()
        moved = int(torch.randint(1, 9, (1,), generator=perm_gen))
        counts[a] -= moved
        counts[b] += moved
    g_idx = torch.repeat_interleave(torch.arange(g), counts)[torch.randperm(k, generator=perm_gen)]
    qt = mpq_from_gptq(p["qweight"], p["qzeros"], p["scales"], g_idx.to(torch.int32).cuda(),
                       device="cuda")
    check(qt.g_idx is not None and qt.q_perm is None, "23c: the ragged g_idx was canonicalized")
    layer = prepare_for_training(MPQLinear(k, n, dtype=torch.bfloat16, qweight=qt))
    sign = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
    grad = 0.3 * torch.randn(k, n, device="cuda", generator=gen) + sign
    return layer, grad


def ft_par_rank(path):
    """One rank of phase 23c's two-rank world (the card shared, gloo), from
    the ``FT_PAR_LAYERS``-layer GPTQ export at ``path``:

    * the unsharded fine-tune step (every rank alike), then the same step at
      fsdp 2 (every packed word, zero and parameter compared) and at tp 2
      (``shard_llama_params``: its loss and gradients against its share of
      the unsharded step's, the codes that differ counted); rank 0 also runs
      the one-process witness of tp 2's split sums (``ft_witness``);
    * the ragged ``g_idx`` layer (``ragged_layer``), one DiodeMix step at a
      refresh, unsharded and as this rank's tp 2 row shard.

    Returns one JSON string (``json``) of its numbers."""
    import torch
    import torch.distributed as dist

    from bitorch_engine_tpu_torch.models.llama_sharding import row_shard, shard_llama_params
    from bitorch_engine_tpu_torch.ops import packing
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams, DiodeMix
    from bitorch_engine_tpu_torch.parallel import make_mesh
    from bitorch_engine_tpu_torch.training import make_train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    hp = DiodeHyperParams(lr=FT_LR, zeros_update_interval=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    toks = torch.randint(0, 128256, (FT_PAR_BATCH, FT_PAR_SEQ + 1), device="cuda", generator=gen)
    batch = (toks[:, :-1].contiguous(), toks[:, 1:].contiguous())
    out = dict(rank=rank)

    # the unsharded step
    model = load_ft_model(torch, path, FT_PAR_LAYERS)
    rec = {}
    with par_record(torch, rec, profiled=False):
        rec["loss"] = float(make_train_step(model, par_loss(None), hp)(batch)["loss"])
    ref = dict(loss=rec["loss"], grads=par_grads(model), after=ft_state(model))
    out["ref"] = rec
    del model
    torch.cuda.empty_cache()
    if rank == 0:
        out["witness"] = ft_witness(torch, path, batch, ref)

    # fsdp 2
    mesh = make_mesh(fsdp=TP)
    model = load_ft_model(torch, path, FT_PAR_LAYERS)
    step = make_train_step(model, par_loss(mesh), hp, mesh=mesh)
    rec = {}
    with par_record(torch, rec, [mesh], profiled=False):
        rec["loss"] = float(step(batch)["loss"])
    after = ft_state(model)
    rec["differing"] = {n: int((t != ref["after"][n]).sum()) for n, t in after.items()
                        if not torch.equal(t, ref["after"][n])}
    rec["tensors"] = len(after)
    rec["splits"] = {n: list(s) for n, s in step.optimizer.splits.items() if n.startswith("layer_0.")}
    out["fsdp"] = rec
    del model, step, after
    torch.cuda.empty_cache()

    # tp 2
    mesh = make_mesh(tp=TP)
    coord = mesh.coord("tp")
    model = shard_llama_params(load_ft_model(torch, path, FT_PAR_LAYERS), mesh)
    step = make_train_step(model, par_loss(mesh), hp, mesh=mesh)
    rec = {}
    with par_record(torch, rec, [mesh], profiled=False):
        rec["loss"] = float(step(batch)["loss"])
    rec["loss_rel"] = abs(rec["loss"] - ref["loss"]) / abs(ref["loss"])
    rows = {f"{n}.grad_shadow": m.tp_rows for n, m in model.named_modules()
            if getattr(m, "tp_rows", None) is not None}
    params = dict(model.named_parameters())
    rels = {n: rel_err(params[n].grad.float(), ft_share(n, g, coord, rows))
            for n, g in ref["grads"].items()}
    rec["worst"] = max(rels, key=rels.get)
    rec["grad_rel"], rec["grads"] = rels[rec["worst"]], len(rels)
    off = dict(codes=0, codes_total=0, zeros=0, zeros_total=0)
    for n, t in ft_state(model).items():
        if n.endswith(("packed", "zeros")):
            unpack = packing.unpack_rows if n.endswith("packed") else packing.unpack_cols
            a, b = unpack(t, 4), unpack(ft_share(n, ref["after"][n], coord, rows), 4)
            key = "codes" if n.endswith("packed") else "zeros"
            off[key] += int((a != b).sum())
            off[f"{key}_total"] += a.numel()
    rec.update(off)
    rec["row_shards"] = len(rows)
    out["tp"] = rec
    del model, step, params, ref
    torch.cuda.empty_cache()

    # the ragged g_idx layer at tp 2, one step at a refresh
    rec = {}
    for key in ("none", "tp2"):
        layer, grad = ragged_layer(torch)
        zeros0 = layer.zeros.clone()
        if key == "tp2":
            layer = row_shard(layer, mesh, "tp", "ragged_down")
            k = layer.qweight.in_features
            grad = grad[coord * k : (coord + 1) * k]
        layer.grad_shadow.grad = grad.contiguous()
        opt = DiodeMix(layer, DiodeHyperParams(lr=FT_RAGGED_LR, zeros_update_interval=1),
                       mesh=mesh if key == "tp2" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        rec[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3
        rec[f"{key}_codes"] = packing.unpack_rows(layer.packed, 4)
        rec[f"{key}_zeros"] = packing.unpack_cols(layer.zeros, 4)
        rec[f"{key}_zeros_moved"] = int((layer.zeros != zeros0).sum())
        del layer, grad, opt
    k = rec["tp2_codes"].shape[0]
    out["ragged"] = dict(
        codes_differing=int((rec["tp2_codes"] != rec["none_codes"][coord * k : (coord + 1) * k]).sum()),
        codes=int(rec["tp2_codes"].numel()),
        zeros_differing=int((rec["tp2_zeros"] != rec["none_zeros"]).sum()),
        zeros=int(rec["none_zeros"].numel()), zeros_moved=rec["none_zeros_moved"],
        none_ms=rec["none_ms"], tp2_ms=rec["tp2_ms"])
    torch.cuda.empty_cache()
    return {"json": json.dumps(out)}


def phase_ft_par(torch, tmp):
    """Phase 23c: the ``FT_PAR_LAYERS``-layer export written here, then
    :func:`ft_par_rank` in a two-rank world sharing the card over gloo,
    its numbers held to their checks."""
    from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

    path = str(pathlib.Path(tmp) / "llama3_8b_gptq_asym_2l.safetensors")
    nbytes = write_gptq_checkpoint(torch, path, FT_PAR_LAYERS, SEED + 27, centered=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = [json.loads(str(r["json"])) for r in launch_world(
        "chip_smoke:ft_par_rank", TP, {"path": path}, timeout=FT_WORLD_TIMEOUT,
        collective_timeout=TPT_COLLECTIVE_TIMEOUT)]
    world_s = time.perf_counter() - t0
    fails = []

    def expect(ok, what):
        if not ok:
            fails.append(what)

    w = ranks[0]["witness"]
    bar = max(TRAIN_GRAD_REL, TPT_WITNESS_FACTOR * w["grad_rel"])
    log(f"23c ({TP_LABEL}): the {FT_PAR_LAYERS}-layer export {nbytes / 2**30:.2f} GiB; world of "
        f"{TP} ran {world_s:.1f} s; witness (one process, tp 2's split sums) vs the unsharded step: "
        f"loss rel {w['loss_rel']:.3e}, max grad rel {w['grad_rel']:.3e} ({w['worst']}, "
        f"{w['tensors']} of {w['of']} tensors); the tp step's bar {bar:.3e}")
    expect(w["tensors"] == w["of"], "23c witness: a gradient missing")
    for r in ranks:
        f, t, g = r["fsdp"], r["tp"], r["ragged"]
        log(f"23c rank {r['rank']} unsharded: loss {r['ref']['loss']:.6f}, wall "
            f"{r['ref']['wall_s']:.2f} s, launches {r['ref']['launches']}, peak "
            f"{r['ref']['peak_gib']:.2f} GiB")
        log(f"23c rank {r['rank']} fsdp 2: loss {f['loss']:.6f}, wall {f['wall_s']:.2f} s; "
            f"{len(f['differing'])} of {f['tensors']} tensors differ from the unsharded step "
            f"({f['differing'] or 'none'}); layer 0's shares {f['splits']}; {comm_text(f['comm'])}")
        log(f"23c rank {r['rank']} tp 2: loss {t['loss']:.6f} (rel {t['loss_rel']:.3e}), max grad "
            f"rel {t['grad_rel']:.3e} ({t['worst']}, {t['grads']} tensors), {t['row_shards']} "
            f"act-order row shards; {t['codes']} of {t['codes_total']} codes and {t['zeros']} of "
            f"{t['zeros_total']} integer zeros off the unsharded step's share; wall "
            f"{t['wall_s']:.2f} s; {comm_text(t['comm'])}")
        log(f"23c rank {r['rank']} ragged g_idx {FT_RAGGED_SHAPE} tp 2: {g['codes_differing']} of "
            f"{g['codes']} codes and {g['zeros_differing']} of {g['zeros']} zeros differ from the "
            f"unsharded step's; the refresh moved {g['zeros_moved']} packed zero words; step "
            f"{g['none_ms']:.1f} ms unsharded, {g['tp2_ms']:.1f} ms a tp rank")
        expect(not f["differing"] and f["loss"] == r["ref"]["loss"],
               f"23c rank {r['rank']} fsdp: {f['differing']}")
        expect(len(f["splits"]) == 7 and all(s[0] == 1 for s in f["splits"].values()),
               f"23c rank {r['rank']} fsdp shares {f['splits']}")
        expect(t["loss_rel"] <= TRAIN_LOSS_REL, f"23c rank {r['rank']} tp loss rel {t['loss_rel']}")
        expect(t["grad_rel"] <= bar, f"23c rank {r['rank']} tp {t['worst']} grad rel {t['grad_rel']}")
        expect(t["row_shards"] == 2 * FT_PAR_LAYERS, f"23c rank {r['rank']} row shards")
        expect(g["codes_differing"] == 0 and g["zeros_differing"] == 0 and g["zeros_moved"] > 0,
               f"23c rank {r['rank']} ragged: {g}")
    check(not fails, "; ".join(fails))
    return dict(label=TP_LABEL, world_s=world_s, export_gib=nbytes / 2**30, witness=w, bar=bar,
                ranks=ranks)


def phase_ft_timing(torch, dequant_rows):
    """Phase 23d: ``utils.benchmark.time_op`` on kernel 2 at the 8B gate|up
    shape and ``time_fn_pytree`` on a 2-layer 8B decode step (its caches
    chained), beside phase 2's CUDA-event reading of the same kernel."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches, prefill
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import dequant_mpq
    from bitorch_engine_tpu_torch.utils.benchmark import time_fn_pytree, time_op

    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    k, n = PROJ_SHAPES["gate_up"]
    qt = mpq_weight(torch, gen, k, n)
    x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
    op_s = time_op(lambda x, qt: dequant_mpq(qt), x, qt)
    phase2_ms = shape_row(dequant_rows, "gate_up")["ms"]
    del qt, x
    model = build_model(torch, 2, SEED)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda")
    logits, caches = prefill(model, prompt, caches)
    tok = torch.argmax(logits[:, -1], dim=-1)

    def step(args):
        tok, caches = args
        last, caches = decode_step(model, tok[:, None], caches, PROMPT, attn_window=bucket(PROMPT + 1))
        return torch.argmax(last, dim=-1), caches

    decode_s = time_fn_pytree(step, (tok, caches))
    del model, caches
    torch.cuda.empty_cache()
    log(f"23d time_op: kernel 2 at gate|up {k} x {n} {op_s * 1e3:.4f} ms an execution (the output "
        f"summed each time, no flush) beside phase 2's CUDA-event median {phase2_ms:.4f} ms (L2 "
        f"flushed); time_fn_pytree: a 2-layer 8B decode step at b{BATCH} {decode_s * 1e3:.4f} ms")
    check(math.isfinite(op_s) and op_s > 0 and math.isfinite(decode_s) and decode_s > 0,
          f"23d: time_op {op_s}, time_fn_pytree {decode_s}")
    return dict(time_op_kernel2_gate_up_ms=op_s * 1e3, phase2_kernel2_gate_up_ms=phase2_ms,
                time_fn_pytree_decode_2l_ms=decode_s * 1e3)


def phase_ft(torch, dequant_rows):
    """Phase 23: 23a-23d, the exports in a temporary directory removed at
    its end."""
    t_start = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    rows = phase_ft_kernels(torch, flush)
    del flush
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["e2e"] = phase_ft_e2e(torch, tmp)
        torch.cuda.empty_cache()
        out["par"] = phase_ft_par(torch, tmp)
    torch.cuda.empty_cache()
    out["timing"] = phase_ft_timing(torch, dequant_rows)
    out["seconds"] = time.perf_counter() - t_start
    log(f"23: the fine-tune of a GPTQ checkpoint ran {out['seconds']:.1f} s")
    return rows, out


# kernel 2's variants, each built from this checkout's
# csrc/dequant_matmul.cu with the -D flags its source note names (the
# port's build defines none): 2 packed rows, 8 columns, or both a thread;
# the tile staged in shared memory and written by TMA bulk stores
KERNEL2_VARIANTS = {
    "rows2": ("-DDQ_RPT=2",),
    "cols8": ("-DDQ_CPT=8",),
    "rows2_cols8": ("-DDQ_RPT=2", "-DDQ_CPT=8"),
    "tma_store": ("-DDQ_TMA_STORE=1",),
}


def dequant_bodies(parent, tmp):
    """Kernel 2's bodies beside the port's own, each ``bte_dequant`` loaded
    with ctypes: "first", the body before the redesign, from ``parent``'s
    source (a checkout of the commit before it), and every
    :data:`KERNEL2_VARIANTS` entry from this checkout's, all built at once
    with the port's nvcc flags into ``tmp``."""
    from bitorch_engine_tpu_torch.ops.cuda import _build

    rel = pathlib.Path("bitorch_engine_tpu_torch") / "csrc" / "dequant_matmul.cu"
    builds = {"first": (pathlib.Path(parent) / rel, ())}
    builds.update({name: (ROOT / rel, flags) for name, flags in KERNEL2_VARIANTS.items()})
    t0 = time.perf_counter()
    jobs = {}
    for name, (src, flags) in builds.items():
        lib = pathlib.Path(tmp) / f"libdequant_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        out = proc.communicate(timeout=900)[0]
        check(proc.returncode == 0, f"nvcc on kernel 2's {name} body:\n{out}")
        fn = ctypes.CDLL(str(lib)).bte_dequant
        # the first body took no row map, zero form or alignment
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                       if name == "first" else
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    log(f"kernel 2's first body and {len(KERNEL2_VARIANTS)} variants built in "
        f"{time.perf_counter() - t0:.1f} s")
    return fns


@contextmanager
def dequant_body(fn):
    """Kernel 2's wrapper launching ``fn`` (a variant's ``bte_dequant``)
    in the port's body's place."""
    dm = importlib.import_module("bitorch_engine_tpu_torch.ops.cuda.dequant_matmul")
    saved = dm._dequant_fn
    dm._dequant_fn = lambda: fn
    try:
        yield
    finally:
        dm._dequant_fn = saved


def first_route(torch, fn, qt, dtype, exact):
    """The route each reconstruction took before the redesign, as a
    function: the stored rows (rewritten to the kernel form if asym)
    through the first body, then scattered back by ``q_perm``; DiodeMix's
    exact form the plain ``dequantize_mpq``."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import _DTYPE_CODE, prepare_for_kernel
    from bitorch_engine_tpu_torch.ops.quant import _unpermute, dequantize_mpq

    if exact and qt.asym:
        return lambda: dequantize_mpq(qt, dtype)
    k, n = qt.logical_shape

    def run():
        kt = qt.replace(q_perm=None)
        if kt.asym:
            kt = prepare_for_kernel(kt)
        out = torch.empty((k, n), dtype=dtype, device="cuda")
        err = fn(kt.packed.data_ptr(), kt.scales.data_ptr(), kt.zeros.data_ptr(), out.data_ptr(),
                 k, n, kt.w_bit, kt.group_size, _DTYPE_CODE[kt.scales.dtype], _DTYPE_CODE[dtype],
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the first body's launch returned CUDA error {err}")
        return out if qt.q_perm is None else _unpermute(out, qt.q_perm)
    return run


def kernel2_ab_paths():
    """The paths the redesign of kernel 2 is read on: each a list of rows
    (shape name, K, N, tensor kind, output dtype name, exact form,
    launches a pass).  Kinds: "sym" (w4 g128, bf16 metadata, as served),
    "act_order" (an ingested act-order export in kernel form: sym, bf16
    metadata, q_perm), "asym" (an ingested act-order export as the
    fine-tune loads it: asym, f32 scales, q_perm)."""
    ckpt = [(f"ao_{name}", k, n, "act_order", "bf16", False, CKPT_LAYERS)
            for name, (k, n) in CKPT_PROJ.items()]
    return {
        "8b_prefill": [(name, k, n, "sym", "bf16", False, PER_PASS[name])
                       for name, (k, n) in PROJ_SHAPES.items()],
        "mixtral_prefill": [(name, *(PROJ_SHAPES.get(name) or MOE_SHAPES[name]), "sym", "bf16",
                             False, w) for name, w in MOE_PER_PASS.items()],
        "act_order_8b_prefill": ckpt + [("head", *PROJ_SHAPES["head"], "sym", "bf16", False, 1)],
        "finetune_step": [(f"ft_{name}", k, n, "asym", "bf16", False, 3 * FT_LAYERS * FT_PER_LAYER[name])
                          for name, k, n in FT_SHAPES]
        + [(f"ft_{name}_exact", k, n, "asym", "f32", True, FT_LAYERS * FT_PER_LAYER[name])
           for name, k, n in FT_SHAPES],
        "train_370m_step": [(name, k, n, "sym", "bf16", False, 3 * TRAIN_LAYERS)
                            for name, (k, n) in TRAIN_SHAPES.items()]
        + [(f"{name}_f32", k, n, "sym", "f32", False, TRAIN_LAYERS)
           for name, (k, n) in TRAIN_SHAPES.items()],
    }


def phase_kernel2_ab(torch, parent):
    """Kernel 2's redesign against its first body (built from ``parent``,
    a checkout of the commit before) in one run, on the paths of
    :func:`kernel2_ab_paths`: at each row the route before (the first
    body, with the asym rewrite and the scatter around it, or the plain
    dequantize in DiodeMix) and the route now (one ``reconstruct_weight``
    call: one launch) bit-equal, and each of :data:`KERNEL2_VARIANTS` in the
    port's body's place bit-equal to it; then all timed in turns (before,
    now, the variants, the variants backwards, now, before; CUDA events,
    median of 20, L2 flushed).  Per pass: the launches' sums beside the
    bound (bytes at 3.35 TB/s)."""
    from bitorch_engine_tpu_torch.ops import mpq_linear as ml
    from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as dm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    perm_gen = torch.Generator().manual_seed(SEED + 19)
    # every width, zero form, row map and path (16-byte and a column at a
    # time) against the plain version first
    for w_bit, gs, n in ((1, 128, 544), (2, 128, 528), (4, 128, 520), (8, 64, 516)):
        for meta in (torch.bfloat16, torch.float32):
            check_dequant(torch, f"w{w_bit}g{gs} asym", asym_weight(torch, gen, 1024, n, w_bit, gs,
                                                                    meta))
            check_dequant(torch, f"w{w_bit}g{gs} ragged", mpq_weight(torch, gen, 1024, 518, w_bit, gs,
                                                                     meta))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    variants = list(KERNEL2_VARIANTS)
    tensors, rows = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kernel2_") as tmp:
        bodies = dequant_bodies(parent, tmp)
        for path, path_rows in kernel2_ab_paths().items():
            for name, k, n, kind, dt, exact, _ in path_rows:
                if name in rows:
                    continue
                key = (k, n, kind)
                if key not in tensors:
                    if kind == "sym":
                        tensors[key] = mpq_weight(torch, gen, k, n, 4)
                    elif kind == "act_order":
                        tensors[key] = act_order_tensor(torch, gen, perm_gen, k, n, 4)
                    else:
                        tensors[key] = asym_tensor(torch, gen, perm_gen, k, n)
                qt, dtype = tensors[key], dtypes[dt]
                before = first_route(torch, bodies["first"], qt, dtype, exact)
                now = lambda qt=qt, dtype=dtype, exact=exact: ml.reconstruct_weight(  # noqa: E731
                    qt, dtype, exact_asym=exact)
                want = now()
                check(torch.equal(before(), want),
                      f"kernel 2 A/B {name}: the new route differs from the first")
                for v in variants:
                    with dequant_body(bodies[v]):
                        check(torch.equal(now(), want),
                              f"kernel 2 A/B {name}: the {v} variant differs from the port's body")
                del want

                def timed(body):
                    if body == "first":
                        return time_ms(torch, before, flush=flush)
                    if body == "now":
                        return time_ms(torch, now, flush=flush)
                    with dequant_body(bodies[body]):
                        return time_ms(torch, now, flush=flush)

                order = ["first", "now", *variants, *variants[::-1], "now", "first"]
                turns = [(body, timed(body)) for body in order]
                ms = {body: statistics.mean(t for b_, t in turns if b_ == body) for body in order}
                b, by = bound(record_bytes(qt) + k * n * dtype.itemsize, 0)
                rows[name] = dict(shape=name, K=k, N=n, kind=kind, form=dm.zero_form(qt, exact),
                                  dtype=dt, first_ms=ms["first"], ms=ms["now"],
                                  variant_ms={v: ms[v] for v in variants},
                                  turns_ms=[t for _, t in turns], bound_ms=b, bound_by=by)
                log(f"kernel 2 A/B {name:18s} K={k:5d} N={n:6d} {kind:9s} "
                    f"{rows[name]['form']:11s} {dt}: first route {ms['first'] * 1e3:9.2f} us, now "
                    f"{ms['now'] * 1e3:9.2f} us, bound {b * 1e3:8.2f} us; variants "
                    + ", ".join(f"{v} {ms[v] * 1e3:.2f}" for v in variants)
                    + f" us (turns {' / '.join(f'{t * 1e3:.2f}' for _, t in turns)})")
    del flush, tensors
    torch.cuda.empty_cache()
    out = {}
    for path, path_rows in kernel2_ab_paths().items():
        def total(get):
            return sum(w * get(rows[name]) for name, *_, w in path_rows)

        tot = {key: total(lambda r, key=key: r[key]) for key in ("first_ms", "ms", "bound_ms")}
        var = {v: total(lambda r, v=v: r["variant_ms"][v]) for v in variants}
        out[path] = dict(tot, variant_ms=var, launches=sum(r[-1] for r in path_rows),
                         share_of_bound=tot["bound_ms"] / tot["ms"],
                         first_share_of_bound=tot["bound_ms"] / tot["first_ms"])
        log(f"kernel 2 A/B {path:22s} {out[path]['launches']:4d} launches: first route "
            f"{tot['first_ms']:.4f} ms, now {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({out[path]['first_share_of_bound']:.1%} -> {out[path]['share_of_bound']:.1%} of it); "
            + ", ".join(f"{v} {t:.4f} ms" for v, t in var.items()))
    return dict(paths=out, rows=rows)


def shape_row(rows, shape):
    """The row of ``rows`` measured at ``shape`` (a KeyError names a
    missing one)."""
    return {r["shape"]: r for r in rows}[shape]


def kernel_line(name, rows, launches, weights, per, check_text):
    """One entry of the kernels JSON: the per-pass sums of the rows that
    ``weights`` names (shape -> launches per pass)."""
    def total(key):
        vals = [shape_row(rows, shape)[key] for shape in weights]
        return None if None in vals else sum(w * v for w, v in zip(weights.values(), vals))

    return dict(
        name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
        tpu_counterpart=TPU_KERNELS[name], launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        check=check_text, max_err=max(r["rel_err"] for r in rows), per=per,
        ms=total("ms"), plain_ms=total("plain_ms"), library_ms=total("library_ms"),
        bound_ms=total("bound_ms"), bound_by=shape_row(rows, next(iter(weights)))["bound_by"],
        shapes=rows,
    )


def main() -> int:
    """The whole run; ``--kernel2-ab PARENT`` instead times kernel 2's
    redesign against its first body, built from ``PARENT`` (a checkout of
    the commit before it), and prints its rows and passes as one JSON line
    before the last."""
    ab_parent = None
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel2-ab":
        ab_parent = sys.argv[2]
    elif len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py [--kernel2-ab PARENT_CHECKOUT]", file=sys.stderr)
        return 2
    if not (ROOT / "bitorch_engine_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(bitorch_engine_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bitorch_engine_tpu_torch.ops.cuda import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, one process per source)")
    if ab_parent is not None:
        print(json.dumps(dict(phase_kernel2_ab(torch, ab_parent), card=smi)), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MiB > L2
    per_shape, kernel1_extra = phase_kernels(torch, gen, flush)
    per_shape.update(phase_paged_kernels(torch, gen, flush))
    del flush
    t0 = time.perf_counter()
    model = build_model(torch, LAYERS, SEED)
    torch.cuda.synchronize()
    log(f"e2e model: Llama-3-8B w4 g128, {LAYERS} layers, built in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    counts, e2e = phase_e2e(torch, gen, model)
    serve_counts, serving = phase_serving(torch, model)
    paged_vs_dense = phase_paged_vs_dense(torch, model)
    del model
    torch.cuda.empty_cache()
    path_rel = phase_path_check(torch, gen)
    gate = phase_paged_gate(torch, gen)

    # the sub-4-bit slice
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    per_shape["mpq_matmul_a8"], quad_more = phase_quad_kernels(torch, gen, flush)
    per_shape["mbwq_matmul"], mbwq_checks, k7_wins = phase_mbwq_kernels(torch, gen, flush)
    del flush
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_mbwq_model(torch, LAYERS, SEED)
    torch.cuda.synchronize()
    log(f"MBWQ model: Llama-2-7B MBWQ-2.5 (w4 g64 / w2 g128), {LAYERS} layers, built in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    mbwq = phase_mbwq_e2e(torch, gen, model)
    del model
    torch.cuda.empty_cache()
    mbwq["path_check_rel"] = phase_mbwq_path_check(torch, gen)

    # the training slice
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    per_shape["flash_attention_bwd"] = phase_flash_bwd_kernels(torch, gen, flush)
    del flush
    train_counts, train = phase_train(torch, gen)
    train["path_check"] = phase_train_path_check(torch, gen)

    # the binary / QAT slice
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    per_shape["xnor_gemm"], xnor_more = phase_xnor_kernels(torch, gen, flush)
    del flush
    torch.backends.cudnn.allow_tf32 = True  # the port's convs must not rely on the caller's flag
    qat = phase_qat_e2e(torch, gen)
    qat["path_check"] = phase_qat_path_check(torch, gen)
    torch.backends.cudnn.allow_tf32 = False
    qat["xnor"] = xnor_more

    # the checkpoint slice
    ckpt, act_rows = phase_ckpt(torch, gen)

    # the MoE slice
    moe_rows, moe_counts, moe = phase_moe(torch, gen)

    # the parallel slice
    tp_rows, tp = phase_tp(torch)

    # the parallel training slice
    par_rows, par = phase_par(torch)

    # tp inside the train step
    tpt_rows, tpt = phase_tpt(torch)

    # the entry points
    entry = phase_entry(torch)

    # the fine-tune of a GPTQ-format checkpoint
    ft_rows, ft = phase_ft(torch, per_shape["dequant_mpq"])

    checks = {
        "mpq_matmul": ("max|d|/max|ref| <= 1e-3 (f32, pre-cast) per shape and per check (m 1-512, "
                       "w1/w2/w4/w8, bf16 and f32 metadata, ragged N, f32 activations); a second "
                       "launch bit-equal; the bf16 out the f32 out cast"),
        "dequant_mpq": "bit-equal (bf16)",
        "flash_attention": (f"bf16 out elements differing <= {FWD_DIFFERING_MAX:g} and out atol 1e-2 "
                            "rtol 1e-2; lse within 1e-4 relative (absolute where |lse| < 1; max_err is this "
                            "lse error, max_out_rel_err the out's max|d|/max|ref|)"),
        "paged_prefix_attention": "acc max|d|/max|ref| <= 5e-3 (p rounds to bf16 in both; a p on "
                                  "a rounding boundary may round the other way); m, l max|d|/max|ref| "
                                  "<= 1e-4 (f32 sums in another order); empty slots exact",
    }
    checks["paged_prefix_attention_update"] = checks["paged_prefix_attention"] + \
        "; pools bit-equal after the write (but the null page 0)"
    checks["mpq_matmul_a8"] = ("f32 accumulator before sx and the cast, max|d|/max|ref| <= 1e-4 "
                               "per shape and per check (m 1-512, f32 metadata), affine and "
                               "mid_sym, and max|d| = 0 at every g128 bf16-metadata shape at m 8 on "
                               "both bodies (the g16 shapes on the dp4a body, which takes them, "
                               "rel only); a "
                               "second launch bit-equal; activation codes and sx bit-equal")
    checks["mbwq_matmul"] = ("max|d|/max|ref| <= 1e-3 (f32, pre-cast) per shape and per check "
                             "(m 1-512, w1/w2/w4/w8 mixes, f32 metadata, ragged N, f32 activations); "
                             "a second launch bit-equal; the bf16 out the f32 out cast")
    checks["flash_attention_bwd"] = ("max|d|/max|ref| <= 1e-2 for each of dq, dk, dv (bf16 out) per "
                                     "shape")
    checks["xnor_gemm"] = ("bit-equal per shape: the words entry (f32 integers, and a second launch), "
                           "the fused packed linear in f32, bf16 and f16 (ties x == -bias_a), and the "
                           "unpack branch's output equal to the fused entry's (f32, and f16 routed "
                           "through binary_linear)")
    kernels = []
    for name in ("mpq_matmul", "dequant_mpq"):
        rows = per_shape[name]
        per = f"one {'decode step' if name == 'mpq_matmul' else 'prefill'} of the main path"
        line = kernel_line(name, rows, counts[name], {r["shape"]: PER_PASS[r["shape"]] for r in rows},
                           per, checks[name])
        if name == "mpq_matmul":
            line["per_launch_us"] = {r["shape"]: r["per_launch_us"] for r in rows}
            line["n_split"] = {r["shape"]: r["n_split"] for r in rows}
            line["max_rel_err_all_checks"] = max(c["rel_err"] for c in kernel1_extra["kernel1_checks"])
            line.update(kernel1_extra)
        kernels.append(line)
    rows = per_shape["flash_attention"]
    line = kernel_line("flash_attention", rows, counts["flash_attention"], {FLASH_PREFILL: LAYERS},
                       "one prefill of the main path", checks["flash_attention"])
    line["max_lse_err"] = max(r["lse_err"] for r in rows)
    line["max_out_rel_err"] = max(r["out_rel_err"] for r in rows)
    line["max_bf16_elements_differing"] = max(r["bf16_elements_differing"] for r in rows)
    # the training path's 48 launches per step (phase 12), at the train shape
    train_row = shape_row(rows, FLASH_TRAIN)
    line["train_step"] = {key: 2 * TRAIN_LAYERS * train_row[key]
                          for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    line["library"] = "scaled_dot_product_attention (causal, enable_gqa)"
    kernels.append(line)
    # the serving slice's path (phase 5b): 32 write-back launches per decode
    # step, reckoned at batch 8 and window 512; 32 read-only launches per
    # prefill chunk after the first, at a wave of 8 and window 256
    kernels.append(kernel_line(
        "paged_prefix_attention_update", per_shape["paged_prefix_attention_update"],
        serve_counts["paged_prefix_attention_update"], {"decode_b8_w512": LAYERS},
        "one decode step of the serving path (b8, window 512)",
        checks["paged_prefix_attention_update"]))
    kernels.append(kernel_line(
        "paged_prefix_attention", per_shape["paged_prefix_attention"],
        serve_counts["paged_prefix_attention"], {"chunk_b8_w256_rs1024": LAYERS},
        "one prefill chunk after the first of the serving path (8 x 256 rows, window 256)",
        checks["paged_prefix_attention"]))
    # the sub-4-bit path (phase 9): per decode step, one launch per
    # projection of each of the 32 layers; kernel 5 in the A8 regime (its
    # w2 segments), kernel 7 in the A16 regime
    a8_weights = {f"mbwq_{p}_w2": LAYERS for p in MBWQ_PROJ}
    rows = per_shape["mpq_matmul_a8"]
    line = kernel_line("mpq_matmul_a8", rows, mbwq["a8"]["launches"]["mpq_matmul_a8"], a8_weights,
                       "one A8 decode step of the MBWQ-2.5 path (the w2 segments)",
                       checks["mpq_matmul_a8"])
    line["yardstick_ms"] = sum(w * shape_row(rows, s)["yardstick_ms"] for s, w in a8_weights.items())
    line["yardstick"] = "torch.matmul on the bf16 dequantized weight (no PyTorch call computes A8)"
    line["first_body_ms"] = sum(w * shape_row(rows, s)["first_body_ms"] for s, w in a8_weights.items())
    line["per_launch_us"] = {s: shape_row(rows, s)["ms"] * 1e3 for s in a8_weights}
    line["further_rows"] = quad_more
    kernels.append(line)
    line = kernel_line("mbwq_matmul", per_shape["mbwq_matmul"],
                       mbwq["a16"]["launches"]["mbwq_matmul"], {p: LAYERS for p in MBWQ_PROJ},
                       "one A16 decode step of the MBWQ-2.5 path (every projection)",
                       checks["mbwq_matmul"])
    line["per_segment_ms"] = sum(LAYERS * r["per_segment_ms"] for r in per_shape["mbwq_matmul"])
    line["per_launch_us"] = {r["shape"]: r["per_launch_us"] for r in per_shape["mbwq_matmul"]}
    line["max_rel_err_all_checks"] = max(c["rel_err"] for c in mbwq_checks)
    line["checks"] = mbwq_checks
    line["n_split"] = {r["shape"]: r["n_split"] for r in per_shape["mbwq_matmul"]}
    line["kernel7_wins_to"] = k7_wins
    kernels.append(line)
    # the training path (phase 12): one backward (a dq and a dkv launch) per
    # layer per step, reckoned at the training shape; library: SDPA's backward
    line = kernel_line("flash_attention_bwd", per_shape["flash_attention_bwd"],
                       train_counts["flash_attention_bwd"], {FLASH_TRAIN: TRAIN_LAYERS},
                       "one train step of the 370M path (24 backward calls of 2 launches)",
                       checks["flash_attention_bwd"])
    line["library"] = "scaled_dot_product_attention backward (forward + backward less forward)"
    kernels.append(line)
    # the binary path (phase 15): one launch of kernel 8 (its fused entry,
    # binary_packed_linear) per packed forward of the binary MLP at batch 8,
    # reckoned at 1024 x 1024, m 8
    xr = per_shape["xnor_gemm"]
    path_serve = qat["mlp"][1]["serve"][SERVE_BATCH]
    path_launches = path_serve["launches"]
    line = kernel_line("xnor_gemm", xr, path_launches, {"mlp_1024_m8": 1},
                       "one packed forward of the binary MLP at batch 8 (the fused entry)",
                       checks["xnor_gemm"])
    row8 = shape_row(xr, "mlp_1024_m8")  # the path's call: the fused entry
    line.update(ms=row8["fused_ms"], plain_ms=row8["fused_plain_ms"], bound_ms=row8["fused_bound_ms"],
                bound_by=row8["fused_bound_by"])
    line["entries"] = {"binary_packed_linear": path_launches, "xnor_gemm": path_serve["words_launches"]}
    line["words_entry_ms"] = row8["ms"]
    line["b1_rate"] = xnor_more["b1_rate"]
    line["yardstick_ms"] = row8["yardstick_ms"]
    line["yardstick"] = ("torch.mm of the bf16 +-1 activations by the unpacked bf16 +-1 weight, f32 out "
                         "(no PyTorch call computes an XNOR-popcount GEMM)")
    line["unpack_branch_ms"] = row8["unpack_ms"]
    line["launch_floor_ms"] = xnor_more["launch_floor_ms"]
    kernels.append(line)
    # the act-order routes (phase 17): launches in the act-order 8B run
    # (kernels 1 and 2), and through the entry points (kernel 5: an
    # act-order A8 projection through mpq_linear; kernel 7: an exl2
    # MBWQLinear), each counted from 0; every per-layer row.  The perplexity
    # gate's launches (no act-order tensor) stand beside, outside act_order
    by_name = {line["name"]: line for line in kernels}
    routes = act_rows["route_launches"]
    act_launches = {
        "mpq_matmul": (ckpt["per_step"]["mpq_matmul"] * DECODE_STEPS,
                       f"{DECODE_STEPS} decode steps of the act-order 8B run"),
        "dequant_mpq": (ckpt["per_prefill"]["dequant_mpq"], "one prefill of the act-order 8B run"),
        "mpq_matmul_a8": (routes["mpq_matmul_a8"], "mpq_linear on an act-order w2 A8 projection, "
                          "m 8, once at each of the two per-layer shapes"),
        "mbwq_matmul": (routes["mbwq_matmul"], "one MBWQLinear forward of the exl2 tensor, m 8"),
    }
    for name, n in ckpt["ppl_gate"]["launches"].items():
        if name in by_name:
            by_name[name]["ppl_gate_launches"] = n
    for name, (launches, per) in act_launches.items():
        rows = act_rows[name]
        by_name[name]["act_order"] = dict(
            launches=launches, per=per, max_abs_err=max(r["max_abs_err"] for r in rows),
            max_rel_err=max(r.get("rel_err", 0.0) for r in rows), rows=rows)
    # the MoE path (phase 18b): launches per Mixtral decode step (kernel 1)
    # and per prefill (kernels 2 and 3); kernels 1 and 2 priced at phase 2's
    # q|k|v and o rows and phase 18a's expert and head rows
    moe_passes = {
        "mpq_matmul": (moe_counts["mpq_matmul"] / DECODE_STEPS, MOE_PER_PASS,
                       "one decode step of the Mixtral path (b8)"),
        "dequant_mpq": (moe_counts["dequant_mpq"], MOE_PER_PASS,
                        "one prefill of the Mixtral path (8 x 256)"),
        "flash_attention": (moe_counts["flash_attention"], {FLASH_PREFILL: LAYERS},
                            "one prefill of the Mixtral path (8 x 256)"),
    }
    for name, (launches, weights, per) in moe_passes.items():
        rows = per_shape[name] + moe_rows.get(name, [])
        sub = kernel_line(name, rows, launches, weights, per, checks[name])
        own = moe_rows.get(name) or [shape_row(rows, s) for s in weights]
        keys = ("launches", "per", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        by_name[name]["moe"] = dict(
            {key: sub[key] for key in keys},
            max_abs_err=max(r["max_abs_err"] for r in own), max_err=max(r["rel_err"] for r in own),
            rows=own)
    # the parallel path (phase 19): one rank's launches in the tp run (32
    # decode steps of kernel 1, a prefill of kernels 2 and 3) and in the tp
    # batcher (kernel 6's write-back form), priced at this rank's shard rows
    r0 = tp["ranks"][0]
    tp_step_launches = sum(rec["launches"].get("mpq_matmul", 0) for rec in r0["records"][1:])
    tp_passes = {
        "mpq_matmul": (tp_step_launches, TP_PER_PASS,
                       f"one decode step of one tp rank (b8; launches over {DECODE_STEPS} steps)"),
        "dequant_mpq": (r0["records"][0]["launches"]["dequant_mpq"], TP_PER_PASS,
                        "one prefill of one tp rank (8 x 256)"),
        "flash_attention": (r0["records"][0]["launches"]["flash_attention"], {TP_FLASH[0]: LAYERS},
                            "one prefill of one tp rank (8 x 256, 16 query / 4 KV heads)"),
        "paged_prefix_attention_update": (
            r0["tp_queue"]["launches"]["paged_prefix_attention_update"], {TP_PAGED[0][0]: LAYERS},
            "one decode step of one rank of the tp batcher (b8, window 512, 4 KV heads)"),
    }
    for name, (launches, weights, per) in tp_passes.items():
        rows = tp_rows[name]
        sub = kernel_line(name, rows, launches, weights, per, checks[name])
        keys = ("launches", "per", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        by_name[name]["tp"] = dict(
            {key: sub[key] for key in keys}, label=TP_LABEL,
            max_abs_err=max(r["max_abs_err"] for r in rows), max_err=max(r["rel_err"] for r in rows),
            rows=rows)
    # the parallel training path (phase 20): one sp rank's launches in its
    # train step, priced at the 370M projections (kernel 2) and at one sp
    # rank's attention blocks (kernels 3 and 4: the ring's rank 1, which
    # runs the diagonal and the earlier block, and a Ulysses rank)
    p_ranks = par["ranks"]
    proj_calls = {name: 4 * TRAIN_LAYERS for name in TRAIN_SHAPES}
    ring1, uly0 = p_ranks[1]["sp_ring"]["launches"], p_ranks[0]["sp_ulysses"]["launches"]
    par_passes = {
        ("dequant_mpq", "sp"): (p_ranks[0]["sp_ring"]["launches"]["dequant_mpq"], proj_calls,
                                "one train step of one sp rank (8 x 1024 tokens, sp 2)"),
        ("flash_attention", "sp_ring"): (
            ring1["flash_attention"], {SP_RING_DIAG: 2 * TRAIN_LAYERS, SP_RING_OFF: 2 * TRAIN_LAYERS},
            "one train step of ring rank 1 (the diagonal and the earlier block a layer, twice)"),
        ("flash_attention", "sp_ulysses"): (
            uly0["flash_attention"], {SP_ULYSSES: 2 * TRAIN_LAYERS},
            "one train step of a Ulysses rank (8 of 16 heads over 2048 positions a layer, twice)"),
        ("flash_attention_bwd", "sp_ring"): (
            ring1["flash_attention_bwd"], {SP_RING_DIAG: TRAIN_LAYERS, SP_RING_OFF: TRAIN_LAYERS},
            "one train step of ring rank 1 (a backward of 2 launches per block)"),
        ("flash_attention_bwd", "sp_ulysses"): (
            uly0["flash_attention_bwd"], {SP_ULYSSES: TRAIN_LAYERS},
            "one train step of a Ulysses rank (a backward of 2 launches a layer)"),
    }
    for (name, key), (launches, weights, per) in par_passes.items():
        rows = [r for r in par_rows[name] if r["shape"] in weights]
        sub = kernel_line(name, rows, launches, weights, per, checks[name])
        keys = ("launches", "per", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        by_name[name][key] = dict(
            {k: sub[k] for k in keys}, label=TP_LABEL,
            max_abs_err=max(r["max_abs_err"] for r in rows), max_err=max(r["rel_err"] for r in rows),
            rows=rows)
    # tp inside the train step (phase 21): one tp rank's launches in its
    # 370M step, priced at its projection shards (kernel 2) and its 8 heads'
    # attention (kernels 3 and 4)
    t_rank = tpt["ranks"][0]["tp"]["launches"]
    tpt_passes = {
        "dequant_mpq": (t_rank["dequant_mpq"], {name: 4 * TRAIN_LAYERS for name in TPT_SHAPES},
                        "one train step of one tp rank (8 x 2048 tokens, tp 2)"),
        "flash_attention": (t_rank["flash_attention"], {TPT_FLASH[0]: 2 * TRAIN_LAYERS},
                            "one train step of one tp rank (8 of 16 heads a layer, twice)"),
        "flash_attention_bwd": (t_rank["flash_attention_bwd"], {TPT_FLASH[0]: TRAIN_LAYERS},
                                "one train step of one tp rank (a backward of 2 launches a layer)"),
    }
    for name, (launches, weights, per) in tpt_passes.items():
        rows = tpt_rows[name]
        sub = kernel_line(name, rows, launches, weights, per, checks[name])
        keys = ("launches", "per", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        by_name[name]["tp_train"] = dict(
            {k: sub[k] for k in keys}, label=TP_LABEL,
            max_abs_err=max(r["max_abs_err"] for r in rows), max_err=max(r["rel_err"] for r in rows),
            rows=rows)
    # the entry points (phase 22): launches of the twins' traced runs, each
    # equal to the count the profiler's trace holds
    gen_run, serve_run = entry["generate"], entry["serve"]["traced"]
    for name in ("mpq_matmul", "dequant_mpq", "flash_attention"):
        by_name[name]["entry_points"] = dict(
            quantize_and_generate=gen_run["counted"][name], serve=serve_run["counted"][name],
            per="one traced run of each twin (22c: load + generate; 22d: build + serve)")
    by_name["paged_prefix_attention_update"]["entry_points"] = dict(
        serve=serve_run["counted"]["paged_attention"],
        per="one traced run of the serve twin (22d), both forms of kernel 6")
    # the fine-tune (phase 23): launches per train step of the asym
    # act-order 8B path (kernels 2, 3, 4; 23b) and per decode step of its
    # generation (kernel 1), priced at 23a's rows (the asym route: kernel
    # 1's rewrite and gather included, kernel 2 one launch; each row also
    # holds the sym route's time, sym_ms)
    fe = ft["e2e"]
    per_train = fe["per_step"]
    ft_passes = {
        "mpq_matmul": (fe["generate"]["counts"]["mpq_matmul"] / (FT_NEW_TOKENS - 1),
                       {f"ft_{s}_m{FT_BATCH}": FT_LAYERS * c for s, c in FT_PER_LAYER.items()},
                       f"one decode step of the fine-tuned model's generation (b{FT_BATCH}, "
                       f"{FT_LAYERS} layers)"),
        "dequant_mpq": (per_train["dequant_mpq"],
                        {**{f"ft_{s}": 3 * FT_LAYERS * c for s, c in FT_PER_LAYER.items()},
                         **{f"ft_{s}_exact_f32": FT_LAYERS * c for s, c in FT_PER_LAYER.items()}},
                        f"one train step of the fine-tune ({FT_BATCH} x {FT_SEQ}, {FT_LAYERS} "
                        "layers: forward, remat, backward in bf16, DiodeMix's exact form in f32)"),
        "flash_attention": (per_train["flash_attention"], {FT_FLASH[0]: 2 * FT_LAYERS},
                            "one train step of the fine-tune (forward and remat a layer)"),
        "flash_attention_bwd": (per_train["flash_attention_bwd"], {FT_FLASH[0]: FT_LAYERS},
                                "one train step of the fine-tune (a backward of 2 launches a layer)"),
    }
    for name, (launches, weights, per) in ft_passes.items():
        rows = [r for r in ft_rows[name] if r["shape"] in weights]
        sub = kernel_line(name, rows, launches, weights, per, checks[name])
        keys = ("launches", "per", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        line = dict({k: sub[k] for k in keys}, max_abs_err=max(r["max_abs_err"] for r in rows),
                    max_err=max(r["rel_err"] for r in rows), rows=ft_rows[name])
        if name in ("mpq_matmul", "dequant_mpq"):
            line["sym_route_ms"] = sum(w * shape_row(rows, s)["sym_ms"] for s, w in weights.items())
            line["max_plain_asym_rel"] = max(r["plain_asym_rel"] for r in ft_rows[name])
        by_name[name]["finetune"] = line
    log(json.dumps({"e2e": e2e, "serving": serving, "paged_vs_dense": paged_vs_dense,
                    "path_check_rel": path_rel, "paged_gate": gate, "mbwq": mbwq, "train": train,
                    "qat": qat, "checkpoint": ckpt, "ragged_g_idx": act_rows["ragged_counts"],
                    "moe": moe, "tp": tp["summary"], "par": par["summary"], "tp_train": tpt["summary"],
                    "entry": entry, "finetune": ft, "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
