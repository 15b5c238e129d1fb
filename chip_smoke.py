#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bitorch_engine_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bitorch_engine_tpu_torch/csrc`` and
then, failing on the first check that does not hold:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and the kernels' build time;
2. holds each kernel against its plain PyTorch version at the shapes of the
   Llama-3-8B w4 g128 serving path (tolerances below), kernel 3 (the flash
   forward) also at the 370M training shape, with the share of its bf16
   outputs that differ from the plain version (both round ``p`` to bf16
   against the running max of the reference's key tile);
3. times each kernel, its plain version and, where one exists, the single
   PyTorch call that computes the same function (CUDA events, median of 20
   launches, L2 flushed before each), beside the least time the card could
   take (bytes at 3.35 TB/s, or bf16 operations at 989 TFLOP/s);
4. runs the serving path at full width (32 layers, random weights from a
   seed): a 256-token prefill of 8 prompts, then 32 greedy decode steps with
   the bucketed attention window, and checks the kernels' launch counts;
   then runs a prefill and 8 decode steps once more under ``torch.profiler``
   and prints, per phase, the device's busy time, its idle share, the
   launches and the kernels with the most device time;
5. the serving slice: holds both paged-attention entry points against their
   plain versions (shuffled page tables, per-slot cache lengths with 0 and
   W - 1, inactive slots on the null page 0; pools bit-equal after the
   write) and times them beside their bound and a gathered-window
   ``scaled_dot_product_attention`` yardstick; serves a mixed queue of 16
   requests through ``ContinuousBatcher`` (8 slots, a paged pool of 16
   pages of 64 per slot, 256-token prefill chunks) on the same 32-layer
   model and checks every request, the freed pool and the paged kernels'
   launch counts; times a decode step paged and dense at batch 8 and 64;
6. compares prefill + 4 decode steps of a 2-layer full-width model between
   the kernel path and the plain path on the card, over dense and over
   paged caches;
7. runs the paged logits gate of ``tools/paged_gate.py`` (4 layers, hidden
   2048, 64 forced decode steps, dense against paged);
8. the sub-4-bit slice: holds kernel 5 (the A8 int8 kernel) against its
   plain version in f32 before ``sx`` and the cast (and its activation
   quantization bit-equal) at the MBWQ-2.5 w2 segments and the uniform-w2
   Llama-3-8B shapes, affine and mid_sym, and at w1 and w4; holds kernel 7
   (the fused mixed-bit kernel, bf16 activations on the tensor cores)
   against its plain version at the MBWQ-2.5 A16 projections at m 1-512,
   at w8 / w1 / w2 / w4 mixes with f32 metadata and ragged N, bf16 out, and
   run twice bit for bit, and its f32-activation route once; times both
   beside their bounds, their plain versions, a bf16 ``torch.matmul`` and
   (kernel 7) the per-segment launches it replaces;
9. runs Llama-2-7B MBWQ-2.5 (25% w4 g64, 75% w2 g128) at full width: a
   256-token prefill of 8 prompts, 32 greedy decode steps in the A8 regime,
   then 32 more after ``prepare_params_for_cuda(..., act_bits_map={2: 16})``
   in the A16 regime, checks the launch counts per step and profiles a few
   steps of each regime;
10. compares prefill + 4 decode steps of a 2-layer MBWQ-2.5 model between
    the kernel path and the plain path on the card, in both regimes;
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
14. the binary / QAT slice: holds kernel 8 (the XNOR-popcount GEMM) bit for
    bit against its plain version at the packed MLP's 1024² (m 1, 8, 16),
    4096² (m 1-128), 8192² (m 8) and a ragged shape, and times it beside its
    bound (bytes, or 32-bit popcounts at 16 per clock per SM), its plain
    version, the bf16 sign matmul it stands in for (``torch.mm`` of the ±1
    operands with f32 output) and the port's own m > 16 branch (unpack +
    that matmul), and prints the m where the matmul overtakes it;
15. trains the MNIST example's ``QuantMLP`` (784 → 1024 → 1024 → 10) at 1,
    4 and 8 bits with DiodeMix (lr 1e-3, batch 128, 20 steps on seeded
    synthetic digits; losses finite and falling, the accuracy the train
    step returns), packs it with ``prepare_for_inference`` and serves it at
    batch 8 (kernel 8: exactly one launch per forward at 1 bit) and batch
    128 (none), with one profiled train step; trains ``QuantConvNet`` (widths
    64-128-128-256, 32×32×3, batch 128) at 1 and 4 bits for 5 steps, with
    the peak memory.  cuDNN's TF32 flag is on during phases 15-16: the
    port's convolutions must turn it off themselves;
16. the packed MLP's logits through kernel 8 against the plain path on the
    card (bit-equal), and one binary-MLP train step and one conv-net step
    at 1 and 4 bits on the card against the same step on the CPU from the
    same weights and optimizer state.

It prints one JSON line describing the kernels and, as its last line,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import importlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): the bounds' rates
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

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
    "mpq_matmul": "bitorch_engine_tpu_torch/csrc/dequant_matmul.cu",
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
# rows of each variant are the ones the main path's pass is reckoned from
PAGED_SHAPES = (
    ("decode_b8_w512", 8, 512, REP, "int8", True),
    ("decode_b8_w256", 8, 256, REP, "int8", True),
    ("decode_b8_w1024", 8, 1024, REP, "int8", True),
    ("decode_b64_w256", 64, 256, REP, "int8", True),
    ("decode_b8_w512_bf16", 8, 512, REP, "bf16", True),
    ("chunk_b8_w256_rs1024", 8, 256, REP * 256, "int8", False),
)
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
# kernel 5's shapes (K, N, w_bit, group size): the MBWQ-2.5 w2 segments
# first (the rows the main path is reckoned from), then the uniform-w2
# Llama-3-8B shapes of tools/quad_gate.py, then w1 and w4 at one shape
QUAD_SHAPES = (
    [(f"mbwq_{name}_w2", k2, n, 2, 128) for name, (_, n, _, k2) in MBWQ_PROJ.items()]
    + [(f"w2_{k}x{n}", k, n, 2, 128) for k, n in
       ((4096, 4096), (4096, 6144), (4096, 28672), (14336, 4096), (2048, 512))]
    + [("w1_4096x4096", 4096, 4096, 1, 128), ("w4_4096x4096", 4096, 4096, 4, 128)]
)

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
# kernel 8's shapes (name, m, K, N): the packed MLP's serving forward first
# (the row the main path is reckoned from), then the A/B shape list of
# BENCH_NOTES.md:817-835 and a ragged one
XNOR_SHAPES = (
    [("mlp_1024_m8", 8, 1024, 1024), ("mlp_1024_m1", 1, 1024, 1024), ("mlp_1024_m16", 16, 1024, 1024)]
    + [(f"4096_m{m}", m, 4096, 4096) for m in (1, 8, 16, 32, 64, 128)]
    + [("8192_m8", 8, 8192, 8192), ("ragged_m3_k1000_n70", 3, 1000, 70)]
)


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


def phase_kernels(torch, gen, flush):
    """Phases 2 and 3: every kernel against its plain version, then timed."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import (
        dequant_mpq, dequant_mpq_ref, mpq_matmul, mpq_matmul_ref, prepare_for_kernel,
    )
    from bitorch_engine_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_ref,
    )
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq

    F = torch.nn.functional
    results = {name: [] for name in TPU_KERNELS}

    def weight(k, n, w_bit, gs=128):
        w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        return prepare_for_kernel(quantize_mpq(w, w_bit=w_bit, group_size=gs), torch.bfloat16)

    # kernel 1 and 2 at the serving shapes (w4 g128, bf16 metadata, m = 8)
    for name, (k, n) in PROJ_SHAPES.items():
        qt = weight(k, n, 4)
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        got = mpq_matmul(x, qt, torch.float32)
        want = mpq_matmul_ref(x, qt, torch.float32)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        log(f"kernel mpq_matmul  {name:8s} K={k} N={n} m=8  max|d|={err:.3e} rel={rel:.3e}")
        check(rel <= 1e-3, f"mpq_matmul {name}: rel err {rel} > 1e-3")
        w_bf16 = dequant_mpq_ref(qt, torch.bfloat16)
        got_w = dequant_mpq(qt, torch.bfloat16)
        equal = torch.equal(got_w, w_bf16)
        log(f"kernel dequant_mpq {name:8s} K={k} N={n}  bit-equal={equal}")
        check(equal, f"dequant_mpq {name}: not bit-equal to the plain version")

        meta = qt.packed.nbytes + qt.scales.nbytes + qt.zeros.nbytes
        b1, by1 = bound(meta + x.nbytes + 8 * n * 2, 2 * 8 * k * n)
        results["mpq_matmul"].append(dict(
            shape=name, K=k, N=n, m=8, max_abs_err=err, rel_err=rel,
            ms=time_ms(torch, lambda: mpq_matmul(x, qt), flush=flush),
            plain_ms=time_ms(torch, lambda: mpq_matmul_ref(x, qt), flush=flush),
            library_ms=time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush),
            bound_ms=b1, bound_by=by1,
        ))
        b2, by2 = bound(meta + k * n * 2, 2 * k * n)
        results["dequant_mpq"].append(dict(
            shape=name, K=k, N=n, max_abs_err=0.0, rel_err=0.0,
            ms=time_ms(torch, lambda: dequant_mpq(qt), flush=flush),
            plain_ms=time_ms(torch, lambda: dequant_mpq_ref(qt), flush=flush),
            library_ms=None, bound_ms=b2, bound_by=by2,
        ))
        del qt, w_bf16, got_w

    # kernel 1 and 2 at the other container widths, one small shape each
    for w_bit in (1, 2, 8):
        qt = weight(1024, 512, w_bit)
        x = torch.randn(8, 1024, device="cuda", generator=gen).to(torch.bfloat16)
        want = mpq_matmul_ref(x, qt, torch.float32)
        rel = ((mpq_matmul(x, qt, torch.float32) - want).abs().max() / want.abs().max()).item()
        equal = torch.equal(dequant_mpq(qt), dequant_mpq_ref(qt))
        log(f"kernel mpq_matmul/dequant_mpq w{w_bit} K=1024 N=512  rel={rel:.3e} bit-equal={equal}")
        check(rel <= 1e-3 and equal, f"w_bit={w_bit}: rel {rel}, bit-equal {equal}")

    # kernel 3: the prefill's attention, a d = 64 shape and the train shape
    # the train shape draws from its own generator, so the later phases get
    # the inputs they got before it was added
    train_gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for name, b, nh, nkv, s, d in FLASH_FWD_SHAPES:
        g = train_gen if name == FLASH_TRAIN else gen
        q = torch.randn(b, nh, s, d, device="cuda", generator=g).to(torch.bfloat16)
        k = torch.randn(b, nkv, s, d, device="cuda", generator=g).to(torch.bfloat16)
        v = torch.randn(b, nkv, s, d, device="cuda", generator=g).to(torch.bfloat16)
        out, lse = flash_attention(q, k, v)
        ref_out, ref_lse = flash_attention_ref(q, k, v)
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
        ops = b * nh * 4 * d * s * (s + 1) / 2  # QK^T and PV over the causal pairs
        b3, by3 = bound(nbytes, ops)
        results["flash_attention"].append(dict(
            shape=name, max_abs_err=err, rel_err=lse_err, out_rel_err=rel,
            bf16_elements_differing=differing, lse_err=lse_err,
            ms=time_ms(torch, lambda: flash_attention(q, k, v), flush=flush),
            plain_ms=time_ms(torch, lambda: flash_attention_ref(q, k, v), flush=flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), flush=flush),
            bound_ms=b3, bound_by=by3,
        ))
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    for name, rows in results.items():
        for r in rows:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {name:16s} {r['shape']:30s} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    return results


def paged_inputs(torch, gen, b, W, rs, pool):
    """Inputs of one paged-attention shape: a shuffled page table read as a
    column slice of the full per-slot table, per-slot cache lengths with 0
    and W - 1, slot 1 inactive (its row all null page 0, length 0)."""
    import numpy as np

    rng = np.random.default_rng(b * 7919 + W + rs)
    P = W // PAGE
    pages = b * PAGES_PER_SLOT + 1
    shape = (pages, PAGE, NKV * HD)
    dev = dict(device="cuda")
    q = torch.randn(b, NKV, rs, HD, generator=gen, **dev).to(torch.bfloat16)
    if pool == "int8":
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, **dev)
                  for _ in range(2))
        ks, vs = (torch.rand(b, CACHE, NKV, generator=gen, **dev) * 0.02 + 0.01 for _ in range(2))
        kn, vn = (torch.randint(-127, 128, (b, NKV * HD), generator=gen, dtype=torch.int8, **dev)
                  for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=gen, **dev).to(torch.bfloat16) for _ in range(2))
        ks = vs = None
        kn, vn = (torch.randn(b, NKV * HD, generator=gen, **dev).to(torch.bfloat16)
                  for _ in range(2))
    full = (rng.permutation(pages - 1) + 1).reshape(b, PAGES_PER_SLOT).astype(np.int32)
    clen = rng.integers(1, W, b).astype(np.int32)
    clen[0], clen[-1] = 0, W - 1
    full[1], clen[1] = 0, 0
    table = torch.from_numpy(full).cuda()[:, :P]
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, table=table, kn=kn, vn=vn,
                clen=torch.from_numpy(clen).cuda(), clen_np=clen)


def phase_paged_kernels(torch, gen, flush):
    """Phase 5a: both paged-attention entry points against their plain
    versions, then timed, at the serving slice's shapes."""
    from bitorch_engine_tpu_torch.ops.cuda import paged_attention as pa

    F = torch.nn.functional
    sm = 1.0 / math.sqrt(HD)
    results = {"paged_prefix_attention": [], "paged_prefix_attention_update": []}
    for name, b, W, rs, pool, update in PAGED_SHAPES:
        a = paged_inputs(torch, gen, b, W, rs, pool)
        args = (a["q"], a["kp"], a["vp"], a["ks"], a["vs"], a["table"], a["clen"])
        kp0, vp0 = a["kp"].clone(), a["vp"].clone()
        if update:
            got = pa.paged_prefix_attention_update(*args, a["kn"], a["vn"], sm_scale=sm)
            kp_got, vp_got = a["kp"].clone(), a["vp"].clone()
            a["kp"].copy_(kp0)
            a["vp"].copy_(vp0)
            want = pa.paged_prefix_attention_update_ref(*args, a["kn"], a["vn"], sm)
            pools_equal = (torch.equal(kp_got[1:], a["kp"][1:])
                           and torch.equal(vp_got[1:], a["vp"][1:])
                           and not torch.equal(kp_got[1:], kp0[1:]))
        else:
            got = pa.paged_prefix_attention(*args, sm_scale=sm)
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
        log(f"kernel paged {name:22s} acc max|d|/max|ref|={acc_rel:.3e} m rel={m_rel:.3e} "
            f"l rel={l_rel:.3e} empty slots exact={empty_ok} pools bit-equal={pools_equal}")
        check(acc_rel <= 5e-3 and m_rel <= 1e-4 and l_rel <= 1e-4 and empty_ok and pools_equal,
              f"paged attention {name}: acc {acc_rel}, m {m_rel}, l {l_rel}, "
              f"empty {empty_ok}, pools {pools_equal}")

        # bound: q, the valid K / V rows and their scales, the table, the
        # outputs, and the new rows read and written; dots at the bf16 rate
        elt = 1 if pool == "int8" else 2
        nv = int(sum(min(int(c), W) for c in a["clen_np"]))
        nbytes = (a["q"].nbytes + 2 * nv * NKV * HD * elt + (2 * nv * NKV * 4 if pool == "int8" else 0)
                  + b * (W // PAGE) * 4 + b * 4 + got[0].nbytes + got[1].nbytes + got[2].nbytes
                  + (4 * b * NKV * HD * elt if update else 0))
        bms, bby = bound(nbytes, 4 * nv * NKV * rs * HD)
        # yardstick: SDPA over the window already gathered and dequantized to
        # bf16 (no page walk, no dequantisation, no write)
        P = W // PAGE

        def window(pool_, scale):
            g = pool_[a["table"].long()].reshape(b, W, NKV, HD).float()
            if scale is not None:
                g = g * scale[:, :W, :, None]
            return g.to(torch.bfloat16).transpose(1, 2).contiguous()

        kd, vd = window(a["kp"], a["ks"]), window(a["vp"], a["vs"])
        s = rs // REP
        qs = a["q"].reshape(b, NKV, REP, s, HD).reshape(b, NKV * REP, s, HD)
        mask = (torch.arange(W, device="cuda") < a["clen"][:, None])[:, None, None, :]
        if update:
            kernel = lambda: pa.paged_prefix_attention_update(*args, a["kn"], a["vn"], sm_scale=sm)
            plain = lambda: pa.paged_prefix_attention_update_ref(*args, a["kn"], a["vn"], sm)
        else:
            kernel = lambda: pa.paged_prefix_attention(*args, sm_scale=sm)
            plain = lambda: pa.paged_prefix_attention_ref(*args, sm)
        key = "paged_prefix_attention_update" if update else "paged_prefix_attention"
        results[key].append(dict(
            shape=name, b=b, W=W, rs=rs, pool=pool, max_abs_err=acc_err, rel_err=acc_rel,
            m_rel=m_rel, l_rel=l_rel, pools_bit_equal=pools_equal, pages=P,
            ms=time_ms(torch, kernel, flush=flush),
            plain_ms=time_ms(torch, plain, flush=flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask, enable_gqa=True), flush=flush),
            bound_ms=bms, bound_by=bby,
        ))
        del a, kp0, vp0, kd, vd
    for name, rows in results.items():
        for r in rows:
            log(f"time {name:30s} {r['shape']:22s} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  sdpa-on-gathered-window {r['library_ms']:.4f} ms  "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    return results


def build_model(torch, num_layers, seed):
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, llama3_8b_serving
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    cfg = llama3_8b_serving(max_seq_len=CACHE, num_layers=num_layers)
    model = LlamaModel(cfg, device="cuda", seed=seed)
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


def _device_summary(torch, prof, wall_s: float, calls: int, top: int = 8) -> dict:
    """Host wall ms, device busy ms (kernel time summed), idle share
    ``1 - busy / wall``, launches and the largest kernels, per call."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return dict(
        wall_ms_per_call=wall_s * 1e3 / calls,
        device_busy_ms_per_call=busy_us / 1e3 / calls,
        idle_share=1.0 - busy_us / 1e6 / wall_s,
        launches_per_call=sum(e.count for e in kernels) / calls,
        top_kernels=[
            dict(name=e.key[:80], ms_per_call=e.self_device_time_total / 1e3 / calls,
                 launches_per_call=e.count / calls)
            for e in kernels[:top]
        ],
    )


def profile_serve(torch, model, prompt, steps):
    """The serving loop once more under ``torch.profiler``: one profiler
    over the prefill, a second over the decode steps."""
    from torch.profiler import ProfilerActivity, profile

    profs = [profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) for _ in range(2)]
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
    out = dict(prefill=_device_summary(torch, profs[0], marks[0] - t0, 1),
               decode=_device_summary(torch, profs[1], t_end - marks[1], steps))
    for phase, r in out.items():
        log(f"profile {phase}: wall {r['wall_ms_per_call']:.2f} ms/call (profiled), device busy "
            f"{r['device_busy_ms_per_call']:.2f} ms/call, idle share {r['idle_share']:.3f}, "
            f"{r['launches_per_call']:.0f} launches/call")
        for kern in r["top_kernels"]:
            log(f"  {kern['ms_per_call']:8.3f} ms  {kern['launches_per_call']:6.1f}x  {kern['name']}")
    return out


def phase_e2e(torch, gen, model):
    """Phase 4: the full-width serving path, with the launch counts."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

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
    proj = 4 * LAYERS + 1
    pre = marks["counts_prefill"]
    log(f"e2e launches at prefill {pre}; over the run {counts}")
    check(pre == counts_with(dequant_mpq=proj, flash_attention=LAYERS), f"prefill launches {pre}")
    check(counts == counts_with(mpq_matmul=proj * DECODE_STEPS, dequant_mpq=proj,
                                flash_attention=LAYERS), f"run launches {counts}")
    check(bool(torch.isfinite(last).all()), "decode logits are not finite")
    check(bool(((toks >= 0) & (toks < model.cfg.vocab_size)).all()), "token ids out of range")
    e2e = dict(
        prefill_ms=prefill_ms, prefill_tok_s=BATCH * PROMPT / prefill_ms * 1e3,
        decode_ms_per_step=step_ms, decode_tok_s=BATCH / step_ms * 1e3,
        batch=BATCH, prompt=PROMPT, decode_steps=DECODE_STEPS, cache=CACHE,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"e2e prefill {prefill_ms:.2f} ms ({e2e['prefill_tok_s']:.0f} tok/s); decode "
        f"{step_ms:.3f} ms/step ({e2e['decode_tok_s']:.1f} tok/s), batch {BATCH}")
    profiled = profile_serve(torch, model, prompt, PROFILE_STEPS)
    # the profiled run's wall is inflated by the profiler's host cost; this
    # divides its device time by the unprofiled run's step time instead
    profiled["decode"]["idle_share_estimate_unprofiled"] = (
        1.0 - profiled["decode"]["device_busy_ms_per_call"] / step_ms)
    e2e["profile"] = profiled
    torch.cuda.empty_cache()
    return counts, e2e


def phase_serving(torch, model):
    """Phase 5b: the serving slice's main path: a mixed queue through
    ContinuousBatcher over the paged cache, on the full-width model."""
    import numpy as np

    from bitorch_engine_tpu_torch.models.generate import ContinuousBatcher
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(SEED)
    queue = [(rng.integers(0, vocab, int(rng.integers(32, 513))).tolist(), int(rng.integers(16, 65)))
             for _ in range(N_REQUESTS)]
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

    check(len(done) == N_REQUESTS, f"serving: {len(done)} of {N_REQUESTS} requests returned")
    for r, (_, n_new) in zip(done, queue):
        check(len(r.generated) == n_new and all(0 <= t < vocab for t in r.generated),
              f"serving: request {r.uid} returned {len(r.generated)} ids, wanted {n_new} in range")
    check(bool(torch.stack(finite).all()), "serving: non-finite logits")
    check(len(b.allocator.free) == SERVE["kv_pages"] - 1 and not b.allocator.table.any(),
          "serving: pages not all returned after run()")
    want_wb = LAYERS * tally["decode_steps"]
    want_ro = LAYERS * tally["chunks_after_first"]
    log(f"serving launches {counts}; decode steps {tally['decode_steps']}, prefill chunks "
        f"after the first {tally['chunks_after_first']}")
    check(counts["paged_prefix_attention_update"] == want_wb,
          f"serving: write-back kernel launched {counts['paged_prefix_attention_update']} != {want_wb}")
    check(counts["paged_prefix_attention"] == want_ro and want_ro > 0,
          f"serving: read-only kernel launched {counts['paged_prefix_attention']} != {want_ro}")
    generated = sum(n for _, n in queue)
    ttft = sorted(first_token_s.values())
    out = dict(
        requests=N_REQUESTS, wall_s=wall, requests_per_s=N_REQUESTS / wall,
        generated_tokens=generated, generated_tok_s=generated / wall,
        prompt_tokens=sum(len(p) for p, _ in queue),
        ttft_median_ms=statistics.median(ttft) * 1e3, ttft_max_ms=ttft[-1] * 1e3,
        admission_waves=tally["waves"], decode_steps=tally["decode_steps"],
        decode_ms_per_step_incl_admission=wall * 1e3 / max(1, tally["decode_steps"]),
        chunks_after_first=tally["chunks_after_first"], launches=counts, config=SERVE,
    )
    log(f"serving: {N_REQUESTS} requests in {wall:.3f} s ({out['requests_per_s']:.3f} req/s, "
        f"{out['generated_tok_s']:.1f} generated tok/s), median time to first token "
        f"{out['ttft_median_ms']:.1f} ms, {tally['decode_steps']} decode steps, "
        f"{tally['waves']} admission waves")
    return counts, out


def phase_paged_vs_dense(torch, model):
    """Phase 5c: one decode step with dense and with paged caches at batch 8
    (window 512) and 64 (window 256), in turns dense, paged, paged, dense."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches

    cfg = model.cfg
    out = {}
    for batch, window, clen in ((8, 512, 300), (64, 256, 200)):
        arms = {"dense": init_kv_caches(cfg, batch, CACHE, device="cuda"),
                "paged": paged_caches(torch, cfg, batch)}
        tok = torch.ones((batch, 1), dtype=torch.long, device="cuda")

        def timed(caches, steps=8):
            for _ in range(2):
                decode_step(model, tok, caches, clen, attn_window=window)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                decode_step(model, tok, caches, clen, attn_window=window)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps

        def busy(caches, steps=4):
            """Device busy ms per step and the largest kernels, profiled."""
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    decode_step(model, tok, caches, clen, attn_window=window)
                torch.cuda.synchronize()
            return _device_summary(torch, prof, time.perf_counter() - t0, steps, top=4)

        ms = {"dense": [], "paged": []}
        for arm in ("dense", "paged", "paged", "dense"):
            ms[arm].append(timed(arms[arm]))
        prof = {arm: busy(arms[arm]) for arm in ("dense", "paged")}
        r = dict(window=window, cache_len=clen, dense_ms=statistics.mean(ms["dense"]),
                 paged_ms=statistics.mean(ms["paged"]), runs=ms,
                 dense_busy_ms=prof["dense"]["device_busy_ms_per_call"],
                 paged_busy_ms=prof["paged"]["device_busy_ms_per_call"],
                 dense_launches=prof["dense"]["launches_per_call"],
                 paged_launches=prof["paged"]["launches_per_call"], profile=prof)
        r["paged_over_dense"] = r["paged_ms"] / r["dense_ms"]
        r["paged_over_dense_busy"] = r["paged_busy_ms"] / r["dense_busy_ms"]
        out[f"b{batch}"] = r
        log(f"paged vs dense decode b{batch} window {window}: dense {r['dense_ms']:.3f} ms/step, "
            f"paged {r['paged_ms']:.3f} ms/step, ratio {r['paged_over_dense']:.4f} (runs {ms}); "
            f"device busy dense {r['dense_busy_ms']:.3f} / paged {r['paged_busy_ms']:.3f} ms/step "
            f"(ratio {r['paged_over_dense_busy']:.4f}), launches/step dense "
            f"{r['dense_launches']:.0f} / paged {r['paged_launches']:.0f}")
        for arm in ("dense", "paged"):
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
    packed binary linear's XNOR GEMM)."""
    from bitorch_engine_tpu_torch.models import llama
    from bitorch_engine_tpu_torch.ops import binary_linear, mbwq_linear, mpq_linear
    from bitorch_engine_tpu_torch.ops.cuda.binary_gemm import xnor_gemm_ref
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
            mock.patch.object(binary_linear, "xnor_gemm", xnor_gemm_ref):
        yield


def phase_path_check(torch, gen):
    """Phase 6: 2 layers at full width, kernel path against plain path,
    both fed the kernel path's tokens, over dense and over paged caches."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = build_model(torch, 2, SEED + 1)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    rels = {}
    for cache in ("dense", "paged"):
        reset_launch_counts()
        got, toks = serve(torch, model, prompt, 4, paged=cache == "paged")
        launched = launch_counts()
        reset_launch_counts()
        with plain_kernels():
            want, _ = serve(torch, model, prompt, 4, forced=toks, paged=cache == "paged")
        torch.cuda.synchronize()
        check(all(n == 0 for n in launch_counts().values()), "the plain path launched a kernel")
        if cache == "paged":
            check(launched["paged_prefix_attention_update"] == 2 * 4,
                  f"paged path check: write-back launches {launched}")
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

def phase_quad_kernels(torch, gen, flush):
    """Phase 8a: kernel 5 against its plain version in f32 before ``sx``
    and the cast (max|d|/max|ref| <= 1e-4, tools/quad_gate.py's bar) with
    its activation quantization bit-equal, affine and mid_sym, then timed
    (the affine weights, which the MBWQ quantizer makes)."""
    from bitorch_engine_tpu_torch.ops.cuda import quad_matmul as qm
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import dequant_mpq_ref, prepare_for_kernel
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq

    rows = []
    for name, k, n, w_bit, gs in QUAD_SHAPES:
        w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        x = torch.randn(8, k, device="cuda", generator=gen).to(torch.bfloat16)
        qx, sx = qm.quantize_activations(x, w_bit)
        rqx, rsx = qm.quantize_activations_ref(x)
        q_equal = (torch.equal(qx, qm.kernel_order(rqx, w_bit).to(torch.int8))
                   and torch.equal(sx, rsx[:, 0]))
        errs = {}
        # mid_sym needs codes on both sides of the midpoint: not at 1 bit;
        # affine last, the tensor that is timed
        for mid in (True, False) if w_bit > 1 else (False,):
            qt = prepare_for_kernel(quantize_mpq(w, w_bit=w_bit, group_size=gs, mid_sym=mid),
                                    torch.bfloat16, act_bits=8)
            check(qt.act_bits == 8 and qt.zeros_mid == mid, f"kernel 5 {name}: regime {qt}")
            got = qm.mpq_matmul_a8(x, qt, accumulator=True)
            want = qm.mpq_matmul_a8_ref(x, qt, accumulator=True)
            err = (got - want).abs().max().item()
            errs[mid] = (err, err / want.abs().max().item())
        log(f"kernel mpq_matmul_a8 {name:18s} K={k} N={n} w{w_bit} g{gs} m=8  qx/sx bit-equal="
            f"{q_equal}  " + "  ".join(f"{'mid_sym' if mid else 'affine'} max|d|={e:.3e} rel={r:.3e}"
                                       for mid, (e, r) in sorted(errs.items())))
        check(q_equal and all(r <= 1e-4 for _, r in errs.values()),
              f"kernel 5 {name}: quantization equal {q_equal}, rel {errs}")
        w_bf16 = dequant_mpq_ref(qt, torch.bfloat16)
        meta = qt.packed.nbytes + qt.scales.nbytes + qt.zeros.nbytes
        bms, bby = bound(meta + x.nbytes + 8 * n * 2, 2 * 8 * k * n, INT8_OPS_PER_S)
        rows.append(dict(
            shape=name, K=k, N=n, w_bit=w_bit, group_size=gs, m=8, qx_bit_equal=q_equal,
            max_abs_err=max(e for e, _ in errs.values()), rel_err=max(r for _, r in errs.values()),
            rel_err_affine=errs[False][1], rel_err_mid_sym=errs.get(True, (None, None))[1],
            ms=time_ms(torch, lambda: qm.mpq_matmul_a8(x, qt), flush=flush),
            plain_ms=time_ms(torch, lambda: qm.mpq_matmul_a8_ref(x, qt), flush=flush),
            library_ms=None,
            yardstick_ms=time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush),
            bound_ms=bms, bound_by=bby,
        ))
        del w, qt, w_bf16
    for r in rows:
        log(f"time mpq_matmul_a8 {r['shape']:18s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"yardstick torch.matmul(bf16 weight) {r['yardstick_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    return rows


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
    version, the per-segment path it replaces (kernel 1 per segment on the
    sliced activations, and the add) and a bf16 ``torch.matmul`` on the
    stacked weight.  Returns the timed rows and every check."""
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import prepare_for_kernel
    from bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul import mbwq_matmul, mbwq_matmul_ref
    from bitorch_engine_tpu_torch.ops.mbwq_linear import dequantize_mbwq
    from bitorch_engine_tpu_torch.ops.mpq_linear import mpq_linear
    from bitorch_engine_tpu_torch.ops.quant import quantize_mpq
    from bitorch_engine_tpu_torch.qtensor import MBWQTensor

    rows, checks = [], []
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

        def per_segment():
            out, off = None, 0
            for seg in qt.segments:
                part = mpq_linear(x[:, off : off + seg.in_features], seg)
                out = part if out is None else out + part
                off += seg.in_features
            return out

        meta = sum(s.packed.nbytes + s.scales.nbytes + s.zeros.nbytes for s in qt.segments)
        bms, bby = bound(meta + x.nbytes + 8 * n * 2, 2 * 8 * k * n)
        ms = time_ms(torch, lambda: mbwq_matmul(x, qt), flush=flush)
        rows.append(dict(
            shape=name, K=k, N=n, m=8, segments=segs, max_abs_err=main["max_abs_err"],
            rel_err=main["rel_err"], ms=ms, per_launch_us=ms * 1e3,
            plain_ms=time_ms(torch, lambda: mbwq_matmul_ref(x, qt), flush=flush),
            per_segment_ms=time_ms(torch, per_segment, flush=flush),
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
    for r in rows:
        log(f"time mbwq_matmul {r['shape']:8s} kernel {r['ms']:.4f} ms  per-segment kernel 1 + add "
            f"{r['per_segment_ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  torch.matmul(bf16 weight) "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    return rows, checks


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
    from torch.profiler import ProfilerActivity, profile

    from bitorch_engine_tpu_torch.models.llama import decode_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            decode_step(model, tok, caches, pos + i, attn_window=bucket(pos + i + 1, MBWQ_WINDOW_FLOOR))
        torch.cuda.synchronize()
    return _device_summary(torch, prof, time.perf_counter() - t0, steps)


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
    del model
    torch.cuda.empty_cache()
    return rels


def phase_flash_bwd_kernels(torch, gen, flush):
    """Phase 11: kernel 4 against its plain version (max|d|/max|ref| <= 1e-2
    for each of dq, dk, dv, bf16 out), then timed beside its bound, its
    plain version and SDPA's backward (its forward + backward less its
    forward)."""
    from bitorch_engine_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    )

    F = torch.nn.functional
    rows = []
    for name, b, nh, nkv, s, d, causal in FLASH_BWD_SHAPES:
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
        rows.append(dict(
            shape=name, b=b, nh=nh, nkv=nkv, s=s, d=d, causal=causal,
            max_abs_err=max(errs.values()), rel_err=max(rels.values()), rel=rels,
            bf16_elements_differing=diff,
            ms=time_ms(torch, lambda: flash_attention_bwd(q, k, v, out, lse, do, causal), flush=flush),
            plain_ms=time_ms(torch, lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, causal),
                             reps=5, flush=flush),
            library_ms=sdpa_fwd_bwd_ms - sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
            sdpa_fwd_ms=sdpa_fwd_ms, bound_ms=bms, bound_by=bby,
        ))
        del q, k, v, do, out, lse, qs, ks, vs
        torch.cuda.empty_cache()
    for r in rows:
        log(f"time flash_attention_bwd {r['shape']:28s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  sdpa backward {r['library_ms']:.4f} ms (fwd+bwd "
            f"{r['sdpa_fwd_bwd_ms']:.4f} - fwd {r['sdpa_fwd_ms']:.4f})  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return rows


def build_train_model(torch, num_layers, seed):
    """The bench's 370M training configuration, random weights from
    ``seed``, in training mode."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, llama_370m_train
    from bitorch_engine_tpu_torch.utils.convert import prepare_for_training

    model = LlamaModel(llama_370m_train(num_layers=num_layers), device="cuda", seed=seed)
    return prepare_for_training(model)


def lm_loss(model, toks):
    """The bench's loss: next-token cross entropy over the batch."""
    from bitorch_engine_tpu_torch.training import cross_entropy_loss

    logits, _ = model(toks[:, :-1])
    return cross_entropy_loss(logits, toks[:, 1:])


def phase_train(torch, gen):
    """Phase 12: the training path at full width: warm-up, timed steps with
    the launch counts, one split step, one profiled step."""
    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(toks)["loss"])
    prof_summary = _device_summary(torch, prof, time.perf_counter() - t0, 1, top=10)
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


def phase_xnor_kernels(torch, gen, flush):
    """Phase 14: kernel 8 bit for bit against its plain version, then timed
    beside its bound, its plain version, the bf16 sign matmul and the
    port's m > 16 branch."""
    from bitorch_engine_tpu_torch.ops import packing
    from bitorch_engine_tpu_torch.ops.binary_linear import _packed_dot, sign_pm1
    from bitorch_engine_tpu_torch.ops.cuda.binary_gemm import xnor_gemm, xnor_gemm_ref
    from bitorch_engine_tpu_torch.qtensor import BinaryQTensor

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    popc_per_s = sms * POPC_PER_CLOCK_PER_SM * clock_mhz * 1e6
    log(f"kernel 8 bound: {sms} SMs x {POPC_PER_CLOCK_PER_SM} popc/clock x {clock_mhz:.0f} MHz = "
        f"{popc_per_s / 1e12:.3f} Tpopc/s; bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    rows = []
    for name, m, k, n in XNOR_SHAPES:
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(n, k, device="cuda", generator=gen)
        xw = packing.pack_signs(packing.pad_to_multiple(x, 1, 32, value=-1.0)[0])
        ww = packing.pack_signs(packing.pad_to_multiple(w, 1, 32, value=-1.0)[0])
        got = xnor_gemm(xw, ww, k)
        want = xnor_gemm_ref(xw, ww, k)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        equal = bool(torch.equal(got, want))
        log(f"kernel xnor_gemm {name:20s} m={m} K={k} N={n}  bit-equal={equal} max|d|={err}")
        check(equal, f"xnor_gemm {name}: not bit-equal to the plain version")
        kw = ww.shape[1]
        t_bytes = (xw.nbytes + ww.nbytes + m * n * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = m * n * kw / popc_per_s * 1e3
        x_bf = sign_pm1(x).to(torch.bfloat16)
        w_bf = packing.unpack_signs(ww, torch.bfloat16)[:, :k].contiguous()
        qt = BinaryQTensor(data=ww, scale_w=torch.ones((), device="cuda"), packed=True, in_features=k)
        rows.append(dict(
            shape=name, m=m, K=k, N=n, max_abs_err=err, rel_err=err, bit_equal=equal,
            ms=time_ms(torch, lambda: xnor_gemm(xw, ww, k), flush=flush),
            plain_ms=time_ms(torch, lambda: xnor_gemm_ref(xw, ww, k), reps=5, flush=flush),
            library_ms=None,
            yardstick_ms=time_ms(torch, lambda: torch.mm(x_bf, w_bf.T, out_dtype=torch.float32),
                                 flush=flush),
            fallback_ms=(time_ms(torch, lambda: _packed_dot(x, qt), flush=flush)
                         if m > 16 else None),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_bytes_ms=t_bytes, bound_popc_ms=t_ops,
        ))
        del x, w, xw, ww, x_bf, w_bf, got, want
    torch.cuda.empty_cache()
    for r in rows:
        fb = "n/a" if r["fallback_ms"] is None else f"{r['fallback_ms']:.4f}"
        log(f"time xnor_gemm {r['shape']:20s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"bf16 sign matmul {r['yardstick_ms']:.4f} ms  m>16 branch {fb} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; bytes {r['bound_bytes_ms']:.4f}, popc "
            f"{r['bound_popc_ms']:.4f})")
    big = [r for r in rows if r["shape"].startswith("4096_m")]
    over = [r["m"] for r in big if r["yardstick_ms"] < r["ms"]]
    crossover = min(over) if over else None
    log(f"kernel 8 at 4096^2: the bf16 sign matmul overtakes it at m = {crossover} "
        f"(m tried: {[r['m'] for r in big]}; the port switches above m = 16)")
    return rows, crossover


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
    from torch.profiler import ProfilerActivity, profile

    from bitorch_engine_tpu_torch.models.cnn import QuantConvNet
    from bitorch_engine_tpu_torch.models.mlp import QuantMLP
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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                float(step(data[MLP_STEPS])["loss"])
            prof_summary = _device_summary(torch, prof, time.perf_counter() - t0, 1, top=6)
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
            want = counts_with(xnor_gemm=SERVE_REPS if bits == 1 and batch <= 16 else 0)
            check(counts == want, f"MLP w{bits} serving b{batch}: launches {counts} != {want}")
            check(logits.shape == (batch, 10) and bool(torch.isfinite(logits).all()),
                  f"MLP w{bits} b{batch} logits")
            serve[batch] = dict(ms_per_forward=ms, launches=counts["xnor_gemm"])
        acc = float((model(x128).argmax(-1) == data[-1][1]).float().mean())
        out["mlp"][bits] = dict(losses=losses, train_acc=accs, step_ms=step_ms,
                                ms_per_step=statistics.median(step_ms), peak_train_gib=peak_train,
                                serve=serve, packed_acc_b128=acc, profile=prof_summary)
        log(f"QuantMLP w{bits}: {statistics.median(step_ms):.3f} ms/step (median of {MLP_STEPS}), "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, train acc {accs[-1]:.3f}; packed "
            f"forward b8 {serve[SERVE_BATCH]['ms_per_forward']:.4f} ms ({serve[SERVE_BATCH]['launches']} "
            f"kernel-8 launches in {SERVE_REPS}), b128 {serve[MLP_BATCH]['ms_per_forward']:.4f} ms; "
            f"acc on a held-out batch {acc:.3f}; peak {peak_train:.3f} GiB")
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
    path on the card (bit-equal); one train step of the binary MLP and of
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
    reset_launch_counts()
    got = model(x[:SERVE_BATCH])
    check(launch_counts() == counts_with(xnor_gemm=1), f"packed path check launches {launch_counts()}")
    with plain_kernels():
        want = model(x[:SERVE_BATCH])
    torch.cuda.synchronize()
    check(launch_counts() == counts_with(xnor_gemm=1), "the plain packed path launched a kernel")
    res["packed_logits_bit_equal"] = bool(torch.equal(got, want))
    log(f"path check packed binary MLP b{SERVE_BATCH}: kernel 8 vs plain logits bit-equal "
        f"{res['packed_logits_bit_equal']}")
    check(res["packed_logits_bit_equal"], "packed MLP logits: kernel 8 differs from the plain path")

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

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MiB > L2
    per_shape = phase_kernels(torch, gen, flush)
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
    per_shape["mpq_matmul_a8"] = phase_quad_kernels(torch, gen, flush)
    per_shape["mbwq_matmul"], mbwq_checks = phase_mbwq_kernels(torch, gen, flush)
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
    per_shape["xnor_gemm"], crossover = phase_xnor_kernels(torch, gen, flush)
    del flush
    torch.backends.cudnn.allow_tf32 = True  # the port's convs must not rely on the caller's flag
    qat = phase_qat_e2e(torch, gen)
    qat["path_check"] = phase_qat_path_check(torch, gen)
    torch.backends.cudnn.allow_tf32 = False
    qat["xnor_crossover_m_4096"] = crossover

    checks = {
        "mpq_matmul": "max|d|/max|ref| <= 1e-3 (f32, pre-cast) per shape",
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
                               "per shape, affine and mid_sym; activation codes and sx bit-equal")
    checks["mbwq_matmul"] = ("max|d|/max|ref| <= 1e-3 (f32, pre-cast) per shape and per check "
                             "(m 1-512, w1/w2/w4/w8 mixes, f32 metadata, ragged N, f32 activations); "
                             "a second launch bit-equal; the bf16 out the f32 out cast")
    checks["flash_attention_bwd"] = ("max|d|/max|ref| <= 1e-2 for each of dq, dk, dv (bf16 out) per "
                                     "shape")
    checks["xnor_gemm"] = "bit-equal (f32 integers) per shape"
    kernels = []
    for name in ("mpq_matmul", "dequant_mpq"):
        rows = per_shape[name]
        per = f"one {'decode step' if name == 'mpq_matmul' else 'prefill'} of the main path"
        kernels.append(kernel_line(name, rows, counts[name], {r["shape"]: PER_PASS[r["shape"]] for r in rows},
                                   per, checks[name]))
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
    kernels.append(line)
    line = kernel_line("mbwq_matmul", per_shape["mbwq_matmul"],
                       mbwq["a16"]["launches"]["mbwq_matmul"], {p: LAYERS for p in MBWQ_PROJ},
                       "one A16 decode step of the MBWQ-2.5 path (every projection)",
                       checks["mbwq_matmul"])
    line["per_segment_ms"] = sum(LAYERS * r["per_segment_ms"] for r in per_shape["mbwq_matmul"])
    line["per_launch_us"] = {r["shape"]: r["per_launch_us"] for r in per_shape["mbwq_matmul"]}
    line["max_rel_err_all_checks"] = max(c["rel_err"] for c in mbwq_checks)
    line["checks"] = mbwq_checks
    kernels.append(line)
    # the training path (phase 12): one backward (a dq and a dkv launch) per
    # layer per step, reckoned at the training shape; library: SDPA's backward
    line = kernel_line("flash_attention_bwd", per_shape["flash_attention_bwd"],
                       train_counts["flash_attention_bwd"], {FLASH_TRAIN: TRAIN_LAYERS},
                       "one train step of the 370M path (24 backward calls of 2 launches)",
                       checks["flash_attention_bwd"])
    line["library"] = "scaled_dot_product_attention backward (forward + backward less forward)"
    kernels.append(line)
    # the binary path (phase 15): one launch per packed forward of the
    # binary MLP at batch 8, reckoned at 1024 x 1024, m 8
    line = kernel_line("xnor_gemm", per_shape["xnor_gemm"], qat["mlp"][1]["serve"][SERVE_BATCH]["launches"],
                       {"mlp_1024_m8": 1}, "one packed forward of the binary MLP at batch 8",
                       checks["xnor_gemm"])
    line["yardstick_ms"] = shape_row(per_shape["xnor_gemm"], "mlp_1024_m8")["yardstick_ms"]
    line["yardstick"] = ("torch.mm of the bf16 +-1 activations by the unpacked bf16 +-1 weight, f32 out "
                         "(no PyTorch call computes an XNOR-popcount GEMM)")
    kernels.append(line)
    log(json.dumps({"e2e": e2e, "serving": serving, "paged_vs_dense": paged_vs_dense,
                    "path_check_rel": path_rel, "paged_gate": gate, "mbwq": mbwq, "train": train,
                    "qat": qat, "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
