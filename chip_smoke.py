#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bitorch_engine_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bitorch_engine_tpu_torch/csrc`` and
then, failing on the first check that does not hold:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and the kernels' build time;
2. holds each kernel against its plain PyTorch version at the shapes of the
   Llama-3-8B w4 g128 serving path (tolerances below);
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
5. compares prefill + 4 decode steps of a 2-layer full-width model between
   the kernel path and the plain path on the card.

It prints one JSON line describing the kernels and, as its last line,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    "mpq_matmul": "bitorch_engine_tpu/ops/pallas/dequant_matmul.py:365",
    "dequant_mpq": "bitorch_engine_tpu/ops/pallas/dequant_matmul.py:789",
    "flash_attention": "bitorch_engine_tpu/ops/pallas/flash_attention.py:75",
}
SOURCES = {
    "mpq_matmul": "bitorch_engine_tpu_torch/csrc/dequant_matmul.cu",
    "dequant_mpq": "bitorch_engine_tpu_torch/csrc/dequant_matmul.cu",
    "flash_attention": "bitorch_engine_tpu_torch/csrc/flash_attention.cu",
}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bucket(n: int) -> int:
    """The bench's attention window: smallest power of 2 >= n, floor 256."""
    w = 256
    while w < n:
        w *= 2
    return min(w, CACHE)


def time_ms(torch, fn, reps: int = 20, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the L2 cache overwritten before each one."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
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

    # kernel 3: the prefill's attention, and one d = 64 shape
    for b, nh, nkv, s, d in ((BATCH, 32, 8, PROMPT, 128), (4, 16, 4, 512, 64)):
        q = torch.randn(b, nh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
        k = torch.randn(b, nkv, s, d, device="cuda", generator=gen).to(torch.bfloat16)
        v = torch.randn(b, nkv, s, d, device="cuda", generator=gen).to(torch.bfloat16)
        out, lse = flash_attention(q, k, v)
        ref_out, ref_lse = flash_attention_ref(q, k, v)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_rel = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1e-6)).max().item()
        ok = torch.allclose(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
        log(f"kernel flash_attention b={b} nh={nh} nkv={nkv} s={s} d={d}  "
            f"max|d out|={err:.3e} lse rel={lse_rel:.3e}")
        check(ok and lse_rel <= 1e-4, f"flash_attention d={d}: out err {err}, lse rel {lse_rel}")
        nbytes = (q.nbytes + k.nbytes + v.nbytes) + out.nbytes + lse.nbytes
        ops = b * nh * 4 * d * s * (s + 1) / 2  # QK^T and PV over the causal pairs
        b3, by3 = bound(nbytes, ops)
        results["flash_attention"].append(dict(
            shape=f"b{b}_nh{nh}_nkv{nkv}_s{s}_d{d}", max_abs_err=err, rel_err=lse_rel,
            ms=time_ms(torch, lambda: flash_attention(q, k, v), flush=flush),
            plain_ms=time_ms(torch, lambda: flash_attention_ref(q, k, v), flush=flush),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), flush=flush),
            bound_ms=b3, bound_by=by3,
        ))
    for name, rows in results.items():
        for r in rows:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"time {name:16s} {r['shape']:24s} kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library {lib} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    return results


def build_model(torch, num_layers, seed):
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, llama3_8b_serving
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    cfg = llama3_8b_serving(max_seq_len=CACHE, num_layers=num_layers)
    model = LlamaModel(cfg, device="cuda", seed=seed)
    return prepare_params_for_cuda(model, meta_dtype=torch.bfloat16)


def serve(torch, model, prompt, steps, on_prefill=None, forced=None):
    """prefill (window 0) + greedy decode steps with the bucketed window;
    returns (last logits, generated tokens (b, steps + 1))."""
    from bitorch_engine_tpu_torch.models.llama import decode_step, init_kv_caches, prefill

    caches = init_kv_caches(model.cfg, BATCH, CACHE, device="cuda")
    logits, caches = prefill(model, prompt, caches)
    last = logits[:, -1]
    if on_prefill is not None:
        on_prefill(logits)
    tok = torch.argmax(last, dim=-1) if forced is None else forced[:, 0]
    toks = [tok]
    for i in range(steps):
        pos = PROMPT + i
        last, caches = decode_step(model, tok[:, None], caches, pos, attn_window=bucket(pos + 1))
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


def phase_e2e(torch, gen):
    """Phase 4: the full-width serving path, with the launch counts."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    model = build_model(torch, LAYERS, SEED)
    torch.cuda.synchronize()
    log(f"e2e model: Llama-3-8B w4 g128, {LAYERS} layers, built in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
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
    check(pre == {"mpq_matmul": 0, "dequant_mpq": proj, "flash_attention": LAYERS},
          f"prefill launches {pre}")
    check(counts == {"mpq_matmul": proj * DECODE_STEPS, "dequant_mpq": proj,
                     "flash_attention": LAYERS}, f"run launches {counts}")
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
    del model
    torch.cuda.empty_cache()
    return counts, e2e


@contextmanager
def plain_kernels():
    """Route the model's three kernel calls to their plain versions."""
    from bitorch_engine_tpu_torch.models import llama
    from bitorch_engine_tpu_torch.ops import mpq_linear
    from bitorch_engine_tpu_torch.ops.cuda.dequant_matmul import dequant_mpq_ref, mpq_matmul_ref
    from bitorch_engine_tpu_torch.ops.cuda.flash_attention import flash_attention_ref

    with mock.patch.object(mpq_linear, "mpq_matmul", mpq_matmul_ref), \
            mock.patch.object(mpq_linear, "dequant_mpq", dequant_mpq_ref), \
            mock.patch.object(llama, "flash_attention", flash_attention_ref):
        yield


def phase_path_check(torch, gen):
    """Phase 5: 2 layers at full width, kernel path against plain path,
    both fed the kernel path's tokens."""
    from bitorch_engine_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = build_model(torch, 2, SEED + 1)
    prompt = torch.randint(0, model.cfg.vocab_size, (BATCH, PROMPT), device="cuda", generator=gen)
    got, toks = serve(torch, model, prompt, 4)
    reset_launch_counts()
    with plain_kernels():
        want, _ = serve(torch, model, prompt, 4, forced=toks)
    torch.cuda.synchronize()
    check(all(n == 0 for n in launch_counts().values()), "the plain path launched a kernel")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"path check (2 layers, prefill + 4 decode steps): max|d logits|/max|logits| = {rel:.3e}")
    check(rel <= 2e-2, f"path check: {rel} > 2e-2")
    del model
    torch.cuda.empty_cache()
    return rel


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
    del flush
    counts, e2e = phase_e2e(torch, gen)
    path_rel = phase_path_check(torch, gen)

    checks = {
        "mpq_matmul": "max|d|/max|ref| <= 1e-3 (f32, pre-cast) per shape",
        "dequant_mpq": "bit-equal (bf16)",
        "flash_attention": "out atol 1e-2 rtol 1e-2 (bf16 out); lse rtol 1e-4",
    }
    per_pass = {"mpq_matmul": "decode step", "dequant_mpq": "prefill",
                "flash_attention": "prefill"}
    kernels = []
    for name, rows in per_shape.items():
        if name == "flash_attention":
            main_rows, weights = rows[:1], [LAYERS]
        else:
            main_rows, weights = rows, [PER_PASS[r["shape"]] for r in rows]

        def total(key):
            vals = [r[key] for r in main_rows]
            return None if None in vals else sum(w * v for w, v in zip(weights, vals))

        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
            tpu_counterpart=TPU_KERNELS[name], launches=counts[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            check=checks[name], max_err=max(r["rel_err"] for r in rows),
            per=f"one {per_pass[name]} of the main path",
            ms=total("ms"), plain_ms=total("plain_ms"), library_ms=total("library_ms"),
            bound_ms=total("bound_ms"), bound_by=main_rows[0]["bound_by"], shapes=rows,
        ))
    log(json.dumps({"e2e": e2e, "path_check_rel": path_rel,
                    "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
