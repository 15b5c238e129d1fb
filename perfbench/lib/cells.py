"""One run of a cell: set-up, the measured window, the traced stretch, the check.

``run_cell`` picks the loop by the mix's ``kind`` and returns the result
line's fields.  The end-to-end metrics are taken by the benchmark itself
on the host clock over the whole window; the per-layer metrics come from
the readers under ``metrics/``, which read the run record (the
benchmark's own spans and counts, and the trace of a fixed stretch of work
inside the window).  After the window closes and the memory peak is read,
the program's state is freed and the reference judges what the timed path
produced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import trace as trace_lib
from .bench import Plan
from .flops import Shape
from .peaks import card_peaks

clock = time.perf_counter


def percentile(values: List[float], q: float) -> float:
    """The ``q`` percentile (0-100) by linear interpolation (numpy's)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    plan: Plan
    shape: Shape
    peaks: Dict[str, float]
    window: tuple  # (t0, t1) host clock
    data: Dict[str, Any]  # the loop's record (spans, requests, steps)
    trace: Optional[trace_lib.Trace] = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def classify(self, kernel: str) -> Optional[str]:
        return self.plan.kernel_class(kernel)


class Profiled:
    """A ``torch.profiler`` over a fixed stretch of loop iterations: one
    warm-up iteration (discarded), then ``active`` traced ones."""

    def __init__(self, path: Path, active: int, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.left = active + 1
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.done = False

        def export(prof):
            prof.export_chrome_trace(str(path))

        self.prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=active, repeat=1),
                            on_trace_ready=export)
        self.prof.start()

    def step(self) -> None:
        self.prof.step()
        self.left -= 1
        if self.left == 0:
            self.prof.stop()
            self.done = True


def span_fn(tracing: bool):
    """Spans for the trace: ``record_function`` when tracing, else nothing."""
    if not tracing:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return lambda name: record_function(trace_lib.SPAN_PREFIX + name)


def warm_profiler() -> None:
    """CUPTI's first start is slow: pay it in set-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").sum().item()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def trace_path(plan: Plan) -> Path:
    d = plan.root / ".perfbench_cache"
    d.mkdir(exist_ok=True)
    return d / f"trace-{plan.workload}.json.gz"


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def serve_e2e(run: Run) -> Dict[str, float]:
    """The serving cell's end-to-end metrics over the whole window: the
    tails of time to first token (a request still waiting at the close
    counts with its wait) and of the gaps between a request's tokens."""
    t0, t1 = run.window
    ttft, gaps = [], []
    for r in run.data["recs"]:
        if t0 <= r.t_submit <= t1:
            first = r.t_first if r.t_first is not None and r.t_first <= t1 else t1
            ttft.append(first - r.t_submit)
        times = r.token_times
        gaps += [b - a for a, b in zip(times, times[1:]) if a >= t0 and b <= t1]
    return {
        "ttft_p90_ms": percentile(ttft, 90) * 1e3,
        "itl_p90_ms": percentile(gaps, 90) * 1e3,
    }


def run_serve(plan: Plan, seed: int, seconds: float, tracing: bool, device, t_start: float,
              check: bool = True) -> Dict[str, Any]:
    from . import serve

    loop = serve.ServeLoop(plan, seed, device)
    span = span_fn(tracing)
    cuda = torch.device(device).type == "cuda"
    if tracing and cuda:
        warm_profiler()
    loop.warm_up(span)
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock() - t_start
    t0 = clock()
    prof = None
    trace_at = t0 + plan.mix["trace"]["start_share"] * seconds
    while True:
        if tracing and prof is None and clock() >= trace_at:
            prof = Profiled(trace_path(plan), plan.mix["trace"]["iterations"], cuda)
        it = loop.iteration(span)
        if prof is not None and not prof.done:
            it.profiled = True
            prof.step()
        if clock() >= t0 + seconds and (not tracing or (prof is not None and prof.done)):
            break
    t1 = clock()
    loop.log_routes(False)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    data = {"recs": list(loop.recs.values()), "iters": loop.iters, "max_len": loop.max_len,
            "prefill_chunk": plan.mix["batcher"]["prefill_chunk"]}
    loop.close()
    out = {"setup_s": setup_s, "window": (t0, t1), "data": data, "memory_peak_bytes": peak}
    if check:
        out["checks"] = check_serve(plan, seed, data, (t0, t1), device)
    return out


def check_serve(plan: Plan, seed: int, data, window, device, control: bool = False
                ) -> Dict[str, Dict[str, float]]:
    """The served tokens against the reference: a sample, drawn from the
    seed, of the requests finished in the window, with the
    longest in it; the reference runs once over each prompt with its
    served tokens, along the experts the program routed them to (the
    configuration's architecture's ``logits_at``).
    Numbers compared: ``served_gap_mean``, the mean gap by which a served
    token's reference logit lies below the reference's best at its
    position; ``served_far``, how many served tokens lie more than the
    limits file's ``far_gap`` logits below it (limit 0: one wrong token
    fails the run); and for a model with routed layers ``route_gap_mean``
    (``reference/llama_ref.py``).  The widest of each gap is printed beside
    them, with no limit (the fp8 control reads under three times the
    program's there: PERF.md §2).
    ``control``: the same two for the fp8 control in the program's place
    (its own routes; its first token at each position)."""
    from ..reference.llama_ref import served_gaps

    logits_at = plan.arch.logits_at
    t0, t1 = window
    moe = plan.shape.routed_layers > 0
    done = [r for r in data["recs"] if r.t_done is not None and t0 <= r.t_done <= t1]
    n = plan.mix["check"]["requests"]
    longest = max(done, key=lambda r: r.prompt_len + len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 7])
    pick = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), min(n - 1, len(rest)),
                                                            replace=False))]
    seqs, wanted, toks = [], [], []
    for r in pick:
        ids = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append(torch.as_tensor(ids, dtype=torch.int64, device=device))
        wanted.append(torch.arange(r.prompt_len - 1, r.prompt_len - 1 + len(r.tokens), device=device))
        toks.append(list(r.tokens))
    routes = [r.route_table().to(device) for r in pick] if moe else None
    limits = plan.limits
    st: Dict[str, Any] = {}
    ref = logits_at(plan.config, seed, seqs, wanted, device, ("f32",), routes, st)["f32"]
    far = limits["far_gap"]
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in served_gaps(ref, toks, far).items()}
    if moe:
        out.update(route_numbers(st["f32"], limits))
    out["served_tokens"] = {"value": float(sum(len(t) for t in toks)), "limit": None}
    if control:
        cst: Dict[str, Any] = {}
        ctl = logits_at(plan.config, seed, seqs, wanted, device, ("fp8",), None, cst)["fp8"]
        rst: Dict[str, Any] = {}
        along = cst["fp8"].get("routes")
        ref2 = logits_at(plan.config, seed, seqs, wanted, device, ("f32",), along, rst)["f32"]
        firsts = [c.argmax(dim=-1).tolist() for c in ctl]
        c = served_gaps(ref2, firsts, far)
        if moe:
            c.update({k: v["value"] for k, v in route_numbers(rst["f32"], limits).items()})
        out.update({f"control_{k}": {"value": v, "limit": limits.get(k)} for k, v in c.items()})
    return out


def route_numbers(st: Dict[str, Any], limits) -> Dict[str, Dict[str, float]]:
    """The routing stage judged by itself: the widest and the mean
    shortfall of a followed expert's reference probability under the
    reference's k-th best, over every layer and position."""
    vals = {"route_gap": st["route_gap"],
            "route_gap_mean": st["route_short_sum"] / max(1, st["route_rows"])}
    return {k: {"value": v, "limit": limits.get(k)} for k, v in vals.items()}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def correct_of(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["limit"] is None or c["value"] <= c["limit"] for name, c in checks.items()
               if not name.startswith("control_"))


def run_cell(plan: Plan, seed: int, seconds: float, tracing: bool, device, t_start: float,
             check: bool = True) -> Dict[str, Any]:
    """One run: returns the result line's fields but ``device``."""
    kind = plan.mix["kind"]
    if kind == "closed_loop":
        raw = run_serve(plan, seed, seconds, tracing, device, t_start, check)
        e2e_fn = serve_e2e
        attempted = sum(raw["window"][0] <= r.t_submit <= raw["window"][1]
                        for r in raw["data"]["recs"])
        failed = 0
    elif kind == "train_steps":
        from .train_cell import run_train, train_e2e

        raw = run_train(plan, seed, seconds, tracing, device, t_start, check)
        e2e_fn = train_e2e
        attempted = len(raw["data"]["window_steps"])
        failed = raw["data"]["failed"]
    else:
        raise ValueError(f"unknown mix kind {kind!r}")
    shape = plan.shape
    peaks = card_peaks(torch.cuda.get_device_name() if torch.cuda.is_available() else "H100")
    run = Run(plan, shape, peaks, raw["window"], raw["data"])
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if tracing:
        run.trace = trace_lib.parse(trace_lib.load_events(str(trace_path(plan))))
        bad = trace_lib.unclaimed(run.trace, run.classify)
        if bad:
            raise RuntimeError("device kernels that no pattern under perfbench/kernels "
                               "claims as their class:\n  " + "\n  ".join(bad))
        for m in plan.per_layer:
            v = plan.reader(m)(run)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        breakdown = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    else:
        values = e2e_fn(run)
        values["setup_s"] = raw["setup_s"]
        for m in plan.end_to_end:
            metrics[m.name] = {"value": values[m.name], "unit": m.unit}
    checks = raw.get("checks", {})
    out = {"correct": bool(checks) and correct_of(checks), "attempted": attempted,
           "failed": failed, "metrics": metrics, "memory_peak_bytes": raw["memory_peak_bytes"]}
    if tracing:
        out["busy_s"] = run.trace.busy_s()
        out["window_s"] = run.trace.window_s()
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["run"] = run
    return out
