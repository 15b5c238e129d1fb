"""The device's idle share of a train step: 1 − (device busy a traced step,
the union of kernel, copy and set intervals in its span) ÷ (the median
host wall of the window's unprofiled steps)."""

from perfbench.lib.cells import percentile


def read(run):
    if not run.trace.device:
        return None  # no device event in the trace
    tr = run.trace
    spans = tr.spans_named("train_step")
    walls = [s["t1"] - s["t0"] for s in run.data["window_steps"] if not s["profiled"]]
    if not spans or not walls:
        return None
    busy = sum(tr.busy_s(sp.start, sp.end) for sp in spans) / len(spans)
    return 100.0 * (1.0 - busy / percentile(walls, 50))
