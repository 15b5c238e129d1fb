"""The share of the traced iterations' device-idle time that Python's
garbage collector holds: the gaps between the trace's device intervals
inside the ``perfbench.admit`` and ``perfbench.step`` spans, covered by
the program's ``bie.gc`` records placed on the trace's clock.  Read only
where the program's traced ``bie.batcher.step`` records land inside the
trace's step spans (the clocks agree and the collector's hook was in)."""

from perfbench.lib import spans


def read(run):
    tr = run.trace
    recs = spans.window_records(run)
    if recs is None or tr is None or not tr.device:
        return None  # no program spans, or no device event in the trace
    steps = tr.spans_named("step")
    mine = spans.on_trace(run, recs, "bie.batcher.step")
    if not steps or not any(s.start <= a and b <= s.end for a, b in mine for s in steps):
        return None
    gaps = spans.idle_gaps(tr, tr.spans_named("admit") + steps)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    return 100.0 * spans.overlap(gaps, spans.on_trace(run, recs, "bie.gc")) / idle
