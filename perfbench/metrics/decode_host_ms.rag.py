"""The host's own time a decode step: the median, over the window's
unprofiled steps, of the program's ``bie.batcher.step`` span less its
``bie.batcher.read`` (the read of the step's tokens, where the host waits
on the device)."""

from perfbench.lib import spans
from perfbench.lib.cells import percentile


def read(run):
    recs = spans.window_records(run)
    if recs is None:
        return None  # the program keeps no spans
    reads = spans.child_walls(recs, "bie.batcher.read")
    own = [r.end - r.start - reads[r.id]
           for r in spans.named(recs, "bie.batcher.step", unprofiled_in=run)]
    return percentile(own, 50) * 1e3 if own else None
