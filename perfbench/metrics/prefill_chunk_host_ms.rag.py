"""The host's wall a prefill chunk forward: the median, over the window's
unprofiled iterations, of the program's ``bie.batcher.chunk`` spans (one
chunk's launches; a chunk ends in no host read)."""

from perfbench.lib import spans
from perfbench.lib.cells import percentile


def read(run):
    recs = spans.window_records(run)
    if recs is None:
        return None  # the program keeps no spans
    walls = [r.end - r.start for r in spans.named(recs, "bie.batcher.chunk", unprofiled_in=run)]
    return percentile(walls, 50) * 1e3 if walls else None
