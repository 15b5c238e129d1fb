"""Median host wall of one ``step()`` (a decode step of every active slot,
ending in the host's read of its tokens), over the window's unprofiled
steps."""

from perfbench.lib import reading
from perfbench.lib.cells import percentile


def read(run):
    walls = [it.step[1] - it.step[0] for it in reading.plain_iters(run) if it.step is not None]
    return percentile(walls, 50) * 1e3 if walls else None
