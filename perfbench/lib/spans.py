"""The program's own spans and counts, read for the per-layer metrics.

The port records spans in memory (``bitorch_engine_tpu_torch.utils.
profiling``: ``records()``, each with a name, an id, its parent's id,
start and end on ``time.perf_counter`` (the harness's clock), counts and
request uids).  The coarse ones (the serving loop's ``bie.batcher.*``) are
recorded in every iteration, so a reader can keep to the unprofiled
iterations; the fine ones (``bie.moe.*``, ``bie.gc``, the train step's)
only in the traced ones.  ``to_trace_us`` places a stamp on the device
trace's clock, given the trace file's ``baseTimeNanoseconds``.

A program without these records (an older commit) gives ``None`` here,
and every reader of them then reports nothing.
"""

from __future__ import annotations

import collections
import gzip
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import reading
from .cells import trace_path
from .trace import merged

_BASE = re.compile(r'"baseTimeNanoseconds"\s*:\s*(\d+)')


def program():
    """The port's profiling module where it keeps span records, else None."""
    try:
        from bitorch_engine_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, a) for a in ("records", "to_trace_us", "RING_SIZE")):
        return None
    return profiling


def window_records(run) -> Optional[list]:
    """The program's closed spans that started inside the run's window;
    None when it keeps none, or its ring no longer reaches back to the
    window's start."""
    prof = program()
    if prof is None:
        return None
    recs = prof.records()
    t0, t1 = run.window
    if len(recs) >= prof.RING_SIZE and min(r.start for r in recs) > t0:
        return None
    return [r for r in recs if t0 <= r.start <= t1]


def named(recs, name: str, unprofiled_in=None) -> list:
    """``recs`` named ``name``; with a run, those outside its profiled
    iterations only."""
    out = [r for r in recs if r.name == name]
    if unprofiled_in is not None:
        out = [r for r in out if reading.unprofiled(unprofiled_in, r.start)]
    return out


def child_walls(recs, name: str) -> Dict[int, float]:
    """The summed wall of the spans named ``name`` under each parent id."""
    out: Dict[int, float] = collections.defaultdict(float)
    for r in recs:
        if r.name == name:
            out[r.parent] += r.end - r.start
    return out


def count_sum(recs, key: str) -> int:
    return sum(r.counts.get(key, 0) for r in recs)


def trace_base_ns(path: Path) -> int:
    """The trace file's ``baseTimeNanoseconds`` (Kineto writes it before
    the events; 0 where the file has none: absolute stamps)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        m = _BASE.search(fh.read(1 << 16))
    if m:
        return int(m.group(1))
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return int(data.get("baseTimeNanoseconds", 0)) if isinstance(data, dict) else 0


def on_trace(run, recs, name: str) -> List[Tuple[float, float]]:
    """The records named ``name`` as (start, end) on the run's trace clock."""
    prof = program()
    base = trace_base_ns(trace_path(run.plan))
    return [(prof.to_trace_us(r.start, base), prof.to_trace_us(r.end, base))
            for r in recs if r.name == name]


def idle_gaps(trace, spans) -> List[Tuple[float, float]]:
    """The device's idle intervals inside each of ``spans`` (trace µs):
    the span less the union of the trace's device intervals."""
    out = []
    for sp in spans:
        prev = sp.start
        for a, b in merged(trace.device, sp.start, sp.end):
            if a > prev:
                out.append((prev, a))
            prev = max(prev, b)
        if sp.end > prev:
            out.append((prev, sp.end))
    return out


def overlap(intervals, cover) -> float:
    """The length of ``intervals`` that ``cover`` covers (µs)."""
    cover = merged(cover, float("-inf"), float("inf"))
    total = 0.0
    for a, b in intervals:
        for c, d in cover:
            if c >= b:
                break
            total += max(0.0, min(b, d) - max(a, c))
    return total
