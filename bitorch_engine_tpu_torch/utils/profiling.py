"""Profiling, tracing and roofline reporting over ``torch.profiler``.

The counterpart of ``bitorch_engine_tpu/utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler.profile`` (CPU
  and, where there is a card, CUDA activities) that exports a Chrome trace
  into a directory; :func:`device_op_table` reads such a directory back
  into a per-kernel device-time table;
* :func:`annotate`: the program's span, :func:`count` a count on the
  innermost open one, :func:`records` the closed spans kept, and
  :func:`to_trace_us` a span's stamp on a device trace's clock (see
  "Spans" below);
* :class:`RooflineReport`: achieved-versus-peak bandwidth and FLOP/s per
  measured op, on the peaks of :data:`CHIP_SPECS`;
* :func:`profiler` and :func:`device_summary`: one profiled region's host
  wall, device busy time, idle share, launches and largest kernels per
  call; :func:`host_profile`: ``cProfile`` of a callable, per Python
  function.

The peaks are the card's own (the H100 SXM's datasheet figures); the port
states no rate for a TPU.

Spans
-----

``with annotate("bie.batcher.step", uids=...) as rec:`` records one span:
a name, an id, the id of the span open around it (its parent, from
nesting, per thread), start and end stamps on ``time.perf_counter``, the
request uids it served and a small dict of integer counts, to which
``count(key, n)`` adds on the innermost open span.  Closed spans go to a
ring of the last :data:`RING_SIZE` (:func:`records`); nothing is written
to disk.  Two levels, with no switch:

* *coarse* spans (the default) are always recorded, for two clock reads
  and one append; the serving loop's few an iteration are coarse, so a
  reader sees every iteration, profiled or not;
* *fine* spans (``fine=True``: the MoE's phases, the train step's,
  DiodeMix's, the collector's) are recorded only while a
  ``torch.profiler`` records (``torch.autograd._profiler_enabled()``);
  otherwise they cost that one check, return ``None``, and a count made
  inside one lands on the coarse span around it.

While a profiler records, every span also opens a ``record_function`` of
its name, so the spans show in the trace, and a ``gc.callbacks`` hook
records each collection as a ``bie.gc`` span (its generation and the
objects it collected as counts).  The hook goes in at the first span that
sees a profiler and out at the first that sees none.

The stamps are on the benchmark's clock.  A Kineto trace's ``ts`` is
``(CLOCK_REALTIME ns - the file's baseTimeNanoseconds) / 1000``; the
module samples the offset of the real-time clock from ``perf_counter``
at import and at every start of a profiler, and :func:`to_trace_us` puts
a stamp on the trace's clock with the sample taken last before it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import glob
import gzip
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

# (HBM GB/s, dense bf16 TFLOP/s, dense int8 TOP/s) per device
CHIP_SPECS: Dict[str, Dict[str, float]] = {
    "h100": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0, "int8_tops": 1979.0},
    "cpu": {"hbm_gbps": 50.0, "bf16_tflops": 1.0, "int8_tops": 2.0},
}

_TRACE_SEQ = itertools.count()


def detect_chip() -> str:
    """``"h100"`` when device 0 is an H100, else ``"cpu"``."""
    try:
        if torch.cuda.is_available() and "h100" in torch.cuda.get_device_name(0).lower():
            return "h100"
    except (RuntimeError, AssertionError):
        pass
    return "cpu"


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def profiler(**kwargs):
    """A ``torch.profiler.profile`` over the CPU and the card (the CPU alone
    without one), ``kwargs`` passed on (a ``schedule``, say); use it as a
    context manager, or ``start()`` / ``stop()``."""
    from torch.profiler import profile

    return profile(activities=_activities(), **kwargs)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block and export a Chrome trace
    (``<logdir>/trace_<pid>_<n>.pt.trace.json``) viewable in Perfetto or
    ``chrome://tracing``; yields the profiler.  The card is synchronised
    before the profiler stops, so every kernel of the block is in it."""
    os.makedirs(logdir, exist_ok=True)
    with profiler() as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.pt.trace.json"))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

RING_SIZE = 1 << 16

_clock = time.perf_counter
_profiler_enabled = torch.autograd._profiler_enabled


def _trace_enter(name: str):
    """Open a ``record_function`` of ``name`` (the profiler's own ops,
    without the Python wrapper's work between its stamp and ours)."""
    return torch.ops.profiler._record_function_enter_new(name, None)


def _trace_exit(handle) -> None:
    torch.ops.profiler._record_function_exit._RecordFunction(handle)


@dataclasses.dataclass(slots=True, eq=False)
class SpanRecord:
    """One closed span; ``start`` / ``end`` in ``time.perf_counter``
    seconds, ``parent`` the id of the span open around it (0: none)."""

    name: str
    id: int
    parent: int
    start: float
    end: float = 0.0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    uids: Tuple[int, ...] = ()


_ring: "collections.deque[SpanRecord]" = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_local = threading.local()
# what the last span saw of the profiler, and the open collection (the
# collector's start and stop callbacks pair up in one thread)
_profiling = False
_turn_lock = threading.Lock()
_gc_open: List[Tuple[SpanRecord, object]] = []


def _clock_pair() -> Tuple[int, int]:
    """``(perf_counter ns, real-time ns - perf_counter ns)`` from the
    closest of a few back-to-back reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, r)
    _, p, r = best
    return p, r - p


_clock_pairs: "collections.deque[Tuple[int, int]]" = collections.deque([_clock_pair()],
                                                                      maxlen=1024)


def _stack() -> List[SpanRecord]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _open(name: str, start: float, counts: Dict[str, int], uids: Tuple[int, ...]
          ) -> SpanRecord:
    stack = _stack()
    return SpanRecord(name, next(_ids), stack[-1].id if stack else 0, start, 0.0, counts, uids)


def _profiler_turned(on: bool) -> None:
    global _profiling
    with _turn_lock:
        if on == _profiling:
            return
        _profiling = on
        if on:
            _clock_pairs.append(_clock_pair())
            gc.callbacks.append(_gc_hook)
        elif _gc_hook in gc.callbacks:
            gc.callbacks.remove(_gc_hook)


def _gc_hook(phase: str, info: Dict[str, int]) -> None:
    """A collection as a ``bie.gc`` span, while a profiler records."""
    if phase == "start":
        if not _profiler_enabled():
            return
        start = _clock()
        rf = _trace_enter("bie.gc")
        _gc_open.append((_open("bie.gc", start, {"generation": info["generation"]}, ()), rf))
    elif _gc_open:
        rec, rf = _gc_open.pop()
        _trace_exit(rf)
        rec.end = _clock()
        rec.counts["collected"] = info["collected"]
        _ring.append(rec)


class _Span:
    __slots__ = ("name", "fine", "uids", "counts", "rec", "rf")

    def __init__(self, name: str, fine: bool, uids: Tuple[int, ...], counts: Dict[str, int]):
        self.name, self.fine, self.uids, self.counts = name, fine, uids, counts
        self.rec = self.rf = None

    def __enter__(self) -> Optional[SpanRecord]:
        on = _profiler_enabled()
        if on != _profiling:
            _profiler_turned(on)
        if self.fine and not on:
            return None
        # the profiler stamps its event inside its enter and exit ops: stamped
        # before the one and after the other, the record holds the event
        start = _clock()
        if on:
            self.rf = _trace_enter(self.name)
        self.rec = _open(self.name, start, self.counts, self.uids)
        _stack().append(self.rec)
        return self.rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if rec is None:
            return False
        if self.rf is not None:
            _trace_exit(self.rf)
        rec.end = _clock()
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        _ring.append(rec)
        return False


def annotate(name: str, uids: Sequence[int] = (), fine: bool = False, **counts: int) -> _Span:
    """The program's span (see the module's notes): a context manager that
    yields its :class:`SpanRecord` (``None`` for a fine span with no
    profiler recording), whose ``counts`` and ``uids`` may be set while it
    is open; ``counts`` start from the keyword arguments."""
    return _Span(name, fine, tuple(uids), counts)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``key`` on the innermost open span of this thread (no
    span open: nothing)."""
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[key] = c.get(key, 0) + int(n)


def records(name: Optional[str] = None) -> List[SpanRecord]:
    """The closed spans kept, in the order they closed (those named
    ``name``, if given)."""
    out = list(_ring)
    return out if name is None else [r for r in out if r.name == name]


def to_trace_us(t: float, base_ns: int = 0) -> float:
    """A stamp ``t`` (``time.perf_counter`` seconds) on a ``torch.profiler``
    trace's clock: microseconds after ``base_ns``, the trace file's
    ``baseTimeNanoseconds`` (0: after the epoch)."""
    t_ns = round(t * 1e9)
    off = _clock_pairs[0][1]
    for p, o in _clock_pairs:
        if p > t_ns:
            break
        off = o
    return (t_ns + off - base_ns) / 1e3


@dataclasses.dataclass
class OpRecord:
    name: str
    seconds: float
    bytes_accessed: int = 0
    flops: int = 0

    def bandwidth_gbps(self) -> float:
        return self.bytes_accessed / self.seconds / 1e9 if self.seconds else 0.0

    def tflops(self) -> float:
        return self.flops / self.seconds / 1e12 if self.seconds else 0.0


@dataclasses.dataclass
class RooflineReport:
    """Accumulates measured ops and reports % of the device's roofline."""

    chip: str = dataclasses.field(default_factory=detect_chip)
    records: List[OpRecord] = dataclasses.field(default_factory=list)

    def add(self, name: str, seconds: float, bytes_accessed: int = 0, flops: int = 0):
        self.records.append(OpRecord(name, seconds, bytes_accessed, flops))

    def summary(self) -> List[Dict]:
        spec = CHIP_SPECS.get(self.chip, CHIP_SPECS["cpu"])
        out = []
        for r in self.records:
            mem_roof = r.bytes_accessed / (spec["hbm_gbps"] * 1e9)
            flop_roof = r.flops / (spec["bf16_tflops"] * 1e12)
            bound = "memory" if mem_roof >= flop_roof else "compute"
            roof = max(mem_roof, flop_roof)
            out.append(
                {
                    "name": r.name,
                    "us": round(r.seconds * 1e6, 1),
                    "achieved_gbps": round(r.bandwidth_gbps(), 1),
                    "achieved_tflops": round(r.tflops(), 2),
                    "bound": bound,
                    "pct_of_roofline": round(100 * roof / r.seconds, 1)
                    if r.seconds
                    else 0.0,
                }
            )
        return out

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps({"chip": self.chip, "ops": self.summary()}, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


def _trace_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def device_op_table(logdir: str, top: Optional[int] = 20) -> List[Dict]:
    """Aggregate the Chrome traces under ``logdir`` (:func:`trace`'s
    ``*.trace.json``, or gzipped) into a per-kernel device-time table.

    Keeps only GPU kernel events (``cat == "kernel"``: the host's operator
    and runtime rows would count the same work again), groups them by
    kernel name and returns rows ``{key, us, count, example}`` (``us`` the
    summed device time, ``count`` the launches, ``example`` the first
    launch's grid and block) sorted by device time, the ``top`` largest
    (every kernel with ``top=None``).  Raises ``FileNotFoundError`` when
    there is no trace."""
    files = sorted(glob.glob(os.path.join(logdir, "**", "*.trace.json"), recursive=True)
                   + glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no trace files under {logdir}")
    us: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    example: Dict[str, str] = {}
    for path in files:
        for ev in _trace_events(path):
            if ev.get("ph") != "X" or ev.get("cat") != "kernel":
                continue
            key = ev.get("name", "")
            us[key] += ev.get("dur", 0)
            count[key] += 1
            if key not in example:
                args = ev.get("args") or {}
                example[key] = f"grid {args.get('grid')} block {args.get('block')}"
    rows = sorted(us, key=lambda k: -us[k])
    return [{"key": k, "us": us[k], "count": count[k], "example": example[k]}
            for k in (rows if top is None else rows[:top])]


def device_summary(prof, wall_s: float, calls: int, top: int = 8) -> Dict:
    """A finished profiler's (:func:`profiler`) region per call: host wall
    ms, device busy ms (kernel time summed), idle share ``1 - busy /
    wall``, launches and the ``top`` kernels by device time."""
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


def host_profile(fn: Callable[[], object], calls: int = 1
                 ) -> Tuple[float, Dict[str, Tuple[float, float, float]]]:
    """``cProfile`` over ``fn()`` (which makes ``calls`` calls of the thing
    measured; the card is synchronised before the clock stops): the wall
    ms a call under the profiler and, per Python function
    (``file:line(name)``), its calls, own ms and cumulative ms a call."""
    import cProfile
    import pstats

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    stats = pstats.Stats(prof).stats
    return wall, {f"{os.path.basename(f)}:{line}({name})": (nc / calls, tt * 1e3 / calls,
                                                           ct * 1e3 / calls)
                  for (f, line, name), (_cc, nc, tt, ct, _callers) in stats.items()}
