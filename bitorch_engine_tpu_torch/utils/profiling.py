"""Profiling, tracing and roofline reporting over ``torch.profiler``.

The counterpart of ``bitorch_engine_tpu/utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler.profile`` (CPU
  and, where there is a card, CUDA activities) that exports a Chrome trace
  into a directory; :func:`device_op_table` reads such a directory back
  into a per-kernel device-time table;
* :func:`annotate`: a named ``record_function`` scope for host-side phases;
* :class:`RooflineReport`: achieved-versus-peak bandwidth and FLOP/s per
  measured op, on the peaks of :data:`CHIP_SPECS`;
* :func:`profiler` and :func:`device_summary`: one profiled region's host
  wall, device busy time, idle share, launches and largest kernels per
  call; :func:`host_profile`: ``cProfile`` of a callable, per Python
  function.

The peaks are the card's own (the H100 SXM's datasheet figures); the port
states no rate for a TPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import gzip
import itertools
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

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


def annotate(name: str):
    """Named trace scope (host-side phase annotation)."""
    return torch.profiler.record_function(name)


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
