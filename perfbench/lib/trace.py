"""Device time from a ``torch.profiler`` Chrome trace, attributed to spans.

The benchmark marks its own spans with ``torch.profiler.record_function``
(names starting ``perfbench.``).  Each device kernel is tied to the host
call that launched it by the trace's correlation id, and so to the span
that was open when it was launched.  The kernel-event table is
``utils/profiling.device_op_table``'s (GPU events only, ``cat ==
"kernel"``: the host's operator and runtime rows would count the same work
again); device busy time is the union of kernel, memcpy and memset
intervals, never their sum, so overlapping streams are not counted twice.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import gzip
import json
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# host operators whose kernels carry matmul or attention work: every kernel
# they launch must be claimed by a pattern of that class
CLASS_OPS = {
    "matmul": ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::_scaled_mm",
               "aten::addbmm", "aten::_int_mm"),
    "attention_forward": ("aten::_scaled_dot_product_flash_attention",
                          "aten::_scaled_dot_product_efficient_attention",
                          "aten::_scaled_dot_product_cudnn_attention"),
    "attention_backward": ("aten::_scaled_dot_product_flash_attention_backward",
                           "aten::_scaled_dot_product_efficient_attention_backward",
                           "aten::_scaled_dot_product_cudnn_attention_backward"),
}


@dataclasses.dataclass
class Kernel:
    name: str
    start: float  # µs, the trace's clock
    dur: float
    op: str  # innermost host operator around its launch ("" if none)


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    kernels: List[Kernel] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Trace:
    spans: List[Span]
    device: List[Tuple[float, float]]  # (start, end) of every device event, µs
    kernels: List[Kernel]
    host_ops: List[Tuple[float, float, str]]  # main thread's operators

    @property
    def start(self) -> float:
        return min(s.start for s in self.spans)

    @property
    def end(self) -> float:
        return max(s.end for s in self.spans)

    def busy_s(self, lo: Optional[float] = None, hi: Optional[float] = None) -> float:
        lo = self.start if lo is None else lo
        hi = self.end if hi is None else hi
        return sum(b - a for a, b in merged(self.device, lo, hi)) / 1e6

    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == SPAN_PREFIX + name]

    def device_ops(self, top: int = 10) -> List[List]:
        us: Dict[str, float] = collections.Counter()
        for k in self.kernels:
            us[k.name[:120]] += k.dur
        return [[name, t / 1e6] for name, t in sorted(us.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest idle gaps inside the traced spans, each labelled by
        the benchmark span and the host operator in progress at its start."""
        busy = merged(self.device, self.start, self.end)
        gaps, prev = [], self.start
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.end > prev:
            gaps.append((prev, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._label(a), (b - a) / 1e6] for a, b in gaps[:top]]

    def _label(self, t: float) -> str:
        span = next((s.name[len(SPAN_PREFIX):] for s in self.spans if s.start <= t < s.end), "none")
        i = bisect.bisect_right([o[0] for o in self.host_ops], t)
        # the latest-starting operator that holds t is the innermost
        op = next((o[2] for o in reversed(self.host_ops[max(0, i - 200):i]) if o[1] > t), "python")
        return f"{span}: {op}"[:120]


def merged(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def parse(events: list) -> Trace:
    """The trace's spans, device events and kernels.  A kernel's launch
    (the CUDA API call with its correlation id) carries the
    ``External id`` of the host operator it ran under."""
    spans: List[Span] = []
    launches: Dict[int, Tuple[float, Optional[int]]] = {}
    op_names: Dict[int, str] = {}
    host: Dict[int, List[Tuple[float, float, str]]] = collections.defaultdict(list)
    device: List[Tuple[float, float]] = []
    raw_kernels = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append(Span(name, ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[int(args["correlation"])] = (ts, args.get("External id"))
        elif cat == "cpu_op":
            host[ev.get("tid")].append((ts, ts + dur, name))
            if "External id" in args:
                op_names[int(args["External id"])] = name
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                raw_kernels.append((name, ts, dur, args.get("correlation")))
    spans.sort(key=lambda s: s.start)
    starts = [s.start for s in spans]
    kernels = []
    for name, ts, dur, corr in raw_kernels:
        launch = launches.get(int(corr)) if corr is not None else None
        at, op = ts, ""
        if launch is not None:
            at, ext = launch
            op = op_names.get(int(ext), "") if ext is not None else ""
        k = Kernel(name, ts, dur, op)
        kernels.append(k)
        # the innermost span open at the launch: spans of one loop do not
        # nest, an outer one may hold inner ones (the latest-starting holder)
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and not (spans[i].start <= at < spans[i].end):
            i -= 1
        if i >= 0:
            spans[i].kernels.append(k)
    main_ops = max(host.values(), key=len) if host else []
    main_ops.sort()
    return Trace(spans, device, kernels, main_ops)


def unclaimed(trace: Trace, classify: Callable[[str], Optional[str]]) -> List[str]:
    """Kernels the rooflines could miss: any kernel of the traced stretch
    that no pattern under ``perfbench/kernels`` claims (a renamed, fused or
    new kernel), and any launched by a matmul or attention operator that no
    pattern of that class claims."""
    bad = set()
    for k in trace.kernels:
        got = classify(k.name)
        if got is None:
            bad.add(f"{k.op or 'no operator'} -> {k.name[:160]} (claimed by no pattern)")
        for op_class, ops in CLASS_OPS.items():
            if k.op in ops and got != op_class:
                bad.add(f"{k.op} -> {k.name[:160]} (claimed as {got})")
    return sorted(bad)


def class_seconds(kernels: List[Kernel], classify: Callable[[str], Optional[str]], op_class: str
                  ) -> float:
    return sum(k.dur for k in kernels if classify(k.name) == op_class) / 1e6
