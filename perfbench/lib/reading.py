"""Helpers the metric readers share: which work was traced, which was not,
and what the traced work needs.

A traced run profiles a fixed stretch of loop iterations inside its window
(``cells.Profiled``: one warm-up iteration the profiler discards, then the
traced ones).  Host-clock readings leave every profiled iteration out; the
trace's spans map one to one, in order, onto the traced iterations.
"""

from __future__ import annotations

from typing import List, Tuple

from .flops import head_flops, token_matmul_flops, weight_bytes_per_forward
from .peaks import least_seconds


def in_window(run, t: float) -> bool:
    return run.window[0] <= t <= run.window[1]


def profiled_intervals(run) -> List[Tuple[float, float]]:
    out = []
    for it in run.data["iters"]:
        if it.profiled:
            out.append((it.admit[0], it.step[1] if it.step else it.admit[1]))
    return out


def unprofiled(run, t: float) -> bool:
    """``t`` lies in the window and outside every profiled iteration."""
    return in_window(run, t) and not any(a <= t <= b for a, b in profiled_intervals(run))


def unprofiled_wall(run) -> float:
    return run.window_s - sum(b - a for a, b in profiled_intervals(run))


def plain_iters(run):
    """The window's iterations the profiler did not touch."""
    return [it for it in run.data["iters"] if not it.profiled and in_window(run, it.admit[0])]


def traced_iters(run):
    """The profiled iterations whose spans are in the trace (the first,
    the profiler's warm-up, is discarded)."""
    return [it for it in run.data["iters"] if it.profiled][1:]


def chunk_tokens(bucket: int, lens: List[int], chunk: int) -> List[int]:
    """True prompt tokens in each prefill chunk of a wave."""
    return [sum(max(0, min(chunk, n - j * chunk)) for n in lens) for j in range(bucket // chunk)]


def prefill_least_s(run, waves) -> float:
    """The least time the matmuls of ``waves``' true prompt tokens take:
    each chunk forward that holds a true token reads every weight once
    and does the top-k matmul operations of its tokens; the head runs for
    each request's last prompt token."""
    s, chunk = run.shape, run.data["prefill_chunk"]
    per_tok, per_fwd = token_matmul_flops(s), weight_bytes_per_forward(s)
    total = 0.0
    for bucket, lens in waves:
        toks = chunk_tokens(bucket, lens, chunk)
        for j, t in enumerate(toks):
            if t == 0:
                continue
            ends = sum(j * chunk < n <= (j + 1) * chunk for n in lens)
            total += least_seconds(t * per_tok + ends * head_flops(s), per_fwd, run.peaks)
    return total


def padded_tokens(waves) -> int:
    """Tokens the prefill computes, padded buckets included."""
    return sum(bucket * len(lens) for bucket, lens in waves)
