"""The one traffic generator: requests drawn from a mix file and a seed.

A mix names a distribution for each length (``lognormal`` with a median
and a sigma, ``uniform_int``, ``fixed``), each clipped to ``[min, max]``.
Every seed gets the same set of ``set_size`` sizes, the distribution's
quantiles at ``(i + 0.5) / set_size``, and only their order and the token
ids differ: the set is dealt out in cycles, each cycle in a fresh seeded
order (prompts and outputs shuffled apart).  So two seeds offer the same
work in another order, and a run's spread across seeds stays that of the
system.  Token ids are uniform over the vocabulary (``phase_serving``'s
draw in ``chip_smoke.py``), with no shared prefixes.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Dict, List

import numpy as np


def quantile(dist: Dict[str, Any], q: float) -> int:
    """The ``q`` quantile of a length distribution, clipped and rounded."""
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    if kind == "uniform_int":
        lo, hi = int(dist["min"]), int(dist["max"])
        return lo + min(hi - lo, int(math.floor(q * (hi - lo + 1))))
    if kind == "lognormal":
        z = statistics.NormalDist().inv_cdf(q)
        v = math.exp(math.log(dist["median"]) + dist["sigma"] * z)
        return int(round(min(max(v, dist["min"]), dist["max"])))
    raise ValueError(f"unknown length distribution {kind!r}")


def size_set(dist: Dict[str, Any], n: int) -> List[int]:
    return [quantile(dist, (i + 0.5) / n) for i in range(n)]


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray  # int32 token ids
    max_new_tokens: int


class RequestStream:
    """The mix's requests in order, drawn from ``seed``."""

    def __init__(self, mix: Dict[str, Any], vocab: int, seed: int):
        self.vocab = vocab
        self.n = int(mix["set_size"])
        self.prompts = size_set(mix["prompt"], self.n)
        self.outputs = size_set(mix["output"], self.n)
        self.rng = np.random.default_rng(seed)
        self._cycle: List[tuple] = []
        self.count = 0

    def _deal(self) -> None:
        p = self.rng.permutation(self.n)
        o = self.rng.permutation(self.n)
        self._cycle = [(self.prompts[i], self.outputs[j]) for i, j in zip(p, o)][::-1]

    def next(self) -> Request:
        if not self._cycle:
            self._deal()
        plen, out = self._cycle.pop()
        ids = self.rng.integers(0, self.vocab, size=plen, dtype=np.int64).astype(np.int32)
        req = Request(self.count, ids, out)
        self.count += 1
        return req

    @property
    def longest(self) -> int:
        """The most cache positions a request of the mix takes."""
        return max(self.prompts) + max(self.outputs)
