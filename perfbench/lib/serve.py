"""The serving loop: a closed loop of clients over ``ContinuousBatcher``.

Each client sends its next request the moment its last one completes (zero
think time), so every batcher slot stays busy.  The harness drives the
batcher the way ``ContinuousBatcher.run()`` does, one iteration at a time,
from outside: the finished requests' clients submit, then ``_admit`` (the
admission waves: chunked prefill, each wave ending in a host read of its
first tokens), then one ``step`` (a decode step of every active slot,
ending in a host read of its tokens).  Every time stamp is the host clock
after such a read, so a token's time is when the host had it.

With no think time the schedule depends only on the order of completions,
never on the clock: a seed gives the same waves and steps on every run.

The experts each routed layer chose are logged from the program's own
routing call (:class:`RouteLog`, no device work of its own)
and kept with each request by position, for the check: the reference
follows the program's routes and judges them apart (the architecture's
``logits_at``; ``reference/llama_ref.py`` for the Llama family).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import model as model_lib
from .traffic import RequestStream

clock = time.perf_counter


class RouteLog:
    """The experts ``ops.moe.route`` picked, in call order: ``moe_mlp``
    calls it by its module name, so a wrapper there sees every layer's
    ``(tokens, k)`` indices and adds no device work."""

    def __init__(self):
        from bitorch_engine_tpu_torch.ops import moe

        self.module, self.inner, self.calls = moe, moe.route, []

        def route(x2, router_w, top_k):
            probs, idx = self.inner(x2, router_w, top_k)
            self.calls.append(idx)
            return probs, idx

        moe.route = route

    def take(self, layers: int) -> List[torch.Tensor]:
        """The forwards since the last take, each ``(layers, rows, k)``:
        ``layers`` the model's routed layers, in order."""
        calls, self.calls = self.calls, []
        return [torch.stack(calls[i : i + layers]) for i in range(0, len(calls), layers)]

    def close(self) -> None:
        self.module.route = self.inner


@dataclasses.dataclass
class Rec:
    """One request as the client saw it."""
    index: int
    prompt: np.ndarray
    max_new: int
    t_submit: float
    t_first: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # the experts its tokens were routed to: prompt chunks' (routed layers,
    # C, k), then one (routed layers, k) a decode step
    routes: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def route_table(self) -> torch.Tensor:
        """``(routed layers, positions, k)`` for its prompt and every served
        token but the last (the positions the reference reads)."""
        prompt = torch.cat([r for r in self.routes if r.dim() == 3], dim=1)[:, : self.prompt_len]
        steps = [r[:, None] for r in self.routes if r.dim() == 2]
        return torch.cat([prompt] + steps[: len(self.tokens) - 1], dim=1)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass
class Iter:
    """One loop iteration: its admission call and its decode step."""
    admit: tuple  # (t0, t1)
    waves: List[tuple]  # (bucket, [true prompt lengths]) a wave
    step: Optional[tuple] = None  # (t0, t1)
    profiled: bool = False


def max_len_for(stream: RequestStream, page: int) -> int:
    """The smallest multiple of the page size above the longest request."""
    return (stream.longest // page + 1) * page


# what the loop implements; any other key (a think time, a sampling rule)
# is refused rather than silently run as zero think time and greedy decoding
MIX_KEYS = {"kind", "clients", "set_size", "prompt", "output", "batcher", "warmup_completions",
            "trace", "check"}
BATCHER_KEYS = {"num_slots", "kv_page_size", "prefill_chunk", "decode_chunk"}


def check_mix(mix: Dict[str, Any]) -> None:
    unknown = sorted(set(mix) - MIX_KEYS) + sorted(set(mix["batcher"]) - BATCHER_KEYS)
    if unknown:
        raise ValueError(f"the closed loop implements none of {unknown}: it resubmits at once "
                         "and decodes greedily")


class ServeLoop:
    def __init__(self, plan, seed: int, device):
        mix = plan.mix
        check_mix(mix)
        self.mix = mix
        self.shape = plan.shape
        self.routed = self.shape.routed_layers
        self.stream = RequestStream(mix, self.shape.vocab, seed)
        b = mix["batcher"]
        self.page = b["kv_page_size"]
        self.max_len = max_len_for(self.stream, self.page)
        self.model = model_lib.build(plan.config, seed, device, self.max_len, plan.arch)
        from bitorch_engine_tpu_torch.models.generate import ContinuousBatcher

        slots = b["num_slots"]
        self.batcher = ContinuousBatcher(
            self.model, num_slots=slots, max_len=self.max_len,
            kv_pages=slots * self.max_len // self.page + 1, kv_page_size=self.page,
            prefill_chunk=b["prefill_chunk"], decode_chunk=b["decode_chunk"],
        )
        self.recs: Dict[int, Rec] = {}  # by the batcher's uid
        self.iters: List[Iter] = []
        self.wave_times: Dict[int, float] = {}
        self.wave_routes: Dict[int, List[torch.Tensor]] = {}
        self.route_log: Optional[RouteLog] = None
        inner = self.batcher._wave_tokens

        def wave_tokens(logits, slots):
            out = inner(logits, slots)  # ends in a host read of the wave's tokens
            t = clock()
            for s in slots:
                self.wave_times[s] = t
            if self.route_log is not None:
                fwds = self.route_log.take(self.routed)
                for row, s in enumerate(slots):
                    self.wave_routes[s] = [f.view(f.shape[0], len(slots), -1, f.shape[-1])[:, row]
                                          for f in fwds]
            return out

        self.batcher._wave_tokens = wave_tokens
        self.log_routes(True)
        for _ in range(mix["clients"]):
            self._submit(clock())

    def log_routes(self, on: bool) -> None:
        """Log the routed layers' routes from now on (a dense model has none)."""
        if on and self.routed and self.route_log is None:
            self.route_log = RouteLog()
        elif not on and self.route_log is not None:
            self.route_log.close()
            self.route_log = None

    def close(self) -> None:
        """Free the program's state (the wrapper closes over the batcher)."""
        self.log_routes(False)
        b = self.batcher
        del b._wave_tokens
        self.batcher = self.model = None
        del b
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _submit(self, now: float) -> None:
        r = self.stream.next()
        uid = self.batcher.submit(r.prompt, max_new_tokens=r.max_new_tokens)
        self.recs[uid] = Rec(r.index, r.prompt, r.max_new_tokens, now)

    def iteration(self, span=None) -> Iter:
        """One admission call and one decode step; finished requests'
        clients submit again at once."""
        b = self.batcher
        waiting = [req for req in b.queue]
        self.wave_times.clear()
        self.wave_routes.clear()
        t0 = clock()
        with span("admit"):
            b._admit()
        t1 = clock()
        waves: Dict[int, List[int]] = {}
        slot_of = {id(req): s for s, req in enumerate(b.active) if req is not None}
        for req in waiting:
            if not req.generated:
                continue
            rec = self.recs[req.uid]
            s = slot_of.get(id(req))
            rec.t_first = self.wave_times.get(s, t1) if s is not None else t1
            if self.route_log is not None and s is not None:
                rec.routes += self.wave_routes[s]
            rec.token_times.append(rec.t_first)
            rec.tokens.append(req.generated[0])
            waves.setdefault(b._bucket(rec.prompt_len), []).append(rec.prompt_len)
            if req.done:
                self._finish(req, t1)
        it = Iter((t0, t1), sorted(waves.items()))
        decoding = [req for req in b.active if req is not None]
        slots_before = [s for s, req in enumerate(b.active) if req is not None]
        if decoding:
            s0 = clock()
            with span("step"):
                b.step()
            s1 = clock()
            it.step = (s0, s1)
            step_routes = self.route_log.take(self.routed)[0] if self.route_log else None
            for s, req in enumerate(decoding):
                rec = self.recs[req.uid]
                if step_routes is not None:
                    rec.routes.append(step_routes[:, slots_before[s]])
                rec.token_times.append(s1)
                rec.tokens.append(req.generated[-1])
                if req.done:
                    self._finish(req, s1)
        self.iters.append(it)
        return it

    def _finish(self, req, now: float) -> None:
        rec = self.recs[req.uid]
        rec.t_done = now
        self.batcher._all.remove(req)  # run() collects so: the list stays short
        self._submit(now)

    def warm_up(self, span) -> None:
        """Set-up's share of the loop: until every prompt bucket of the mix
        has been prefilled and ``warmup_completions`` requests have
        finished, so that the window starts in the loop's steady state
        and not in the first fill's wave of decode-only steps.  Eager
        PyTorch compiles nothing; this loads the kernels and settles the
        allocator and cuBLAS on the shapes the window uses."""
        b = self.batcher
        buckets = {b._bucket(n) for n in self.stream.prompts}
        seen = set()
        while True:
            it = self.iteration(span)
            seen.update(bucket for bucket, _ in it.waves)
            done = sum(r.t_done is not None for r in self.recs.values())
            if seen >= buckets and done >= self.mix["warmup_completions"]:
                break
        self.iters.clear()
