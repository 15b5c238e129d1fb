"""Sampling, the simple batched generation loop and the continuous-batching
serving engine: the counterpart of ``bitorch_engine_tpu/models/generate.py``.

``ContinuousBatcher`` keeps a fixed number of batch slots, each with its own
cache position; finished requests free their slot, and queued prompts are
prefilled into free slots between decode steps, so the decode step never
waits on stragglers.  The KV cache is dense (``slots × max_len``) or paged
(``kv_pages`` pages shared by the slots, ``models/paged_kv.py``).  What was
``jit`` and buffer donation in the JAX package has no counterpart (PyTorch
runs eagerly and the caches are updated in place); ``lax.scan`` over decode
steps is a Python loop that keeps the tokens on the device and syncs with
the host once per chunk.

With a ``mesh`` the batcher is one rank of a sharded engine: every rank runs
the same host loop in lockstep, its dp group's slots through its part of
the model (``models/llama_sharding.shard_llama_params``) and caches, and the
sampled tokens are gathered over dp before the queue, the slots and the
allocator move, so every rank moves them on the same values (the JAX
package's ``_rep_out`` / ``_local``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..parallel.comm import all_gather
from .llama import LlamaModel, decode_step, init_kv_caches
from .paged_kv import PageAllocator, init_paged_kv_caches


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Greedy (temperature 0) or top-k temperature sampling; logits (b, V).

    Sampling draws from ``generator``, so it gives other tokens than the JAX
    package's PRNG for the same seed; greedy tokens are the same."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    model: LlamaModel,
    prompt: torch.Tensor,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    eos_id: Optional[int] = None,
    seed: int = 0,
    max_len: Optional[int] = None,
) -> torch.Tensor:
    """Prefill the prompt, then decode; ``prompt`` int ``(b, plen)`` →
    ``(b, plen + max_new_tokens)`` (sequences past EOS repeat EOS).

    Both phases read the whole cache (no attention window), as the JAX
    package's ``generate`` does."""
    cfg = model.cfg
    prompt = prompt.to(model.device)
    b, plen = prompt.shape
    max_len = max_len or min(cfg.max_seq_len, plen + max_new_tokens)
    caches = init_kv_caches(cfg, b, max_len, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(seed)

    logits, caches = model(prompt, kv_caches=caches, cache_len=0)
    nxt = sample_token(logits[:, -1], gen, temperature)
    out = [prompt, nxt[:, None]]
    finished = torch.zeros(b, dtype=torch.bool, device=model.device)
    for i in range(max_new_tokens - 1):
        logits, caches = decode_step(model, nxt[:, None], caches, plen + i)
        nxt = sample_token(logits, gen, temperature)
        if eos_id is not None:
            finished = finished | (nxt == eos_id)
            nxt = torch.where(finished, eos_id, nxt)
        out.append(nxt[:, None])
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (plen,) int32
    max_new_tokens: int = 64
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching on one device.

    The slots decode in lock-step, each at its own position.  ``submit``
    queues a request; ``run`` drains the queue, prefilling free slots
    between decode steps.  Everything runs on ``model.device``.
    """

    def __init__(
        self,
        model: LlamaModel,
        num_slots: int = 4,
        max_len: int = 512,
        eos_id: int = -1,
        temperature: float = 0.0,
        decode_chunk: int = 1,
        kv_pages: Optional[int] = None,
        kv_page_size: int = 64,
        mesh=None,
        prefill_chunk: Optional[int] = None,
    ):
        """``decode_chunk``: decode T tokens per host sync; up to T - 1
        slot-steps after a mid-chunk EOS are wasted (the slot is prefilled
        anew on the next admit, so the tokens are unaffected).

        ``prefill_chunk``: prefill prompts longer than this (a power of 2
        >= 8) in C-token chunks at growing cache offsets (the two-part
        attention, or the read-only paged kernel), which caps the
        activations of long prompts.

        ``kv_pages``: use a paged KV cache of this many pages of
        ``kv_page_size`` tokens (page 0 is the null page: usable capacity
        ``(kv_pages - 1) * kv_page_size`` tokens, chosen apart from
        ``num_slots * max_len``).  Admission reserves a request's worst case
        up front and blocks, never mid-decode, when the pool is full; the
        tokens equal the dense cache's.

        ``temperature > 0`` samples from a ``torch.Generator`` seeded with 0
        (other draws than the JAX package's key 0 gives); greedy tokens are
        the same.

        ``mesh`` (``parallel.make_mesh``): serve ``model`` (already cut to
        this rank's part where the mesh has tp) as one rank of the sharded
        engine.  The slots split over dp in contiguous groups (``num_slots``
        must divide), each group's caches on its ranks, and a paged pool
        hands each group pages from its own range.  Every rank calls the
        same methods in the same order; the tokens equal the unsharded
        batcher's."""
        dp = 1 if mesh is None else mesh.size("dp")
        if num_slots % dp:
            raise ValueError(f"num_slots {num_slots} not divisible by dp {dp}")
        self.mesh, self._dp = mesh, dp
        # this rank's slots: its dp group's contiguous range
        per = num_slots // dp
        self._lo = per * (0 if mesh is None else mesh.coord("dp"))
        self._hi = self._lo + per
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.decode_chunk = max(1, int(decode_chunk))
        if prefill_chunk is not None and (prefill_chunk < 8 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of 2 >= 8, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.paged = kv_pages is not None
        if self.paged:
            if max_len % kv_page_size:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of kv_page_size {kv_page_size}")
            pages_per_slot = max_len // kv_page_size
            self.allocator = PageAllocator(kv_pages, kv_page_size, num_slots, pages_per_slot,
                                           dp_groups=dp)
            self.caches = init_paged_kv_caches(
                self.cfg, kv_pages, kv_page_size, num_slots, pages_per_slot, device=self.device,
                mesh=mesh)
        else:
            self.caches = init_kv_caches(self.cfg, num_slots, max_len, device=self.device,
                                         mesh=mesh)
        self.positions = np.zeros(num_slots, np.int32)  # next cache position per slot
        self.active: List[Optional[Request]] = [None] * num_slots
        self.cur_tok = np.zeros((num_slots, 1), np.int32)
        self.queue: List[Request] = []
        # every request submitted and not yet collected by run(), so that
        # submit → step() → run() sequences are tracked too
        self._all: List[Request] = []
        self._uid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    def _caches_in(self):
        """The caches for a decode step: in paged mode the allocator's
        current table is copied into the table tensor every layer shares."""
        if self.paged:
            rows = self.allocator.table[self._lo : self._hi]
            self.caches[0].page_table.copy_(torch.from_numpy(rows))
        return self.caches

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64) -> int:
        self._uid += 1
        req = Request(self._uid, np.asarray(prompt, np.int32), max_new_tokens)
        self.queue.append(req)
        self._all.append(req)
        return self._uid

    def _bucket(self, plen: int) -> int:
        """Power-of-2 prompt bucket (min 8, capped below max_len)."""
        if plen >= self.max_len:
            raise ValueError(f"prompt length {plen} >= max_len {self.max_len}")
        bucket = 8
        while bucket < plen:
            bucket *= 2
        return min(bucket, self.max_len - 1)

    def _admit(self):
        """Fill free slots from the queue.  Every queued request in the FIFO
        head's bucket is prefilled in one batched call (pulled from anywhere
        in the queue, so one long head prompt does not split the short ones
        behind it); the head always goes first."""
        while self.queue and any(r is None for r in self.active):
            free = [s for s in range(self.num_slots) if self.active[s] is None]
            bucket = self._bucket(len(self.queue[0].prompt))
            batch: List[Request] = []
            rest: List[Request] = []
            pool_full = False
            for req in self.queue:
                take = (not pool_full and len(batch) < len(free)
                        and self._bucket(len(req.prompt)) == bucket)
                if take and self.paged:
                    # reserve the worst case up front so the pool never runs
                    # out mid-decode; strict FIFO: a full pool blocks the
                    # whole wave rather than let small requests starve the head
                    need = min(len(req.prompt) + req.max_new_tokens, self.max_len)
                    if not self.allocator.alloc(free[len(batch)], need):
                        pool_full = True
                        take = False
                if take:
                    batch.append(req)
                else:
                    rest.append(req)
            self.queue = rest
            if not batch:
                return  # pool exhausted: wait for decode to free pages
            slots = free[: len(batch)]
            padded = np.zeros((len(batch), bucket), np.int32)
            for i, req in enumerate(batch):
                padded[i, : len(req.prompt)] = req.prompt
            true_lens = np.asarray([len(r.prompt) for r in batch], np.int32)
            if self.prefill_chunk is not None and bucket > self.prefill_chunk:
                logits = self._prefill_chunked(padded, slots, true_lens)
            else:
                logits = self._prefill_slots(padded, slots, true_lens)
            nxt_np = self._wave_tokens(logits, slots)
            for i, (s, req) in enumerate(zip(slots, batch)):
                nxt = int(nxt_np[i])
                req.generated.append(nxt)
                if nxt == self.eos_id or req.max_new_tokens <= 1:
                    req.done = True
                    if self.paged:
                        self.allocator.free_slot(s)
                    continue  # the slot stays free for the next admit round
                self.active[s] = req
                self.positions[s] = len(req.prompt)
                self.cur_tok[s, 0] = nxt

    def _mine(self, slots) -> List[int]:
        """Positions in ``slots`` of this rank's slots."""
        return [i for i, s in enumerate(slots) if self._lo <= s < self._hi]

    def _gather_slots(self, local: torch.Tensor) -> np.ndarray:
        """``local`` (..., this rank's slots) → (..., every slot) on the
        host, gathered over dp in slot order."""
        local = local.cpu()
        if self._dp > 1:
            local = all_gather(self.mesh, local, "dp", dim=-1)
        return local.numpy()

    def _wave_tokens(self, logits: torch.Tensor, slots) -> np.ndarray:
        """Each wave request's greedy token: this rank's rows of ``logits``
        are its own slots'; over dp each rank places them in a vector of
        its slot range, and :func:`_gather_slots` puts every slot's together."""
        local = torch.argmax(logits, dim=-1).cpu()
        if self._dp == 1:
            return local.numpy()
        mine = torch.zeros(self._hi - self._lo, dtype=local.dtype)
        mine[[slots[i] - self._lo for i in self._mine(slots)]] = local
        return self._gather_slots(mine)[list(slots)]

    def _wave_caches(self, slots_t: torch.Tensor, table_rows: Optional[torch.Tensor]):
        """The caches of an admission wave: dense caches' rows of ``slots``
        (copies); in paged mode the pools themselves, the wave's table rows
        and copies of its rows of the dense per-slot scale caches."""
        if not self.paged:
            return [tuple(a[slots_t] for a in layer) for layer in self.caches]
        return [
            c.replace(page_table=table_rows,
                      k_scale=None if c.k_scale is None else c.k_scale[slots_t],
                      v_scale=None if c.v_scale is None else c.v_scale[slots_t])
            for c in self.caches
        ]

    def _wave_put(self, wave, slots_t: torch.Tensor) -> None:
        """Write a wave's slot rows back (the paged pools were written in place)."""
        for full, part in zip(self.caches, wave):
            if not self.paged:
                for a, pa in zip(full, part):
                    a[slots_t] = pa
            elif full.k_scale is not None:
                full.k_scale[slots_t] = part.k_scale
                full.v_scale[slots_t] = part.v_scale

    def _wave_tables(self, slots):
        """This rank's slots (local indices) and their page-table rows."""
        slots_t = self._tensor(np.asarray(slots, np.int64) - self._lo)
        rows = self._tensor(self.allocator.table[slots]) if self.paged else None
        return slots_t, rows

    def _wave_rows(self, padded, slots, true_lens):
        """The wave's rows of this rank's slots."""
        mine = self._mine(slots)
        return padded[mine], [slots[i] for i in mine], true_lens[mine]

    @torch.no_grad()
    def _prefill_slots(self, padded, slots, true_lens) -> torch.Tensor:
        """Prefill n slots in one batched forward at window 0; returns each
        request's last-prompt-token logits (n, vocab), this rank's slots'
        rows only."""
        padded, slots, true_lens = self._wave_rows(padded, slots, true_lens)
        if not slots:
            return torch.zeros((0, self.cfg.vocab_size), device=self.device)
        slots_t, rows = self._wave_tables(slots)
        wave = self._wave_caches(slots_t, rows)
        n = len(slots)
        cache_len = [0] * n if self.paged else 0
        logits, _ = self.model(self._tensor(padded), kv_caches=wave, cache_len=cache_len,
                               attn_window=0)
        self._wave_put(wave, slots_t)
        return logits[torch.arange(n, device=self.device), self._tensor(true_lens).long() - 1]

    @torch.no_grad()
    def _prefill_chunked(self, padded, slots, true_lens) -> torch.Tensor:
        """Sequential C-token prefill chunks over one admission wave.  Chunk
        j writes positions [j·C, (j+1)·C) and attends over the cached prefix
        window plus the chunk, causal.  Returns each request's
        last-prompt-token logits (this rank's slots' rows only)."""
        C = self.prefill_chunk
        padded, slots, true_lens = self._wave_rows(padded, slots, true_lens)
        n, bucket = padded.shape
        if not slots:
            return torch.zeros((0, self.cfg.vocab_size), device=self.device)
        slots_t, rows = self._wave_tables(slots)
        tl = self._tensor(true_lens).long()
        ar = torch.arange(n, device=self.device)
        last = torch.zeros((n, self.cfg.vocab_size), dtype=torch.float32, device=self.device)
        for j in range(bucket // C):
            base = j * C
            window = 0 if j == 0 else self._window(base)
            positions = (base + torch.arange(C, device=self.device)).expand(n, C)
            wave = self._wave_caches(slots_t, rows)
            logits, _ = self.model(self._tensor(padded[:, base : base + C]), positions=positions,
                                   kv_caches=wave, cache_len=base, attn_window=window)
            self._wave_put(wave, slots_t)
            idx = torch.clamp(tl - 1 - base, 0, C - 1)
            inrange = (tl - 1 >= base) & (tl - 1 < base + C)
            last = torch.where(inrange[:, None], logits[ar, idx], last)
        return last

    def _window(self, needed: int) -> int:
        """Smallest power-of-2 attention window covering ``needed`` cache
        positions, capped at max_len; floor 256 for GQA, 128 for MHA (the
        JAX package's)."""
        cfg = self.cfg
        w = 256 if cfg.num_kv_heads < cfg.num_heads else 128
        while w < needed:
            w *= 2
        return min(w, self.max_len)

    @torch.no_grad()
    def _decode(self, toks: torch.Tensor, positions: np.ndarray, active: torch.Tensor,
                window: int) -> torch.Tensor:
        """One lock-step decode step of this rank's slots; inactive slots
        give 0."""
        logits, _ = decode_step(self.model, toks, self._caches_in(),
                                [int(p) for p in positions], attn_window=window)
        nxt = sample_token(logits, self._gen, self.temperature)
        return torch.where(active, nxt, 0)

    def step(self):
        """One decode step across all active slots."""
        lo, hi = self._lo, self._hi
        window = self._window(int(self.positions.max()) + 1)
        active = self._tensor(np.asarray([r is not None for r in self.active[lo:hi]]))
        nxt = self._decode(self._tensor(self.cur_tok[lo:hi]), self.positions[lo:hi], active,
                           window)
        nxt_np = self._gather_slots(nxt)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt_np[s])
            req.generated.append(tok)
            self.positions[s] += 1
            self.cur_tok[s, 0] = tok
            if (tok == self.eos_id or len(req.generated) >= req.max_new_tokens
                    or self.positions[s] >= self.max_len - 1):
                req.done = True
                self.active[s] = None
                self.positions[s] = 0
                if self.paged:
                    self.allocator.free_slot(s)

    def step_chunk(self, n_steps: int):
        """``n_steps`` decode steps with the tokens kept on the device, then
        one host sync to settle EOS, quotas and evictions."""
        lo, hi = self._lo, self._hi
        active_np = np.asarray([r is not None for r in self.active[lo:hi]])
        active = self._tensor(active_np)
        window = self._window(int(self.positions.max()) + n_steps)
        toks = self._tensor(self.cur_tok[lo:hi])
        positions = self.positions[lo:hi].copy()
        seq = []
        for _ in range(n_steps):
            nxt = self._decode(toks, positions, active, window)
            seq.append(nxt)
            toks = nxt[:, None]
            positions = np.where(active_np, np.minimum(positions + 1, self.max_len - 1), positions)
        toks_np = self._gather_slots(torch.stack(seq))  # (n_steps, slots)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            for t in range(n_steps):
                tok = int(toks_np[t, s])
                req.generated.append(tok)
                self.positions[s] = min(self.positions[s] + 1, self.max_len - 1)
                if (tok == self.eos_id or len(req.generated) >= req.max_new_tokens
                        or self.positions[s] >= self.max_len - 1):
                    # mid-chunk end: the slot's later chunk tokens are
                    # dropped; its cache is prefilled anew on the next admit
                    req.done = True
                    self.active[s] = None
                    self.positions[s] = 0
                    if self.paged:
                        self.allocator.free_slot(s)
                    break
            else:
                self.cur_tok[s, 0] = int(toks_np[n_steps - 1, s])

    def run(self) -> List[Request]:
        """Drain the queue; returns every request completed during this call
        (in submit order), including any already in flight from standalone
        ``step()`` / ``step_chunk()`` calls."""
        completed: List[Request] = []

        def collect():
            for req in list(self._all):
                if req.done:
                    completed.append(req)
                    self._all.remove(req)

        collect()
        while self.queue or any(r is not None for r in self.active):
            self._admit()
            if self.queue and not any(r is not None for r in self.active):
                # nothing running and nothing admitted: the page pool is too
                # small for the head of the queue
                head = self.queue[0]
                raise RuntimeError(
                    f"KV page pool too small for request uid={head.uid} "
                    f"(prompt {len(head.prompt)} + max_new {head.max_new_tokens} "
                    f"tokens); grow kv_pages")
            if any(r is not None for r in self.active):
                if self.decode_chunk > 1:
                    self.step_chunk(self.decode_chunk)
                else:
                    self.step()
            collect()
        collect()
        completed.sort(key=lambda r: r.uid)
        return completed
