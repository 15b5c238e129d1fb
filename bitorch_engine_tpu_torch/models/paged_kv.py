"""Paged (block) KV cache: KV capacity chosen apart from the slot count.

The counterpart of ``bitorch_engine_tpu/models/paged_kv.py``, with the same
layouts so that the two packages compare like with like:

* one **page pool** per layer for K and for V, token-major rank-3
  ``(num_pages, page_size, kv_heads·head_dim)``, shared by every slot: one
  decode token is one contiguous row, and the paged-attention kernel
  (``ops/cuda/paged_attention.py``) reads a page as one dense rectangle and
  a head as a 128-aligned column slice of it;
* in the int8 mode, f32 per-position scales in **dense per-slot** caches
  ``(slots, pages_per_slot·page_size, kv_heads)``, k and v separate (not
  paged: slots own disjoint pages, so per-(slot, position) scales carry the
  same information, and the window read is a prefix slice);
* a **page table** ``(slots, pages_per_slot)`` mapping each slot's logical
  blocks to pool pages, kept on the host by :class:`PageAllocator`;
* **page 0 is the null page**: never handed out, it takes the writes of
  inactive slots and backs unmapped table entries.  Reads of positions at or
  past a slot's ``cache_len`` are masked, so its contents are inert.

The port updates the pools and the scale caches in place (the JAX package
returns new arrays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import P


@dataclasses.dataclass
class PagedKV:
    """One layer's paged KV cache.

    ``k_pool`` / ``v_pool``: ``(num_pages, page_size, kv_heads·head_dim)``.
    ``k_scale`` / ``v_scale``: ``None`` for pools in the model dtype; in the
    int8 mode f32 ``(slots, pages_per_slot·page_size, kv_heads)``.  Stale
    scale rows after a slot is reused are inert: attention multiplies the
    scales into the scores before the ``pos < cache_len`` mask selects
    them away, and every buffer starts at zero, so stale values are finite.
    ``page_table``: ``(b, pages_per_slot)`` int32.  The JAX package keeps a
    distinct table buffer per layer only because XLA refuses to donate one
    buffer twice; PyTorch donates nothing, so one table tensor serves every
    layer here.
    """

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_table: torch.Tensor
    kv_heads: int = 0

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[1]

    @property
    def view_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    def replace(self, **changes) -> "PagedKV":
        return dataclasses.replace(self, **changes)


def local_kv_heads(cfg, tp: int) -> int:
    """KV heads a rank of a ``tp``-way split holds: ``nkv / tp``, or one
    (shared by ``tp / nkv`` ranks, Megatron's rule) when there are fewer KV
    heads than ranks."""
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if nh % tp or (nkv % tp if nkv >= tp else tp % nkv):
        raise ValueError(f"{nh} query / {nkv} KV heads do not split over tp={tp}")
    return max(1, nkv // tp)


def local_batch(batch: int, mesh) -> int:
    """This rank's share of a batch split over the mesh's dp axis."""
    dp = 1 if mesh is None else mesh.size("dp")
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by dp {dp}")
    return batch // dp


# The caches' layout over a mesh, read by the builders below: 'dp' splits
# the slots, 'tp' an axis of whole KV heads (:func:`local_kv_heads`).  The
# pools keep every page (the allocator's ``dp_groups`` keep each dp group
# on its own pages).  The int8 scale caches hold a rank's own heads: the
# JAX package replicates them over tp instead.
DENSE_KV_SPEC = P("dp", None, "tp", None)  # (b, L, kv_heads, hd)
DENSE_SCALE_SPEC = P("dp", None, "tp")  # (b, L, 2·kv_heads), [k-scales | v-scales]
PAGED_KV_SPECS = dict(
    k_pool=P(None, None, "tp"),  # (pages, page_size, kv_heads·hd)
    v_pool=P(None, None, "tp"),
    k_scale=P("dp", None, "tp"),  # (slots, pages_per_slot·page_size, kv_heads)
    v_scale=P("dp", None, "tp"),
    page_table=P("dp", None),  # (slots, pages_per_slot)
)


def kv_cache_shardings(num_layers: int, kv_cache_dtype: str = "bf16"):
    """Specs of the dense caches that :func:`models.llama.init_kv_caches`
    builds: ``(k, v)``, or ``(k, v, kv_scales)`` in the int8 mode."""
    if kv_cache_dtype == "int8":
        return [(DENSE_KV_SPEC, DENSE_KV_SPEC, DENSE_SCALE_SPEC) for _ in range(num_layers)]
    return [(DENSE_KV_SPEC, DENSE_KV_SPEC) for _ in range(num_layers)]


def paged_kv_shardings(caches):
    """Specs of the paged caches that :func:`init_paged_kv_caches` builds."""
    return [
        c.replace(**{k: None if getattr(c, k) is None else v for k, v in PAGED_KV_SPECS.items()})
        for c in caches
    ]


def local_shape(cfg, shape, spec: P, mesh) -> Tuple[int, ...]:
    """This rank's block of a cache of global ``shape`` under ``spec``."""
    tp = 1 if mesh is None else mesh.size("tp")
    out = []
    for size, axis in zip(shape, spec):
        if axis == "dp":
            size = local_batch(size, mesh)
        elif axis == "tp":  # whole KV heads of size // nkv entries each
            size = size // cfg.num_kv_heads * local_kv_heads(cfg, tp)
        elif axis is not None:
            raise ValueError(f"a cache does not split over {axis!r}")
        out.append(size)
    return tuple(out)


def init_paged_kv_caches(
    cfg, num_pages: int, page_size: int, slots: int, pages_per_slot: int, device=None,
    mesh=None,
) -> List[PagedKV]:
    """Per-layer zeroed page pools and one all-zero page table shared by the
    layers.  ``num_pages`` counts the null page 0: usable capacity is
    ``(num_pages - 1) * page_size`` tokens.  ``device=None`` means ``cuda``.
    With a ``mesh``, this rank's part under :data:`PAGED_KV_SPECS`."""
    device = resolve_device(device)
    nkv = cfg.num_kv_heads
    int8 = cfg.kv_cache_dtype == "int8"
    pool_dtype = torch.int8 if int8 else cfg.dtype
    shapes = dict(pool=(num_pages, page_size, nkv * cfg.head_dim),
                  scale=(slots, pages_per_slot * page_size, nkv),
                  page_table=(slots, pages_per_slot))

    def zeros(name, kind, dtype):
        return torch.zeros(local_shape(cfg, shapes[kind], PAGED_KV_SPECS[name], mesh),
                           dtype=dtype, device=device)

    def scale(name):
        return zeros(name, "scale", torch.float32) if int8 else None

    table = zeros("page_table", "page_table", torch.int32)
    return [
        PagedKV(
            k_pool=zeros("k_pool", "pool", pool_dtype),
            v_pool=zeros("v_pool", "pool", pool_dtype),
            k_scale=scale("k_scale"),
            v_scale=scale("v_scale"),
            page_table=table,
            kv_heads=local_kv_heads(cfg, 1 if mesh is None else mesh.size("tp")),
        )
        for _ in range(cfg.num_layers)
    ]


def paged_write_positions(cache: PagedKV, cache_len, b: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) int64 tensors of shape (b, s) for writing ``s`` new
    tokens per slot from each slot's ``cache_len`` (an int, a per-slot
    sequence or a tensor); a block past the table clamps to its last entry."""
    ps = cache.page_size
    dev = cache.page_table.device
    step = torch.arange(s, device=dev)
    start = torch.as_tensor(cache_len, device=dev).long()
    pos = (start.reshape(-1, 1) + step).expand(b, s)
    blk = torch.clamp(pos // ps, max=cache.page_table.shape[1] - 1)
    page = torch.gather(cache.page_table.long(), 1, blk)
    return page, pos % ps


class PageAllocator:
    """Host-side free-list page allocator and slot page-table bookkeeping.

    Page 0 is the null page and never handed out; ``table`` rows of inactive
    slots point at page 0.
    """

    def __init__(self, num_pages: int, page_size: int, slots: int, pages_per_slot: int,
                 dp_groups: int = 1):
        """``dp_groups > 1``: partition slots and pages into ``dp_groups``
        contiguous groups and hand a slot pages from its own group only (the
        layout a data-parallel split of the slots would keep local)."""
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.dp_groups = dp_groups
        if slots % dp_groups:
            raise ValueError(f"slots {slots} not divisible by dp_groups {dp_groups}")
        self._slots_per_group = slots // dp_groups
        usable = list(range(1, num_pages))
        per = len(usable) // dp_groups
        if per == 0:
            raise ValueError(f"{num_pages} pages cannot cover {dp_groups} dp groups")
        # stacks: pop() hands out the lowest page of the slot's group first
        self._free_by_group: List[List[int]] = [
            list(reversed(usable[g * per : (g + 1) * per])) for g in range(dp_groups)
        ]
        self.table = np.zeros((slots, pages_per_slot), np.int32)
        self._owned: List[List[int]] = [[] for _ in range(slots)]

    @property
    def free(self) -> List[int]:
        return [p for grp in self._free_by_group for p in grp]

    def _group_of(self, slot: int) -> int:
        return slot // self._slots_per_group

    def pages_needed(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.page_size))

    def can_alloc(self, tokens: int, slot: int = 0) -> bool:
        return len(self._free_by_group[self._group_of(slot)]) >= self.pages_needed(tokens)

    def alloc(self, slot: int, tokens: int) -> bool:
        """Reserve enough pages for ``tokens`` cache positions on ``slot``
        (from the slot's group).  Returns False, allocating nothing, when
        that group's pages are exhausted."""
        n = self.pages_needed(tokens)
        if n > self.pages_per_slot:
            raise ValueError(f"request needs {n} pages > pages_per_slot {self.pages_per_slot}")
        grp = self._free_by_group[self._group_of(slot)]
        if len(grp) < n:
            return False
        self.free_slot(slot)
        pages = [grp.pop() for _ in range(n)]
        self._owned[slot] = pages
        self.table[slot] = 0
        self.table[slot, : len(pages)] = pages
        return True

    def free_slot(self, slot: int) -> None:
        self._free_by_group[self._group_of(slot)].extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self.table[slot] = 0
