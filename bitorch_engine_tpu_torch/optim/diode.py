"""DiodeMix: the engine's optimizer for quantized and fp parameters.

The counterpart of ``bitorch_engine_tpu/optim/diode.py``, as an object in
the shape of a ``torch.optim.Optimizer`` (``step()``, ``zero_grad()``,
``state_dict()``) built over a model's modules.  Regimes, by the layer's
quantized record:

* **fp parameters** (embedding, norms, biases, QAT scales and shifts):
  AdamW (betas (0.99, 0.9999), decoupled weight decay, bias correction),
  no f32 master: a bf16 parameter is updated in f32 and cast back each
  step, as the JAX package does;
* **MPQ** (``MPQLinear``): the gradient is its grad shadow's ``.grad``;
  optional GaLore projection; AdamW on the dequantized f32 weight; the
  zeros refreshed every ``zeros_update_interval`` steps from the group
  means of the update (asym: of the updated integer zeros); the weight
  repacked into its codes in place;
* **MBWQ** (``MBWQLinear``): AdamW on the dequantized logical weight, then
  each segment repacked with its own scales (and zeros refreshed on
  schedule);
* **binary** (``BinaryLinear``, ``BinaryConv2d``): sign descent with two
  EMAs, ``exp_avg_l`` of the gradient (β1) and ``exp_avg_s`` of ``lr ·
  sign(exp_avg_l)`` (β2); a weight flips where ``-sign(exp_avg_s)`` (0 →
  +1) disagrees with its sign.  ``exp_avg_s`` starts at ``-sign(w) · U(0,
  1e-3)``, drawn from a ``torch.Generator`` seeded with ``seed``; that draw
  decides the first flips, so a run compared with the JAX package starts
  from its moments (``utils.convert.load_jax_diode_state``);
* **IntQ** (``Q4Linear``, ``Q8Linear``, ``Q4Conv2d``): AdamW on the codes as
  f32, then requantized by ``nv_tensor_quant`` at the layer's width (the
  scale ``scale_w`` stays);
* **binary embedding** (``BinaryEmbedding(Bag)``): the EMA of ``lr ·
  sign(g)`` (0 → -1) over the whole table; the rows with a nonzero gradient
  take the EMA's signs, the others keep theirs.

GaLore applies to MPQ layers and to fp matrices larger than the rank
(``_galore_eligible``).  A model holding integer weights outside these
layers (``Int8Embedding``) raises.

Under ``fsdp`` (``DiodeMix(mesh=)`` with ``mesh.size("fsdp") > 1``; the
moments' specs are ``parallel.sharding.optimizer_partition_specs``'s) each
rank keeps only its share of every moment along one dimension (the
*split*, ``DiodeMix.splits``), updates that share of the weight from the
full gradient (the ranks hold the same) and all-gathers the result.  The
update is local to the split (AdamW and the sign descents are elementwise,
the requantization reads one group's scale and zero per element), so the
result equals the unsharded step's bit for bit.  Per regime:

* MPQ: the K rows in whole quant groups and whole words (the packed words
  and, on a refresh, the zeros gathered; the scales are never written); a
  weight whose rows do not split so (the 370M ``down_proj``'s tp 2 shard
  holds 1408 rows, 5.5 groups of 128 a rank at fsdp 2), and every
  act-order weight (``q_perm`` or ``g_idx``: its stored rows' groups are
  not its logical rows' groups), splits its N columns instead (asym: whole
  words of zeros, ``32 // w_bit`` columns; ``q_perm`` and ``g_idx`` stay
  whole on every rank), and a column share's zeros refresh reads the whole
  update, gathered;
* MBWQ: the N columns of every segment (its rows are permuted and cut into
  segments of other widths);
* binary, IntQ: the first dimension of the weight that splits (IntQ's
  per-tensor requantization reads the maximum over every rank's share);
* binary embedding: the vocabulary rows;
* fp: the rows of a 2-D parameter, else its columns;
* GaLore: the projection is computed from the whole gradient on every rank
  (the same); the low-rank moments split their rows, and the normalized
  low-rank direction is gathered before it is projected back.

A share that does not split raises.

A tp row shard of an act-order MPQ tensor (``models.llama_sharding
.row_shard``: a ``q_perm`` tensor's stored rows with their logical rows
``tp_rows``, or a ragged ``g_idx`` tensor's rows with every group's scales
and zeros) refreshes its zeros from the whole update, as the JAX package's
one GSPMD program does: the ranks' rows of the update are all-gathered
over ``tp`` (put back in logical order by the gathered ``tp_rows``, or
grouped by the gathered ``g_idx``), the group means taken over the whole,
and the rank keeps its groups' zeros (a ragged shard: all of them).  The
reduction so runs on the unsharded shape, and the step equals the
unsharded step's bit for bit.  Such a shard needs the ``mesh`` it was cut
on.

The step counter starts at 1, the bias corrections compute ``beta ** step``
in f32 as the JAX package does; every update works in place under
``torch.no_grad``.  An MPQ weight is reconstructed by the JAX package's
arithmetic through ``ops.mpq_linear.reconstruct_weight(...,
exact_asym=True)``: kernel 2 on the card, bit-exact with the plain
``dequantize_mpq`` (a symmetric tensor's ``q·s − z``, an asym one's
``s·(q − z)``, not the forward's kernel form ``q·s − (s·z)``), fsdp column
parts and tp row shards included; a ragged ``g_idx`` the plain dequantize.
:data:`update_counts` counts the two routes.

While a profiler records, each MPQ and MBWQ weight's update opens fine
spans (``utils/profiling``): ``bie.diode.update`` (AdamW's direction,
through GaLore where it applies), ``bie.diode.reconstruct`` (the f32
weight) and ``bie.diode.repack`` (zeros refreshed, codes packed, the fsdp
gathers); the other regimes' updates share one ``bie.diode.update``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..layers.linear import MBWQLinear, MPQLinear
from ..ops import packing
from ..ops.mbwq_linear import reconstruct_mbwq
from ..ops.mpq_linear import reconstruct_weight
from ..ops.quant import nv_tensor_quant, repack_mpq, slice_mpq_n
from ..parallel.comm import all_gather
from ..qtensor import BinaryEmbeddingQTensor, BinaryQTensor, IntQTensor, MPQTensor
from ..utils.convert import quantized_layers
from ..utils.profiling import annotate
from .galore import (
    GaLoreConfig,
    GaLoreState,
    galore_init,
    galore_project,
    galore_project_back,
)


@dataclasses.dataclass(frozen=True)
class DiodeHyperParams:
    lr: float = 1e-4
    beta1: float = 0.99
    beta2: float = 0.9999
    eps: float = 1e-6
    weight_decay: float = 0.0
    correct_bias: bool = True
    zeros_update_interval: int = 5
    galore: Optional[GaLoreConfig] = None


# DiodeMix's MPQ reconstructions by route: "kernel" (``reconstruct_weight``'s
# kernel 2 on the card) and "plain" (its plain dequantize: a ragged g_idx);
# the caller resets them
update_counts = {"kernel": 0, "plain": 0}


def _galore_eligible(shape: Tuple[int, ...], kind: str, rank: int) -> bool:
    """MPQ layers always, the other quantized layers never; fp matrices
    whose smaller side exceeds the rank."""
    if kind != "fp":
        return kind == "mpq"
    return len(shape) == 2 and min(shape) > rank


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _step_size(hp: DiodeHyperParams, step: int) -> float:
    """``lr · sqrt(1 − β2^t) / (1 − β1^t)`` in f32 (the JAX package's order
    of operations), as an exact Python float."""
    if not hp.correct_bias:
        return float(_f32(hp.lr))
    t = _f32(float(step))
    bc1 = 1.0 - _f32(hp.beta1) ** t
    bc2 = 1.0 - _f32(hp.beta2) ** t
    return float(_f32(hp.lr) * torch.sqrt(bc2) / bc1)


def _group_mean(x: torch.Tensor, group_size: int) -> torch.Tensor:
    k, n = x.shape
    return x.reshape(k // group_size, group_size, n).mean(dim=1)


# the quantized regimes, by the layer's record type
_REGIMES = {BinaryQTensor: "binary", IntQTensor: "intq", BinaryEmbeddingQTensor: "bemb"}


Split = Tuple[int, int, int]  # (dim, start, end) of this fsdp rank's share


def _share(size: int, n: int, i: int, multiple: int = 1) -> Optional[Tuple[int, int]]:
    """Rank ``i``'s ``[start, end)`` of ``size`` split ``n`` ways, each share
    a multiple of ``multiple``; ``None`` where it does not split so."""
    if size % n or (size // n) % multiple:
        return None
    return i * (size // n), (i + 1) * (size // n)


def _part(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    return t if split is None else t.narrow(split[0], split[1], split[2] - split[1])


def _mpq_part(qt: MPQTensor, split: Split) -> MPQTensor:
    """The rows or columns ``[start, end)`` of ``qt``: its words and groups,
    or its columns (asym zeros pack along N: whole words of them)."""
    dim, a, b = split
    if dim == 1:
        return slice_mpq_n(qt.replace(grad_shadow=None), a, b - a)
    words = slice(a // 32 * qt.w_bit, b // 32 * qt.w_bit)
    groups = slice(a // qt.group_size, b // qt.group_size)
    return qt.replace(packed=qt.packed[words], scales=qt.scales[groups],
                      zeros=qt.zeros[groups], grad_shadow=None)


class DiodeMix:
    """DiodeMix over ``model``'s trainable parameters (call
    ``utils.convert.prepare_for_training`` first: the quantized layers need
    their grad shadows).  ``seed`` seeds the binary regimes' initial
    ``exp_avg_s``; ``mesh``: shard the moments' rows over its ``fsdp``
    axis (see the module's notes)."""

    def __init__(self, model: nn.Module, hp: Optional[DiodeHyperParams] = None, seed: int = 0,
                 mesh=None):
        self.hp = hp or DiodeHyperParams()
        self.step_count = 0
        self.mesh = mesh
        names = {id(m): n for n, m in model.named_modules()}
        self.mpq, self.mbwq, self.binary, self.intq, self.bemb = [], [], [], [], []
        owned = set()
        for mod in quantized_layers(model):
            if mod.grad_shadow is None:
                raise ValueError(
                    f"{names[id(mod)]}: a quantized layer without a grad shadow "
                    "(call utils.convert.prepare_for_training first)"
                )
            if isinstance(mod, MBWQLinear):
                kind = "mbwq"
            elif isinstance(mod, MPQLinear):
                kind = "mpq"
            else:
                kind = _REGIMES[mod._RECORD]
            getattr(self, kind).append((names[id(mod)], mod))
            owned.update(id(t) for t in mod.buffers())
            owned.add(id(mod.grad_shadow))
        for name, buf in model.named_buffers():
            if id(buf) not in owned and not buf.is_floating_point():
                raise NotImplementedError(
                    f"{name}: DiodeMix updates the quantized layers (MPQ, MBWQ, binary, "
                    "IntQ, binary embedding) and fp parameters, not a bare integer weight"
                )
        self.fp = [(n, p) for n, p in model.named_parameters()
                   if p.requires_grad and id(p) not in owned]
        self.splits = self._fsdp_plan()  # name → this fsdp rank's share of its moments
        # name → ("rows" | "g_idx", the whole index over tp) of a tp row shard
        # of an act-order tensor (see the module's notes)
        self.tp_whole = {name: self._tp_whole(name, mod) for name, mod in self.mpq
                         if self._is_tp_row_shard(mod)}
        self.state: Dict[str, Dict[str, Any]] = {}
        gens: Dict[torch.device, torch.Generator] = {}

        def delta(shape, device):
            gen = gens.setdefault(device, torch.Generator(device=device).manual_seed(seed))
            return torch.rand(shape, generator=gen, device=device) * 1e-3

        for name, mod in self.mpq + self.mbwq + self.intq:
            kind = "mpq" if isinstance(mod, MPQLinear) else "quant"
            self.state[name] = self._init_state(name, tuple(mod.grad_shadow.shape), kind,
                                                mod.grad_shadow.device)
        # the binary regimes' initial moments: the whole draw, then this rank's share
        for name, mod in self.binary:
            w = mod.data.float()
            st = {"exp_avg_l": torch.zeros_like(w),
                  "exp_avg_s": -(torch.sign(w) * delta(w.shape, w.device))}
            self.state[name] = {k: _part(v, self.splits.get(name)).clone() for k, v in st.items()}
        for name, mod in self.bemb:
            k = mod.qweight.logical_shape[1]
            w_sign = packing.unpack_signs(mod.data)[:, :k]
            st = -(w_sign * delta(w_sign.shape, w_sign.device))
            self.state[name] = {"exp_avg_s": _part(st, self.splits.get(name)).clone()}
        for name, p in self.fp:
            self.state[name] = self._init_state(name, tuple(p.shape), "fp", p.device)

    @staticmethod
    def _is_tp_row_shard(mod: MPQLinear) -> bool:
        """Whether ``mod`` is a tp row shard of an act-order tensor: a
        ``q_perm`` tensor's stored rows (``tp_rows``), or a ragged ``g_idx``
        tensor's rows holding every group's scales and zeros."""
        qt = mod.qweight
        return getattr(mod, "tp_rows", None) is not None or (
            qt.g_idx is not None and qt.scales.shape[0] * qt.group_size != qt.in_features)

    def _tp_whole(self, name: str, mod: MPQLinear) -> Tuple[str, torch.Tensor]:
        """The whole tensor's row index of a tp row shard, gathered over
        ``tp`` once: ``("rows", q_perm)`` or ``("g_idx", g_idx)``."""
        mesh = self.mesh
        if mesh is None or "tp" not in mesh.shape or mesh.size("tp") == 1:
            raise ValueError(f"{name}: a tp row shard of an act-order tensor refreshes its zeros "
                             "from every tp rank's rows: pass DiodeMix the mesh it was cut on")
        rows = getattr(mod, "tp_rows", None)
        kind, index = ("rows", rows) if rows is not None else ("g_idx", mod.qweight.g_idx)
        return kind, all_gather(mesh, index.contiguous(), "tp", dim=0).long()

    def _fsdp_plan(self) -> Dict[str, Split]:
        """This fsdp rank's share of each weight (see the module's notes);
        ``{}`` without fsdp."""
        mesh = self.mesh
        n = 1 if mesh is None or "fsdp" not in mesh.shape else mesh.size("fsdp")
        if n == 1:
            return {}
        i, splits = mesh.coord("fsdp"), {}

        def plan(name, choices):
            """The first of ``choices`` (dim, size, multiple) that splits."""
            for dim, size, multiple in choices:
                share = _share(size, n, i, multiple)
                if share is not None:
                    splits[name] = (dim, *share)
                    return
            sizes = " or ".join(f"{size} (whole blocks of {m})" for _, size, m in choices)
            raise ValueError(f"{name}: {sizes} do not split over fsdp={n}")

        for name, mod in self.mpq:
            qt = mod.qweight
            k, cols = qt.logical_shape
            by_cols = (1, cols, 32 // qt.w_bit if qt.asym else 1)
            if qt.g_idx is not None or qt.q_perm is not None or self._is_tp_row_shard(mod):
                plan(name, [by_cols])  # act-order: the columns only
            else:
                plan(name, [(0, k, 32 * qt.group_size // math.gcd(32, qt.group_size)), by_cols])
        for name, mod in self.mbwq:
            segs = mod.qweight.segments
            plan(name, [(1, mod.qweight.out_features,
                         max(32 // s.w_bit if s.asym else 1 for s in segs))])
        for name, mod in self.binary + self.intq:
            plan(name, [(d, size, 1) for d, size in enumerate(mod.data.shape)])
        for name, mod in self.bemb:
            plan(name, [(0, mod.data.shape[0], 1)])
        for name, p in self.fp:
            if p.dim() == 2:
                plan(name, [(0, p.shape[0], 1), (1, p.shape[1], 1)])
        return splits

    def moment_split(self, name: str) -> Optional[Split]:
        """The share of the whole moments of ``name`` that this rank holds
        (its projected moments' under GaLore); ``None`` for all of them."""
        st = self.state[name]
        return st.get("low_split") if "galore" in st else self.splits.get(name)

    def _gather(self, t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """Every fsdp rank's share of ``t`` along the split's dimension."""
        return t if split is None else all_gather(self.mesh, t, "fsdp", dim=split[0])

    def trainable(self) -> List[torch.Tensor]:
        """Every tensor whose ``.grad`` the step reads: the grad shadows,
        then the fp parameters."""
        return [mod.grad_shadow for _, mod in self._quantized()] + [p for _, p in self.fp]

    def _init_state(self, name: str, shape, kind: str, device) -> Dict[str, Any]:
        """Zero moments of this rank's share of a weight of ``shape`` (under
        GaLore: of its projected shape, whose rows split over fsdp)."""
        st: Dict[str, Any] = {}
        galore, split = self.hp.galore, self.splits.get(name)
        if galore is not None and _galore_eligible(shape, kind, galore.rank):
            st["galore"] = galore_init(shape, galore.rank)
            shape = st["galore"].projected_shape(shape)
            if split is not None:
                n = self.mesh.size("fsdp")
                share = _share(shape[0], n, self.mesh.coord("fsdp"))
                if share is None:
                    raise ValueError(f"{name}: GaLore's {shape[0]} projected rows do not split "
                                     f"over fsdp={n}")
                split = st["low_split"] = (0, *share)
        if split is not None:
            shape = shape[: split[0]] + (split[2] - split[1],) + shape[split[0] + 1 :]
        st["exp_avg_l"] = torch.zeros(shape, dtype=torch.float32, device=device)
        st["exp_avg_s"] = torch.zeros(shape, dtype=torch.float32, device=device)
        return st

    def _quantized(self):
        return self.mpq + self.mbwq + self.binary + self.intq + self.bemb

    def zero_grad(self) -> None:
        for _, mod in self._quantized():
            mod.grad_shadow.grad = None
        for _, p in self.fp:
            p.grad = None

    # the shared AdamW moments: the normalized gradient, in place on ``st``
    def _adamw(self, grad: torch.Tensor, st: Dict[str, Any]) -> torch.Tensor:
        hp = self.hp
        st["exp_avg_l"].mul_(hp.beta1).add_(grad * (1.0 - hp.beta1))
        st["exp_avg_s"].mul_(hp.beta2).add_(grad * grad * (1.0 - hp.beta2))
        return st["exp_avg_l"] / (torch.sqrt(st["exp_avg_s"]) + hp.eps)

    def _direction(self, grad: torch.Tensor, st: Dict[str, Any], step: int,
                   split: Optional[Split] = None) -> torch.Tensor:
        """AdamW's normalized gradient of this rank's share (``split``) of
        the whole ``grad``, through GaLore's projection where the state has
        one (the whole gradient projected, the low-rank moments' share
        updated, the direction gathered and projected back)."""
        galore: Optional[GaLoreState] = st.get("galore")
        if galore is None:
            return self._adamw(_part(grad, split), st)
        low = galore_project(galore, grad, step, self.hp.galore)
        low_split = st.get("low_split")
        d = self._gather(self._adamw(_part(low, low_split), st), low_split)
        return _part(galore_project_back(galore, d, self.hp.galore), split)

    @staticmethod
    def _shadow_grad(mod: nn.Module) -> torch.Tensor:
        g = mod.grad_shadow.grad
        return torch.zeros_like(mod.grad_shadow) if g is None else g.float()

    @torch.no_grad()
    def step(self) -> None:
        self.step_count += 1
        step = self.step_count
        size = _step_size(self.hp, step)
        refresh = step % self.hp.zeros_update_interval == 0
        split = self.splits.get
        for name, mod in self.mpq:
            self._update_mpq(name, mod, self.state[name], step, size, refresh, split(name))
        for name, mod in self.mbwq:
            self._update_mbwq(mod, self.state[name], step, size, refresh, split(name))
        with annotate("bie.diode.update", fine=True):
            for name, mod in self.binary:
                self._update_binary(mod, self.state[name], split(name))
            for name, mod in self.intq:
                self._update_intq(mod, self.state[name], size, split(name))
            for name, mod in self.bemb:
                self._update_binary_embedding(mod, self.state[name], split(name))
            for name, p in self.fp:
                self._update_fp(p, self.state[name], step, size, split(name))

    def _group_mean(self, x: torch.Tensor, group_size: int, split: Optional[Split]) -> torch.Tensor:
        """The group means of this rank's share of ``x``; a column share's
        taken over the whole of ``x``, gathered, then cut (a reduction's
        order may depend on its width; a row share holds whole groups)."""
        if split is None or split[0] == 0:
            return _group_mean(x, group_size)
        return _part(_group_mean(self._gather(x, split), group_size), split)

    def _update_fp(self, p: nn.Parameter, st, step: int, size: float, split=None) -> None:
        g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
        w = _part(p.float(), split) - size * self._direction(g, st, step, split)
        if self.hp.weight_decay > 0.0:
            w = w - self.hp.lr * self.hp.weight_decay * w
        p.copy_(self._gather(w.to(p.dtype), split))

    def _update_mpq(self, name: str, mod: MPQLinear, st, step: int, size: float, refresh: bool,
                    split=None) -> None:
        qt = mod.qweight if split is None else _mpq_part(mod.qweight, split)
        with annotate("bie.diode.update", fine=True):
            update = size * self._direction(self._shadow_grad(mod), st, step, split)
        update_counts["plain" if qt.g_idx is not None else "kernel"] += 1
        with annotate("bie.diode.reconstruct", fine=True):
            w = reconstruct_weight(qt, torch.float32, exact_asym=True) - update
        with annotate("bie.diode.repack", fine=True):
            zeros, z_int = qt.zeros, None
            if refresh:
                zeros, z_int = self._refreshed_zeros(name, qt, update, split)
                mod._zeros_mid = False  # the zeros are no longer mid * scales
            if qt.asym:
                if z_int is None:
                    z_int = packing.unpack_cols(zeros, qt.w_bit)
                packed = repack_mpq(w, qt.replace(zeros=zeros), unpacked_zeros=z_int.float())
            else:
                packed = repack_mpq(w, qt.replace(zeros=zeros))
            mod.packed.copy_(self._gather(packed, split))
            if refresh:
                mod.zeros.copy_(self._gather(zeros, split))

    def _refreshed_zeros(self, name: str, qt: MPQTensor, update: torch.Tensor, split):
        """This rank's share of the refreshed zeros of ``qt`` (this rank's
        part of the layer) from ``update``, the JAX package's rule: sym, the
        zeros plus the group means of the update; asym, the rounded group
        means of the integer zeros plus the update, row by row (by
        ``g_idx`` where the tensor has one), clamped to ``[1, 2^w_bit]``.
        A tp row shard of an act-order tensor takes the means over the whole
        update, gathered over ``tp``.  Returns the zeros and, for asym,
        their integer codes."""
        zeros, g_idx = qt.zeros, qt.g_idx
        kind, index = self.tp_whole.get(name, (None, None))
        if kind is not None:
            update = all_gather(self.mesh, update.contiguous(), "tp", dim=0)
            if kind == "rows":  # stored rows back to logical order; every rank's groups
                update = torch.empty_like(update).index_copy_(0, index, update)
                zeros = all_gather(self.mesh, zeros.contiguous(), "tp", dim=0)
            else:
                g_idx = index
        gs, k = qt.group_size, update.shape[0]
        if qt.asym:
            g = g_idx.long() if g_idx is not None else torch.arange(k, device=update.device) // gs
            full_z = packing.unpack_cols(zeros, qt.w_bit).float()[g] + update
            grouped = self._group_mean(full_z[torch.argsort(g, stable=True)], gs, split)
            new = torch.clamp(torch.round(grouped), 1, 2 ** qt.w_bit).to(torch.int32)
        else:
            new = zeros + self._group_mean(update, gs, split).to(zeros.dtype)
        if kind == "rows":  # this rank's groups
            n_g, c = qt.scales.shape[0], self.mesh.coord("tp")
            new = new[c * n_g : (c + 1) * n_g]
        return (packing.pack_cols(new, qt.w_bit), new) if qt.asym else (new, None)

    def _update_mbwq(self, mod: MBWQLinear, st, step: int, size: float, refresh: bool,
                     split=None) -> None:
        qt = mod.qweight
        if split is not None:
            qt = qt.replace(segments=tuple(_mpq_part(s, split) for s in qt.segments),
                            grad_shadow=None)
        with annotate("bie.diode.update", fine=True):
            update = size * self._direction(self._shadow_grad(mod), st, step, split)
        with annotate("bie.diode.reconstruct", fine=True):
            w = reconstruct_mbwq(qt, torch.float32) - update
        with annotate("bie.diode.repack", fine=True):
            if qt.q_perm is not None:
                perm = qt.q_perm.long()
                w, update = w[perm], update[perm]
            off = 0
            for seg_mod, seg in zip(mod.segments, qt.segments):
                rows = slice(off, off + seg.in_features)
                zeros = seg.zeros
                if refresh:
                    zeros = zeros + self._group_mean(update[rows], seg.group_size,
                                                     split).to(zeros.dtype)
                    seg_mod.zeros.copy_(self._gather(zeros, split))
                    seg_mod._zeros_mid = False
                seg_mod.packed.copy_(
                    self._gather(repack_mpq(w[rows], seg.replace(zeros=zeros)), split))
                off += seg.in_features

    def _update_binary(self, mod: nn.Module, st, split=None) -> None:
        hp = self.hp
        g = _part(self._shadow_grad(mod), split)
        st["exp_avg_l"].add_((g - st["exp_avg_l"]) * (1.0 - hp.beta1))
        v = torch.sign(st["exp_avg_l"]) * hp.lr
        st["exp_avg_s"].add_((v - st["exp_avg_s"]) * (1.0 - hp.beta2))
        u = -torch.sign(st["exp_avg_s"])
        u = torch.where(u == 0, 1.0, u)
        w = _part(mod.data, split)
        mod.data.copy_(self._gather(torch.where(u != torch.sign(w.float()), -w, w), split))

    def _update_intq(self, mod: nn.Module, st, size: float, split=None) -> None:
        g = _part(self._shadow_grad(mod), split)
        w = _part(mod.data, split).float() - size * self._adamw(g, st)
        if self.hp.weight_decay > 0.0:
            w = w - self.hp.lr * self.hp.weight_decay * w
        # the per-tensor requantization's amax: the largest of every share's
        amax = None if split is None else self._gather(w.max().reshape(1), (0, 0, 1)).max()
        q = nv_tensor_quant(w, amax=amax, num_bits=mod._w_bit)[0].to(torch.int8)
        mod.data.copy_(self._gather(q, split))

    def _update_binary_embedding(self, mod: nn.Module, st, split=None) -> None:
        g = _part(self._shadow_grad(mod), split)
        active = (g != 0.0).any(dim=1, keepdim=True)
        v = torch.sign(g)
        v = torch.where(v == 0, -1.0, v) * self.hp.lr
        st["exp_avg_s"].add_((v - st["exp_avg_s"]) * (1.0 - self.hp.beta2))
        bits = torch.where(st["exp_avg_s"] >= 0, 1.0, -1.0)
        packed = packing.pack_signs(packing.pad_to_multiple(bits, 1, 32, value=-1.0)[0])
        mod.data.copy_(self._gather(torch.where(active, packed, _part(mod.data, split)), split))

    def state_dict(self) -> Dict[str, Any]:
        def leaf(st):
            out = {k: v for k, v in st.items() if k != "galore"}
            if "galore" in st:
                out["galore"] = dataclasses.asdict(st["galore"])
            return out

        return {"step": self.step_count, "hp": dataclasses.asdict(self.hp),
                "state": {name: leaf(st) for name, st in self.state.items()}}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.step_count = int(state_dict["step"])
        for name, st in state_dict["state"].items():
            mine = self.state[name]
            for key in ("exp_avg_l", "exp_avg_s"):
                if key in mine:
                    mine[key].copy_(st[key])
            if "galore" in st:
                mine["galore"] = GaLoreState(**st["galore"])
