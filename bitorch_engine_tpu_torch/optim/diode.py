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
rank keeps only its share of the K rows of every 2-D moment (whole quant
groups and whole words; a shape that does not split raises), updates those
rows of every MPQ weight and 2-D fp parameter from the full gradient (the
ranks hold the same), and all-gathers the rows: the packed words and the
zeros of an MPQ weight (the scales are never written), the parameter's
rows of an fp one.  The update is row-local (AdamW is elementwise, the
requantization reads one group's scale and zero, the zeros refresh is a
mean within a group), so the result equals the unsharded step's bit for
bit.  GaLore's projection is not row-local and raises under fsdp, as do
the other regimes (not ported).

The step counter starts at 1, the bias corrections compute ``beta ** step``
in f32 as the JAX package does; every update works in place under
``torch.no_grad``.  On the card the dequantization is kernel 2 (bit-exact
with the plain version), which takes only symmetric gptq tensors: an asym
MPQ layer raises there, and trains on the CPU.
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
from ..ops.quant import nv_tensor_quant, repack_mpq
from ..parallel.comm import all_gather
from ..qtensor import BinaryEmbeddingQTensor, BinaryQTensor, IntQTensor, MPQTensor
from ..utils.convert import quantized_layers
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


def _fsdp_rows(name: str, k: int, n: int, i: int, multiple: int = 1) -> Tuple[int, int]:
    """Rank ``i``'s rows ``[k0, k1)`` of ``k`` split ``n`` ways, each share a
    multiple of ``multiple``."""
    if k % n or (k // n) % multiple:
        raise ValueError(f"{name}: {k} rows do not split over fsdp={n} into shares of whole "
                         f"blocks of {multiple}")
    return i * (k // n), (i + 1) * (k // n)


def _mpq_row_block(qt: MPQTensor, rows: Tuple[int, int]) -> MPQTensor:
    """The logical rows ``[k0, k1)`` of ``qt``: its words and its groups."""
    k0, k1 = rows
    words = slice(k0 // 32 * qt.w_bit, k1 // 32 * qt.w_bit)
    groups = slice(k0 // qt.group_size, k1 // qt.group_size)
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
        self.rows = self._fsdp_plan()  # name → this fsdp rank's rows [k0, k1)
        self.state: Dict[str, Dict[str, Any]] = {}
        gens: Dict[torch.device, torch.Generator] = {}

        def delta(shape, device):
            gen = gens.setdefault(device, torch.Generator(device=device).manual_seed(seed))
            return torch.rand(shape, generator=gen, device=device) * 1e-3

        for name, mod in self.mpq + self.mbwq + self.intq:
            kind = "mpq" if isinstance(mod, MPQLinear) else "quant"
            self.state[name] = self._init_state(self._local_shape(name, mod.grad_shadow), kind,
                                                mod.grad_shadow.device)
        for name, mod in self.binary:
            w = mod.data.float()
            self.state[name] = {"exp_avg_l": torch.zeros_like(w),
                                "exp_avg_s": -(torch.sign(w) * delta(w.shape, w.device))}
        for name, mod in self.bemb:
            k = mod.qweight.logical_shape[1]
            w_sign = packing.unpack_signs(mod.data)[:, :k]
            self.state[name] = {"exp_avg_s": -(w_sign * delta(w_sign.shape, w_sign.device))}
        for name, p in self.fp:
            self.state[name] = self._init_state(self._local_shape(name, p), "fp", p.device)

    def _fsdp_plan(self) -> Dict[str, Tuple[int, int]]:
        """This fsdp rank's rows of each MPQ weight (whole groups and whole
        words) and each 2-D fp parameter; ``{}`` without fsdp."""
        mesh = self.mesh
        n = 1 if mesh is None or "fsdp" not in mesh.shape else mesh.size("fsdp")
        if n == 1:
            return {}
        if self.hp.galore is not None:
            raise NotImplementedError("GaLore under fsdp: its projection is not row-local")
        for kind in ("mbwq", "binary", "intq", "bemb"):
            if getattr(self, kind):
                raise NotImplementedError(f"fsdp sharding of {kind} layers is not ported")
        i, rows = mesh.coord("fsdp"), {}
        for name, mod in self.mpq:
            qt = mod.qweight
            if qt.g_idx is not None or qt.q_perm is not None:
                raise ValueError(f"{name}: act-order rows do not split over fsdp")
            multiple = 32 * qt.group_size // math.gcd(32, qt.group_size)
            rows[name] = _fsdp_rows(name, qt.in_features, n, i, multiple)
        for name, p in self.fp:
            if p.dim() == 2:
                rows[name] = _fsdp_rows(name, p.shape[0], n, i)
        return rows

    def _local_shape(self, name: str, t: torch.Tensor) -> Tuple[int, ...]:
        rows = self.rows.get(name)
        return tuple(t.shape) if rows is None else (rows[1] - rows[0], *t.shape[1:])

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather(self.mesh, t, "fsdp", dim=0)

    def trainable(self) -> List[torch.Tensor]:
        """Every tensor whose ``.grad`` the step reads: the grad shadows,
        then the fp parameters."""
        return [mod.grad_shadow for _, mod in self._quantized()] + [p for _, p in self.fp]

    def _init_state(self, shape, kind: str, device) -> Dict[str, Any]:
        st: Dict[str, Any] = {}
        galore = self.hp.galore
        if galore is not None and _galore_eligible(shape, kind, galore.rank):
            st["galore"] = galore_init(shape, galore.rank)
            shape = st["galore"].projected_shape(shape)
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

    def _direction(self, grad: torch.Tensor, st: Dict[str, Any], step: int) -> torch.Tensor:
        """AdamW's normalized gradient, through GaLore's projection where
        the state has one."""
        galore: Optional[GaLoreState] = st.get("galore")
        if galore is None:
            return self._adamw(grad, st)
        low = galore_project(galore, grad, step, self.hp.galore)
        return galore_project_back(galore, self._adamw(low, st), self.hp.galore)

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
        for name, mod in self.mpq:
            self._update_mpq(mod, self.state[name], step, size, refresh, self.rows.get(name))
        for name, mod in self.mbwq:
            self._update_mbwq(mod, self.state[name], step, size, refresh)
        for name, mod in self.binary:
            self._update_binary(mod, self.state[name])
        for name, mod in self.intq:
            self._update_intq(mod, self.state[name], size)
        for name, mod in self.bemb:
            self._update_binary_embedding(mod, self.state[name])
        for name, p in self.fp:
            self._update_fp(p, self.state[name], step, size, self.rows.get(name))

    def _update_fp(self, p: nn.Parameter, st, step: int, size: float, rows=None) -> None:
        g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
        w = p.float()
        if rows is not None:
            g, w = g[rows[0] : rows[1]], w[rows[0] : rows[1]]
        w = w - size * self._direction(g, st, step)
        if self.hp.weight_decay > 0.0:
            w = w - self.hp.lr * self.hp.weight_decay * w
        w = w.to(p.dtype)
        p.copy_(w if rows is None else self._gather_rows(w))

    def _update_mpq(self, mod: MPQLinear, st, step: int, size: float, refresh: bool,
                    rows=None) -> None:
        qt, grad = mod.qweight, self._shadow_grad(mod)
        if rows is not None:
            qt, grad = _mpq_row_block(qt, rows), grad[rows[0] : rows[1]]
        update = size * self._direction(grad, st, step)
        w = reconstruct_weight(qt, torch.float32) - update
        zeros = qt.zeros
        if qt.asym:
            k, _ = qt.logical_shape
            z_int = packing.unpack_cols(zeros, qt.w_bit)
            if refresh:
                g = qt.g_idx.long() if qt.g_idx is not None else (
                    torch.arange(k, device=w.device) // qt.group_size)
                full_z = z_int.float()[g] + update
                grouped = _group_mean(full_z[torch.argsort(g, stable=True)], qt.group_size)
                z_int = torch.clamp(torch.round(grouped), 1, 2 ** qt.w_bit).to(torch.int32)
                zeros = packing.pack_cols(z_int, qt.w_bit)
            packed = repack_mpq(w, qt.replace(zeros=zeros), unpacked_zeros=z_int.float())
        else:
            if refresh:
                zeros = zeros + _group_mean(update, qt.group_size).to(zeros.dtype)
                mod._zeros_mid = False  # the zeros are no longer mid * scales
            packed = repack_mpq(w, qt.replace(zeros=zeros))
        if rows is not None:
            packed = self._gather_rows(packed)
            if refresh:
                zeros = self._gather_rows(zeros)
        mod.packed.copy_(packed)
        if refresh:
            mod.zeros.copy_(zeros)

    def _update_mbwq(self, mod: MBWQLinear, st, step: int, size: float, refresh: bool) -> None:
        qt = mod.qweight
        update = size * self._direction(self._shadow_grad(mod), st, step)
        w = reconstruct_mbwq(qt, torch.float32) - update
        if qt.q_perm is not None:
            perm = qt.q_perm.long()
            w, update = w[perm], update[perm]
        off = 0
        for seg_mod, seg in zip(mod.segments, qt.segments):
            rows = slice(off, off + seg.in_features)
            if refresh:
                seg_mod.zeros.add_(_group_mean(update[rows], seg.group_size).to(seg_mod.zeros.dtype))
                seg_mod._zeros_mid = False
            seg_mod.packed.copy_(repack_mpq(w[rows], seg.replace(zeros=seg_mod.zeros)))
            off += seg.in_features

    def _update_binary(self, mod: nn.Module, st) -> None:
        hp = self.hp
        g = self._shadow_grad(mod)
        st["exp_avg_l"].add_((g - st["exp_avg_l"]) * (1.0 - hp.beta1))
        v = torch.sign(st["exp_avg_l"]) * hp.lr
        st["exp_avg_s"].add_((v - st["exp_avg_s"]) * (1.0 - hp.beta2))
        u = -torch.sign(st["exp_avg_s"])
        u = torch.where(u == 0, 1.0, u)
        w = mod.data
        mod.data.copy_(torch.where(u != torch.sign(w.float()), -w, w))

    def _update_intq(self, mod: nn.Module, st, size: float) -> None:
        w = mod.data.float() - size * self._adamw(self._shadow_grad(mod), st)
        if self.hp.weight_decay > 0.0:
            w = w - self.hp.lr * self.hp.weight_decay * w
        mod.data.copy_(nv_tensor_quant(w, num_bits=mod._w_bit)[0].to(torch.int8))

    def _update_binary_embedding(self, mod: nn.Module, st) -> None:
        g = self._shadow_grad(mod)
        active = (g != 0.0).any(dim=1, keepdim=True)
        v = torch.sign(g)
        v = torch.where(v == 0, -1.0, v) * self.hp.lr
        st["exp_avg_s"].add_((v - st["exp_avg_s"]) * (1.0 - self.hp.beta2))
        bits = torch.where(st["exp_avg_s"] >= 0, 1.0, -1.0)
        packed = packing.pack_signs(packing.pad_to_multiple(bits, 1, 32, value=-1.0)[0])
        mod.data.copy_(torch.where(active, packed, mod.data))

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
