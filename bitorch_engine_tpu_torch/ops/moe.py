"""Mixture-of-Experts with quantized experts (the counterpart of
``bitorch_engine_tpu/ops/moe.py``).

Each expert is a SwiGLU MLP whose gate, up and down projections are
:class:`MPQTensor` records.  Experts come in two forms, as in the JAX
package: a tuple of per-expert dicts ``{"gate", "up", "down"}`` (the model
parameters' form, ``models.llama.QuantMoEMLP``) or one dict whose records
hold every expert stacked on a leading ``E`` axis (:func:`stack_experts`).

:func:`moe_mlp` routes each token to its top-k experts under a static
capacity ``C`` per expert: ``capacity_factor=None`` is drop-free (``C =
T``: a token routes to an expert at most once, so the routed forward equals
the dense Mixtral forward), a float the Switch / GShard capacity whose
overflowing routes are dropped.  Every expert runs on its whole ``(C, d)``
dispatch buffer, by one of two routes that compute the same arithmetic:

* grouped, wherever :func:`~.mpq_linear.mpq_linear` would rebuild each
  weight (on the card ``C > MAX_FUSED_ROWS_A16``, prefill; every ``C`` on
  the CPU), nothing needs a gradient, there is no ``tp`` axis and the
  local experts' records agree (:func:`_expert_groups`): one grouped
  kernel-2 launch rebuilds every gate and up, one every down
  (``dequant_mpq_grouped``), and ``torch.bmm`` runs the products on the
  ``(E_local, C, d)`` buffer;
* else a static loop over the experts through ``mpq_linear`` (kernel 1 at
  ``C <= MAX_FUSED_ROWS_A16`` rows on the card: decode).

Expert parallelism (``mesh`` with an ``ep`` axis): :func:`expert_shardings`
cuts the experts' leading E axis to this rank's ``E/ep``; ``x`` is the same
on every rank of ``ep`` (replicated, as in the JAX package's test and dry
run).  Every rank routes all tokens as before and runs its own experts on
their dispatch rows; the expert outputs are gathered along E
(``comm.all_gather_diff``) before the combine, so the combine sums each
token's choices in the unsharded f32 order and the output equals the
unsharded one.  An all-reduce of partial combines would change that order.
In the backward each rank's experts give the gradient of their own
dispatch rows only, so the dispatch buffer's gradient is summed over ep
(``comm.sum_grad``) before it reaches ``x``.

Tensor parallelism inside the experts (``mesh`` with a ``tp`` axis,
``models.llama_sharding``): every expert's gate and up hold this rank's
``inter / tp`` columns and its down the matching rows; the down's f32
partials are summed over tp (``comm.all_reduce_diff``) and cast once, and
the dispatch buffer's gradient is summed over tp, Megatron's rule.

While a profiler records, :func:`moe_mlp` opens fine spans
(``utils/profiling``) for its phases: ``bie.moe.route``,
``bie.moe.dispatch`` (the slots and ``index_put``), ``bie.moe.experts``
(either route) and ``bie.moe.combine``.  Every call counts, from the
host's shapes alone, ``moe_routed_rows`` (``T·k``), ``moe_computed_rows``
(``E_local·C``, the rows the experts compute) and ``moe_grouped_rows``
(the same ``E_local·C`` on the grouped route, 0 on the loop), on the
innermost span open: a profiler's phase span, else the caller's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..device import resolve_device
from ..parallel.comm import all_gather_diff, all_reduce_diff, sum_grad
from ..qtensor import MPQTensor
from ..utils.profiling import annotate, count
from .cuda.dequant_matmul import DequantGroup, dequant_mpq_grouped, group_key
from .mpq_linear import mpq_linear, mpq_route, needs_grad
from .quant import quantize_mpq

EXPERT_PROJS = ("gate", "up", "down")


def init_moe_experts(
    generator: Optional[torch.Generator],
    num_experts: int,
    hidden: int,
    intermediate: int,
    w_bit: int = 4,
    group_size: int = 64,
    scale: float = 0.02,
    stack: bool = True,
    device=None,
):
    """Random ``E`` quantized SwiGLU experts: each projection ``normal ×
    scale`` drawn from ``generator`` on ``device`` (``None`` means ``cuda``)
    and quantized by ``quantize_mpq``, its f32 draw freed before the next.
    ``stack=True`` returns the stacked form, ``stack=False`` the tuple of
    per-expert dicts.  On the ``meta`` device nothing is drawn."""
    device = resolve_device(device)
    shapes = {"gate": (hidden, intermediate), "up": (hidden, intermediate),
              "down": (intermediate, hidden)}
    experts = []
    for _ in range(num_experts):
        expert = {}
        for name in EXPERT_PROJS:
            w = torch.randn(shapes[name], generator=generator, device=device) * scale
            expert[name] = quantize_mpq(w, w_bit=w_bit, group_size=group_size)
            del w
        experts.append(expert)
    return stack_experts(experts) if stack else tuple(experts)


def _fields(qt: MPQTensor):
    return {f.name: getattr(qt, f.name) for f in dataclasses.fields(qt)}


def stack_experts(experts):
    """Per-expert dicts of records → one dict of records whose tensor fields
    are stacked on a new leading ``E`` axis; every static field (and which
    fields are ``None``) must agree across the experts."""
    out = {}
    for name in experts[0]:
        per = [_fields(e[name]) for e in experts]
        fields = {}
        for key, first in per[0].items():
            vals = [p[key] for p in per]
            if isinstance(first, torch.Tensor):
                if not all(isinstance(v, torch.Tensor) for v in vals):
                    raise ValueError(f"{name}.{key}: a tensor in some experts only")
                fields[key] = torch.stack(vals)
            elif any(v != first for v in vals):
                raise ValueError(f"{name}.{key}: the experts disagree ({vals})")
            else:
                fields[key] = first
        out[name] = MPQTensor(**fields)
    return out


def _expert_slice(experts, e: int):
    """Expert ``e`` from either form."""
    if isinstance(experts, (tuple, list)):
        return experts[e]
    return {name: MPQTensor(**{k: v[e] if isinstance(v, torch.Tensor) else v
                               for k, v in _fields(qt).items()})
            for name, qt in experts.items()}


def expert_shardings(mesh, experts, axis: str = "ep"):
    """This rank's ``E/ep`` experts along ``axis``, in either form (the
    stacked records' leading E axis cut, contiguous; the tuple sliced)."""
    n, i = mesh.size(axis), mesh.coord(axis)
    e = num_experts(experts)
    if e % n:
        raise ValueError(f"{e} experts do not split over {axis}={n}")
    lo, hi = i * (e // n), (i + 1) * (e // n)
    if isinstance(experts, (tuple, list)):
        return type(experts)(experts[lo:hi])
    return {name: MPQTensor(**{k: v[lo:hi].clone() if isinstance(v, torch.Tensor) else v
                               for k, v in _fields(qt).items()})
            for name, qt in experts.items()}


def num_experts(experts) -> int:
    if isinstance(experts, (tuple, list)):
        return len(experts)
    return next(iter(experts.values())).packed.shape[0]


def _expert_mlp(exp, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """One expert's SwiGLU on its buffer ``x``; over ``tp`` (its gate and
    up this rank's columns, its down the matching rows) the down's f32
    partials summed over the axis and cast once."""
    gate = F.silu(mpq_linear(x, exp["gate"]).float()).to(x.dtype)
    h = gate * mpq_linear(x, exp["up"])
    if _axis_size(mesh, "tp") == 1:
        return mpq_linear(h, exp["down"])
    part = mpq_linear(h, exp["down"], out_dtype=torch.float32)
    return all_reduce_diff(mesh, part, "tp").to(x.dtype)


# a layer's kernel-2 groups (or None: its experts take the loop), by its
# first gate's codes, dropped with them
_GROUPS = WeakIdKeyDictionary()


def _expert_groups(gate_up, down, device_type: str):
    """The grouped route's kernel-2 groups of a layer's experts, every gate
    then every up, and every down; None where they do not group: records
    of another :func:`group_key` or ``act_bits`` in either set, a ragged
    ``g_idx``, a TPU row layout, or asym zeros off the card (the loop's
    CPU reconstruction reads them as ``s·(q − z)``, kernel 2's plain
    version in the kernel form).  Checked once a layer: the groups hold
    the records' tensors weakly and are kept while they match."""
    hit = _GROUPS.get(gate_up[0].packed, False)
    if hit is None or (hit and hit[0].holds(gate_up) and hit[1].holds(down)):
        return hit
    groups = None
    if all(len({group_key(qt) + (qt.act_bits,) for qt in qts}) == 1
           and qts[0].g_idx is None and qts[0].layout == "gptq"
           and (not qts[0].asym or device_type == "cuda") for qts in (gate_up, down)):
        groups = DequantGroup(gate_up), DequantGroup(down)
    _GROUPS[gate_up[0].packed] = groups
    return groups


def _grouped_experts(experts, xs: torch.Tensor, mesh) -> Optional[torch.Tensor]:
    """Every local expert's SwiGLU on its buffer ``xs[e]`` (``xs`` is
    ``(E_local, C, d)``) in batched launches, ``(E_local, C, d)``; None
    where the loop runs instead (see the module's notes).  The loop's
    arithmetic: each weight from kernel 2 in ``xs.dtype``, the products
    from one batched GEMM each (their sums in another order than the
    loop's ``torch.matmul`` may take), the SwiGLU's elementwise chain."""
    if _axis_size(mesh, "tp") > 1:
        return None
    local, rows = xs.shape[0], xs.shape[1]
    records = [_expert_slice(experts, e) for e in range(local)]
    gate_up = [r["gate"] for r in records] + [r["up"] for r in records]
    down = [r["down"] for r in records]
    dev = xs.device.type
    if any(needs_grad(xs, qt.grad_shadow) for qt in gate_up + down):
        return None
    groups = _expert_groups(gate_up, down, dev)
    if groups is None or any(mpq_route(qts[0], rows, dev) != "reconstruct" for qts in (gate_up, down)):
        return None
    w = dequant_mpq_grouped(gate_up, xs.dtype, groups[0])
    gate = F.silu(torch.bmm(xs, w[:local]).float()).to(xs.dtype)
    h = gate * torch.bmm(xs, w[local:])
    return torch.bmm(h, dequant_mpq_grouped(down, xs.dtype, groups[1]))


def _slots(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each route's slot in its expert's buffer: the count of earlier
    routes (row-major by token) to the same expert, from a stable sort by
    expert and each expert's first place in the sorted routes."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, torch.arange(num_experts, device=flat_e.device))
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - first[sorted_e]
    return torch.empty_like(rank).scatter_(0, order, rank)


def _axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None or axis not in mesh.shape else mesh.size(axis)


def route(x2: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """f32 router probabilities ``(T, E)`` of the rows ``x2`` and each row's
    top-k experts ``(T, k)`` by probability, ties to the lower expert index
    (a stable sort, as ``lax.top_k``)."""
    probs = torch.softmax(x2.float() @ router_w.float(), dim=-1)
    return probs, torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]


def moe_mlp(
    x: torch.Tensor,
    router_w: torch.Tensor,
    experts,
    top_k: int = 2,
    capacity_factor: Optional[float] = 1.25,
    renormalize: bool = True,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routed MoE MLP: ``x`` (..., d), ``router_w`` (d, E), ``experts``
    in either form → ``(y, aux_loss, dropped_frac)``.

    The JAX package's semantics: the routes of :func:`route`;
    ``renormalize`` (Mixtral) makes the k gates sum to 1.
    ``C = T`` when ``capacity_factor`` is None, else ``max(1, min(T,
    ceil(T·k/E·capacity_factor)))``.  A route's slot in its expert's buffer
    is the count of earlier routes to that expert, row-major by token;
    routes past ``C`` are dropped (sent to slot ``C - 1`` with no
    contribution).  The combine sums each token's k weighted outputs in f32
    in choice order.  ``aux_loss = Σ_e frac_e · mean_p_e · E / k`` (1 for a
    uniform router); ``dropped_frac`` is the share of routes dropped.
    With a ``mesh`` whose ``ep`` axis has ``n > 1`` ranks, ``experts`` are
    this rank's ``E/n`` (:func:`expert_shardings`) and ``x`` the same on
    every rank: see the module's notes."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    T, E = x2.shape[0], router_w.shape[1]

    n_ep = _axis_size(mesh, "ep")
    local = num_experts(experts)
    if local * n_ep != E:
        raise ValueError(f"{local} experts a rank over ep={n_ep} for a router of {E}")
    e0 = 0 if n_ep == 1 else mesh.coord("ep") * local

    with annotate("bie.moe.route", fine=True):
        probs, gate_idx = route(x2, router_w, top_k)
        gate_vals = probs.gather(1, gate_idx)  # (T, k)
        if renormalize:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    if capacity_factor is None:
        C = T
    else:
        C = max(1, min(T, math.ceil(T * top_k / E * capacity_factor)))
    with annotate("bie.moe.dispatch", fine=True):
        count("moe_routed_rows", T * top_k)
        flat_e = gate_idx.reshape(-1)  # (T·k,) row-major by token
        pos_in_e = _slots(flat_e, E)
        keep = pos_in_e < C
        pos_c = torch.where(keep, pos_in_e, C - 1)

        tok_idx = torch.arange(T, device=x.device).repeat_interleave(top_k)
        routed = torch.where(keep[:, None], x2[tok_idx], 0).to(x2.dtype)
        # kept routes own distinct slots; a dropped one adds an exact zero
        disp = torch.zeros((E, C, d), dtype=x2.dtype, device=x.device).index_put(
            (flat_e, pos_c), routed, accumulate=True)

    with annotate("bie.moe.experts", fine=True):
        count("moe_computed_rows", local * C)
        if n_ep > 1:
            disp = sum_grad(mesh, disp, "ep")  # each rank's backward fills its experts' rows
        if _axis_size(mesh, "tp") > 1:
            disp = sum_grad(mesh, disp, "tp")  # each rank's gate and up give their columns' share
        outs = _grouped_experts(experts, disp[e0:e0 + local], mesh)
        count("moe_grouped_rows", 0 if outs is None else local * C)
        if outs is None:
            outs = torch.stack([_expert_mlp(_expert_slice(experts, e), disp[e0 + e], mesh)
                                for e in range(local)])
        if n_ep > 1:
            outs = all_gather_diff(mesh, outs, "ep", dim=0)  # (E, C, d), every rank alike

    with annotate("bie.moe.combine", fine=True):
        w = (gate_vals.reshape(-1) * keep).float()
        contrib = (outs[flat_e, pos_c].float() * w[:, None]).reshape(T, top_k, d)
        y = contrib[:, 0]
        for j in range(1, top_k):
            y = y + contrib[:, j]

        frac = F.one_hot(gate_idx, E).float().sum(dim=1).mean(dim=0)  # (E,)
        aux = torch.sum(frac * probs.mean(dim=0)) * E / top_k
        dropped = 1.0 - keep.float().mean()
    return y.to(x.dtype).reshape(*lead, d), aux, dropped
