"""Pipeline parallelism: the GPipe schedule over the ``pp`` axis.  The
counterpart of ``bitorch_engine_tpu/parallel/pipeline.py``.

The model's layers are split into ``S`` contiguous **stages**, one a rank
of the ``pp`` axis; the batch into ``M`` **microbatches**.  Every rank runs
the same schedule of ``S + M − 1`` ticks: at tick ``t`` the rank holding
stage ``s`` runs microbatch ``t − s`` (when in range) and sends its
activation to stage ``s + 1`` (``comm.send`` / ``comm.recv``, one send a
tick), the last stage keeps its finished microbatches, and at the end they
are shared to every rank (an all-reduce over ``pp`` in which the other
stages add zeros, as the JAX package's ``psum``), so every rank returns
the whole output.

Where the JAX package stacks the stages' parameters on a leading axis
sharded over ``pp`` (:func:`stack_stages`, :func:`stage_shardings`) and
indexes its own inside ``shard_map``, here :func:`stage_shardings` cuts
this rank's stage out of the stacked tree (as ``sharding.shard_params``
cuts a tp shard) and each rank passes its own stage to
:func:`pipeline_apply`, whatever ``stage_fn`` takes: tensors, records (an
``MPQTensor`` stage runs ``mpq_linear``: kernel 1 or 2 on the card) or
modules.

The pipeline is differentiable end to end (one ``torch.autograd.Function``
that keeps each microbatch's graph; its backward runs the ticks in reverse
with ``torch.autograd.grad``, each cotangent sent from stage ``s + 1`` to
stage ``s``).  Two shares are kept apart:

* the output is replicated and every rank computes the same loss from it,
  so its cotangent is handed to the last stage **once** (from that rank's
  own loss), never summed over the ``S`` ranks;
* the input is replicated too: its cotangent, which only stage 0 computes,
  is shared to every rank (the all-reduce's transpose), so a parameter
  used before the pipeline (an embedding) gets the same whole gradient on
  every rank, as one after it (a head) does.

So no gradient is summed over ``pp``: each rank holds its stage's
gradients and the whole gradients of what runs around the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
from torch import nn

from .comm import all_reduce, recv, send
from .mesh import Mesh


def _tree_map(fn, *trees):
    """``fn`` over the tensors of same-shaped trees of dicts, lists, tuples
    and records (frozen dataclasses); other leaves come from the first."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    if dataclasses.is_dataclass(first):
        changes = {f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
                   for f in dataclasses.fields(first)
                   if isinstance(getattr(first, f.name), (torch.Tensor, tuple, list, dict))}
        return dataclasses.replace(first, **changes)
    return first


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def add(t):
        out.append(t)
        return t

    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    _tree_map(add, tree)
    return out


def stack_stages(params_list):
    """Stack per-stage parameter trees on a new leading stage axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *params_list)


def stage_shardings(mesh: Mesh, stacked_params, axis: str = "pp"):
    """This rank's stage of a stacked tree: index ``coord(axis)`` of the
    leading axis of every tensor (a contiguous copy)."""
    i = mesh.coord(axis)
    return _tree_map(lambda a: a[i].clone(), stacked_params)


def _schedule(stage_fn, stage_params, xs, mesh: Mesh, axis: str, keep_graphs: bool):
    """The forward ticks: this rank's stage over its microbatches.  Returns
    the finished microbatches (zeros but on the last stage) and, with
    ``keep_graphs``, each microbatch's ``(input, output)`` under autograd."""
    S, s, M = mesh.size(axis), mesh.coord(axis), xs.shape[0]
    outs = torch.zeros_like(xs)
    graphs, sends = {}, []
    for t in range(S + M - 1):
        m = t - s
        if not 0 <= m < M:
            continue
        x_in = xs[m] if s == 0 else recv(mesh, xs[m], axis, frm=s - 1)
        if keep_graphs:
            x_in = x_in.detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(stage_params, x_in)
            graphs[m] = (x_in, y)
        else:
            y = stage_fn(stage_params, x_in)
        if y.shape != x_in.shape or y.dtype != x_in.dtype:
            raise ValueError(f"a stage maps {tuple(x_in.shape)} {x_in.dtype} to "
                             f"{tuple(y.shape)} {y.dtype}: stages keep shape and dtype")
        if s < S - 1:
            sends.append(send(mesh, y.detach(), axis, to=s + 1))
        else:
            outs[m] = y.detach()
    for pending in sends:
        pending.wait()
    # the finished microbatches to every rank (the JAX package's psum)
    return _share(mesh, outs, axis), graphs


def _share(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of ``t``, zeros on all ranks but one: that
    rank's ``t`` on every rank, exactly (``x + 0`` is ``x``)."""
    return all_reduce(mesh, t, axis)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, stage_params, mesh, axis, xs, *params):
        outs, graphs = _schedule(stage_fn, stage_params, xs, mesh, axis, keep_graphs=True)
        ctx.graphs, ctx.params, ctx.args = graphs, params, (mesh, axis)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        mesh, axis = ctx.args
        S, s, M = mesh.size(axis), mesh.coord(axis), g_outs.shape[0]
        params = list(ctx.params)
        dparams: List[Optional[torch.Tensor]] = [None] * len(params)
        dxs = torch.zeros_like(g_outs)
        sends = []
        for t in reversed(range(S + M - 1)):
            m = t - s
            if not 0 <= m < M:
                continue
            x_in, y = ctx.graphs.pop(m)
            # the last stage reads the output's cotangent (its own loss's: once)
            dy = g_outs[m] if s == S - 1 else recv(mesh, y, axis, frm=s + 1)
            grads = torch.autograd.grad(y, [x_in] + params, dy, allow_unused=True)
            for j, g in enumerate(grads[1:]):
                if g is not None:
                    dparams[j] = g if dparams[j] is None else dparams[j] + g
            if s > 0:
                sends.append(send(mesh, grads[0], axis, to=s - 1))
            else:
                dxs[m] = grads[0]
        for pending in sends:
            pending.wait()
        # the input is replicated: stage 0's cotangent to every rank
        dxs = _share(mesh, dxs, axis)
        return (None, None, None, None, dxs) + tuple(dparams)


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh: Mesh,
    axis: str = "pp",
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """Run ``x`` through the ``S = mesh.size(axis)`` pipelined stages.

    ``stage_fn(stage_params, x_mb) -> y_mb`` applies one stage to one
    microbatch, keeping its shape and dtype; ``stage_params`` is this
    rank's stage (:func:`stage_shardings`), a tree of tensors and records
    or a module; ``x`` is the global input ``(batch, ...)``, the same on
    every rank; ``num_microbatches`` (default ``S``) must divide the batch.
    Returns the stages applied in order, on every rank; differentiable in
    ``x`` and in the stage's tensors that require grad."""
    M = num_microbatches or mesh.size(axis)
    b = x.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible by microbatches {M}")
    xs = x.reshape(M, b // M, *x.shape[1:])
    params = [t for t in _tensors(stage_params) if t.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        outs = _GPipe.apply(stage_fn, stage_params, mesh, axis, xs, *params)
    else:
        outs, _ = _schedule(stage_fn, stage_params, xs, mesh, axis, keep_graphs=False)
    return outs.reshape(x.shape)
