"""Sharding rules for quantized-record trees and DiodeMix's state: the
counterpart of ``bitorch_engine_tpu/parallel/sharding.py``.

A spec is a :class:`P`, the port's stand-in for JAX's ``PartitionSpec``: a
tuple holding, per tensor dimension, the mesh axis it is split over or
``None``.  A record's spec is a record of the same type whose tensor fields
hold ``P``s, as in the JAX package, so the JAX tests' assertions read the
same here.

Column-parallel MPQ tensors split the output features (N); row-parallel
ones split the packed rows, whole quant groups and whole int32 words to a
shard (:func:`mpq_row_parallel_spec` checks).

:func:`shard_params` cuts this rank's shard out of each tensor by its spec.
The JAX package placed whole records with ``device_put`` and, across
processes, ``global_put`` (``parallel/multiprocess.py:57``); here every rank
builds the same host values (a seeded init, or one checkpoint) and keeps its
own shard, so ``global_put`` needs no counterpart.

:func:`optimizer_partition_specs` gives DiodeMix's moments their specs:
every 2-D moment ``P(fsdp, tp)`` (its K rows over fsdp, its N columns
with the weight's over tp), every other ``P()``.  ``DiodeMix(mesh=)``
keeps the fsdp rows itself; a tp-cut layer's moments have its local N.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional

import torch

from ..qtensor import BinaryEmbeddingQTensor, BinaryQTensor, IntQTensor, MBWQTensor, MPQTensor
from .mesh import Mesh

RECORDS = (MPQTensor, MBWQTensor, BinaryQTensor, IntQTensor, BinaryEmbeddingQTensor)


class P(tuple):
    """A partition spec: per dimension, a mesh axis name or ``None``;
    ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _opt(t, spec):
    return None if t is None else spec


def mpq_column_parallel_spec(qt: MPQTensor, axis: str = "tp") -> MPQTensor:
    """Specs of an N-sharded (column-parallel) MPQ tensor."""
    return qt.replace(
        packed=P(None, axis),
        scales=P(None, axis),
        zeros=P(None, axis),  # asym packed zeros are (G, N/32*b): N-sharded too
        g_idx=_opt(qt.g_idx, P(None)),
        q_perm=_opt(qt.q_perm, P(None)),
        grad_shadow=_opt(qt.grad_shadow, P(None, axis)),
    )


def mpq_row_parallel_spec(qt: MPQTensor, axis: str = "tp", n_shards: int = 1) -> MPQTensor:
    """Specs of a K-sharded (row-parallel) MPQ tensor.  The packed rows and
    the groups must divide by ``n_shards``: each shard owns whole quant
    groups (scales and zeros split along G with them) and whole words."""
    kw, g = qt.packed.shape[0], qt.scales.shape[0]
    if n_shards > 1 and (kw % n_shards or g % n_shards):
        raise ValueError(
            f"row-parallel needs packed rows ({kw}) and groups ({g}) divisible "
            f"by shards ({n_shards}); pad K or use column-parallel"
        )
    return qt.replace(
        packed=P(axis, None),
        scales=P(axis, None),
        zeros=P(axis, None),
        g_idx=_opt(qt.g_idx, P(axis)),
        q_perm=_opt(qt.q_perm, P(axis)),
        grad_shadow=_opt(qt.grad_shadow, P(axis, None)),
    )


def _default_qtensor_spec(qt, axis: str = "tp"):
    if isinstance(qt, MPQTensor):
        return mpq_column_parallel_spec(qt, axis)
    if isinstance(qt, (BinaryQTensor, IntQTensor)):
        # (N, K) / (N, K/32): shard output features
        return qt.replace(data=P(axis, None), scale_w=P(),
                          grad_shadow=_opt(qt.grad_shadow, P(axis, None)))
    if isinstance(qt, BinaryEmbeddingQTensor):
        return qt.replace(data=P(axis, None), scale=P(axis, None),
                          grad_shadow=_opt(qt.grad_shadow, P(axis, None)))
    if isinstance(qt, MBWQTensor):
        return qt.replace(
            segments=tuple(mpq_column_parallel_spec(s, axis) for s in qt.segments),
            q_perm=_opt(qt.q_perm, P(None)),
            channel_scale=_opt(qt.channel_scale, P(None)),
            block_perm=_opt(qt.block_perm, P(None)),
            grad_shadow=_opt(qt.grad_shadow, P(None, axis)),
        )
    raise TypeError(type(qt))


def _replicated(qt):
    """Every tensor field of a record ``P()`` (segments included)."""
    changes = {}
    for f in dataclasses.fields(qt):
        v = getattr(qt, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = P()
        elif isinstance(v, tuple) and v and isinstance(v[0], RECORDS):
            changes[f.name] = tuple(_replicated(s) for s in v)
    return qt.replace(**changes)


def rule_choice(rules: Dict[str, Any], path: str):
    """The value of the first of ``rules`` whose regex matches ``path``
    ('/'-joined, layer indices collapsed to '*'), or ``None``."""
    key = re.sub(r"\b\d+\b", "*", path)
    for pat, val in rules.items():
        if re.search(pat, key):
            return val
    return None


def make_sharding_rules(rules: Dict[str, Any], default_axis: str = "tp") -> Callable:
    """A path → spec function from regex rules.

    ``rules`` maps path regexes (:func:`rule_choice`) to a :class:`P` (fp
    leaves) or to one of 'column' / 'row' / 'replicated' (record leaves);
    the first match wins."""

    def spec_for(path: str, leaf):
        choice = rule_choice(rules, path)
        if isinstance(leaf, RECORDS):
            if choice == "row":
                return mpq_row_parallel_spec(leaf, default_axis)
            if choice == "replicated":
                return _replicated(leaf)
            return _default_qtensor_spec(leaf, default_axis)
        if choice is None or isinstance(choice, str):
            return P()
        return choice

    return spec_for


def _map_tree(tree, fn, path=""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples whose
    leaves are records and tensors."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [_map_tree(v, fn, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(path, tree)


def _leaf_spec(rule_fn: Optional[Callable], axis: str) -> Callable:
    def spec(path, leaf):
        if rule_fn is not None:
            return rule_fn(path, leaf)
        if isinstance(leaf, RECORDS):
            return _default_qtensor_spec(leaf, axis)
        return P()

    return spec


def partition_specs(params, rule_fn: Optional[Callable] = None, axis: str = "tp"):
    """A spec tree matching ``params`` (records and tensors in dicts, lists
    and tuples, as ``utils.convert.params_tree`` gives a model's)."""
    return _map_tree(params, _leaf_spec(rule_fn, axis))


def shard_tensor(t: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, a contiguous copy (a view
    would keep the whole tensor alive)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.size(axis), mesh.coord(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over {axis}={n}")
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t.clone(memory_format=torch.contiguous_format)


def shard_record(qt, spec, mesh: Mesh):
    """A record with every tensor field cut by the field's spec."""
    changes = {}
    for f in dataclasses.fields(qt):
        v, s = getattr(qt, f.name), getattr(spec, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = shard_tensor(v, s, mesh)
        elif isinstance(v, tuple) and v and isinstance(v[0], RECORDS):
            changes[f.name] = tuple(shard_record(a, b, mesh) for a, b in zip(v, s))
    return qt.replace(**changes)


def shard_params(params, mesh: Mesh, rule_fn: Optional[Callable] = None, axis: str = "tp"):
    """This rank's shards of ``params`` under :func:`partition_specs`."""
    spec_of = _leaf_spec(rule_fn, axis)

    def cut(path, leaf):
        spec = spec_of(path, leaf)
        if isinstance(leaf, RECORDS):
            return shard_record(leaf, spec, mesh)
        if isinstance(leaf, torch.Tensor):
            return shard_tensor(leaf, spec, mesh)
        return leaf

    return _map_tree(params, cut)


def optimizer_partition_specs(optimizer, tp_axis: str = "tp", fsdp_axis: Optional[str] = "fsdp"):
    """Specs of ``optimizer``'s state (a ``DiodeMix``), in the shape of its
    ``state_dict()``: ``{"step": P(), "state": {name: {key: spec}}}``,
    every 2-D moment ``P(fsdp_axis, tp_axis)`` (``P(None, tp_axis)``
    without an fsdp axis) and every other one ``P()``; GaLore's state is
    read through its fields."""
    spec2d = P(fsdp_axis, tp_axis)

    def spec(v):
        if dataclasses.is_dataclass(v):
            return {f.name: spec(getattr(v, f.name)) for f in dataclasses.fields(v)}
        return spec2d if isinstance(v, torch.Tensor) and v.dim() == 2 else P()

    return {"step": P(), "state": {name: {key: spec(v) for key, v in st.items()}
                                   for name, st in optimizer.state.items()}}
