"""Llama's tensor-parallel layout (Megatron) over a process mesh: the
counterpart of ``bitorch_engine_tpu/models/llama_sharding.py``.

* q / k / v, gate / up and the head are **column-parallel**: each rank
  holds a share of their output features;
* o and down are **row-parallel**: each rank holds a share of their input
  features (whole quant groups) and the model sums the ranks' f32 partials
  (``models/llama.py`` ``_row_parallel``);
* the embedding and the norms are replicated;
* a MoE model's experts split over the ``ep`` axis (each rank holds E/ep
  of every layer's experts, ``ops/moe.py``), the rest replicated; or,
  over ``tp``, every expert's gate and up column-parallel over ``inter /
  tp`` and its down row-parallel, the dense MLP's rule (a Megatron layout:
  the JAX specs shard every expert leaf ``P(None, 'tp')`` and GSPMD adds
  the collectives; the numbers agree up to the f32 split sum).  The router
  stays replicated.  On a mesh with both, each rank keeps its ``E/ep``
  experts, each cut over ``tp``;
* a padded projection (``proj_pad_to``) loses its padding: a column shard
  takes logical columns only, a row shard the logical output columns, so
  no shard carries an ``out_slice``;
* a layer in training mode (a grad shadow) gives its shard the shadow's
  matching block, ``P(None, tp)`` for a column shard and ``P(tp, None)``
  for a row shard, as the JAX specs cut it (an act-order row shard: the
  shadow's rows ``tp_rows``); so ``prepare_for_training`` may run before
  or after :func:`shard_llama_params`;
* KV caches split their batch (slots) over dp and their heads over tp
  (``kv_cache_shardings`` / ``paged_kv_shardings``, kept beside the cache
  builders in ``models/paged_kv.py``, which read them).

:data:`LLAMA_RULES` decides each projection's layout: :func:`llama_partition_specs`
gives the JAX package's specs from it, and :func:`shard_llama_params` cuts
a whole model down to this rank's part by it, by heads rather than by
halves of a fused N axis: q by
``nh / tp`` query heads, k and v by the KV heads those query heads read
(``nkv / tp``, or the one they share where ``nkv < tp``, replicated over
``tp / nkv`` ranks as Megatron does), gate and up by ``inter / tp``, and a
fused q|k|v or gate|up is re-fused from its parts on the rank, so no
collective sits between a projection and attention.  GSPMD reshuffles
around its half split of the fused axis instead; column sharding changes no
sum, so the numbers are the same.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..layers.basic import Dense
from ..layers.linear import MBWQLinear, MPQLinear
from ..ops.quant import slice_mpq_n
from ..parallel.mesh import Mesh
from ..parallel.sharding import (
    P,
    make_sharding_rules,
    mpq_row_parallel_spec,
    partition_specs,
    rule_choice,
    shard_record,
)
from ..qtensor import MPQTensor
from .llama import LlamaMLP, LlamaModel, QuantMoEMLP
from .paged_kv import kv_cache_shardings, local_kv_heads, paged_kv_shardings  # noqa: F401

LLAMA_RULES = {
    r"(q|k|v)_proj": "column",
    r"(gate|up)_proj": "column",
    r"(o|down)_proj": "row",
    # vocab-dim (output-features) sharding: each shard owns a logits slice
    r"lm_head": "column",
    r"embed": "replicated",
}


def llama_partition_specs(params, axis: str = "tp"):
    """Spec tree for a Llama parameter tree (a model is read through
    ``utils.convert.params_tree``)."""
    if isinstance(params, nn.Module):
        from ..utils.convert import params_tree  # that module imports models.llama

        params = params_tree(params)
    rules = make_sharding_rules(LLAMA_RULES, default_axis=axis)
    return partition_specs(params, rules, axis)


Ranges = Sequence[Tuple[int, int]]


def _cols_mpq(qt: MPQTensor, ranges: Ranges) -> MPQTensor:
    """The output columns ``[start, start + size)`` of each range, in
    order, as one contiguous tensor (an act-order tensor keeps its whole
    ``q_perm`` / ``g_idx``: they index rows), its grad shadow's columns
    with them."""
    parts = [slice_mpq_n(qt, start, size) for start, size in ranges]
    shadow = qt.grad_shadow
    if shadow is not None:
        shadow = torch.cat([shadow.detach()[:, s : s + n] for s, n in ranges], dim=1)
    return qt.replace(
        packed=torch.cat([p.packed for p in parts], dim=1),
        scales=torch.cat([p.scales for p in parts], dim=1),
        zeros=torch.cat([p.zeros for p in parts], dim=1),
        grad_shadow=shadow,
    )


def _bias_cols(bias, ranges: Ranges):
    if bias is None:
        return None
    return nn.Parameter(torch.cat([bias[s : s + n] for s, n in ranges]).contiguous(),
                        requires_grad=False)


def _check_shardable(layer: nn.Module, where: str) -> None:
    if isinstance(layer, MBWQLinear):
        # the JAX package's row rule hands an MBWQ tensor to
        # mpq_row_parallel_spec, which reads MPQ fields it does not have
        raise NotImplementedError(f"{where}: tp sharding of MBWQ projections is not a feature "
                                  "of the JAX package, nor of the port")


def column_shard(layer: nn.Module, ranges: Ranges, where: str) -> nn.Module:
    """A new layer holding the output columns of ``ranges`` (concatenated;
    logical columns, so a padded layer's padding is left behind)."""
    _check_shardable(layer, where)
    if isinstance(layer, Dense):
        kernel = torch.cat([layer.kernel[:, s : s + n] for s, n in ranges], dim=1)
        out = Dense(*kernel.shape, layer.bias is not None, device="meta", dtype=layer.dtype)
        out.kernel = nn.Parameter(kernel.contiguous(), requires_grad=False)
        out.bias = _bias_cols(layer.bias, ranges)
        return out
    qt = _cols_mpq(layer.qweight, ranges)
    out = MPQLinear(qt.in_features, qt.out_features, dtype=layer.dtype, qweight=qt)
    out.bias = _bias_cols(layer.bias, ranges)
    return out


def row_shard(layer: nn.Module, mesh: Mesh, axis: str, where: str) -> nn.Module:
    """A new layer holding this rank's equal share of the input rows: whole
    quant groups and whole words (``mpq_row_parallel_spec``'s check).  A
    canonical act-order tensor (``q_perm``) is cut by its stored rows; the
    logical rows they hold ride along as ``tp_rows``.  A ragged ``g_idx``
    tensor keeps every group's scales and zeros and its rows' ``g_idx``
    (whole words of rows).  A padded layer keeps its logical output
    columns only."""
    _check_shardable(layer, where)
    n, i = mesh.size(axis), mesh.coord(axis)
    if getattr(layer, "bias", None) is not None:
        raise ValueError(f"{where}: a row-parallel projection takes no bias")
    if isinstance(layer, Dense):
        k = layer.kernel.shape[0] // n
        out = Dense(k, layer.kernel.shape[1], False, device="meta", dtype=layer.dtype)
        out.kernel = nn.Parameter(layer.kernel[i * k : (i + 1) * k].contiguous(),
                                  requires_grad=False)
        return out
    qt = layer.qweight
    if layer.out_slice is not None:
        qt = _cols_mpq(qt, [(0, layer.out_slice)])
    shadow = qt.grad_shadow
    q_perm = qt.q_perm
    qt = qt.replace(q_perm=None, grad_shadow=None)
    if qt.g_idx is not None:
        # a ragged g_idx: this rank's rows read groups anywhere, so the
        # shard keeps every group's scales and zeros and its rows' g_idx
        spec = mpq_row_parallel_spec(qt, axis, n_shards=1)
        spec = spec.replace(scales=P(), zeros=P())
    else:
        spec = mpq_row_parallel_spec(qt, axis, n_shards=n)
    qt = shard_record(qt, spec, mesh)
    k = qt.in_features
    rows = None if q_perm is None else q_perm[i * k : (i + 1) * k].long().contiguous()
    if shadow is not None:
        # the shadow's rows are logical: the act-order shard's are tp_rows
        shadow = shadow.detach()
        shadow = shadow[i * k : (i + 1) * k] if rows is None else shadow[rows]
        qt = qt.replace(grad_shadow=shadow.contiguous())
    out = MPQLinear(qt.in_features, qt.out_features, dtype=layer.dtype, qweight=qt)
    if rows is not None:
        out.register_buffer("tp_rows", rows)
    return out


def _shard_experts(model: LlamaModel, mesh: Mesh) -> LlamaModel:
    """Keep this rank's ``E/ep`` experts of every MoE layer (``ops.moe
    .expert_shardings``' cut of the tuple form)."""
    from ..ops.moe import expert_shardings

    if "ep" not in mesh.shape:
        raise ValueError(f"a MoE model shards its experts over an 'ep' axis; the mesh has "
                         f"{tuple(mesh.shape)}")
    for layer in model.layers:
        mlp = layer.mlp
        if isinstance(mlp, QuantMoEMLP):
            mlp.experts = torch.nn.ModuleList(expert_shardings(mesh, tuple(mlp.experts)))
            mlp.mesh = mesh
    model.mesh = mesh
    return model


def _shard_expert_tp(expert: nn.Module, mesh: Mesh, axis: str, where: str) -> None:
    """An expert's gate and up cut to this rank's ``inter / tp`` columns,
    its down to the matching rows, in place."""
    tp, r = mesh.size(axis), mesh.coord(axis)
    inter = expert.gate.qweight.out_features
    if inter % tp:
        raise ValueError(f"{where}: intermediate size {inter} does not split over tp={tp}")
    cols = [(r * (inter // tp), inter // tp)]
    expert.gate = column_shard(expert.gate, cols, f"{where}/gate")
    expert.up = column_shard(expert.up, cols, f"{where}/up")
    expert.down = row_shard(expert.down, mesh, axis, f"{where}/down")


@torch.no_grad()
def shard_llama_params(model: LlamaModel, mesh: Mesh, axis: str = "tp") -> LlamaModel:
    """Cut ``model`` (every rank holding the same whole model) down to this
    rank's tensor-parallel part, in place; returns it.  The model then
    runs its forward with this rank's heads and the collectives of
    ``mesh``'s ``axis`` group; ``model.cfg`` stays the global config.  A
    MoE model on a mesh whose ``tp`` axis has size 1 (or none) keeps this
    rank's experts of the mesh's ``ep`` axis instead; over ``tp`` its
    experts (this rank's of ``ep``, where the mesh has one) are cut as the
    dense MLP (see the module's notes)."""
    cfg = model.cfg
    tp = mesh.size(axis) if axis in mesh.shape else 1
    if cfg.moe_num_experts and (tp == 1 or ("ep" in mesh.shape and mesh.size("ep") > 1)):
        _shard_experts(model, mesh)  # this rank's experts of ep, then each cut over tp
        if tp == 1:
            return model
    r = mesh.coord(axis)
    hd, nh, nkv, inter = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    nh_l, nkv_l = nh // tp, local_kv_heads(cfg, tp)
    if inter % tp:
        raise ValueError(f"intermediate size {inter} does not split over tp={tp}")
    kv0 = r * nh_l // (nh // nkv)  # the first KV head this rank's query heads read
    q_cols = (r * nh_l * hd, nh_l * hd)
    k_cols = (kv0 * hd, nkv_l * hd)
    i_cols = (r * (inter // tp), inter // tp)
    off_k, off_v = nh * hd, (nh + nkv) * hd
    # each projection's output columns a rank keeps, where it is column-parallel
    cols = dict(qkv_proj=[q_cols, (off_k + k_cols[0], k_cols[1]), (off_v + k_cols[0], k_cols[1])],
                q_proj=[q_cols], k_proj=[k_cols], v_proj=[k_cols],
                gate_up_proj=[i_cols, (inter + i_cols[0], i_cols[1])],
                gate_proj=[i_cols], up_proj=[i_cols])

    def cut(parent: nn.Module, name: str, path: str) -> None:
        layer, choice = getattr(parent, name), rule_choice(LLAMA_RULES, path)
        if choice == "column":
            setattr(parent, name, column_shard(layer, cols[name], path))
        elif choice == "row":
            setattr(parent, name, row_shard(layer, mesh, axis, path))
        else:
            raise ValueError(f"{path}: LLAMA_RULES gives {choice!r}, not a tp projection layout")

    for li, layer in enumerate(model.layers):
        attn, mlp = layer.attn, layer.mlp
        where = f"layer_{li}"
        names = ["qkv_proj"] if cfg.fuse_qkv else ["q_proj", "k_proj", "v_proj"]
        for name in names + ["o_proj"]:
            cut(attn, name, f"{where}/attn/{name}")
        if isinstance(mlp, QuantMoEMLP):
            for e, expert in enumerate(mlp.experts):
                _shard_expert_tp(expert, mesh, axis, f"{where}/mlp/experts/{e}")
        elif isinstance(mlp, LlamaMLP):
            names = ["gate_up_proj"] if cfg.fuse_gate_up else ["gate_proj", "up_proj"]
            for name in names + ["down_proj"]:
                cut(mlp, name, f"{where}/mlp/{name}")
        else:
            raise NotImplementedError(f"{where}: tp sharding of {type(mlp).__name__}")
        attn.n_heads, attn.n_kv_heads, attn.mesh, mlp.mesh = nh_l, nkv_l, mesh, mesh
    if model.lm_head is not None:
        n = model.lm_head.qweight.out_features
        if n % tp:
            raise ValueError(f"head of {n} outputs does not split over tp={tp}")
        cols["lm_head"] = [(r * (n // tp), n // tp)]
        cut(model, "lm_head", "lm_head")
    model.mesh = mesh
    return model
