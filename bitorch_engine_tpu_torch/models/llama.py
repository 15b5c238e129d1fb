"""Llama family with weight-only quantized projections, in PyTorch.

The counterpart of ``bitorch_engine_tpu/models/llama.py`` for the serving
path: MPQ or mixed-bit MBWQ projections (``mbwq_strategy``), or fp
projections (``quantized=False``: flax ``Dense`` layers), in the A16
or the A8 regime (``utils.convert.prepare_params_for_cuda``'s
``act_bits_map``), optionally fused q|k|v and gate|up, RoPE,
RMSNorm and SwiGLU, dense or paged bf16 / int8 KV caches, a bf16 / int8 /
w4 head.  Parameters live in the modules (``LlamaModel(cfg, device)`` builds
random ones from a seeded ``torch.Generator``, or on the ``meta`` device
none, a skeleton for a loader to fill; ``utils.convert`` loads the JAX
package's, ``models.llama_loader`` HF checkpoints); the entry points are
:func:`prefill`, :func:`decode_step` and ``models.generate.generate`` for
serving, and a plain call under autograd for training
(``training.make_train_step``).

Attention reads the dense cache in one of four ways, as the reference does:
no cache (full causal attention over the tokens), full read (window None or
covering the whole cache: attend over the updated cache), window 0
(prefill from an empty cache: causal attention over the new tokens only,
through the flash kernel on the card) and the two-part window (a prefix
of the cache before this step's write, plus this step's tokens as a causal
block, under one softmax).  The caches are updated in place and returned;
the window paths write after they have read.  A paged cache
(``models/paged_kv.py``) takes the same paths over its gathered pages, or
the paged-attention kernel's (see ``LlamaAttention._paged``).

Training: after ``utils.convert.prepare_for_training`` the embedding (when
not quantized), the norms and the biases are trainable parameters and
every quantized projection carries a grad shadow.  The cache-less path on
the card runs the differentiable flash attention (kernel 3 forward, kernel
4 backward); ``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), as the JAX package's ``nn.remat``.

MoE (``moe_num_experts > 0``, Mixtral): every block's MLP is a
:class:`QuantMoEMLP`, quantized SwiGLU experts behind a top-k router
(``ops/moe.py``); :func:`moe_losses` reads each layer's load-balance term
and dropped share from the last forward.

Tensor parallelism (``models/llama_sharding.shard_llama_params``) turns a
model into one rank's part: attention over the rank's query and KV heads
(``LlamaAttention.n_heads`` / ``n_kv_heads``), the MLP (or each expert) over
its share of the intermediate features, an f32 ``all_reduce`` of the
row-parallel o and down partials (cast once after it, as GSPMD sums the f32
dot of the JAX package), an ``all_gather`` of the column-parallel head's
logits; ``cfg`` stays the global configuration.  The collectives are
Megatron's differentiable pair, so a tp model trains: the input of every
column-parallel projection is ``comm.sum_grad`` ("f": its cotangent summed
over tp, so the norms, the embedding and the residual stream get whole
gradients on every rank), the row-parallel sum is ``comm.all_reduce_diff``
("g": the cotangent passed through), and the head's gather keeps this
rank's slice of the cotangent.  :func:`init_kv_caches` with a mesh holds
this rank's heads and its dp share of the batch.

Sequence parallelism (``cfg.sequence_parallel`` ``"ring"`` or
``"ulysses"`` over the ``cfg.sp_axis`` axis of ``cfg.sp_mesh``, the JAX
package's branch): each rank holds ``(b, L/n)`` of the tokens; every layer
runs on them as usual but for a cache-less attention of more than one
token, which repeats the KV heads to full heads and runs
``parallel/ring_attention.py`` or ``parallel/ulysses.py`` across the
ranks.  The rank's positions (RoPE and the mask) are its global offset
``coord · L/n + arange(L/n)``: the default when ``positions`` is not given.
Every rank holds the whole weights, so a train step sums the parameter
gradients over ``sp`` (``training.make_train_step(mesh=)``), as GSPMD's
all-reduce does in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..layers.basic import Dense
from ..layers.linear import MBWQLinear, MPQLinear
from ..ops.cuda.flash_attention import HEAD_DIMS, flash_attention_diff
from ..ops.cuda.paged_attention import (
    cache_len_tensor,
    merge_attention_parts,
    paged_prefix_attention,
    paged_prefix_attention_update,
)
from ..ops.mbwq_linear import strategy_dict
from ..ops.moe import EXPERT_PROJS, init_moe_experts, moe_mlp
from ..ops.mpq_linear import _matmul_f32, mpq_linear
from ..ops.quant import concat_mpq
from ..parallel.comm import all_gather_diff, all_reduce_diff, sum_grad
from ..parallel.pipeline import pipeline_apply
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses import ulysses_attention
from .paged_kv import (
    PagedKV,
    kv_cache_shardings,
    local_shape,
    paged_write_positions,
)

# a host-side cache length: one position for the batch, or one per row
CacheLen = Union[None, int, List[int]]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    max_seq_len: int = 4096
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    # quantization
    w_bit: int = 4
    group_size: int = 128
    asym: bool = False
    quantized: bool = True
    # channel-mixed bits: (bits, proportion[, group_size]) entries, e.g.
    # ((4, 0.25), (2, 0.75, 128)) → MBWQLinear projections
    mbwq_strategy: Any = None
    # per-bit storage container of the MBWQ segments, e.g. {2: 4}
    mbwq_container_bits: Any = None
    quant_mid_sym: bool = False
    remat: bool = False  # recompute each block in the backward pass
    # sequence-parallel exact attention ("ring" / "ulysses") for cache-less
    # forwards, the sequence axis sharded over mesh axis ``sp_axis`` of
    # ``sp_mesh`` (a ``parallel.mesh.Mesh``)
    sequence_parallel: Optional[str] = None
    sp_mesh: Any = None
    sp_axis: str = "sp"
    # Mixtral-style MoE MLPs: > 0 experts a block, each token routed to its
    # top k; capacity None is drop-free (C = T), a float the Switch capacity;
    # renormalize: the k gates sum to 1 (Mixtral)
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: Optional[float] = None
    moe_renormalize: bool = True
    kv_cache_dtype: str = "bf16"
    quantize_embed: bool = False
    head_w_bit: Optional[int] = None
    head_pad_to: int = 0
    proj_pad_to: int = 0
    fuse_qkv: bool = False
    fuse_gate_up: bool = False
    attn_qkv_bias: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def replace(self, **changes) -> "LlamaConfig":
        return dataclasses.replace(self, **changes)


def llama3_8b(**overrides) -> LlamaConfig:
    return LlamaConfig(**overrides)


def llama2_7b(**overrides) -> LlamaConfig:
    defaults = dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_layers=32,
        num_heads=32, num_kv_heads=32, rope_theta=10000.0, rms_eps=1e-5,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def mistral_7b(**overrides) -> LlamaConfig:
    """Mistral-7B-v0.2+: llama blocks with 8-head GQA and a 14336 MLP."""
    defaults = dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
        num_heads=32, num_kv_heads=8, rope_theta=1000000.0, rms_eps=1e-5,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def qwen2_7b(**overrides) -> LlamaConfig:
    """Qwen2/Qwen2.5-7B: q/k/v projection biases, 4-head GQA, 152k vocab."""
    defaults = dict(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_layers=28,
        num_heads=28, num_kv_heads=4, rope_theta=1000000.0, rms_eps=1e-6,
        attn_qkv_bias=True,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def mixtral_8x7b(**overrides) -> LlamaConfig:
    """Mixtral-8x7B: llama blocks with 8-expert top-2 MoE MLPs."""
    defaults = dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
        num_heads=32, num_kv_heads=8, rope_theta=1e6, moe_num_experts=8, moe_top_k=2,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def mixtral_8x7b_serving(**overrides) -> LlamaConfig:
    """Mixtral-8x7B in the MoE serving form of the JAX package's bench
    (``bench.py:380-396``) at Mixtral's own width: w4 g128 projections and
    experts, fused q|k|v (the experts are never fused), int8 KV cache,
    int8 embedding, w4 head padded to 2048, bf16, a 1024-position cache,
    drop-free capacity."""
    defaults = dict(
        dtype=torch.bfloat16, max_seq_len=1024, kv_cache_dtype="int8", quantize_embed=True,
        head_w_bit=4, head_pad_to=2048, fuse_qkv=True, fuse_gate_up=True,
    )
    defaults.update(overrides)
    return mixtral_8x7b(**defaults)


def llama3_8b_serving(**overrides) -> LlamaConfig:
    """Llama-3-8B in the serving form of the JAX package's bench: w4 g128
    projections with fused q|k|v and gate|up, int8 KV cache, int8
    embedding, w4 head padded to 2048, bf16, a 1024-position cache."""
    defaults = dict(
        dtype=torch.bfloat16, max_seq_len=1024, kv_cache_dtype="int8", quantize_embed=True,
        head_w_bit=4, head_pad_to=2048, fuse_qkv=True, fuse_gate_up=True,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def llama2_7b_mbwq_serving(**overrides) -> LlamaConfig:
    """Llama-2-7B in the MBWQ-2.5 serving form of the JAX package's bench
    (``bench.py:474-497``): 25% of each projection's rows at w4 g64, 75% at
    w2 g128, fused q|k|v and gate|up with out-features padded to 2048, int8
    KV cache, int8 embedding, w4 head padded to 2048, bf16, a 1024-position
    cache.  The bench's A8 regime is ``prepare_params_for_cuda(model,
    torch.bfloat16, act_bits_map={2: 8})``."""
    defaults = dict(
        dtype=torch.bfloat16, mbwq_strategy=((4, 0.25), (2, 0.75, 128)), group_size=64,
        max_seq_len=1024, kv_cache_dtype="int8", quantize_embed=True, head_w_bit=4,
        head_pad_to=2048, fuse_qkv=True, fuse_gate_up=True, proj_pad_to=2048,
    )
    defaults.update(overrides)
    return llama2_7b(**defaults)


def llama_370m_train(**overrides) -> LlamaConfig:
    """The JAX package's training configuration (``bench.py:627-642``): a
    ~370M-parameter Llama (hidden 1024, intermediate 2816, 24 layers, 16 MHA
    heads of 64, vocab 32000), w4 g128 projections, bf16, 2048 positions,
    block remat, tied bf16 embedding."""
    defaults = dict(
        vocab_size=32000, hidden_size=1024, intermediate_size=2816, num_layers=24,
        num_heads=16, num_kv_heads=16, max_seq_len=2048, w_bit=4, group_size=128,
        remat=True, dtype=torch.bfloat16,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def tiny_llama(**overrides) -> LlamaConfig:
    """Small config for tests and CPU dry runs."""
    defaults = dict(
        vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=128, group_size=64,
    )
    defaults.update(overrides)
    return LlamaConfig(**defaults)


def _check_slice(cfg: LlamaConfig) -> None:
    if cfg.sequence_parallel not in (None, "ring", "ulysses"):
        raise ValueError(f"unknown sequence_parallel {cfg.sequence_parallel!r}")
    if cfg.sequence_parallel is not None and cfg.sp_mesh is None:
        raise ValueError("sequence_parallel needs sp_mesh (parallel.mesh.make_axes_mesh)")
    if cfg.sequence_parallel is not None and cfg.sp_axis not in cfg.sp_mesh.shape:
        raise ValueError(f"sp_axis {cfg.sp_axis!r} is not an axis of sp_mesh "
                         f"{tuple(cfg.sp_mesh.shape)}")
    if cfg.kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {cfg.kv_cache_dtype!r}")


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device), requires_grad=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(self.dtype)


def _rope(pos: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions ``pos`` (any shape) → (..., head_dim/2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=pos.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = pos.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, d) with cos/sin (b, s, d/2), rotate-half convention."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _proj(cfg: LlamaConfig, in_features: int, out_features: int, device, generator,
          use_bias: bool = False) -> Union[MPQLinear, MBWQLinear, Dense]:
    if not cfg.quantized:
        # flax nn.Dense in the model dtype; proj_pad_to pads quantized ones only
        dense = Dense(in_features, out_features, use_bias, device, generator, dtype=cfg.dtype)
        return dense.requires_grad_(False)
    out_slice = None
    if cfg.proj_pad_to and out_features % cfg.proj_pad_to and not use_bias:
        out_slice = out_features
        out_features = -(-out_features // cfg.proj_pad_to) * cfg.proj_pad_to
    if cfg.mbwq_strategy is not None:
        if use_bias:
            raise NotImplementedError("MBWQ projections do not support bias")
        strategy = strategy_dict(cfg.mbwq_strategy, cfg.group_size, cfg.mbwq_container_bits,
                                 mid_sym=cfg.quant_mid_sym)
        return MBWQLinear(
            in_features, out_features, strategy=strategy, dtype=cfg.dtype, device=device,
            generator=generator, out_slice=out_slice,
        )
    return MPQLinear(
        in_features, out_features, w_bit=cfg.w_bit, group_size=cfg.group_size,
        asym=cfg.asym, use_bias=use_bias, mid_sym=cfg.quant_mid_sym, dtype=cfg.dtype,
        device=device, generator=generator, out_slice=out_slice,
    )


def _quantize_kv(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) int8: ``scale = max(amax, 1e-6) / 127``."""
    u32 = u.float()
    scale = torch.clamp_min(u32.abs().amax(dim=-1), 1e-6) / 127.0
    q8 = torch.clamp(torch.round(u32 / scale[..., None]), -127, 127).to(torch.int8)
    return q8, scale


def _write(cache: torch.Tensor, update: torch.Tensor, cache_len) -> None:
    """Write ``update`` (b, s, ...) at ``cache_len`` along axis 1, in place,
    clamping the start into the cache as ``dynamic_update_slice`` does."""
    length, s = cache.shape[1], update.shape[1]
    update = update.to(cache.dtype)
    if isinstance(cache_len, list):
        for i, p in enumerate(cache_len):
            start = min(max(p, 0), length - s)
            cache[i, start : start + s] = update[i]
    else:
        start = min(max(cache_len, 0), length - s)
        cache[:, start : start + s] = update


_NEG = torch.finfo(torch.float32).min  # the reference's mask value


def _scores(qg: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """f32 products of the working-dtype operands: queries grouped per KV head
    (b, s, nkv, rep, hd) against keys (b, L, nkv, hd) → (b, nkv, rep, s, L)."""
    scale = math.sqrt(qg.shape[-1])
    return torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), keys.to(qg.dtype).float()) / scale


def _context(probs: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(b, nkv, rep, s, L) probabilities × values (b, L, nkv, hd) → (b, s, nh·hd)."""
    ctx = torch.einsum("bgrqk,bkgd->bqgrd", probs, values.to(probs.dtype))
    return ctx.reshape(ctx.shape[0], ctx.shape[1], -1)


def _violation(cache_len, prefix_len: int) -> float:
    """NaN when a cache length exceeds the window read (the caller's
    contract ``attn_window >= max(cache_len)``), else 0: added to the
    scores so a violation shows in any finiteness check."""
    lens = cache_len if isinstance(cache_len, list) else [cache_len]
    return float("nan") if any(c > prefix_len for c in lens) else 0.0


def _scale_keys(t: torch.Tensor) -> torch.Tensor:
    """Per-position scales (b, L, nkv) → (b, nkv, 1, 1, L), broadcast over
    (rep, query) in the score layout (b, nkv, rep, q, k)."""
    return t.permute(0, 2, 1)[:, :, None, None, :]


def tp_size(mesh) -> int:
    """The tp size of a model's mesh: 1 without one, or on a mesh without
    a tp axis (an ep-sharded MoE model's)."""
    return 1 if mesh is None or "tp" not in mesh.shape else mesh.size("tp")


def _column_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a tp model's column-parallel projections: itself, its
    cotangent summed over tp in the backward (each rank's projections
    give only their columns' share of it)."""
    return x if tp_size(mesh) == 1 else sum_grad(mesh, x, "tp")


def _row_parallel(proj: nn.Module, x: torch.Tensor, mesh) -> torch.Tensor:
    """``proj(x)``; on a tp-sharded model ``proj`` holds this rank's rows
    of a row-parallel projection (no bias), and the result is the f32 sum
    of every rank's partial, cast once (its backward hands every rank the
    whole cotangent).  A shard of an act-order tensor (``tp_rows``: the
    logical rows of its stored rows) reads the whole activation, gathered
    over tp; the gather's backward sums the ranks' cotangents and keeps
    this rank's slice."""
    if tp_size(mesh) == 1:
        return proj(x)
    rows = getattr(proj, "tp_rows", None)
    if rows is not None:
        x = all_gather_diff(mesh, x, "tp", dim=-1, reduce=True).index_select(-1, rows)
    if isinstance(proj, MPQLinear):
        part = mpq_linear(x.to(proj.dtype), proj.qweight, out_dtype=torch.float32)
    else:  # Dense
        dtype = proj.dtype or x.dtype
        x2d = x.reshape(-1, x.shape[-1]).to(dtype)
        part = _matmul_f32(x2d, proj.kernel.to(dtype)).reshape(*x.shape[:-1], -1)
    return all_reduce_diff(mesh, part, "tp").to(proj.dtype or x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        # this rank's head counts and mesh (models/llama_sharding.py sets them)
        self.n_heads, self.n_kv_heads, self.mesh = cfg.num_heads, cfg.num_kv_heads, None
        hd, nh, nkv, h = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.hidden_size
        bias = cfg.attn_qkv_bias
        if cfg.fuse_qkv:
            self.qkv_proj = _proj(cfg, h, (nh + 2 * nkv) * hd, device, generator, bias)
        else:
            self.q_proj = _proj(cfg, h, nh * hd, device, generator, bias)
            self.k_proj = _proj(cfg, h, nkv * hd, device, generator, bias)
            self.v_proj = _proj(cfg, h, nkv * hd, device, generator, bias)
        self.o_proj = _proj(cfg, nh * hd, h, device, generator)

    def _use_flash(self, x: torch.Tensor, s: int) -> bool:
        cfg = self.cfg
        return (
            x.device.type == "cuda"
            and s > 1
            and s % 128 == 0
            and cfg.dtype == torch.bfloat16
            and cfg.head_dim in HEAD_DIMS
        )

    def _flash(self, q, k, v) -> torch.Tensor:
        """Kernel 3 on (b, s, h, d) operands → ctx (b, s, nh * hd); under
        autograd its backward is kernel 4."""
        b, s = q.shape[:2]

        def heads_first(t):
            return t.transpose(1, 2).to(self.cfg.dtype).contiguous()

        ctx = flash_attention_diff(
            heads_first(q), heads_first(k), heads_first(v),
            causal=True, sm_scale=1.0 / math.sqrt(self.cfg.head_dim),
        )
        return ctx.transpose(1, 2).reshape(b, s, -1)

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        kv_cache: Union[None, tuple, PagedKV] = None,
        cache_len: CacheLen = None,
        attn_window: Optional[int] = None,
    ):
        """``attn_window``: prefix of the cache to read (a power-of-2 bucket
        chosen per step).  Contract: ``attn_window >= max(cache_len)``; a
        violation poisons the output with NaN instead of silently dropping
        cached positions."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, nh, nkv = cfg.head_dim, self.n_heads, self.n_kv_heads
        rep = nh // nkv
        x = _column_input(x, self.mesh)
        if cfg.fuse_qkv:
            q, k, v = torch.split(self.qkv_proj(x), [nh * hd, nkv * hd, nkv * hd], dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        cos, sin = _rope(positions, hd, cfg.rope_theta)
        q = _apply_rope(q.reshape(b, s, nh, hd), cos, sin)
        k = _apply_rope(k.reshape(b, s, nkv, hd), cos, sin)
        v = v.reshape(b, s, nkv, hd)
        qg = q.reshape(b, s, nkv, rep, hd)

        if kv_cache is not None and not isinstance(kv_cache, (tuple, list, PagedKV)):
            raise TypeError(f"kv_cache must be a dense tuple or a PagedKV, got {type(kv_cache)}")
        kv_quant = cfg.kv_cache_dtype == "int8" and kv_cache is not None
        cl_rows = None  # per-row cache lengths on the device, (b, 1, 1, 1, 1)
        if isinstance(cache_len, list):
            cl_rows = torch.tensor(cache_len, device=x.device)[:, None, None, None, None]

        if kv_cache is None:
            if cfg.sequence_parallel is not None and s > 1:
                return self._out(self._sequence_parallel(q, k, v)), None
            if self._use_flash(x, s):
                return self._out(self._flash(q, k, v)), None
            return self._out(self._full_read(qg, positions, k, v)), None

        if kv_quant:
            k_new, ks_new = _quantize_kv(k)
            v_new, vs_new = _quantize_kv(v)
        else:
            pool_dtype = kv_cache.k_pool.dtype if isinstance(kv_cache, PagedKV) else kv_cache[0].dtype
            k_new, v_new = k.to(pool_dtype), v.to(pool_dtype)
            ks_new = vs_new = None
        new = (q, qg, k_new, v_new, ks_new, vs_new)
        if isinstance(kv_cache, PagedKV):
            ctx = self._paged(x, positions, kv_cache, cache_len, cl_rows, attn_window, new)
            return self._out(ctx), kv_cache

        total_len = kv_cache[0].shape[1]
        full_read = attn_window is None or attn_window >= total_len
        if kv_quant:
            ck0, cv0, ckvs0 = kv_cache
            writes = ((ck0, k_new), (cv0, v_new), (ckvs0, torch.cat([ks_new, vs_new], dim=-1)))
        else:
            ck0, cv0 = kv_cache
            writes = ((ck0, k_new), (cv0, v_new))

        if full_read:
            for cache, update in writes:
                _write(cache, update, cache_len)
            ks_all = vs_all = None
            if kv_quant:
                ks_all, vs_all = ckvs0[..., :nkv], ckvs0[..., nkv:]
            valid = (cache_len + s) if cl_rows is None else (cl_rows + s)
            ctx = self._full_read(qg, positions, ck0, cv0, ks_all, vs_all, valid)
            return self._out(ctx), kv_cache

        prefix_len = attn_window
        viol = _violation(cache_len, prefix_len)
        if prefix_len == 0:
            ctx = self._window0(x, new, viol)
        else:
            pre = (ck0[:, :prefix_len], cv0[:, :prefix_len], None, None)
            if kv_quant:
                pre = pre[:2] + (ckvs0[:, :prefix_len, :nkv], ckvs0[:, :prefix_len, nkv:])
            ctx = self._two_part(new, pre, cache_len, cl_rows, viol)
        # this step read the cache before its write (stream order keeps it so)
        for cache, update in writes:
            _write(cache, update, cache_len)
        return self._out(ctx), kv_cache

    def _sequence_parallel(self, q, k, v) -> torch.Tensor:
        """Ring or Ulysses attention of this rank's ``(b, s, h, d)`` shard
        over ``cfg.sp_axis`` → ctx (b, s, nh · hd), the KV heads repeated to
        full heads as the JAX package does (ring and Ulysses run per head)."""
        cfg = self.cfg
        b, s = q.shape[:2]
        rep = self.n_heads // self.n_kv_heads

        def heads_first(t, r=1):
            return t.repeat_interleave(r, dim=2).transpose(1, 2).to(cfg.dtype).contiguous()

        attend = ring_attention if cfg.sequence_parallel == "ring" else ulysses_attention
        ctx = attend(heads_first(q), heads_first(k, rep), heads_first(v, rep),
                     mesh=cfg.sp_mesh, axis=cfg.sp_axis)
        return ctx.transpose(1, 2).reshape(b, s, -1).to(cfg.dtype)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        return _row_parallel(self.o_proj, ctx, self.mesh)

    def _window0(self, x, new, viol) -> torch.Tensor:
        """Prefill from an empty cache: causal attention over the new
        tokens, over their dequantized k/v (what a later read sees)."""
        cfg = self.cfg
        q, qg, k_new, v_new, ks_new, vs_new = new
        s = q.shape[1]
        if self._use_flash(x, s):
            if ks_new is not None:
                kd = (k_new.float() * ks_new[..., None]).to(cfg.dtype)
                vd = (v_new.float() * vs_new[..., None]).to(cfg.dtype)
            else:
                kd, vd = k_new.to(cfg.dtype), v_new.to(cfg.dtype)
            ctx = self._flash(q, kd, vd)
        else:
            # codes in the dot, scales factored out: the same math as the
            # two-part window's new-token block
            sc = _scores(qg, k_new)
            if ks_new is not None:
                sc = sc * _scale_keys(ks_new)
            causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            sc = torch.where(causal, sc, _NEG)
            probs = torch.softmax(sc, dim=-1).to(cfg.dtype)
            if vs_new is not None:
                probs = probs * _scale_keys(vs_new).to(probs.dtype)
            ctx = _context(probs, v_new)
        return (ctx.float() + viol).to(cfg.dtype)

    def _two_part(self, new, pre, cache_len, cl_rows, viol) -> torch.Tensor:
        """One softmax over [the cached prefix (positions < cache_len)] ++
        [this step's tokens, causal among themselves]."""
        q, qg, k_new, v_new, ks_new, vs_new = new
        k_pre, v_pre, ks_pre, vs_pre = pre
        s, prefix_len = q.shape[1], k_pre.shape[1]
        sc_p = _scores(qg, k_pre)
        if ks_pre is not None:
            sc_p = sc_p * _scale_keys(ks_pre)
        kv_pos = torch.arange(prefix_len, device=q.device)
        cl = cache_len if cl_rows is None else cl_rows
        sc_p = torch.where(kv_pos < cl, sc_p, _NEG) + viol
        sc_n = _scores(qg, k_new)
        if ks_new is not None:
            sc_n = sc_n * _scale_keys(ks_new)
        causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc_n = torch.where(causal, sc_n, _NEG)
        probs = torch.softmax(torch.cat([sc_p, sc_n], dim=-1), dim=-1).to(self.cfg.dtype)
        pp, pn = probs[..., :prefix_len], probs[..., prefix_len:]
        if vs_pre is not None:
            pp = pp * _scale_keys(vs_pre).to(pp.dtype)
            pn = pn * _scale_keys(vs_new).to(pn.dtype)
        return _context(pp, v_pre) + _context(pn, v_new)

    def _paged(self, x, positions, cache: PagedKV, cache_len, cl_rows, attn_window, new):
        """Attention over a paged cache, with the JAX package's branch rule:
        a one-token step with hd % 128 == 0 goes through the write-back
        kernel (a window covering the whole allocation becomes the full
        view); a windowed multi-token step (chunked prefill) with hd % 128
        == 0 reads its prefix through the read-only kernel and merges it
        with its own causal block; window 0 reads no cache; the rest
        gathers the window's pages for the dense cache's math.  The pools
        and scale caches are updated in place."""
        cfg = self.cfg
        q, qg, k_new, v_new, ks_new, vs_new = new
        b, s = x.shape[:2]
        hd, nkv = cfg.head_dim, self.n_kv_heads
        ps = cache.page_size
        want_full = attn_window is None or attn_window >= cache.view_len
        kernel_ok = s == 1 and hd % 128 == 0
        full_read = want_full and not kernel_ok
        eff_window = cache.view_len if (want_full and kernel_ok) else attn_window
        tbl = cache.page_table
        if not full_read:
            # read only the pages covering the window (writes use the table)
            tbl = tbl[:, : max(0 if eff_window == 0 else 1, -(-eff_window // ps))]
        prefix_len = tbl.shape[1] * ps
        kernel_wb = kernel_ok and not full_read and prefix_len > 0
        page, off = paged_write_positions(cache, cache_len, b, s)

        def gather(pool):  # (pages, ps, nkv·hd) → (b, P·ps, nkv, hd)
            return pool[tbl.long()].reshape(b, prefix_len, nkv, hd)

        def write_pools():
            cache.k_pool[page, off] = k_new.reshape(b, s, nkv * hd)
            cache.v_pool[page, off] = v_new.reshape(b, s, nkv * hd)

        if ks_new is not None:
            # dense per-slot scale caches, written before any read: the
            # write-back kernel reads the post-update caches (the new
            # position is masked)
            _write(cache.k_scale, ks_new, cache_len)
            _write(cache.v_scale, vs_new, cache_len)
        if full_read:
            write_pools()
            ks_all = vs_all = None
            if ks_new is not None:
                ks_all, vs_all = cache.k_scale[:, :prefix_len], cache.v_scale[:, :prefix_len]
            valid = (cache_len + s) if cl_rows is None else (cl_rows + s)
            return self._full_read(qg, positions, gather(cache.k_pool), gather(cache.v_pool),
                                   ks_all, vs_all, valid)

        viol = _violation(cache_len, prefix_len)
        if prefix_len == 0:
            ctx = self._window0(x, new, viol)
        elif hd % 128 == 0:
            ctx = self._paged_kernel(q, cache, tbl, cache_len, new, kernel_wb, viol)
        else:
            pre = (gather(cache.k_pool), gather(cache.v_pool), None, None)
            if ks_new is not None:
                pre = pre[:2] + (cache.k_scale[:, :prefix_len], cache.v_scale[:, :prefix_len])
            ctx = self._two_part(new, pre, cache_len, cl_rows, viol)
        if not kernel_wb:
            write_pools()
        return ctx

    def _paged_kernel(self, q, cache: PagedKV, tbl, cache_len, new, writeback, viol):
        """Kernel 6 over the window's pages (with the step's token written in
        the same launch when ``writeback``), merged with this step's causal
        block by the two-way softmax combine."""
        cfg = self.cfg
        _, _, k_new, v_new, ks_new, vs_new = new
        b, s = q.shape[:2]
        hd, nh, nkv = cfg.head_dim, self.n_heads, self.n_kv_heads
        rep = nh // nkv
        rs = rep * s
        qk2 = q.reshape(b, s, nkv, rep, hd).permute(0, 2, 3, 1, 4).reshape(b, nkv, rs, hd)
        qk2 = qk2.contiguous()
        clen = cache_len_tensor(cache_len, b, q.device)
        sm_scale = 1.0 / math.sqrt(hd)
        if writeback:
            acc_p, m_p, l_p = paged_prefix_attention_update(
                qk2, cache.k_pool, cache.v_pool, cache.k_scale, cache.v_scale, tbl, clen,
                k_new.reshape(b, nkv * hd), v_new.reshape(b, nkv * hd), sm_scale=sm_scale,
            )
        else:
            acc_p, m_p, l_p = paged_prefix_attention(
                qk2, cache.k_pool, cache.v_pool, cache.k_scale, cache.v_scale, tbl, clen,
                sm_scale=sm_scale,
            )
        if ks_new is not None:
            kd2 = (k_new.float() * ks_new[..., None]).to(qk2.dtype)
            vd2 = (v_new.float() * vs_new[..., None]).to(qk2.dtype)
        else:
            kd2, vd2 = k_new.to(qk2.dtype), v_new.to(qk2.dtype)
        sc_n = torch.einsum("bgrd,bkgd->bgrk", qk2.float(), kd2.float()) / math.sqrt(hd)
        iq = torch.arange(rs, device=q.device)[:, None] % s
        ik = torch.arange(s, device=q.device)[None, :]
        sc_n = torch.where(ik <= iq, sc_n, _NEG)
        m_n = sc_n.amax(dim=-1, keepdim=True)
        p_n = torch.exp(sc_n - m_n)
        l_n = p_n.sum(dim=-1, keepdim=True)
        acc_n = torch.einsum("bgrk,bkgd->bgrd", p_n, vd2.float())
        ctx = merge_attention_parts(acc_p, m_p, l_p, acc_n, m_n, l_n)
        ctx = (ctx + viol).to(cfg.dtype)
        return ctx.reshape(b, nkv, rep, s, hd).permute(0, 3, 1, 2, 4).reshape(b, s, nh * hd)

    def _full_read(self, qg, positions, k_all, v_all, ks_all=None, vs_all=None, valid=None):
        """One softmax over all of ``k_all``/``v_all`` under the causal mask in
        absolute positions (and ``kv_pos < valid`` with a cache); int8 keys
        and values come with their per-position scales."""
        sc = _scores(qg, k_all)
        if ks_all is not None:
            sc = sc * _scale_keys(ks_all)
        kv_pos = torch.arange(k_all.shape[1], device=qg.device)
        mask = kv_pos <= positions[:, None, None, :, None]
        if valid is not None:
            mask = mask & (kv_pos < valid)
        probs = torch.softmax(torch.where(mask, sc, _NEG), dim=-1).to(self.cfg.dtype)
        if vs_all is not None:
            probs = probs * _scale_keys(vs_all).to(probs.dtype)
        return _context(probs, v_all)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.mesh = None  # set on a tp-sharded model (models/llama_sharding.py)
        if cfg.fuse_gate_up:
            self.gate_up_proj = _proj(cfg, h, 2 * i, device, generator)
        else:
            self.gate_proj = _proj(cfg, h, i, device, generator)
            self.up_proj = _proj(cfg, h, i, device, generator)
        self.down_proj = _proj(cfg, i, h, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _column_input(x, self.mesh)
        if cfg.fuse_gate_up:
            gate, up = torch.chunk(self.gate_up_proj(x), 2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        h = nn.functional.silu(gate.float()).to(cfg.dtype) * up
        return _row_parallel(self.down_proj, h, self.mesh)


class MoEExpert(nn.Module):
    """One quantized SwiGLU expert: ``gate``, ``up`` and ``down``
    ``MPQLinear`` layers built around its records."""

    def __init__(self, records, dtype):
        super().__init__()
        for name in EXPERT_PROJS:
            qt = records[name]
            setattr(self, name, MPQLinear(qt.in_features, qt.out_features, dtype=dtype, qweight=qt))

    def records(self):
        """``{"gate", "up", "down"}`` → each layer's record (grad shadow
        included): an expert as the JAX package's parameters hold it."""
        return {name: getattr(self, name).qweight for name in EXPERT_PROJS}


class QuantMoEMLP(nn.Module):
    """Mixtral-style MoE MLP: a f32 ``router`` (hidden, E) drawn ``normal ×
    0.02`` and ``E`` quantized SwiGLU ``experts`` at ``w_bit`` /
    ``group_size`` (the JAX experts' form: no fusing, padding, asym or
    mid_sym).  ``aux`` and ``dropped`` hold the last forward's load-balance
    term and dropped share (the JAX package's sown ``moe_aux`` /
    ``moe_dropped``; :func:`moe_losses`)."""

    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h, e = cfg.hidden_size, cfg.moe_num_experts
        router = torch.randn(h, e, generator=generator, device=device) * 0.02
        self.router = nn.Parameter(router, requires_grad=False)
        experts = init_moe_experts(generator, e, h, cfg.intermediate_size, w_bit=cfg.w_bit,
                                   group_size=cfg.group_size, stack=False, device=device)
        self.experts = nn.ModuleList(MoEExpert(rec, cfg.dtype) for rec in experts)
        self.aux = self.dropped = None
        self.mesh = None  # an ep-sharded model's (models/llama_sharding.py): its experts a rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        y, self.aux, self.dropped = moe_mlp(
            x, self.router, tuple(e.records() for e in self.experts), top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, renormalize=cfg.moe_renormalize,
            mesh=self.mesh,
        )
        return y


def moe_losses(model: "LlamaModel") -> dict:
    """``{"moe_aux": [...], "moe_dropped": [...]}``: each MoE layer's values
    from the model's last forward, in layer order (0-d f32 tensors; ``aux``
    keeps its graph, so a training loss may add it)."""
    mlps = [layer.mlp for layer in model.layers if isinstance(layer.mlp, QuantMoEMLP)]
    return {"moe_aux": [m.aux for m in mlps], "moe_dropped": [m.dropped for m in mlps]}


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, device)
        self.attn = LlamaAttention(cfg, device, generator)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, device)
        mlp_cls = QuantMoEMLP if cfg.moe_num_experts else LlamaMLP
        self.mlp = mlp_cls(cfg, device, generator)

    def forward(self, x, positions, kv_cache=None, cache_len=None, attn_window=None):
        h, new_cache = self.attn(self.input_norm(x), positions, kv_cache, cache_len, attn_window)
        x = x + h
        x = x + self.mlp(self.post_attn_norm(x))
        return x, new_cache


class Int8Embedding(nn.Module):
    """int8 table with per-row f32 scales (``quantize_embed``)."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        scale = torch.clamp_min(table.abs().amax(dim=1), 1e-6) / 127.0
        data = torch.clamp(torch.round(table / scale[:, None]), -127, 127).to(torch.int8)
        self.register_buffer("data", data)
        self.register_buffer("scale", scale.float())


def _host_cache_len(cache_len) -> CacheLen:
    """An int, a 0-d tensor or a per-row sequence → int or list of ints
    (read once per call, so no layer waits on the device for it)."""
    if cache_len is None or isinstance(cache_len, int):
        return cache_len
    t = torch.as_tensor(cache_len)
    return int(t) if t.dim() == 0 else [int(c) for c in t.tolist()]


class LlamaModel(nn.Module):
    """Decoder-only Llama; call with token ids ``(b, s)``.

    ``device`` defaults to ``cuda`` (and raises without a GPU); pass
    ``device="cpu"`` for the plain PyTorch path.  Random parameters come
    from a ``torch.Generator`` seeded with ``seed``; quantized projections
    are quantized on ``device``.
    """

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        _check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = None  # set on a tp-sharded model (models/llama_sharding.py)
        gen = None  # a meta skeleton draws nothing
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device).manual_seed(seed)
        table = torch.randn(
            cfg.vocab_size, cfg.hidden_size, generator=gen, device=self.device
        ) * 0.02
        if cfg.quantize_embed:
            self.embed = Int8Embedding(table)
        else:
            self.embed = nn.Parameter(table.to(cfg.dtype), requires_grad=False)
        del table
        self.layers = []
        for i in range(cfg.num_layers):
            block = LlamaBlock(cfg, self.device, gen)
            self.add_module(f"layer_{i}", block)
            self.layers.append(block)
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, self.device)
        self.lm_head = None
        if cfg.head_w_bit is not None:
            n_head = cfg.vocab_size
            if cfg.head_pad_to:
                n_head = -(-cfg.vocab_size // cfg.head_pad_to) * cfg.head_pad_to
            # the head is quantized at group size 128 whatever cfg.group_size says
            self.lm_head = MPQLinear(
                cfg.hidden_size, n_head, w_bit=cfg.head_w_bit, group_size=128,
                dtype=cfg.dtype, device=self.device, generator=gen,
            )

    def forward(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        kv_caches: Optional[Sequence[tuple]] = None,
        cache_len=None,
        attn_window: Optional[int] = None,
    ):
        """Returns ``(logits f32 (b, s, vocab), caches or None)``."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        b, s = tokens.shape
        if positions is None:
            # a sequence-parallel rank holds positions coord·s .. coord·s + s - 1
            offset = 0
            if cfg.sequence_parallel is not None and kv_caches is None:
                offset = cfg.sp_mesh.coord(cfg.sp_axis) * s
            positions = torch.arange(offset, offset + s, device=self.device).expand(b, s)
        positions = positions.to(self.device)
        cache_len = _host_cache_len(cache_len)
        x = self.embed_tokens(tokens)
        if kv_caches is None:
            x = self.run_blocks(self.layers, x, positions, attn_window)
        else:
            for layer, cache_i in zip(self.layers, kv_caches):
                x, _ = layer(x, positions, cache_i, cache_len, attn_window)
        return self.logits(x), kv_caches

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids → the first layer's input (``cfg.dtype``)."""
        cfg = self.cfg
        if cfg.quantize_embed:
            return (self.embed.data[tokens].to(cfg.dtype)
                    * self.embed.scale[tokens][..., None].to(cfg.dtype))
        return nn.functional.embedding(tokens, self.embed).to(cfg.dtype)

    def run_blocks(self, blocks, x: torch.Tensor, positions: torch.Tensor,
                   attn_window: Optional[int] = None) -> torch.Tensor:
        """``blocks`` (a run of ``self.layers``) over ``x`` without caches;
        with ``cfg.remat`` under autograd each block's activations are
        recomputed in the backward pass."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in blocks:
            if remat:
                x, _ = checkpoint(layer, x, positions, None, None, attn_window,
                                  use_reentrant=False)
            else:
                x, _ = layer(x, positions, None, None, attn_window)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's output → f32 logits (b, s, vocab): the final
        norm and the head (a tp-sharded head's shares gathered)."""
        cfg = self.cfg
        x = self.final_norm(x)
        if self.lm_head is not None:
            logits = self.lm_head(_column_input(x, self.mesh)).float()
            if tp_size(self.mesh) > 1:
                # a column-parallel head gives this rank's share of the vocabulary
                logits = all_gather_diff(self.mesh, logits, "tp", dim=-1)
            logits = logits[..., : cfg.vocab_size]
        elif cfg.quantize_embed:
            e8 = self.embed.data.T.to(cfg.dtype).float()
            logits = torch.matmul(x.float(), e8) * self.embed.scale
        else:
            logits = torch.matmul(x.float(), self.embed.T.to(cfg.dtype).float())
        return logits


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None, device=None,
                   mesh=None):
    """Empty per-layer dense caches: bf16 ``(k, v)`` of (b, L, nkv, hd), or
    int8 ``(k, v, kv_scales)`` with the k and v per-position f32 scales in
    one (b, L, 2·nkv) tensor, ``[k-scales | v-scales]``.  With a ``mesh``,
    this rank's part under ``paged_kv.kv_cache_shardings``: ``b`` over dp,
    its KV heads (the scale halves built at its head count)."""
    device = resolve_device(device)
    max_len = max_len or cfg.max_seq_len
    specs = kv_cache_shardings(1, cfg.kv_cache_dtype)[0]
    nkv = cfg.num_kv_heads
    shape = local_shape(cfg, (batch, max_len, nkv, cfg.head_dim), specs[0], mesh)
    if cfg.kv_cache_dtype == "int8":
        sshape = local_shape(cfg, (batch, max_len, 2 * nkv), specs[2], mesh)
        return [
            (
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device),
            )
            for _ in range(cfg.num_layers)
        ]
    return [
        (torch.zeros(shape, dtype=cfg.dtype, device=device),
         torch.zeros(shape, dtype=cfg.dtype, device=device))
        for _ in range(cfg.num_layers)
    ]


@torch.no_grad()
def decode_step(model: LlamaModel, tokens, kv_caches, cache_len, attn_window=None):
    """One decode step: tokens (b, 1) at position ``cache_len`` → (logits
    (b, vocab), caches).  ``attn_window``: see :class:`LlamaAttention`."""
    cache_len = _host_cache_len(cache_len)
    b = tokens.shape[0]
    if isinstance(cache_len, list):
        positions = torch.tensor(cache_len, device=model.device)[:, None]
    else:
        positions = torch.full((b, 1), cache_len, device=model.device)
    logits, caches = model(
        tokens, positions=positions, kv_caches=kv_caches, cache_len=cache_len,
        attn_window=attn_window,
    )
    return logits[:, -1], caches


@torch.no_grad()
def prefill(model: LlamaModel, tokens, kv_caches):
    """Prefill an empty cache with a whole prompt → (logits, caches).

    ``attn_window=0``: no cache read; on the card the flash kernel runs the
    causal attention when the prompt length is a multiple of 128."""
    return model(tokens, kv_caches=kv_caches, cache_len=0, attn_window=0)


def pipeline_forward(model: LlamaModel, tokens, mesh, axis: str = "pp",
                     num_microbatches: Optional[int] = None) -> torch.Tensor:
    """The cache-less forward (training) with the blocks run as a GPipe
    pipeline over ``axis`` (``parallel.pipeline.pipeline_apply``): the
    ``num_layers`` blocks cut into ``S = mesh.size(axis)`` equal stages of
    consecutive blocks, this rank running its own; the embedding, the
    final norm and the head run on every rank around the pipeline.
    ``tokens`` (b, s) is the global batch on every rank; returns its f32
    logits on every rank, differentiable (see ``parallel/pipeline.py`` for
    which gradients each rank holds)."""
    n_stages, stage = mesh.size(axis), mesh.coord(axis)
    layers = model.layers
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} blocks do not split into {n_stages} stages")
    per = len(layers) // n_stages
    tokens = tokens.to(model.device)
    b, s = tokens.shape
    positions = torch.arange(s, device=model.device)

    def stage_fn(blocks, x_mb):
        return model.run_blocks(blocks, x_mb, positions.expand(x_mb.shape[0], s))

    blocks = nn.ModuleList(layers[stage * per : (stage + 1) * per])
    x = pipeline_apply(stage_fn, blocks, model.embed_tokens(tokens), mesh, axis,
                       num_microbatches)
    return model.logits(x)


def _fuse_group(parent: nn.Module, names: Sequence[str], fused_name: str) -> None:
    parts = [getattr(parent, n) for n in names]
    if all(isinstance(p, Dense) for p in parts):
        kernel = torch.cat([p.kernel for p in parts], dim=1)
        fused = Dense(*kernel.shape, all(p.bias is not None for p in parts), device="meta",
                      dtype=parts[0].dtype)
        fused.kernel = nn.Parameter(kernel, requires_grad=False)
        if fused.bias is not None:
            fused.bias = nn.Parameter(torch.cat([p.bias for p in parts]), requires_grad=False)
        for n in names:
            delattr(parent, n)
        setattr(parent, fused_name, fused)
        return
    if any(isinstance(p, MBWQLinear) for p in parts):
        raise ValueError(
            f"cannot fuse {names}: MBWQ projections permute their rows per projection; "
            "build the model with fuse_qkv / fuse_gate_up instead"
        )
    if any(p.out_slice is not None for p in parts):
        raise ValueError(f"cannot fuse {names}: padded projections")
    qt = concat_mpq([p.qweight for p in parts])
    fused = MPQLinear(qt.in_features, qt.out_features, dtype=parts[0].dtype, qweight=qt)
    if all(p.bias is not None for p in parts):
        fused.bias = nn.Parameter(torch.cat([p.bias for p in parts]), requires_grad=False)
    for n in names:
        delattr(parent, n)
    setattr(parent, fused_name, fused)


@torch.no_grad()
def fuse_llama_params(model: LlamaModel, fuse_qkv: bool = True, fuse_gate_up: bool = True):
    """Rewrite an unfused model in place into the ``fuse_qkv`` /
    ``fuse_gate_up`` form: q|k|v and gate|up concatenate along the output
    features (``concat_mpq``; fp kernels and biases by ``torch.cat``), which
    leaves the logits unchanged.  Act-order parts (``q_perm`` / ``g_idx``)
    raise, as in the JAX package: such a checkpoint loads unfused.  Returns
    the model.  MBWQ projections raise (the JAX package's ``concat_mpq``
    cannot take them either): build such a model fused.  MoE MLPs are left
    alone (the JAX package fuses only where gate and up are present)."""
    cfg = model.cfg.replace(
        fuse_qkv=model.cfg.fuse_qkv or fuse_qkv,
        fuse_gate_up=model.cfg.fuse_gate_up or fuse_gate_up,
    )
    for layer in model.layers:
        if fuse_qkv and not layer.attn.cfg.fuse_qkv:
            _fuse_group(layer.attn, ("q_proj", "k_proj", "v_proj"), "qkv_proj")
        if fuse_gate_up and isinstance(layer.mlp, LlamaMLP) and not layer.mlp.cfg.fuse_gate_up:
            _fuse_group(layer.mlp, ("gate_proj", "up_proj"), "gate_up_proj")
        layer.attn.cfg = layer.mlp.cfg = cfg
    model.cfg = cfg
    return model
