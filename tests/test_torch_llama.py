"""The port's Llama model against the JAX package's on a tiny f32 config.

Parameters are made by the JAX package and carried over with
``load_jax_params``; both sides see the same tokens.  Two variants: the
default dense cache in the model dtype, and the serving form (int8 KV cache,
int8 embedding, untied w4 head padded, fused q|k|v and gate|up).  Each
scenario compares every layer's output and the logits at rtol 1e-4 (with
an absolute floor of 1e-4 of the largest value): both sides compute in
f32, but sums run in another order and XLA folds divisions by constants
into reciprocal multiplies, so the two drift by a few ulps per layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu_torch.layers.basic import Dense
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.utils.convert import load_jax_params, prepare_params_for_cuda

VARIANTS = {
    "dense_kv": dict(),
    "int8kv_w4head_fused": dict(
        kv_cache_dtype="int8", quantize_embed=True, head_w_bit=4, head_pad_to=384,
        fuse_qkv=True, fuse_gate_up=True,
    ),
}
B, S, CACHE = 2, 16, 64


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _build(kw):
    jcfg = jl.tiny_llama(dtype=jnp.float32, **kw)
    jmodel = jl.LlamaModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **kw), device="cpu", seed=1)
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, tmodel


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    return _build(VARIANTS[request.param])


def _tokens(seed, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


def _jax(jmodel, params, tokens, **kw):
    (logits, caches), state = jmodel.apply(
        params, jnp.asarray(tokens), **kw,
        capture_intermediates=lambda mdl, _: isinstance(mdl, jl.LlamaBlock),
        mutable=["intermediates"],
    )
    inter = state["intermediates"]
    hidden = [np.asarray(inter[f"layer_{i}"]["__call__"][0][0]) for i in range(len(inter))]
    return np.asarray(logits), caches, hidden


def _port(tmodel, fn):
    hidden = []
    hooks = [
        layer.register_forward_hook(lambda mod, inp, out: hidden.append(out[0].clone()))
        for layer in tmodel.layers
    ]
    try:
        logits, caches = fn()
    finally:
        for h in hooks:
            h.remove()
    return logits.numpy(), caches, [h.numpy() for h in hidden]


def _compare(port, ref):
    for got, want in zip(port[2], ref[2]):
        _close(got.reshape(want.shape), want)
    _close(port[0].reshape(ref[0].shape), ref[0])


def test_cacheless_forward(models):
    jcfg, jmodel, params, tmodel = models
    toks = _tokens(0)
    ref = _jax(jmodel, params, toks)
    port = _port(tmodel, lambda: tmodel(torch.from_numpy(toks)))
    _compare(port, ref)


@pytest.mark.parametrize("window", [0, None], ids=["window0", "full_read"])
def test_prefill(models, window):
    jcfg, jmodel, params, tmodel = models
    toks = _tokens(1)
    ref = _jax(jmodel, params, toks, kv_caches=jl.init_kv_caches(jcfg, B, CACHE),
               cache_len=jnp.zeros((), jnp.int32), attn_window=window)
    caches = tl.init_kv_caches(tmodel.cfg, B, CACHE, device="cpu")
    port = _port(tmodel, lambda: tmodel(torch.from_numpy(toks), kv_caches=caches,
                                        cache_len=0, attn_window=window))
    _compare(port, ref)


@pytest.mark.parametrize(
    "window,per_row", [(None, False), (32, False), (32, True)],
    ids=["full_read", "two_part", "two_part_per_row"],
)
def test_decode_step(models, window, per_row):
    """Prefill 16 tokens at window 0 (JAX), then decode one at position 16
    from the same caches: an int8 code on a rounding boundary may flip
    between two prefills that differ by ulps, so the port starts from the
    JAX package's caches."""
    jcfg, jmodel, params, tmodel = models
    toks, nxt = _tokens(2), _tokens(3, 1)
    jcaches = jl.prefill(jmodel, params, jnp.asarray(toks), jl.init_kv_caches(jcfg, B, CACHE))[1]
    tcaches = [tuple(torch.from_numpy(np.array(c)) for c in layer) for layer in jcaches]
    jlen = jnp.full((B,), S, jnp.int32) if per_row else jnp.asarray(S, jnp.int32)
    ref = _jax(jmodel, params, nxt, positions=jnp.full((B, 1), S, jnp.int32),
               kv_caches=jcaches, cache_len=jlen, attn_window=window)
    tlen = [S] * B if per_row else S
    port = _port(tmodel, lambda: tl.decode_step(tmodel, torch.from_numpy(nxt), tcaches, tlen,
                                                attn_window=window))
    _compare(port, ref)


def test_window_violation_poisons_with_nan(models):
    """attn_window below the cache length NaN-poisons both packages' logits."""
    jcfg, jmodel, params, tmodel = models
    toks, nxt = _tokens(4), _tokens(5, 1)
    jcaches = jl.prefill(jmodel, params, jnp.asarray(toks), jl.init_kv_caches(jcfg, B, CACHE))[1]
    ref, _ = jmodel.apply(params, jnp.asarray(nxt), positions=jnp.full((B, 1), S, jnp.int32),
                          kv_caches=jcaches, cache_len=jnp.asarray(S, jnp.int32), attn_window=8)
    tcaches = tl.init_kv_caches(tmodel.cfg, B, CACHE, device="cpu")
    tl.prefill(tmodel, torch.from_numpy(toks), tcaches)
    got, _ = tl.decode_step(tmodel, torch.from_numpy(nxt), tcaches, S, attn_window=8)
    assert np.isnan(np.asarray(ref)).all()
    assert torch.isnan(got).all()


def test_fuse_llama_params_keeps_logits():
    """Fusing q|k|v and gate|up in the port leaves the logits of the JAX
    unfused model unchanged (and matches the JAX fused tree)."""
    jcfg, jmodel, params, tmodel = _build(dict(kv_cache_dtype="int8", quantize_embed=True))
    toks = _tokens(6)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(toks))[0])
    fused = tl.fuse_llama_params(tmodel)
    assert fused.cfg.fuse_qkv and hasattr(fused.layer_0.attn, "qkv_proj")
    _close(fused(torch.from_numpy(toks))[0].numpy(), ref)

    jfused = jl.fuse_llama_params(params)
    tfused = tl.LlamaModel(fused.cfg, device="cpu")
    load_jax_params(tfused, jax.tree_util.tree_map(np.asarray, jfused))
    _close(tfused(torch.from_numpy(toks))[0].numpy(), ref)


def test_prepared_for_cuda_model_keeps_logits():
    """prepare_params_for_cuda (the asym→sym rewrite, f32 metadata kept)
    changes the logits by no more than that rewrite's f32 rounding."""
    jcfg, jmodel, params, tmodel = _build(dict(asym=True))
    toks = _tokens(7)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(toks))[0])
    prepare_params_for_cuda(tmodel)
    assert all(not m.qweight.asym for m in tmodel.modules() if hasattr(m, "set_qweight"))
    _close(tmodel(torch.from_numpy(toks))[0].numpy(), ref)


@pytest.mark.parametrize(
    "name", ["llama3_8b", "llama2_7b", "mistral_7b", "qwen2_7b", "mixtral_8x7b", "tiny_llama"])
def test_config_factories_match(name):
    jcfg, tcfg = getattr(jl, name)(), getattr(tl, name)()
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.head_dim == jcfg.head_dim


@pytest.mark.parametrize(
    "field,value,slice_",
    [
        ("mbwq_strategy", ((2, 0.5), (4, 0.5)), "sub-4-bit"),
        ("moe_num_experts", 4, "MoE"),
        ("sequence_parallel", "ring", "parallel"),
        ("remat", True, "training"),
        ("quantized", False, "training"),
    ],
)
def test_out_of_slice_configs_raise(field, value, slice_):
    """Configurations of a slice still to port raise, naming it; those of a
    slice that has landed build (the sub-4-bit slice: MBWQ projections,
    whose parity is in test_torch_llama_mbwq.py; the training slice: remat,
    whose gradients test_torch_training.py checks; the checkpoint slice: fp
    projections, flax ``Dense`` layers, whose parity is in
    test_torch_llama_loader.py; the MoE slice: a ``QuantMoEMLP`` in every
    block, whose parity is in test_torch_moe.py; the parallel slice:
    sequence parallelism on an ``sp`` mesh, whose parity is in
    test_torch_sequence_parallel.py)."""
    if field == "sequence_parallel":
        from bitorch_engine_tpu_torch.parallel import make_axes_mesh

        with pytest.raises(ValueError, match="sp_mesh"):
            tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **{field: value}), device="cpu")
        mesh = make_axes_mesh(sp=1)  # the one-process world
        cfg = tl.tiny_llama(dtype=torch.float32, sp_mesh=mesh, **{field: value})
        sp_model = tl.LlamaModel(cfg, device="cpu", seed=1)
        plain = tl.LlamaModel(cfg.replace(sequence_parallel=None, sp_mesh=None), device="cpu",
                              seed=1)
        toks = torch.tensor([[1, 2, 3, 4]])
        torch.testing.assert_close(sp_model(toks)[0], plain(toks)[0], rtol=1e-5, atol=1e-5)
        return
    cfg = tl.tiny_llama(dtype=torch.float32, **{field: value})
    if field == "quantized":
        model = tl.LlamaModel(cfg, device="cpu")
        assert isinstance(model.layer_0.attn.q_proj, Dense)
        assert model(torch.tensor([[1, 2, 3]]))[0].shape == (1, 3, cfg.vocab_size)
        return
    if slice_ == "sub-4-bit":
        model = tl.LlamaModel(cfg, device="cpu")
        assert model.layer_0.attn.q_proj.qweight.bit_widths == (4, 2)
        return
    if field == "remat":
        assert tl.LlamaModel(cfg, device="cpu").cfg.remat
        return
    if slice_ == "MoE":
        model = tl.LlamaModel(cfg, device="cpu")
        assert all(isinstance(layer.mlp, tl.QuantMoEMLP) and len(layer.mlp.experts) == value
                   for layer in model.layers)
        return
    with pytest.raises(NotImplementedError, match=slice_):
        tl.LlamaModel(cfg, device="cpu")


@pytest.mark.parametrize(
    "field",
    ["mbwq_container_bits", "use_flash_attention", "sp_mesh", "sp_axis", "moe_top_k",
     "moe_capacity_factor", "moe_renormalize"],
)
def test_reference_only_config_fields_are_refused(field):
    """Fields of the JAX config that no code of the port reads yet are not
    accepted (and so never silently ignored); a field that a landed slice
    reads (``mbwq_container_bits``, the sub-4-bit slice; ``moe_top_k``,
    ``moe_capacity_factor`` and ``moe_renormalize``, the MoE slice;
    ``sp_mesh`` and ``sp_axis``, the parallel slice) is accepted with the
    JAX default."""
    assert field in {f.name for f in dataclasses.fields(jl.tiny_llama())}
    if field in ("sp_mesh", "sp_axis"):
        from bitorch_engine_tpu_torch.parallel import make_axes_mesh

        jax_default = getattr(jl.tiny_llama(), field)
        assert getattr(tl.tiny_llama(), field) == jax_default
        value = make_axes_mesh(sp=1) if field == "sp_mesh" else "seq"
        assert getattr(tl.tiny_llama(**{field: value}), field) is value
        return
    if field == "mbwq_container_bits":
        assert tl.tiny_llama(**{field: {2: 4}}).mbwq_container_bits == {2: 4}
        assert tl.tiny_llama().mbwq_container_bits == jl.tiny_llama().mbwq_container_bits
        return
    if field.startswith("moe_"):
        jax_default = getattr(jl.tiny_llama(), field)
        assert getattr(tl.tiny_llama(), field) == jax_default
        assert getattr(tl.tiny_llama(**{field: jax_default}), field) == jax_default
        return
    with pytest.raises(TypeError, match=field):
        tl.tiny_llama(**{field: getattr(jl.tiny_llama(), field)})


def test_paged_cache_is_a_later_slice():
    """The serving slice brought paged caches: a PagedKV is taken (its
    parity with the JAX package is in test_torch_paged_kv.py); a cache of
    any other type is refused."""
    from bitorch_engine_tpu_torch.models.paged_kv import init_paged_kv_caches

    cfg = tl.tiny_llama(dtype=torch.float32, num_layers=1)
    model = tl.LlamaModel(cfg, device="cpu")
    paged = init_paged_kv_caches(cfg, 3, 8, 1, 2, device="cpu")
    paged[0].page_table[0] = torch.tensor([1, 2], dtype=torch.int32)
    logits, _ = model(torch.zeros((1, 3), dtype=torch.long), kv_caches=paged, cache_len=0)
    assert torch.isfinite(logits).all()
    assert paged[0].k_pool[1, :3].abs().sum() > 0  # the prompt was written

    class Paged:
        pass

    with pytest.raises(TypeError, match="PagedKV"):
        model(torch.zeros((1, 1), dtype=torch.long), kv_caches=[Paged()], cache_len=0)
