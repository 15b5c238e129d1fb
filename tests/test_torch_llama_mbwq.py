"""The port's MBWQ Llama against the JAX package's on a tiny f32 config, in
the A16 and the A8 regime.

The config is the serving form (int8 KV cache, int8 embedding, untied w4
head padded, fused q|k|v and gate|up, projections padded) with 50% of each
projection's rows at w4 and 50% at w2, g32: at hidden 256 and intermediate
512 every w2 segment has 4 or 8 groups, a multiple of the A8 superblock, so
``act_bits_map={2: 8}`` really runs them A8 (asserted on both sides).  The
JAX parameters are carried over with ``load_jax_params``: A16 as quantized,
A8 after the JAX package's ``relayout_params_for_tpu`` (``tpu_quad`` and
``tpu_pair`` layouts, which the port reads and repacks).  Greedy tokens
must be identical; logits agree to 1e-4 (with an absolute floor of 1e-4 of
the largest): both sides compute in f32 with sums in another order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.models import generate as jg
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.utils.convert import relayout_params_for_tpu
from bitorch_engine_tpu_torch.layers.linear import MBWQLinear
from bitorch_engine_tpu_torch.models import generate as tg
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.utils.convert import load_jax_params, prepare_params_for_cuda

MBWQ = dict(
    mbwq_strategy=((4, 0.5), (2, 0.5)), group_size=32, kv_cache_dtype="int8",
    quantize_embed=True, head_w_bit=4, head_pad_to=384, fuse_qkv=True, fuse_gate_up=True,
    proj_pad_to=384,
)
A8 = {2: 8}


@functools.lru_cache(maxsize=None)
def _models(regime):
    jmodel = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **MBWQ))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    if regime == "a8":
        params = relayout_params_for_tpu(params, act_bits_map=A8)
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **MBWQ), device="cpu", seed=1)
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    prepare_params_for_cuda(tmodel, act_bits_map=A8 if regime == "a8" else None)
    return jmodel, params, tmodel


def _mbwq_layers(tmodel):
    return [m for m in tmodel.modules() if isinstance(m, MBWQLinear)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("regime", ["a16", "a8"])
def test_every_w2_segment_takes_the_regime(regime):
    jmodel, params, tmodel = _models(regime)
    layers = _mbwq_layers(tmodel)
    assert len(layers) == 4 * 2  # q|k|v, o, gate|up and down in each of 2 layers
    for mod in layers:
        segs = mod.qweight.segments
        assert [s.w_bit for s in segs] == [4, 2]
        assert [s.act_bits for s in segs] == ([16, 8] if regime == "a8" else [16, 16])
        assert all(s.layout == "gptq" and not s.asym for s in segs)
    jsegs = [leaf for leaf in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: hasattr(x, "segments")) if hasattr(leaf, "segments")]
    assert len(jsegs) == len(layers)
    for qt in jsegs:
        want = ["tpu_pair", "tpu_quad"] if regime == "a8" else ["gptq", "gptq"]
        assert [s.layout for s in qt.segments] == want


@pytest.mark.parametrize("regime", ["a16", "a8"])
def test_cacheless_logits_match_jax(regime):
    jmodel, params, tmodel = _models(regime)
    toks = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(toks))[0])
    got = tmodel(torch.from_numpy(toks))[0].numpy()
    _close(got, want)


@pytest.mark.parametrize("regime", ["a16", "a8"])
def test_greedy_tokens_identical_to_jax(regime):
    jmodel, params, tmodel = _models(regime)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 5)).astype(np.int32)
    want = np.asarray(jg.generate(jmodel, params, jnp.asarray(prompt), max_new_tokens=8))
    got = tg.generate(tmodel, torch.from_numpy(prompt), max_new_tokens=8).numpy()
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("regime", ["a16", "a8"])
def test_batcher_tokens_identical_to_jax(regime):
    """One paged ``ContinuousBatcher`` run (a queue longer than the slots,
    decode chunks of 2) on the MBWQ model, request by request."""
    jmodel, params, tmodel = _models(regime)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (4, 7, 3, 6)]
    kw = dict(num_slots=2, max_len=32, kv_pages=9, kv_page_size=8, decode_chunk=2)

    def serve(b):
        for p in prompts:
            b.submit(p, max_new_tokens=5)
        return {r.uid: r.generated for r in b.run()}

    want = serve(jg.ContinuousBatcher(jmodel, params, **kw))
    got = serve(tg.ContinuousBatcher(tmodel, **kw))
    assert len(got) == 4 and got == want


def test_a16_and_a8_flip_without_requantizing():
    """``prepare_params_for_cuda`` with ``{2: 16}`` brings the A8 model back
    to the A16 model's logits, on the same codes."""
    _, _, t16 = _models("a16")
    _, _, t8 = _models("a8")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 6)))
    want16, want8 = t16(toks)[0], t8(toks)[0]
    model = tl.LlamaModel(t16.cfg, device="cpu")
    model.load_state_dict(t16.state_dict())
    prepare_params_for_cuda(model, act_bits_map=A8)
    torch.testing.assert_close(model(toks)[0], want8, rtol=0, atol=0)
    packed = [s.packed.clone() for m in _mbwq_layers(model) for s in m.segments]
    prepare_params_for_cuda(model, act_bits_map={2: 16})
    torch.testing.assert_close(model(toks)[0], want16, rtol=0, atol=0)
    assert all(torch.equal(a, s.packed) for a, s in zip(
        packed, (s for m in _mbwq_layers(model) for s in m.segments)))


def test_serving_factory_is_the_bench_config():
    """``llama2_7b_mbwq_serving`` holds the JAX bench's MBWQ-2.5 settings
    (``bench.py:474-497``: A8 from ``act_bits_map``, window floor 128 from
    the caller)."""
    tcfg = tl.llama2_7b_mbwq_serving()
    jcfg = jl.llama2_7b(
        dtype=jnp.bfloat16, mbwq_strategy=((4, 0.25), (2, 0.75, 128)), quant_mid_sym=False,
        group_size=64, max_seq_len=1024, kv_cache_dtype="int8", quantize_embed=True,
        head_w_bit=4, head_pad_to=2048, fuse_qkv=True, fuse_gate_up=True, proj_pad_to=2048,
    )
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.bfloat16


def test_mbwq_bias_and_late_fusion_raise():
    with pytest.raises(NotImplementedError, match="bias"):
        tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, attn_qkv_bias=True,
                                    mbwq_strategy=((4, 0.5), (2, 0.5))), device="cpu")
    model = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, mbwq_strategy=((4, 0.5), (2, 0.5))),
                          device="cpu")
    with pytest.raises(ValueError, match="MBWQ"):
        tl.fuse_llama_params(model)
