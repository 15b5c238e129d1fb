"""The port's HF checkpoint loader and ``quantize_llama_params`` against the
JAX package's, and the fp (``quantized=False``) Llama.

Each case of ``tests/test_llama_loader.py`` (fp weights quantized at load,
a GPTQ projection, the int8 embedding with the untied w4 head, the tied
head, Qwen2's q/k/v biases with fusion, the padded head) feeds one
seeded tensor dict to both loaders: every record and array of the port's
model (``utils.convert.params_tree``) must equal the JAX tree's bit for
bit, and the logits must agree.  ``quantize_llama_params`` (MPQ and MBWQ)
is held the same way on an fp model carried over from the JAX package's
``init``; the fp model itself gives the JAX logits within f32 rel 1e-5 and
the same greedy tokens.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)
from test_torch_ingest import assert_records_equal

from bitorch_engine_tpu.models import generate as jgen
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.models import llama_loader as jloader
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu_torch.models import generate as tgen
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.models import llama_loader as tloader
from bitorch_engine_tpu_torch.utils.convert import load_jax_params, params_tree

TOKENS = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]], np.int32)


def _hf_fp_tensors(cfg, seed=0):
    """As ``tests/test_llama_loader.py`` makes them."""
    rng = np.random.default_rng(seed)
    t = {"model.embed_tokens.weight":
         rng.standard_normal((cfg.vocab_size, cfg.hidden_size)).astype(np.float32) * 0.02,
         "model.norm.weight": np.ones(cfg.hidden_size, np.float32)}
    hd = cfg.head_dim
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + 0.1 * rng.standard_normal(cfg.hidden_size).astype(
            np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones(cfg.hidden_size, np.float32)
        shapes = {
            "self_attn.q_proj": (cfg.num_heads * hd, cfg.hidden_size),
            "self_attn.k_proj": (cfg.num_kv_heads * hd, cfg.hidden_size),
            "self_attn.v_proj": (cfg.num_kv_heads * hd, cfg.hidden_size),
            "self_attn.o_proj": (cfg.hidden_size, cfg.num_heads * hd),
            "mlp.gate_proj": (cfg.intermediate_size, cfg.hidden_size),
            "mlp.up_proj": (cfg.intermediate_size, cfg.hidden_size),
            "mlp.down_proj": (cfg.hidden_size, cfg.intermediate_size),
        }
        for name, (o, k) in shapes.items():
            t[p + name + ".weight"] = rng.standard_normal((o, k)).astype(np.float32) * 0.02
    return t


def assert_trees_equal(port, ref, path=""):
    """The port's ``params_tree`` against the JAX tree (numpy leaves): the
    same paths, records field by field, arrays bit for bit."""
    assert set(port) == set(ref), (path, sorted(port), sorted(ref))
    for key, want in ref.items():
        got, where = port[key], f"{path}/{key}"
        if isinstance(want, dict):
            assert_trees_equal(got, want, where)
        elif hasattr(want, "segments") or hasattr(want, "packed"):
            assert_records_equal(got, want)
        else:
            want = np.asarray(want)
            assert got.dtype == torch.from_numpy(np.array(want)).dtype, where
            np.testing.assert_array_equal(got.numpy(), want, err_msg=where)


def _both(tensors, **kw):
    jcfg = jl.tiny_llama(dtype=jnp.float32, **kw)
    tcfg = tl.tiny_llama(dtype=torch.float32, **kw)
    params = jloader.load_llama_params(tensors, jcfg, dtype=jnp.float32)
    model = tloader.load_llama_params(tensors, tcfg, dtype=torch.float32, device="cpu")
    ref = jax.tree_util.tree_map(np.asarray, params)["params"]
    assert_trees_equal(params_tree(model), ref)
    want, _ = jl.LlamaModel(jcfg).apply(params, jnp.asarray(TOKENS))
    got, _ = model(torch.from_numpy(TOKENS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    return params, model


def _gptq_one(tensors, cfg_kw):
    """Replace layer 0's q_proj by its GPTQ export, as the JAX test does."""
    cfg = jl.tiny_llama(dtype=jnp.float32, **cfg_kw)
    p = "model.layers.0.self_attn.q_proj."
    qt = jquant.quantize_mpq(jnp.asarray(tensors[p + "weight"].T), w_bit=cfg.w_bit,
                             group_size=cfg.group_size, asym=True)
    del tensors[p + "weight"]
    tensors[p + "qweight"] = np.asarray(qt.packed)
    tensors[p + "qzeros"] = np.asarray(qt.zeros)
    tensors[p + "scales"] = np.asarray(qt.scales)
    return tensors


CASES = {
    "fp_rtn": (lambda cfg: _hf_fp_tensors(cfg), {}),
    "gptq": (lambda cfg: _gptq_one(_hf_fp_tensors(cfg, seed=1), dict(asym=True)),
             dict(asym=True)),
    "int8_embed_w4_head": (
        lambda cfg: {**_hf_fp_tensors(cfg), "lm_head.weight": np.random.default_rng(9)
                     .standard_normal((cfg.vocab_size, cfg.hidden_size)).astype(np.float32) * 0.02},
        dict(quantize_embed=True, head_w_bit=4)),
    "tied_head": (lambda cfg: _hf_fp_tensors(cfg), dict(quantize_embed=True, head_w_bit=4)),
    "padded_head": (lambda cfg: _hf_fp_tensors(cfg), dict(head_w_bit=4, head_pad_to=512)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loader_records_match_jax(case):
    make, kw = CASES[case]
    _both(make(tl.tiny_llama(**kw)), **kw)


def test_loader_qwen_bias_and_fusion_match_jax():
    """q/k/v biases ingest; the fused model concatenates them into qkv_proj
    and gives the unfused logits."""
    cfg = tl.tiny_llama()
    t = _hf_fp_tensors(cfg)
    rng = np.random.default_rng(7)
    hd = cfg.head_dim
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}.self_attn."
        for name, n in (("q", cfg.num_heads), ("k", cfg.num_kv_heads), ("v", cfg.num_kv_heads)):
            t[p + f"{name}_proj.bias"] = rng.standard_normal(n * hd).astype(np.float32)
    _, unfused = _both(t, attn_qkv_bias=True)
    _, fused = _both(t, attn_qkv_bias=True, fuse_qkv=True, fuse_gate_up=True)
    assert fused.layer_0.attn.qkv_proj.bias.shape[0] == (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    tokens = torch.from_numpy(TOKENS)
    assert torch.equal(unfused(tokens)[0], fused(tokens)[0])


def test_loader_builds_no_random_weights(monkeypatch):
    """The loader's model is a meta skeleton filled from the checkpoint:
    nothing is quantized on the target device but the checkpoint's own
    weights (one RTN per projection and the head)."""
    from bitorch_engine_tpu_torch.layers import linear

    cfg = tl.tiny_llama(dtype=torch.float32, head_w_bit=4)
    tensors = _hf_fp_tensors(cfg)
    devices = []
    real = linear.quantize_mpq
    monkeypatch.setattr(linear, "quantize_mpq", lambda w, **kw: devices.append(w.device.type)
                        or real(w, **kw))
    model = tloader.load_llama_params(tensors, cfg, torch.float32, device="cpu")
    assert set(devices) == {"meta"} and model.device.type == "cpu"
    assert all(not t.is_meta for t in model.state_dict().values())


@functools.lru_cache(maxsize=None)
def _jax_fp_params():
    """The JAX package's untrained fp parameters, initialized once a module
    (JAX arrays are immutable; the port copies them in)."""
    jcfg = jl.tiny_llama(dtype=jnp.float32, quantized=False)
    return jcfg, jl.LlamaModel(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


def _fp_models():
    jcfg, params = _jax_fp_params()
    model = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, quantized=False), device="cpu", seed=1)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model


def test_fp_llama_matches_jax():
    """fp projections: logits within f32 rel 1e-5, identical greedy tokens."""
    jcfg, params, model = _fp_models()
    want, _ = jl.LlamaModel(jcfg).apply(params, jnp.asarray(TOKENS))
    got, _ = model(torch.from_numpy(TOKENS))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    jtoks = jgen.generate(jl.LlamaModel(jcfg), params, jnp.asarray(TOKENS), max_new_tokens=6)
    ttoks = tgen.generate(model, torch.from_numpy(TOKENS), max_new_tokens=6)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("kind", ["mpq", "mbwq"])
def test_quantize_llama_params_matches_jax(kind):
    kw = dict(w_bit=2, group_size=32, quant_mid_sym=True) if kind == "mpq" else dict(
        group_size=32, mbwq_strategy=((4, 0.25), (2, 0.75)))
    _, params, model = _fp_models()
    jq = jloader.quantize_llama_params(params, jl.tiny_llama(dtype=jnp.float32, **kw))
    tq = tloader.quantize_llama_params(model, tl.tiny_llama(dtype=torch.float32, **kw),
                                       device="cpu")
    assert_trees_equal(params_tree(tq), jax.tree_util.tree_map(np.asarray, jq)["params"])
