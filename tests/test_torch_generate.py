"""Greedy generation in the port gives the JAX package's tokens exactly, on
both tiny f32 variants (parameters carried over with ``load_jax_params``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.models import generate as jg
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu_torch.models import generate as tg
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.utils.convert import load_jax_params

VARIANTS = {
    "dense_kv": dict(),
    "int8kv_w4head_fused": dict(
        kv_cache_dtype="int8", quantize_embed=True, head_w_bit=4, head_pad_to=384,
        fuse_qkv=True, fuse_gate_up=True,
    ),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_tokens_identical_to_jax(variant):
    kw = VARIANTS[variant]
    jmodel = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, **kw))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **kw), device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    prompt = np.random.default_rng(1).integers(0, 256, (2, 5)).astype(np.int32)

    want = np.asarray(jg.generate(jmodel, params, jnp.asarray(prompt), max_new_tokens=8))
    got = tg.generate(tmodel, torch.from_numpy(prompt), max_new_tokens=8).numpy()
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got, want)


def test_eos_repeats_after_finish():
    model = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32), device="cpu")
    prompt = torch.tensor([[1, 2, 3]])
    free = tg.generate(model, prompt, max_new_tokens=4)
    eos = int(free[0, 4])  # the first decoded token
    out = tg.generate(model, prompt, max_new_tokens=6, eos_id=eos)
    assert (out[0, 4:] == eos).all()


def test_sample_token():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, -1.0, 0.5]])
    assert tg.sample_token(logits).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    drawn = tg.sample_token(logits, gen, temperature=1.0, top_k=1)
    assert drawn.tolist() == [1, 0]  # top-1 leaves one candidate per row
