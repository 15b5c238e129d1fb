"""The batcher tests' shared JAX and port models and drivers
(``test_torch_batcher*.py``: one file a group of scenarios, so that
parallel test workers take them apart)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bitorch_engine_tpu.models import generate as jg
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu_torch.models import generate as tg
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.utils.convert import load_jax_params


@functools.lru_cache(maxsize=None)
def _models(kv_dtype="bf16", **kw):
    jmodel = jl.LlamaModel(jl.tiny_llama(dtype=jnp.float32, kv_cache_dtype=kv_dtype, **kw))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, kv_cache_dtype=kv_dtype, **kw),
                           device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def _prompts(seed, lens, lo=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, 256, size=n).tolist() for n in lens]


def _serve(batcher, prompts, n_new):
    for p in prompts:
        batcher.submit(p, max_new_tokens=n_new)
    return {r.uid: r.generated for r in batcher.run()}


def _both(prompts, n_new, kv_dtype="bf16", model_kw=(), **kw):
    jmodel, params, tmodel = _models(kv_dtype, **dict(model_kw))
    want = _serve(jg.ContinuousBatcher(jmodel, params, **kw), prompts, n_new)
    tb = tg.ContinuousBatcher(tmodel, **kw)
    got = _serve(tb, prompts, n_new)
    return got, want, tb
