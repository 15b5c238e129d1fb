"""The port's ContinuousBatcher gives the JAX package's greedy tokens
exactly, request by request, on ``tiny_llama(dtype=f32)`` with the JAX
parameters carried over: dense and paged caches, bf16 and int8 KV, decode
chunks of 1 and 4, chunked prefill, a tight pool that reuses pages, EOS,
mixed-bucket admission and step-then-run (the scenarios of
``tests/test_paged_kv.py`` and ``tests/test_generate.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tokens_identical_to_jax(paged, kv_dtype, chunk):
    kw = dict(num_slots=2, max_len=32, decode_chunk=chunk)
    if paged:
        kw.update(kv_pages=9, kv_page_size=8)
    got, want, tb = _both(_prompts(11, (4, 6, 3, 5, 7)), 7, kv_dtype, **kw)
    assert len(got) == 5 and all(len(g) == 7 for g in got.values())
    assert got == want
    if paged:  # every page back on the free list, the table all zero
        assert len(tb.allocator.free) == 8 and (tb.allocator.table == 0).all()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_identical_to_jax(paged):
    kw = dict(num_slots=2, max_len=64, prefill_chunk=8)
    if paged:
        kw.update(kv_pages=1 + 2 * 8, kv_page_size=8)
    got, want, _ = _both(_prompts(7, (21, 5, 17, 12), lo=1), 6, "int8", **kw)
    assert got == want


def test_tight_pool_reuses_pages_identical_to_jax():
    """3 usable pages (24 tokens) < num_slots × max_len: requests pass
    through the pool one after another."""
    got, want, tb = _both(_prompts(12, (5, 6, 4, 7)), 6, "int8", num_slots=2, max_len=32,
                          kv_pages=4, kv_page_size=8)
    assert got == want and len(tb.allocator.free) == 3


def test_pool_too_small_raises():
    _, _, tmodel = _models()
    b = tg.ContinuousBatcher(tmodel, num_slots=2, max_len=32, kv_pages=2, kv_page_size=8)
    b.submit(list(range(1, 7)), max_new_tokens=20)  # 26 tokens > 8 usable
    with pytest.raises(RuntimeError, match="page pool too small"):
        b.run()


@pytest.mark.parametrize("chunk", [1, 4])
def test_eos_identical_to_jax(chunk):
    _, _, tmodel = _models("int8")
    prompts = _prompts(6, (4, 5, 3))
    eos = _serve(tg.ContinuousBatcher(tmodel, num_slots=2, max_len=32), prompts, 6)[1][2]
    got, want, _ = _both(prompts, 6, "int8", num_slots=2, max_len=32, eos_id=eos,
                         decode_chunk=chunk)
    assert got == want and got[1][-1] == eos and len(got[1]) <= 3


def test_prompt_too_long_raises():
    _, _, tmodel = _models()
    b = tg.ContinuousBatcher(tmodel, num_slots=1, max_len=8)
    b.submit(list(range(1, 10)), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_len"):
        b.run()


def test_mixed_bucket_admission_identical_to_jax():
    """A 16-bucket head and three 8-bucket prompts behind it: two batched
    prefills, tokens equal to the JAX package's."""
    jmodel, params, tmodel = _models()
    prompts = _prompts(9, (12, 3, 4, 5))
    want = _serve(jg.ContinuousBatcher(jmodel, params, num_slots=4, max_len=32), prompts, 4)
    b = tg.ContinuousBatcher(tmodel, num_slots=4, max_len=32)
    calls = []
    inner = b._prefill_slots
    b._prefill_slots = lambda *a: calls.append(len(a[1])) or inner(*a)
    assert _serve(b, prompts, 4) == want
    assert calls == [1, 3]


def test_step_then_run_identical_to_jax():
    jmodel, params, tmodel = _models()
    p1, p2 = _prompts(8, (4, 5))

    def drive(b):
        b.submit(p1, max_new_tokens=3)
        b._admit()
        b.step()
        b.submit(p2, max_new_tokens=3)
        done = {r.uid: r.generated for r in b.run()}
        assert b.run() == []
        return done

    want = drive(jg.ContinuousBatcher(jmodel, params, num_slots=2, max_len=32))
    assert drive(tg.ContinuousBatcher(tmodel, num_slots=2, max_len=32)) == want


def test_paged_kernel_path_identical_to_jax(monkeypatch):
    """hd 128, max_len 512 (windows of 256 < the 512 view): the port's
    decode steps go through the write-back kernel's wrapper and its later
    prefill chunks through the read-only one (plain versions on the CPU);
    the JAX batcher runs its kernel in interpret mode.  Page reuse, inactive
    slots on the null page."""
    monkeypatch.setenv("BITORCH_PAGED_KERNEL", "interpret")
    calls = {"paged_prefix_attention": 0, "paged_prefix_attention_update": 0}
    for name in calls:
        def counting(*a, _inner=getattr(tl, name), _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)
        monkeypatch.setattr(tl, name, counting)
    kw = dict(num_slots=2, max_len=512, kv_pages=1 + 2 * 4, kv_page_size=8, prefill_chunk=8)
    got, want, tb = _both(_prompts(13, (12, 3, 9)), 5, "int8",
                          model_kw=(("hidden_size", 512), ("num_heads", 4)), **kw)
    assert got == want and (tb.allocator.table == 0).all()
    assert calls["paged_prefix_attention"] > 0 and calls["paged_prefix_attention_update"] > 0


def test_sampling_runs_in_range():
    _, _, tmodel = _models()
    b = tg.ContinuousBatcher(tmodel, num_slots=2, max_len=32, temperature=1.0)
    got = _serve(b, _prompts(4, (4, 6)), 5)
    assert all(len(g) == 5 and all(0 <= t < 256 for t in g) for g in got.values())


def test_mesh_is_a_later_slice():
    """The parallel-layouts slice brought ``mesh=``: the one-process mesh
    serves as the unsharded batcher, and a layout the world does not hold
    raises (the sharded worlds are in test_torch_serving_sharded.py)."""
    from bitorch_engine_tpu_torch.parallel import make_mesh

    _, _, tmodel = _models()
    kw = dict(num_slots=2, max_len=32)
    prompts = _prompts(5, (4, 6, 3))
    meshed = _serve(tg.ContinuousBatcher(tmodel, mesh=make_mesh(), **kw), prompts, 4)
    assert meshed == _serve(tg.ContinuousBatcher(tmodel, **kw), prompts, 4)
    with pytest.raises(ValueError, match="dp"):
        make_mesh(dp=2)


def test_bad_prefill_chunk_and_page_size_raise():
    _, _, tmodel = _models()
    with pytest.raises(ValueError, match="power of 2"):
        tg.ContinuousBatcher(tmodel, prefill_chunk=12)
    with pytest.raises(ValueError, match="multiple of kv_page_size"):
        tg.ContinuousBatcher(tmodel, max_len=30, kv_pages=5, kv_page_size=8)
