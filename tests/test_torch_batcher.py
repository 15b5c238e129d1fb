"""The port's ContinuousBatcher gives the JAX package's greedy tokens
exactly, request by request, on ``tiny_llama(dtype=f32)`` with the JAX
parameters carried over: dense caches (bf16 and int8 KV, decode chunks of
1 and 4), chunked prefill, and the batcher's refusals (the scenarios of
``tests/test_paged_kv.py`` and ``tests/test_generate.py``; the paged
caches in ``test_torch_batcher_paged.py``, EOS, admission and the kernel
path in ``test_torch_batcher_flow.py``).
"""

import pytest

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_batcher_common import _both, _models, _prompts, _serve
from bitorch_engine_tpu_torch.models import generate as tg


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [False], ids=["dense"])
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


def test_pool_too_small_raises():
    _, _, tmodel = _models()
    b = tg.ContinuousBatcher(tmodel, num_slots=2, max_len=32, kv_pages=2, kv_page_size=8)
    b.submit(list(range(1, 7)), max_new_tokens=20)  # 26 tokens > 8 usable
    with pytest.raises(RuntimeError, match="page pool too small"):
        b.run()


def test_prompt_too_long_raises():
    _, _, tmodel = _models()
    b = tg.ContinuousBatcher(tmodel, num_slots=1, max_len=8)
    b.submit(list(range(1, 10)), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_len"):
        b.run()


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
