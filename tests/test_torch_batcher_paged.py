"""The port's ContinuousBatcher over paged caches gives the JAX
package's greedy tokens exactly (``test_torch_batcher.py``'s scenario on
an int8 / bf16 page pool, decode chunks of 1 and 4: every page back on
the free list after)."""

import pytest

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_batcher_common import _both, _prompts


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [True], ids=["paged"])
def test_tokens_identical_to_jax(paged, kv_dtype, chunk):
    kw = dict(num_slots=2, max_len=32, decode_chunk=chunk)
    if paged:
        kw.update(kv_pages=9, kv_page_size=8)
    got, want, tb = _both(_prompts(11, (4, 6, 3, 5, 7)), 7, kv_dtype, **kw)
    assert len(got) == 5 and all(len(g) == 7 for g in got.values())
    assert got == want
    if paged:  # every page back on the free list, the table all zero
        assert len(tb.allocator.free) == 8 and (tb.allocator.table == 0).all()
