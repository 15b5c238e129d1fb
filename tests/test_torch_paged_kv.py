"""The port's paged KV cache against the JAX package's: the page allocator's
bookkeeping, the cache layouts, the write positions and the carried-over
caches; then the paged branch of the Llama attention on the hd-128 tiny
config of ``tests/test_paged_attention_kernel.py``, where both packages take
the paged-attention kernel's path (the JAX one in interpret mode, the port
through the kernel's plain version on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.models import llama as jl
from bitorch_engine_tpu.models import paged_kv as jpk
from bitorch_engine_tpu_torch.models import llama as tl
from bitorch_engine_tpu_torch.models import paged_kv as tpk
from bitorch_engine_tpu_torch.utils.convert import load_jax_params, paged_kv_from_jax


def _drive(pk, dp_groups):
    """The same alloc / free sequence on an allocator of package ``pk``;
    returns every intermediate (result, table, free list)."""
    al = pk.PageAllocator(num_pages=13, page_size=8, slots=4, pages_per_slot=4,
                          dp_groups=dp_groups)
    trace = []
    for op, slot, tokens in [("a", 0, 20), ("a", 1, 8), ("a", 3, 17), ("a", 2, 32), ("f", 0, 0),
                             ("a", 2, 9), ("a", 0, 30), ("f", 1, 0), ("a", 1, 25), ("f", 3, 0)]:
        res = al.alloc(slot, tokens) if op == "a" else al.free_slot(slot)
        trace.append((res, al.table.copy(), list(al.free), al.can_alloc(16, slot)))
    with pytest.raises(ValueError, match="pages_per_slot"):
        al.alloc(1, tokens=1000)
    return trace


@pytest.mark.parametrize("dp_groups", [1, 2])
def test_page_allocator_matches_jax(dp_groups):
    got, want = _drive(tpk, dp_groups), _drive(jpk, dp_groups)
    assert any(res is False for res, *_ in want)  # exhaustion was exercised
    for (r1, t1, f1, c1), (r2, t2, f2, c2) in zip(got, want):
        assert r1 == r2 and f1 == f2 and c1 == c2
        np.testing.assert_array_equal(t1, t2)


@pytest.mark.parametrize("kw", [dict(slots=3, dp_groups=2), dict(num_pages=2, dp_groups=2)])
def test_page_allocator_refusals_match_jax(kw):
    args = dict(num_pages=9, page_size=8, slots=4, pages_per_slot=4)
    args.update(kw)
    with pytest.raises(ValueError) as want:
        jpk.PageAllocator(**args)
    with pytest.raises(ValueError) as got:
        tpk.PageAllocator(**args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_init_and_convert_match_jax(kv_dtype):
    jcaches = jpk.init_paged_kv_caches(jl.tiny_llama(kv_cache_dtype=kv_dtype), 9, 8, 3, 4)
    tcaches = tpk.init_paged_kv_caches(tl.tiny_llama(kv_cache_dtype=kv_dtype), 9, 8, 3, 4,
                                       device="cpu")
    assert len(tcaches) == len(jcaches)
    for t, j in zip(tcaches, jcaches):
        for name in ("k_pool", "v_pool", "k_scale", "v_scale", "page_table"):
            a, b = getattr(t, name), getattr(j, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype)
                assert not a.any()
        assert (t.kv_heads, t.page_size, t.view_len) == (j.kv_heads, j.page_size, j.view_len)
    # one table tensor serves every layer in the port
    assert all(c.page_table is tcaches[0].page_table for c in tcaches)

    # carried-over caches keep every value
    rng = np.random.default_rng(0)
    filled = [j.replace(
        k_pool=jnp.asarray(rng.standard_normal(j.k_pool.shape), j.k_pool.dtype),
        page_table=jnp.asarray(rng.integers(0, 9, j.page_table.shape), jnp.int32),
        k_scale=None if j.k_scale is None else jnp.asarray(rng.uniform(size=j.k_scale.shape),
                                                           jnp.float32),
    ) for j in jcaches]
    conv = paged_kv_from_jax(jax.tree_util.tree_map(np.asarray, filled), device="cpu")
    for t, j in zip(conv, filled):
        np.testing.assert_array_equal(t.k_pool.float().numpy(), np.asarray(j.k_pool, np.float32))
        np.testing.assert_array_equal(t.page_table.numpy(), np.asarray(j.page_table))
        assert t.page_table.dtype == torch.int32 and t.kv_heads == j.kv_heads
        if j.k_scale is not None:
            np.testing.assert_array_equal(t.k_scale.numpy(), np.asarray(j.k_scale))


@pytest.mark.parametrize("cache_len", [5, [0, 9, 31]], ids=["scalar", "per_slot"])
@pytest.mark.parametrize("s", [1, 4])
def test_write_positions_match_jax(cache_len, s):
    jc = jpk.init_paged_kv_caches(jl.tiny_llama(), 13, 8, 3, 4)[0]
    table = np.random.default_rng(1).permutation(12).reshape(3, 4).astype(np.int32) + 1
    jc = jc.replace(page_table=jnp.asarray(table))
    tc = tpk.init_paged_kv_caches(tl.tiny_llama(num_layers=1), 13, 8, 3, 4, device="cpu")[0]
    tc.page_table.copy_(torch.from_numpy(table))
    jlen = jnp.asarray(cache_len, jnp.int32)
    want = jpk.paged_write_positions(jc, jlen, 3, s)
    got = tpk.paged_write_positions(tc, cache_len, 3, s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the paged branch of the Llama attention on the kernel's path ----------

B, PLEN, PS, P = 2, 4, 8, 4


def _hd128_models():
    kw = dict(hidden_size=512, num_heads=4, num_kv_heads=2, kv_cache_dtype="int8")
    jcfg = jl.tiny_llama(dtype=jnp.float32, **kw)
    jmodel = jl.LlamaModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = tl.LlamaModel(tl.tiny_llama(dtype=torch.float32, **kw), device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jmodel, params, tmodel


@pytest.fixture(scope="module")
def hd128():
    return _hd128_models()


def _jax_paged(jcfg):
    caches = jpk.init_paged_kv_caches(jcfg, 1 + B * P, PS, B, P)
    table = jnp.asarray(1 + np.arange(B * P)[::-1].reshape(B, P), jnp.int32)
    return [c.replace(page_table=table) for c in caches]


def test_llama_paged_decode_kernel_path_matches_jax(hd128, monkeypatch):
    """Prefill (JAX, window 0), then 4 decode steps at window 16 < view 32:
    both packages write the token and read the prefix through the
    paged-attention kernel's path.  The port starts from the JAX caches (an
    int8 code on a rounding boundary may flip between two f32 prefills);
    logits within the JAX kernel test's tolerance and greedy tokens equal."""
    monkeypatch.setenv("BITORCH_PAGED_KERNEL", "interpret")
    jcfg, jmodel, params, tmodel = hd128
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, PLEN)).astype(np.int32)
    logits, jcaches = jmodel.apply(params, jnp.asarray(toks), kv_caches=_jax_paged(jcfg),
                                   cache_len=jnp.zeros((B,), jnp.int32), attn_window=0)
    tcaches = paged_kv_from_jax(jax.tree_util.tree_map(np.asarray, jcaches), device="cpu")
    jcur = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None]
    tcur = jcur.copy()
    for step in range(4):
        pos = PLEN + step
        jl_, jcaches = jmodel.apply(params, jnp.asarray(jcur), positions=jnp.full((B, 1), pos),
                                    kv_caches=jcaches, cache_len=jnp.full((B,), pos, jnp.int32),
                                    attn_window=16)
        tl_, _ = tl.decode_step(tmodel, torch.from_numpy(tcur), tcaches, [pos] * B,
                                attn_window=16)
        want, got = np.asarray(jl_[:, -1]), tl_.numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3, err_msg=f"step {step}")
        jcur, tcur = want.argmax(-1)[:, None], got.argmax(-1)[:, None]
        np.testing.assert_array_equal(tcur, jcur, err_msg=f"tokens step {step}")
    for t, j in zip(tcaches, jcaches):  # the written pools agree
        np.testing.assert_array_equal(t.k_pool.numpy()[1:], np.asarray(j.k_pool)[1:])
        np.testing.assert_allclose(t.v_scale.numpy(), np.asarray(j.v_scale), rtol=1e-6)


def test_llama_paged_chunk_read_only_kernel_path_matches_jax(hd128, monkeypatch):
    """A second 8-token prefill chunk at cache_len 8, window 16: both read
    the prefix through the read-only kernel's path and merge it with the
    chunk's causal block."""
    monkeypatch.setenv("BITORCH_PAGED_KERNEL", "interpret")
    jcfg, jmodel, params, tmodel = hd128
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, 16)).astype(np.int32)
    _, jcaches = jmodel.apply(params, jnp.asarray(toks[:, :8]), kv_caches=_jax_paged(jcfg),
                              cache_len=jnp.asarray(0, jnp.int32), attn_window=0)
    tcaches = paged_kv_from_jax(jax.tree_util.tree_map(np.asarray, jcaches), device="cpu")
    positions = np.broadcast_to(np.arange(8, 16), (B, 8)).astype(np.int32)
    want, jcaches = jmodel.apply(params, jnp.asarray(toks[:, 8:]),
                                 positions=jnp.asarray(positions), kv_caches=jcaches,
                                 cache_len=jnp.asarray(8, jnp.int32), attn_window=16)
    got, _ = tmodel(torch.from_numpy(toks[:, 8:]), positions=torch.from_numpy(positions),
                    kv_caches=tcaches, cache_len=8, attn_window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    for t, j in zip(tcaches, jcaches):
        np.testing.assert_array_equal(t.k_pool.numpy()[1:], np.asarray(j.k_pool)[1:])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_port_paged_matches_port_dense(kv_dtype):
    """hd 64 (the gather path): a shuffled page table gives the dense
    cache's logits exactly, at full read and through a window."""
    cfg = tl.tiny_llama(dtype=torch.float32, kv_cache_dtype=kv_dtype)
    model = tl.LlamaModel(cfg, device="cpu", seed=3)
    b, max_len = 3, 32
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (b, PLEN)))
    dense = tl.init_kv_caches(cfg, b, max_len, device="cpu")
    paged = tpk.init_paged_kv_caches(cfg, 1 + b * P, PS, b, P, device="cpu")
    table = np.random.default_rng(7).permutation(b * P).reshape(b, P) + 1
    paged[0].page_table.copy_(torch.from_numpy(table))
    for window in (None, 16):
        outs = []
        for caches in (dense, paged):
            logits, _ = model(toks, kv_caches=caches, cache_len=[0] * b, attn_window=0)
            seq = [logits[:, -1]]
            cur = logits[:, -1].argmax(-1)[:, None]
            for i in range(4):
                lg, _ = tl.decode_step(model, cur, caches, [PLEN + i] * b, attn_window=window)
                seq.append(lg)
                cur = lg.argmax(-1)[:, None]
            outs.append(torch.stack(seq))
        assert torch.equal(outs[0], outs[1]), window
