"""The port's ring-overlapped row-parallel MPQ product
(``tests/test_overlap.py``): the ring against dense at (w_bit, tp) = (4,
4), (2, 4) and (8, 2) at 1e-5, against the JAX package's dense product on
the same inputs; its refusals; and the overlap
property as an event trace: each step posts the accumulator's send before
it launches the next chunk's product (the JAX test reads the same property
off the jaxpr: no chunk's product consumes a ppermute's output).

The port's side runs in one gloo world of 4 CPU processes
(``_torch_worlds.overlap_world``; tp 2 on a dp 2 × tp 2 mesh)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_worlds import start_world
from bitorch_engine_tpu.ops import quant as jquant
from bitorch_engine_tpu.ops.mpq_linear import mpq_linear as jmpq_linear
from bitorch_engine_tpu_torch.ops import quant as tquant

CASES = [(4, 4), (2, 4), (8, 2)]


@pytest.fixture(scope="module")
def pending_world():
    return start_world("overlap_world", 4)


@pytest.fixture(scope="module")
def world(pending_world, dense):
    return pending_world.result()


@pytest.fixture(scope="module")
def dense(pending_world):
    """The JAX package's dense products, computed while the world runs."""
    out = {}
    for w_bit, tp in CASES:
        k, n, gs, m = 1024, 512, 32, 4
        rng = np.random.default_rng(0)
        w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
        qt = jquant.quantize_mpq(w, w_bit=w_bit, group_size=gs)
        x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
        out[w_bit, tp] = np.asarray(jmpq_linear(x, qt))
    return out


@pytest.mark.parametrize("w_bit,tp", CASES)
def test_ring_row_parallel_matches_dense(world, dense, w_bit, tp):
    for rank in world:
        np.testing.assert_allclose(rank[f"ring_w{w_bit}_tp{tp}"], dense[w_bit, tp],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w_bit,tp", CASES)
def test_ring_posts_each_send_before_the_next_product(world, w_bit, tp):
    """D products, D - 1 sends, one all-gather; at every step s >= 1 the
    send of the accumulator is posted before chunk s's product is launched,
    and its receive is awaited only after."""
    for rank in world:
        trace = [tuple(e) for e in rank[f"trace_w{w_bit}_tp{tp}"]]
        assert sum(k == 0 for k, _ in trace) == tp and sum(k == 1 for k, _ in trace) == tp - 1
        for s in range(1, tp):
            send, product, recv = (trace.index((kind, s)) for kind in (1, 0, 2))
            assert send < product < recv
            assert trace.index((0, s - 1)) < send
        assert tuple(rank[f"comm_w{w_bit}_tp{tp}"]) == (tp - 1, 1)


@pytest.mark.parametrize("what", ["split", "act_order"])
def test_ring_rejects_bad_split(world, what):
    """K = 128 over 4 ranks breaks whole groups of 64; act-order tensors
    cannot shard along K."""
    for rank in world:
        assert int(rank[f"raises_{what}"]) == 1


def test_slice_concat_roundtrip():
    """``slice_mpq_n`` is the inverse of ``concat_mpq``, as in the JAX package."""
    w = np.random.default_rng(1).standard_normal((256, 384)).astype(np.float32)
    qt = tquant.quantize_mpq(torch.from_numpy(w), w_bit=4, group_size=64)
    parts = [tquant.slice_mpq_n(qt, i * 128, 128) for i in range(3)]
    back = tquant.concat_mpq(parts)
    assert torch.equal(back.packed, qt.packed) and torch.equal(back.scales, qt.scales)
    jqt = jquant.quantize_mpq(jnp.asarray(w), w_bit=4, group_size=64)
    want = np.asarray(jquant.dequantize_mpq(jquant.slice_mpq_n(jqt, 128, 128), jnp.float32))
    np.testing.assert_array_equal(tquant.dequantize_mpq(parts[1], torch.float32).numpy(), want)
