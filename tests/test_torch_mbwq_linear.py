"""The port's MBWQ (mixed-bit) linear against the JAX package's on the CPU:
the strategy helpers; ``quantize_mbwq`` and ``dequantize_mbwq`` bit for bit;
kernel 7's plain version against the JAX fused Pallas kernel in interpret
mode; the forward (A16 and A8 segments, with and without ``channel_scale``)
against the JAX ``mbwq_linear``; the block and row gathers.  The CUDA kernel
itself runs only on the card (``chip_smoke.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import mbwq_linear as jmb
from bitorch_engine_tpu.ops.pallas.dequant_matmul import relayout_tpu
from bitorch_engine_tpu.ops.pallas.mbwq_matmul import mbwq_matmul_pallas
from bitorch_engine_tpu_torch.layers.linear import MBWQLinear
from bitorch_engine_tpu_torch.ops import mbwq_linear as tmb
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul import mbwq_matmul, mbwq_matmul_ref
from bitorch_engine_tpu_torch.utils.convert import _mbwq

S_42 = {"bits": [4, 2], "bits_prop": [0.75, 0.25], "group_size": {"4": 32, "2": 32}}
S_PER_BIT = {"bits": [4, 2], "bits_prop": [0.25, 0.75], "group_size": {"4": 64, "2": 128}}
S_842 = {"bits": [8, 4, 2], "bits_prop": [0.25, 0.5, 0.25],
         "group_size": {"8": 64, "4": 64, "2": 64}}
S_BENCH = jmb.strategy_dict(((4, 0.25), (2, 0.75, 128)), 64)  # MBWQ-2.5 of bench.py
STRATEGIES = {
    "w4w2_g32": (S_42, 256),
    "w4g64_w2g128": (S_PER_BIT, 1024),
    "w8w4w2_g64": (S_842, 1024),
    "bench_2p5": (S_BENCH, 4096),
    "mid_sym": (dict(S_PER_BIT, mid_sym=True), 1024),
    "container_2in4": (dict(S_42, container_bits={"2": 4}), 256),
    "odd_w3": ({"bits": [4, 3], "bits_prop": [0.5, 0.5], "group_size": {"4": 32, "3": 32}}, 256),
}


def _weight(k, n, base_gs, seed=0):
    """Blocks of ``base_gs`` rows with unit energy times a distinct factor:
    block norms 2% apart, far beyond an f32 sum-order difference."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    nb = k // base_gs
    blocks = w.reshape(nb, base_gs, n)
    blocks /= np.sqrt((blocks ** 2).sum(axis=(1, 2), keepdims=True))
    blocks *= (1.0 + 0.01 * rng.permutation(nb))[:, None, None]
    return (blocks.reshape(k, n) * 0.5).astype(np.float32)


def _base_gs(strategy):
    return min(int(v) for v in strategy["group_size"].values())


def _pair(name, n=64, seed=0):
    strategy, k = STRATEGIES[name]
    w = _weight(k, n, _base_gs(strategy), seed)
    jqt = jmb.quantize_mbwq(jnp.asarray(w), strategy)
    tqt = tmb.quantize_mbwq(torch.from_numpy(w), strategy)
    return w, jqt, tqt


def _port(jqt):
    return _mbwq(jax.tree_util.tree_map(np.asarray, jqt), "cpu")


@pytest.mark.parametrize(
    "entries,gs,cont,mid",
    [(((4, 0.25), (2, 0.75, 128)), 64, None, False), (((2, 0.5), (4, 0.5)), 32, {2: 4}, True),
     (((8, 0.25), (4, 0.5), (2, 0.25)), 128, None, False)],
)
def test_strategy_dict_matches_jax(entries, gs, cont, mid):
    assert tmb.strategy_dict(entries, gs, cont, mid) == jmb.strategy_dict(entries, gs, cont, mid)


@pytest.mark.parametrize(
    "bits,props,n_blocks,align",
    [([4, 2], [0.75, 0.25], 8, 1), ([4, 2], [0.25, 0.75], 64, 16), ([4, 2], [0.25, 0.75], 172, 4),
     ([8, 4, 2], [0.25, 0.5, 0.25], 16, 8), ([4, 2], [0.3, 0.7], 24, 1), ([4, 2], [0.5, 0.5], 4, 4)],
)
def test_segment_counts_match_jax(bits, props, n_blocks, align):
    assert tmb._segment_counts(bits, props, n_blocks, align) == jmb._segment_counts(
        bits, props, n_blocks, align)


@pytest.mark.parametrize("req,seg_k,w_bit", [(128, 192, 2), (128, 8192, 2), (64, 2816, 4),
                                             (128, 544, 4), (32, 96, 8)])
def test_fit_group_size_matches_jax(req, seg_k, w_bit):
    assert tmb._fit_group_size(req, seg_k, w_bit) == jmb._fit_group_size(req, seg_k, w_bit)


def test_fit_group_size_raises_like_jax():
    for mod in (tmb, jmb):
        with pytest.raises(ValueError, match="no valid group size"):
            mod._fit_group_size(32, 20, 2)


def _assert_same(tqt, jqt):
    np.testing.assert_array_equal(tqt.q_perm.numpy(), np.asarray(jqt.q_perm))
    np.testing.assert_array_equal(tqt.block_perm.numpy(), np.asarray(jqt.block_perm))
    assert tqt.perm_block == jqt.perm_block and tqt.bit_widths == jqt.bit_widths
    for ts, js in zip(tqt.segments, jqt.segments, strict=True):
        assert (ts.w_bit, ts.group_size, ts.code_bits, ts.zeros_mid) == (
            js.w_bit, js.group_size, js.code_bits, js.zeros_mid)
        for f in ("packed", "scales", "zeros"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_quantize_mbwq_bit_equal(name):
    _, jqt, tqt = _pair(name)
    _assert_same(tqt, jqt)
    assert tmb.average_bits(tqt) == jmb.average_bits(jqt)
    assert tmb.average_storage_bits(tqt) == jmb.average_storage_bits(jqt)


def test_bench_strategy_segments():
    """MBWQ-2.5 at K = 4096: 1024 rows w4 g64 and 3072 rows w2 g128 (24
    groups, a multiple of the A8 superblock of 4)."""
    _, _, tqt = _pair("bench_2p5")
    assert [(s.w_bit, s.group_size, s.in_features) for s in tqt.segments] == [
        (4, 64, 1024), (2, 128, 3072)]
    assert tmb.average_bits(tqt) == 2.5


def test_quantize_mbwq_fitted_group_size_warns_like_jax():
    # 9 blocks of 32 rows: 3 at w4, whose 96 rows take g96 in place of g128
    strategy = {"bits": [4, 2], "bits_prop": [0.3, 0.7], "group_size": {"4": 128, "2": 32}}
    w = _weight(288, 64, 32, seed=2)
    with pytest.warns(UserWarning, match="fitted to"):
        tqt = tmb.quantize_mbwq(torch.from_numpy(w), strategy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jqt = jmb.quantize_mbwq(jnp.asarray(w), strategy)
    _assert_same(tqt, jqt)


@pytest.mark.parametrize("name", ["w4w2_g32", "w8w4w2_g64", "mid_sym", "odd_w3"])
def test_dequantize_mbwq_bit_equal(name):
    _, jqt, tqt = _pair(name, seed=3)
    want = np.asarray(jmb.dequantize_mbwq(jqt, dtype=jnp.float32))
    np.testing.assert_array_equal(tmb.dequantize_mbwq(tqt).numpy(), want)
    np.testing.assert_array_equal(tmb.dequantize_mbwq(_port(jqt)).numpy(), want)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("strategy", [
    {"bits": [4, 2], "bits_prop": [0.25, 0.75], "group_size": {"4": 128, "2": 128}},
    S_842,
], ids=["w4w2_g128", "w8w4w2_g64"])
def test_mbwq_matmul_ref_matches_pallas(strategy, m):
    """Kernel 7's plain version (on the kernel form of the segments)
    against the JAX fused kernel in interpret mode, at the JAX kernel test's
    tolerance (its sub-byte layouts cancel a +128 code bias in f32)."""
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((1024, 256)) * 0.02).astype(np.float32)
    x = rng.standard_normal((m, 1024)).astype(np.float32)
    jqt = jmb.quantize_mbwq(jnp.asarray(w), strategy)
    xp = jnp.asarray(x)[:, jqt.q_perm]
    want = np.asarray(mbwq_matmul_pallas(xp, jqt, interpret=True))
    tqt = _port(jqt)
    tqt = tqt.replace(segments=tuple(tdm.prepare_for_kernel(s) for s in tqt.segments))
    txp = tmb.gather_activations(torch.from_numpy(x), tqt)
    np.testing.assert_array_equal(txp.numpy(), np.asarray(xp))
    got = mbwq_matmul(txp, tqt).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-4)
    # one f32 accumulator, cast once: the same sum as the per-segment f32 products
    acc = mbwq_matmul_ref(txp, tqt, torch.float32)
    np.testing.assert_allclose(acc.numpy(), x @ np.asarray(jmb.dequantize_mbwq(jqt)),
                               rtol=1e-5, atol=1e-5)


# widths at which every w2 segment's group count is a multiple of the A8
# superblock (4): 128 rows at g32, and 3072 rows at g128
FORWARD = {"w4w2_g32": (S_42, 512), "bench_2p5": (S_BENCH, 4096)}


@pytest.mark.parametrize("channel_scale", [False, True], ids=["plain", "channel_scale"])
@pytest.mark.parametrize("regime", ["a16", "a8"])
@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_matches_jax(name, regime, channel_scale):
    """``mbwq_linear`` on the CPU against the JAX package's (per-segment
    sums of its XLA paths; the A8 segments in its simulation of the A8
    kernel): f32, sums in another order (1e-5)."""
    strategy, k = FORWARD[name]
    w = _weight(k, 64, _base_gs(strategy), seed=4)
    cs = np.random.default_rng(5).uniform(0.5, 2.0, k).astype(np.float32) if channel_scale else None
    jqt = jmb.quantize_mbwq(jnp.asarray(w), strategy,
                            channel_scale=None if cs is None else jnp.asarray(cs))
    tqt = _port(jqt)
    if regime == "a8":
        jqt = jqt.replace(segments=tuple(relayout_tpu(s, act_bits=8 if s.w_bit == 2 else None)
                                         for s in jqt.segments))
        tqt = tqt.replace(segments=tuple(tdm.prepare_for_kernel(s, act_bits=8 if s.w_bit == 2 else None)
                                         for s in tqt.segments))
        assert [s.layout == "tpu_quad" for s in jqt.segments] == [False, True]
        assert [s.act_bits for s in tqt.segments] == [16, 8]
    x = np.random.default_rng(6).standard_normal((2, 3, k)).astype(np.float32)
    want = np.asarray(jmb.mbwq_linear(jnp.asarray(x), jqt))
    got = tmb.mbwq_linear(torch.from_numpy(x), tqt).numpy()
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_block_gather_matches_row_gather():
    """The block gather by ``block_perm`` is the row gather by ``q_perm``,
    bit for bit, and the JAX package's."""
    _, jqt, tqt = _pair("w4w2_g32", seed=7)
    assert tqt.perm_block == 32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32))
    by_block = tmb.gather_activations(x, tqt)
    assert torch.equal(by_block, tmb.gather_activations(x, tqt.replace(perm_block=0)))
    assert torch.equal(by_block, tmb.gather_activations(x, tqt.replace(block_perm=None)))
    np.testing.assert_array_equal(by_block.numpy(), x.numpy()[:, np.asarray(jqt.q_perm)])
    assert torch.equal(tmb.mbwq_linear(x, tqt), tmb.mbwq_linear(x, tqt.replace(perm_block=0)))


def test_mbwq_linear_layer():
    """The layer quantizes a seeded Kaiming weight on the CPU, keeps its
    segments in MPQLinear buffers, slices a padded output, and its forward
    is ``mbwq_linear`` in the layer dtype."""
    gen = torch.Generator().manual_seed(0)
    layer = MBWQLinear(256, 96, strategy=S_42, use_channel_scale=True, dtype=torch.float32,
                       device="cpu", generator=gen, out_slice=80)
    qt = layer.qweight
    assert qt.bit_widths == (4, 2) and qt.logical_shape == (256, 96)
    assert torch.equal(qt.channel_scale, torch.ones(256))
    names = set(dict(layer.named_buffers()))
    assert {"q_perm", "channel_scale", "block_perm", "segments.0.packed", "segments.1.scales"} <= names
    x = torch.randn(3, 256, generator=gen)
    out = layer(x)
    assert out.shape == (3, 80)
    torch.testing.assert_close(out, tmb.mbwq_linear(x, qt)[:, :80], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        mbwq_matmul(torch.empty((2, 256), device="meta"), qt)


def test_backward_is_a_later_slice():
    """The backward has landed with the training slice: an input that needs
    a gradient gets ``g @ (dequant · channel_scale)ᵀ`` (its parity with the
    JAX package is in test_torch_mpq_linear_grad.py); under ``no_grad`` or
    without a gradient the forward is unchanged."""
    _, _, tqt = _pair("w4w2_g32", seed=8)
    x = torch.randn(2, 256, requires_grad=True)
    out = tmb.mbwq_linear(x, tqt)
    g = torch.randn(2, 64)
    out.backward(g)
    torch.testing.assert_close(x.grad, g @ tmb.dequantize_mbwq(tqt).T, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(tmb.mbwq_linear(x, tqt), out.detach())
    assert tmb.mbwq_linear(x.detach(), tqt).shape == (2, 64)
