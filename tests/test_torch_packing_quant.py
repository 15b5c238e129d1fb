"""The port's packing and MPQ quantization against the JAX package.

Both sides do the same integer and float32 operations in the same order,
so everything here is held bit-exact.  Inputs come from numpy with a seed
and are fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import packing as jpk
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.ops import quant as tq
from bitorch_engine_tpu_torch.utils.convert import _mpq


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(jqt):
    """A JAX MPQTensor carried into the port, as load_jax_params does."""
    return _mpq(jax.tree_util.tree_map(np.asarray, jqt), "cpu")


@pytest.mark.parametrize("w_bit", [1, 2, 4, 8])
def test_pack_unpack_rows_cols_bit_exact(w_bit):
    rng = np.random.default_rng(w_bit)
    q = rng.integers(0, 2**w_bit, (256, 64), dtype=np.int32)
    jp = np.asarray(jpk.pack_rows(jnp.asarray(q), w_bit))
    np.testing.assert_array_equal(tpk.pack_rows(_t(q), w_bit).numpy(), jp)
    np.testing.assert_array_equal(tpk.unpack_rows(_t(jp), w_bit).numpy(), q)

    z = rng.integers(1, 2**w_bit + 1, (4, 64), dtype=np.int32)
    jz = np.asarray(jpk.pack_cols(jnp.asarray(z), w_bit))
    np.testing.assert_array_equal(tpk.pack_cols(_t(z), w_bit).numpy(), jz)
    np.testing.assert_array_equal(tpk.unpack_cols(_t(jz), w_bit).numpy(), z)


@pytest.mark.parametrize(
    "layout,w_bit",
    [("tpu_tiled", b) for b in (1, 2, 4, 8)]
    + [("tpu_pair", b) for b in (1, 2, 4)]
    + [("tpu_quad", b) for b in (1, 2, 4)],
)
def test_unpack_rows_layout_reads_tpu_layouts(layout, w_bit):
    """Words packed by the JAX package in a TPU layout unpack to the same codes."""
    gs = 128
    rng = np.random.default_rng(10 + w_bit)
    q = rng.integers(0, 2**w_bit, (1024, 32), dtype=np.int32)
    packed = np.asarray(jpk.pack_rows_layout(jnp.asarray(q), w_bit, gs, layout))
    got = tpk.unpack_rows_layout(_t(packed), w_bit, gs, layout).numpy()
    np.testing.assert_array_equal(got, q)


@pytest.mark.parametrize(
    "w_bit,kw",
    [
        (4, dict()),
        (4, dict(asym=True)),
        (4, dict(mid_sym=True)),
        (4, dict(code_bits=3)),
        (2, dict()),
        (8, dict(asym=True)),
    ],
    ids=["sym", "asym", "mid_sym", "code_bits3", "w2_sym", "w8_asym"],
)
def test_quantize_mpq_bit_exact(w_bit, kw):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 96)) * 0.05).astype(np.float32)
    jqt = jq.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=64, **kw)
    tqt = tq.quantize_mpq(_t(w), w_bit=w_bit, group_size=64, **kw)
    for field in ("packed", "scales", "zeros"):
        np.testing.assert_array_equal(
            getattr(tqt, field).numpy(), np.asarray(getattr(jqt, field)), err_msg=field
        )
    assert (tqt.asym, tqt.code_bits, tqt.zeros_mid) == (jqt.asym, jqt.code_bits, jqt.zeros_mid)


def _style(style):
    rng = np.random.default_rng(4)
    k, n, gs = 256, 64, 64
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jqt = jq.quantize_mpq(jnp.asarray(w), w_bit=4, group_size=gs, asym=style == "asym")
    if style == "g_idx":
        g_idx = rng.integers(0, k // gs, k).astype(np.int32)
        jqt = jqt.replace(g_idx=jnp.asarray(g_idx))
    if style == "q_perm":
        jqt = jqt.replace(q_perm=jnp.asarray(rng.permutation(k).astype(np.int32)))
    return jqt


@pytest.mark.parametrize("style", ["asym", "g_idx", "q_perm"])
def test_dequantize_mpq_three_styles_bit_exact(style):
    jqt = _style(style)
    want = np.asarray(jq.dequantize_mpq(jqt, dtype=jnp.float32))
    got = tq.dequantize_mpq(_port(jqt), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_concat_and_slice_mpq():
    rng = np.random.default_rng(5)
    parts_np = [(rng.standard_normal((128, n)) * 0.05).astype(np.float32) for n in (64, 32, 32)]
    jparts = [jq.quantize_mpq(jnp.asarray(p), w_bit=4, group_size=64) for p in parts_np]
    tparts = [tq.quantize_mpq(_t(p), w_bit=4, group_size=64) for p in parts_np]
    jcat = jq.concat_mpq(tuple(jparts))
    tcat = tq.concat_mpq(tparts)
    for field in ("packed", "scales", "zeros"):
        np.testing.assert_array_equal(getattr(tcat, field).numpy(), np.asarray(getattr(jcat, field)))
    back = tq.slice_mpq_n(tcat, 64, 32)
    np.testing.assert_array_equal(back.packed.numpy(), tparts[1].packed.numpy())
    np.testing.assert_array_equal(back.scales.numpy(), tparts[1].scales.numpy())
    with pytest.raises(ValueError):
        tq.concat_mpq([tparts[0], tparts[1].replace(w_bit=2)])
