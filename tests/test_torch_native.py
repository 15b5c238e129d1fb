"""The port's host bitpack library (``native/``) against the JAX package's
packing ops and the port's torch packing ops, bit for bit (as JAX
``tests/test_native.py`` holds the JAX library), and its build-failure
path: the entry points raise with the compiler's error."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)

from bitorch_engine_tpu.ops import packing as jpack
from bitorch_engine_tpu_torch import native
from bitorch_engine_tpu_torch.ops import packing as tpack

BITS = [2, 4, 8]


def test_library_builds_here():
    assert native.available()
    assert native.lib_path().exists()


@pytest.mark.parametrize("w_bit", BITS)
def test_repack_matches_jax(w_bit):
    rng = np.random.default_rng(0)
    k, n, gs = 256, 64, 64
    codes = rng.integers(0, 2**w_bit, (k, n), dtype=np.int64).astype(np.int32)
    gptq = np.asarray(jpack.pack_rows(jnp.asarray(codes), w_bit))
    expected = np.asarray(jpack.pack_rows_tpu_tiled(jnp.asarray(codes), w_bit, gs))
    got = native.repack_gptq_to_tpu_tiled(gptq, w_bit, gs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, expected)
    # the port reads the tiled words back to the same codes
    np.testing.assert_array_equal(
        tpack.unpack_rows_tpu_tiled(torch.from_numpy(got), w_bit, gs).numpy(), codes)


@pytest.mark.parametrize("w_bit", BITS)
def test_pack_unpack_match_jax_and_torch(w_bit):
    rng = np.random.default_rng(1)
    k, n = 128, 96
    codes = rng.integers(0, 2**w_bit, (k, n), dtype=np.int64).astype(np.uint8)
    packed = native.pack_gptq_codes(codes, w_bit)
    assert packed.dtype == np.int32 and packed.shape == (k * w_bit // 32, n)
    np.testing.assert_array_equal(
        packed, np.asarray(jpack.pack_rows(jnp.asarray(codes, jnp.int32), w_bit)))
    np.testing.assert_array_equal(
        packed, tpack.pack_rows(torch.from_numpy(codes.astype(np.int32)), w_bit).numpy())
    unpacked = native.unpack_gptq_codes(packed, w_bit)
    assert unpacked.dtype == np.uint8
    np.testing.assert_array_equal(unpacked, codes)
    np.testing.assert_array_equal(
        unpacked, tpack.unpack_rows(torch.from_numpy(packed), w_bit).numpy())


@pytest.mark.parametrize("w_bit", BITS)
def test_pack_signs_matches_jax_and_torch(w_bit):
    """Signs of (w_bit-seeded) rows with exact zeros and negative zeros
    (bit set iff x >= 0)."""
    rng = np.random.default_rng(2 + w_bit)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    x[0, :8] = 0.0
    x[1, :8] = -0.0
    got = native.pack_signs(x)
    assert got.dtype == np.uint32 and got.shape == (16, 4)
    np.testing.assert_array_equal(got, np.asarray(jpack.pack_signs(jnp.asarray(x))))
    np.testing.assert_array_equal(got.view(np.int32),
                                  tpack.pack_signs(torch.from_numpy(x)).numpy())


def test_ragged_inputs_raise():
    with pytest.raises(ValueError, match="multiple of 8"):
        native.pack_gptq_codes(np.zeros((12, 4), np.uint8), 4)
    with pytest.raises(ValueError, match="w_bit=3 unsupported"):
        native.unpack_gptq_codes(np.zeros((4, 4), np.int32), 3)
    with pytest.raises(ValueError, match="group"):
        native.repack_gptq_to_tpu_tiled(np.zeros((4, 4), np.int32), 8, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        native.pack_signs(np.zeros((2, 40), np.float32))


def test_build_failure_raises():
    """With the compiler pointed at a missing binary the library cannot be
    built: ``available()`` is False and every entry point raises with the
    cause (the JAX package returns None instead)."""
    code = """
import numpy as np
from bitorch_engine_tpu_torch import native
native.CXX = "/nonexistent/bin/g++"
assert not native.lib_path().exists()
assert native.available() is False
for call in (lambda: native.pack_signs(np.zeros((1, 32), np.float32)),
             lambda: native.unpack_gptq_codes(np.zeros((1, 4), np.int32), 4)):
    try:
        call()
    except RuntimeError as e:
        assert "bitpack build failed" in str(e) and "/nonexistent/bin/g++" in str(e), e
    else:
        raise AssertionError("no RuntimeError")
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
