"""Kernels 1 and 2 of the port, through their plain versions, against the
JAX package's Pallas kernels in interpret mode; the kernel form
(``prepare_for_kernel``) against ``relayout_tpu``; the MPQ linear on the
CPU against the JAX package's.  The CUDA kernels themselves run only on the
card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import mpq_linear as jlin
from bitorch_engine_tpu.ops import packing as jpk
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.pallas.dequant_matmul import (
    dequant_mpq_pallas,
    mpq_matmul_pallas,
    relayout_tpu,
)
from bitorch_engine_tpu_torch.ops import mpq_linear as tlin
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.ops.cuda import _build
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.utils.convert import _mpq


def _port(jqt):
    return _mpq(jax.tree_util.tree_map(np.asarray, jqt), "cpu")


def _mk(m, k, n, gs, w_bit, asym=False, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, jq.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=gs, asym=asym)


def _bf16_bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize(
    "w_bit,asym,meta",
    [(4, True, jnp.bfloat16), (2, False, jnp.bfloat16), (8, True, None), (4, False, None)],
)
def test_prepare_for_kernel_matches_relayout_tpu(w_bit, asym, meta):
    """Same asym→sym zeros and metadata cast, bit for bit; the codes are the
    same values in the port's gptq order."""
    _, jqt = _mk(1, 256, 64, 64, w_bit, asym=asym)
    jrl = relayout_tpu(jqt, meta_dtype=meta)
    trl = tdm.prepare_for_kernel(_port(jqt), None if meta is None else torch.bfloat16)
    assert not trl.asym and trl.layout == "gptq"
    if meta is None:
        np.testing.assert_array_equal(trl.scales.numpy(), np.asarray(jrl.scales))
        np.testing.assert_array_equal(trl.zeros.numpy(), np.asarray(jrl.zeros))
    else:
        np.testing.assert_array_equal(_bf16_bits(trl.scales.view(torch.uint16)), _bf16_bits(jrl.scales))
        np.testing.assert_array_equal(_bf16_bits(trl.zeros.view(torch.uint16)), _bf16_bits(jrl.zeros))
    codes = np.asarray(jpk.unpack_rows_layout(jrl.packed, w_bit, 64, jrl.layout))
    np.testing.assert_array_equal(tpk.unpack_rows(trl.packed, w_bit).numpy(), codes)


@pytest.mark.parametrize("w_bit", [1, 2, 4, 8])
def test_mpq_matmul_ref_matches_pallas(w_bit):
    """f32, the JAX kernel test's tolerance: the sub-byte Pallas layouts
    cancel a +128 code bias through the zeros term, which rounds in f32."""
    x, jqt = _mk(8, 512, 256, 128, w_bit)
    want = np.asarray(mpq_matmul_pallas(jnp.asarray(x), jqt, interpret=True))
    got = tdm.mpq_matmul_ref(torch.from_numpy(x), tdm.prepare_for_kernel(_port(jqt))).numpy()
    tol = dict(rtol=2e-3, atol=5e-4) if w_bit in (1, 2, 4) else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("w_bit,gs", [(4, 128), (2, 64), (8, 64)])
def test_dequant_ref_bit_equal_to_pallas(w_bit, gs):
    """bf16 output of the plain version equals the Pallas dequant kernel's
    (bf16 metadata, as on the serving path)."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    jqt = relayout_tpu(jq.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=gs),
                       meta_dtype=jnp.bfloat16)
    want = dequant_mpq_pallas(jqt, dtype=jnp.bfloat16, interpret=True)
    got = tdm.dequant_mpq_ref(tdm.prepare_for_kernel(_port(jqt)), torch.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(got.view(torch.uint16)), _bf16_bits(want))


@pytest.mark.parametrize("m", [4, 600])
def test_mpq_linear_cpu_matches_jax(m):
    """Both regimes' CPU path: dequantize to x.dtype, f32 product (sums in
    another order: 1e-5)."""
    x, jqt = _mk(m, 256, 128, 64, 4, asym=True, seed=m)
    want = np.asarray(jlin.mpq_linear(jnp.asarray(x), jqt))
    got = tlin.mpq_linear(torch.from_numpy(x), _port(jqt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_wrappers_run_plain_only_on_cpu():
    """A tensor on another device never reaches the plain version."""
    _, jqt = _mk(1, 256, 64, 64, 4)
    qt = tdm.prepare_for_kernel(_port(jqt))
    meta = torch.empty((2, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdm.mpq_matmul(meta, qt)
    with pytest.raises(ValueError, match="unsupported device"):
        tdm.dequant_mpq(qt.to("meta"))


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """Asking for a kernel where the CUDA toolkit is missing raises; there is
    no silent plain fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("dequant_matmul")


def test_act_bits_8_is_a_later_slice():
    """The sub-4-bit slice brought the A8 regime: an ``act_bits=8`` tensor
    is prepared in that regime and its linear runs the JAX package's A8
    simulation on the CPU (its parity is in test_torch_quad_matmul.py)."""
    from bitorch_engine_tpu_torch.ops.cuda.quad_matmul import mpq_matmul_a8_ref

    x, jqt = _mk(2, 256, 64, 64, 4)
    qt = _port(jqt).replace(act_bits=8)
    prepared = tdm.prepare_for_kernel(qt)
    assert prepared.act_bits == 8 and prepared.layout == "gptq"
    xt = torch.from_numpy(x)
    torch.testing.assert_close(tlin.mpq_linear(xt, qt), mpq_matmul_a8_ref(xt, qt), rtol=0, atol=0)
    with pytest.raises(ValueError, match="act_bits must be 8 or 16"):
        tdm.prepare_for_kernel(qt, act_bits=4)
