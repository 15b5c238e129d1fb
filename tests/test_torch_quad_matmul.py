"""Kernel 5 of the port (the A8 dequant-matmul) on the CPU: its plain version
against the JAX package's ``tpu_quad`` Pallas kernel in interpret mode on the
same int8 activations; the A8 ``mpq_linear`` against the JAX package's CPU
simulation; ``prepare_for_kernel``'s A8 regime decisions against
``relayout_tpu``'s; the kernel's dot order emulated word by word.  The CUDA
kernel itself runs only on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import mpq_linear as jlin
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.pallas.dequant_matmul import _mpq_matmul_call, relayout_tpu
from bitorch_engine_tpu_torch.ops import mpq_linear as tlin
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.ops.cuda import quad_matmul as tqm
from bitorch_engine_tpu_torch.ops.quant import dequantize_mpq
from bitorch_engine_tpu_torch.utils.convert import _mpq

K, N = 1024, 256


def _port(jqt):
    return _mpq(jax.tree_util.tree_map(np.asarray, jqt), "cpu")


def _weight(w_bit, gs, mid=False, k=K, n=N, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    return jq.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=gs, mid_sym=mid)


def _x(m, k=K, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(dtype)


@jax.jit
def _jax_qx(x):
    """The per-token quantization of ``mpq_matmul_pallas`` (``:744-747``)
    under jit, as its callers run it: XLA folds ``/ 127.0`` into a multiply
    by the f32 reciprocal, which the port follows."""
    xf = jnp.asarray(x, jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
    return jnp.round(xf / sx), sx


@pytest.mark.parametrize("mid", [False, True], ids=["affine", "mid_sym"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("w_bit,gs", [(1, 32), (1, 128), (2, 32), (2, 64), (2, 128), (4, 64), (4, 128)])
def test_a8_accumulator_matches_pallas_quad(w_bit, gs, m, mid):
    """The f32 accumulator before ``sx`` and the cast: the plain version
    against the JAX ``tpu_quad`` kernel on the same int8 activations (the
    port quantizes them bit-equal to the JAX package); both dot integers
    exactly, so they differ by f32 summation order only (1e-5 of the
    largest value)."""
    jqt8 = relayout_tpu(_weight(w_bit, gs, mid), act_bits=8)
    assert jqt8.layout == "tpu_quad" and jqt8.zeros_mid == mid
    x = _x(m, seed=m)
    jqx, jsx = _jax_qx(x)
    want = np.asarray(_mpq_matmul_call(
        jqx.astype(jnp.int8), jqt8.packed, jqt8.scales, jqt8.zeros, w_bit=w_bit,
        group_size=gs, layout="tpu_quad", out_dtype=jnp.float32, interpret=True,
        mid_codes=2 ** (w_bit - 1) if mid else 0,
    ))
    qt = tdm.prepare_for_kernel(_port(jqt8))
    assert qt.act_bits == 8 and qt.layout == "gptq" and qt.zeros_mid == mid
    tqx, tsx = tqm.quantize_activations_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    got = tqm.mpq_matmul_a8(torch.from_numpy(x), qt, accumulator=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bit,mid,m", [(2, False, 4), (2, True, 8), (4, False, 1), (1, False, 8)])
def test_mpq_linear_a8_cpu_matches_jax(w_bit, mid, m, dtype):
    """The A8 ``mpq_linear`` on the CPU against the JAX package's (its XLA
    simulation of the A8 kernel): an f32 product summed in another order,
    so f32 outputs agree to 1e-5 and bf16 outputs bit for bit but for at
    most one bf16 ulp.  (Called eagerly, the JAX package divides by 127
    where the port, like its jitted callers, multiplies by the reciprocal:
    an ``sx`` one f32 ulp apart in a few rows, well inside both bars.)"""
    jqt8 = relayout_tpu(_weight(w_bit, 64, mid, seed=w_bit), act_bits=8)
    x = _x(m, seed=10 + m)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jlin.mpq_linear(jx, jqt8).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    for qt in (_port(jqt8), tdm.prepare_for_kernel(_port(jqt8))):  # tpu_quad as loaded, and gptq
        got = tlin.mpq_linear(tx, qt)
        assert got.dtype == tx.dtype
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        else:
            ulp = np.abs(np.asarray(jnp.asarray(want, jnp.bfloat16)).view(np.int16).astype(np.int32)
                         - torch.from_numpy(got).to(torch.bfloat16).view(torch.int16).numpy())
            assert ulp.max() <= 1, ulp.max()


@pytest.mark.parametrize(
    "w_bit,gs,k,mid,detect,a8",
    [
        (2, 64, 1024, False, False, True),    # 16 groups: A8
        (2, 128, 768, False, False, False),   # 6 groups, not a multiple of 4: A16
        (1, 32, 1024, False, False, True),    # 32 groups, superblock 8
        (1, 128, 512, False, False, False),   # 4 groups < 8: A16
        (4, 64, 1024, False, False, True),
        (8, 64, 1024, False, False, False),   # 8-bit: the A16 (tiled) kernel
        (2, 128, 1024, True, False, True),    # mid_sym: zeros_mid kept
        (2, 128, 1024, True, True, True),     # zeros == mid * scales, flag dropped: detected
        (4, 128, 1024, True, True, True),
    ],
)
def test_prepare_for_kernel_a8_regime_matches_relayout_tpu(w_bit, gs, k, mid, detect, a8):
    jqt = _weight(w_bit, gs, mid, k=k, seed=3)
    if detect:
        jqt = jqt.replace(zeros_mid=False)  # a tensor that predates the flag
    jrl = relayout_tpu(jqt, meta_dtype=jnp.bfloat16, act_bits=8)
    trl = tdm.prepare_for_kernel(_port(jqt), torch.bfloat16, act_bits=8)
    assert (jrl.layout == "tpu_quad") == a8
    assert trl.act_bits == (8 if a8 else 16) and trl.layout == "gptq"
    assert trl.zeros_mid == jrl.zeros_mid == (mid and (a8 or not detect))
    bits = lambda t: t.view(torch.int16).numpy()  # noqa: E731
    np.testing.assert_array_equal(bits(trl.scales), np.asarray(jrl.scales).view(np.int16))
    np.testing.assert_array_equal(bits(trl.zeros), np.asarray(jrl.zeros).view(np.int16))
    # flipping back to A16 keeps the codes and the metadata
    back = tdm.prepare_for_kernel(trl, act_bits=16)
    assert back.act_bits == 16 and torch.equal(back.packed, trl.packed)


def test_affine_zeros_are_not_detected_as_mid():
    jqt = _weight(2, 128)
    assert not relayout_tpu(jqt, act_bits=8).zeros_mid
    assert not tdm.prepare_for_kernel(_port(jqt), act_bits=8).zeros_mid


@pytest.mark.parametrize("w_bit,gs", [(1, 32), (2, 64), (4, 128)])
def test_tpu_quad_tensor_from_jax_dequantizes_bit_equal(w_bit, gs):
    """A ``tpu_quad`` tensor relayouted by the JAX package loads, and
    dequantizes bit-equal to it as loaded and after the port's gptq
    repack."""
    jqt8 = relayout_tpu(_weight(w_bit, gs, seed=5), act_bits=8)
    want = np.asarray(jq.dequantize_mpq(jqt8, dtype=jnp.float32))
    loaded = _port(jqt8)
    assert loaded.layout == "tpu_quad" and loaded.act_bits == 8
    np.testing.assert_array_equal(dequantize_mpq(loaded, torch.float32).numpy(), want)
    prepared = tdm.prepare_for_kernel(loaded)
    np.testing.assert_array_equal(tdm.dequant_mpq_ref(prepared, torch.float32).numpy(), want)


def test_check_weight_takes_a8_tensors_for_kernel_2():
    """Prefill reconstructs A8 weights: kernel 2's check takes a prepared A8
    tensor, kernel 1's refuses it and kernel 5's refuses an A16 one."""
    qt = tdm.prepare_for_kernel(_port(_weight(2, 64)), torch.bfloat16, act_bits=8)
    assert qt.act_bits == 8
    cpu = torch.device("cpu")
    tdm._check_weight(qt, cpu, act_bits=(16, 8))
    tdm._check_weight(qt, cpu, act_bits=(8,))
    with pytest.raises(ValueError, match="act_bits"):
        tdm._check_weight(qt, cpu)
    with pytest.raises(ValueError, match="act_bits"):
        tdm._check_weight(qt.replace(act_bits=16), cpu, act_bits=(8,))
    with pytest.raises(ValueError, match="prepare_for_kernel"):
        tdm._check_weight(_port(relayout_tpu(_weight(2, 64), act_bits=8)), cpu, act_bits=(8,))


def _emulate_kernel(x, qt, accumulator=True):
    """``csrc/quad_matmul.cu`` step by step in numpy: the quantization's
    scatter into the dot order, then per packed row r and shift t the
    dp4a of activation word t with the shifted, masked code word, the
    per-group int32 sums and the f32 group correction."""
    w_bit, gs = qt.w_bit, qt.group_size
    ppw, s_ = 32 // w_bit, 8 // w_bit
    qx, sx = tqm.quantize_activations_ref(torch.from_numpy(x))
    qx = qx.numpy().astype(np.int64)
    m, k = qx.shape
    order = np.empty_like(qx)
    for kk in range(k):  # qr[r * PPW + 4 * (j % S) + j / S] = q(k)
        r, j = divmod(kk, ppw)
        order[:, r * ppw + 4 * (j % s_) + j // s_] = qx[:, kk]
    assert np.array_equal(order, tqm.kernel_order(torch.from_numpy(qx), w_bit).numpy())
    words = qt.packed.numpy().astype(np.int64) & 0xFFFFFFFF
    mask = ((1 << w_bit) - 1) * 0x01010101
    scales, zeros = qt.scales.float().numpy(), qt.zeros.float().numpy()
    mid = tqm._mid(qt)
    acc = np.zeros((m, words.shape[1]), np.float32)
    for g in range(k // gs):
        dot = np.zeros((m, words.shape[1]), np.int64)
        xs = np.zeros((m, 1), np.int64)
        for r in range(g * gs // ppw, (g + 1) * gs // ppw):
            for t in range(s_):
                a = order[:, r * ppw + 4 * t : r * ppw + 4 * t + 4]  # activation word t
                code = (words[r] >> (t * w_bit)) & mask
                xs += a.sum(axis=1, keepdims=True)
                for b in range(4):
                    dot += a[:, b : b + 1] * ((code >> (8 * b)) & 0xFF)[None, :]
        if mid:
            acc += (dot - mid * xs).astype(np.float32) * scales[g]
        else:
            acc += dot.astype(np.float32) * scales[g] - xs.astype(np.float32) * zeros[g]
    return acc if accumulator else acc * sx.numpy()


@pytest.mark.parametrize("w_bit,mid", [(1, False), (2, False), (2, True), (4, False), (4, True)])
def test_kernel_dot_order_emulated(w_bit, mid):
    """The CUDA kernel's index arithmetic, emulated on the CPU, gives the
    plain version's accumulator (to f32 order)."""
    qt = tdm.prepare_for_kernel(_port(_weight(w_bit, 32, mid, k=256, n=8, seed=7)), act_bits=8)
    assert qt.act_bits == 8
    x = _x(3, k=256, seed=8)
    got = _emulate_kernel(x, qt)
    want = tqm.mpq_matmul_a8_ref(torch.from_numpy(x), qt, accumulator=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_a8_kernel_wrapper_runs_plain_only_on_cpu():
    qt = tdm.prepare_for_kernel(_port(_weight(2, 64)), act_bits=8)
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.mpq_matmul_a8(torch.empty((2, K), device="meta"), qt)
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.quantize_activations(torch.zeros(2, K), 2)


def test_nan_activations_poison_the_a8_output():
    """A NaN in a row (the model's window-violation poison) gives NaN
    outputs in that row, as the JAX simulation does."""
    qt = tdm.prepare_for_kernel(_port(_weight(2, 64)), act_bits=8)
    x = torch.from_numpy(_x(2))
    x[1, 5] = float("nan")
    out = tlin.mpq_linear(x, qt)
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()
    assert tpk.QUAD_BITS == (1, 2, 4)
