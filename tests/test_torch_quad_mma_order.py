"""Kernel 5's tensor-core body (``csrc/quad_matmul.cu`` ``quad_mma_kernel``)
modelled in numpy on the CPU: the lane -> fragment maps of
``mma.m16n8k32.u8.s8.s32`` (A the shifted, masked code words of 16 output
columns, B the activation words of 8 rows in the kernel's dot order, Σx
from an all-ones A), the chunks of ``chunk_words`` packed rows, the warps'
equal K runs that cut groups into pieces, the present kernel's f32 group
terms at each piece's end, and the warps' partials summed in warp order.
The model must give the plain per-group integer dots exactly, and the plain
accumulator (``mpq_matmul_a8_ref``) exactly where every f32 term and sum is
exact (dyadic metadata), and the JAX package's ``tpu_quad`` Pallas kernel
(interpret mode) on the same codes within f32 summation order.  The CUDA
kernel runs only on the card (``chip_smoke.py`` phase 8a).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.pallas.dequant_matmul import _mpq_matmul_call, relayout_tpu
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.ops.cuda import quad_matmul as tqm
from bitorch_engine_tpu_torch.ops.quant import quantize_mpq
from bitorch_engine_tpu_torch.utils.convert import _mpq

BN = 32  # output columns a block
K = 768
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4  # a lane's group and thread in group


def _s8(word, b):
    return ((word >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)


def _mma(a, b0, b1):
    """``mma.m16n8k32.row.col.s32.u8.s8.s32`` from the 32 lanes' registers:
    ``a`` (4, 32) uint32, ``b0`` / ``b1`` (32,) uint32; returns the four D
    registers (4, 32) as the lanes hold them."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for b in range(4):
        A[G, 4 * T + b] = (a[0] >> (8 * b)) & 0xFF        # row g, k 4t..
        A[G + 8, 4 * T + b] = (a[1] >> (8 * b)) & 0xFF    # row g + 8
        A[G, 16 + 4 * T + b] = (a[2] >> (8 * b)) & 0xFF   # row g, k 16 + 4t..
        A[G + 8, 16 + 4 * T + b] = (a[3] >> (8 * b)) & 0xFF
        B[4 * T + b, G] = _s8(b0, b)                      # column g
        B[16 + 4 * T + b, G] = _s8(b1, b)
    d = A @ B
    return np.stack([d[G, 2 * T], d[G, 2 * T + 1], d[G + 8, 2 * T], d[G + 8, 2 * T + 1]])


def mma_body(qxo, words, scales, zeros, mid, w_bit, gs):
    """The tensor-core body on int8 activations ``qxo`` (m, K) in the dot
    order and gptq words (K / ppw, N), blocks of 32 columns and
    ``mma_row_tiles`` n8 tiles: the f32 accumulator (m, N) before ``sx``,
    and the int32 dots per group (groups, m, N) summed over pieces."""
    m, k = qxo.shape
    n = words.shape[1]
    ppw, s_ = 32 // w_bit, 8 // w_bit
    c = tqm.chunk_words(w_bit, gs)
    ck, ns, tpw = c * ppw, c * s_ // 8, 4 // c
    mt_n, nw = tqm.mma_row_tiles(m), tqm.MMA_WARPS
    n_chunks, cpg = k // ck, gs // ck
    mask = np.uint64(((1 << w_bit) - 1) * 0x01010101)
    widx, sb = T // tpw, (T % tpw) * 2 * ns
    ones = np.full((4, 32), 0x01010101, np.uint64)
    out = np.zeros((m, n), np.float32)
    dots = np.zeros((k // gs, m, n), np.int64)
    for n0 in range(0, n, BN):
        cols = n0 + 4 * G  # the lane's 4 columns cols .. cols + 3
        col_ok = cols < n  # columns past N: read as 0, never stored
        cc = np.minimum(cols, n - 4)[:, None] + np.arange(4)  # (32, 4)
        for m0 in range(0, m, 8 * mt_n):
            part = np.zeros((nw, 8 * mt_n, BN), np.float32)
            for w in range(nw):
                c_lo, c_hi = w * n_chunks // nw, (w + 1) * n_chunks // nw
                acc = np.zeros((2, mt_n, 4, 32), np.float32)
                dot = np.zeros((2, mt_n, 4, 32), np.int64)
                xs = np.zeros((mt_n, 4, 32), np.int64)
                for i in range(c_lo, c_hi):
                    r = i * c + widx
                    wv = np.where(col_ok[:, None], words[r[:, None], cc], 0).astype(np.uint64)
                    xw = []
                    for mt in range(mt_n):
                        row = np.minimum(m0 + mt * 8 + G, m - 1)
                        at = i * ck + widx * ppw + 4 * sb
                        xb = qxo[row[:, None], at[:, None] + np.arange(8 * ns)]  # (32, 8 ns) int8
                        xw.append(np.ascontiguousarray(xb).view(np.uint32).astype(np.uint64))
                    for j in range(ns):
                        lo = ((sb + 2 * j) * w_bit).astype(np.uint64)
                        hi = lo + np.uint64(w_bit)
                        for mt in range(mt_n):
                            xs[mt] += _mma(ones, xw[mt][:, 2 * j], xw[mt][:, 2 * j + 1])
                        for h in range(2):
                            w0, w1 = wv[:, 2 * h], wv[:, 2 * h + 1]
                            a = np.stack([(w0 >> lo) & mask, (w1 >> lo) & mask,
                                          (w0 >> hi) & mask, (w1 >> hi) & mask])
                            for mt in range(mt_n):
                                dot[h, mt] += _mma(a, xw[mt][:, 2 * j], xw[mt][:, 2 * j + 1])
                    if (i + 1) % cpg == 0 or i + 1 == c_hi:  # the group piece ends
                        gi = i // cpg
                        s4, z4 = scales[gi, cc], zeros[gi, cc]  # (32, 4)
                        for h in range(2):
                            for mt in range(mt_n):
                                for rr in range(4):
                                    d, x = dot[h, mt, rr], xs[mt, rr & 1]
                                    ci = 2 * h + (rr >> 1)
                                    if mid:
                                        term = (d - mid * x).astype(np.float32) * s4[:, ci]
                                    else:
                                        term = (d.astype(np.float32) * s4[:, ci]
                                                - x.astype(np.float32) * z4[:, ci])
                                    acc[h, mt, rr] = acc[h, mt, rr] + term
                                    row = m0 + mt * 8 + 2 * T + (rr & 1)
                                    ok = (row < m) & col_ok
                                    dots[gi, row[ok], cols[ok] + ci] += d[ok]
                        dot[:] = 0
                        xs[:] = 0
                for h in range(2):
                    for mt in range(mt_n):
                        for rr in range(4):
                            part[w, mt * 8 + 2 * T + (rr & 1), 4 * G + 2 * h + (rr >> 1)] = acc[h, mt, rr]
            tile = np.zeros((8 * mt_n, BN), np.float32)
            for w in range(nw):  # warp order
                tile = tile + part[w]
            rows, cn = min(8 * mt_n, m - m0), min(BN, n - n0)
            out[m0 : m0 + rows, n0 : n0 + cn] = tile[:rows, :cn]
    return out, dots


def _dyadic_weight(w_bit, gs, mid, n, seed):
    """A kernel-form A8 tensor whose bf16 scales are powers of 2 and whose
    zeros are small multiples of them, so every f32 term and sum of both
    the kernel's order and the plain product is exact."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, n)) * 0.02).astype(np.float32))
    qt = tdm.prepare_for_kernel(quantize_mpq(w, w_bit=w_bit, group_size=gs, mid_sym=mid),
                                torch.bfloat16, act_bits=8)
    scales = torch.from_numpy(2.0 ** -rng.integers(6, 10, qt.scales.shape)).float()
    if mid:
        zeros = scales * float(2 ** (w_bit - 1))
    else:
        zeros = scales * torch.from_numpy(rng.integers(0, 2 ** w_bit, qt.scales.shape)).float()
    return qt.replace(scales=scales.to(torch.bfloat16), zeros=zeros.to(torch.bfloat16),
                      zeros_mid=mid)


@pytest.mark.parametrize("m", [1, 8, 13])  # 13: two row tiles, the second partial
@pytest.mark.parametrize("w_bit,gs,mid", [
    (1, 32, False), (1, 64, False), (1, 128, False),
    (2, 32, False), (2, 64, True), (2, 128, False), (2, 128, True),
    (4, 32, True), (4, 64, False), (4, 128, False),
])
def test_mma_body_matches_plain(w_bit, gs, mid, m):
    n = 164  # a ragged last block at every width
    qt = _dyadic_weight(w_bit, gs, mid, n, seed=w_bit * 100 + gs + mid)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, K)).astype(np.float32))
    qx, _ = tqm.quantize_activations_ref(x)
    qxo = tqm.kernel_order(qx, w_bit).numpy().astype(np.int8)
    words = qt.packed.numpy().view(np.uint32)
    got, dots = mma_body(qxo, words, qt.scales.float().numpy(), qt.zeros.float().numpy(),
                         tqm._mid(qt), w_bit, gs)
    # the per-group integer dots, exactly
    ppw = 32 // w_bit
    kk = np.arange(K)
    codes = (words[kk // ppw].astype(np.int64) >> ((kk % ppw) * w_bit)[:, None]) & ((1 << w_bit) - 1)
    qxi = qx.numpy().astype(np.int64)
    want_dots = np.stack([qxi[:, g0 : g0 + gs] @ codes[g0 : g0 + gs] for g0 in range(0, K, gs)])
    np.testing.assert_array_equal(dots, want_dots)
    # the accumulator, bit for bit
    want = tqm.mpq_matmul_a8_ref(x, qt, accumulator=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,want", [(1, 1), (8, 1), (9, 2), (16, 2), (17, 4), (512, 4)])
def test_mma_row_tiles(m, want):
    assert tqm.mma_row_tiles(m) == want


@pytest.mark.parametrize("w_bit,gs,want", [
    (1, 32, 1), (1, 64, 2), (1, 128, 4), (2, 32, 2), (2, 64, 4), (2, 128, 4),
    (4, 32, 4), (4, 64, 4), (4, 128, 4), (2, 16, None), (4, 16, None),
])
def test_chunk_words_and_route(w_bit, gs, want):
    """A chunk holds whole k32 slabs and tiles the group; groups of 16
    codes at w2 / w4 keep the first (dp4a) body."""
    assert tqm.chunk_words(w_bit, gs) == want
    assert tqm.quad_route(w_bit, gs) == ("dp4a" if want is None else "mma")


JAX_K, JAX_N = 1024, 256  # A8 at w2 g128: 8 groups, a multiple of 4


@functools.lru_cache(maxsize=None)
def _jax_quad(w_bit, gs, mid, m):
    """The JAX ``tpu_quad`` kernel in interpret mode on int8 activations
    and a random weight: (its f32 accumulator, the JAX tensor, x)."""
    rng = np.random.default_rng(w_bit * 1000 + gs + m)
    w = (rng.standard_normal((JAX_K, JAX_N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((m, JAX_K)).astype(np.float32)
    jqt8 = relayout_tpu(jq.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=gs, mid_sym=mid),
                        act_bits=8)
    assert jqt8.layout == "tpu_quad"
    qx, _ = tqm.quantize_activations_ref(torch.from_numpy(x))
    acc = np.asarray(_mpq_matmul_call(
        jnp.asarray(qx.numpy()).astype(jnp.int8), jqt8.packed, jqt8.scales, jqt8.zeros,
        w_bit=w_bit, group_size=gs, layout="tpu_quad", out_dtype=jnp.float32, interpret=True,
        mid_codes=2 ** (w_bit - 1) if mid else 0,
    ))
    return acc, jqt8, x


@pytest.mark.parametrize("w_bit,gs,mid,m", [(2, 128, False, 8)])
def test_mma_body_matches_pallas_quad(w_bit, gs, mid, m):
    """The model's accumulator against the JAX package's ``tpu_quad``
    kernel on the same codes and activations: both dot integers exactly,
    so they differ by f32 summation order only (the bar of
    ``test_torch_quad_matmul.py``)."""
    want, jqt8, x = _jax_quad(w_bit, gs, mid, m)
    qt = tdm.prepare_for_kernel(_mpq(jax.tree_util.tree_map(np.asarray, jqt8), "cpu"))
    assert qt.act_bits == 8 and qt.layout == "gptq" and qt.zeros_mid == mid
    qx, _ = tqm.quantize_activations_ref(torch.from_numpy(x))
    qxo = tqm.kernel_order(qx, w_bit).numpy().astype(np.int8)
    got, _ = mma_body(qxo, qt.packed.numpy().view(np.uint32), qt.scales.float().numpy(),
                      qt.zeros.float().numpy(), tqm._mid(qt), w_bit, gs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
