"""Kernel 8's tensor-core body (``csrc/binary_gemm.cu`` ``xnor_mma_kernel``)
modelled in numpy on the CPU: the lane -> fragment maps of
``mma.m16n8k256.b1.b1.s32.and.popc`` (A the weight words of 16 output
columns, B the x words of 8 rows; lane ``t`` takes words ``8 s + t`` and
``8 s + 4 + t`` of slab ``s``), slabs of 8 words zero past ``Kw``, the
launch plan's row tiles, column tiles and K runs (``xnor_plan``), each
run's ±1 dot ``32 words - 2 popc(x) - 2 popc(w) + 4 popc(x & w)``, the
runs' int32 partials summed, and the pad correction.  The model must give
``xnor_gemm_ref`` and the JAX package's Pallas kernel (interpret mode)
exactly, for any pad bits; the fused entry's plain version must give the
JAX package's packed forward bit for bit, signs at ``x == -bias_a``
included.  The CUDA kernel runs only on the card (``chip_smoke.py`` phase
14).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import binary_linear as jbl
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.pallas.binary_gemm import xnor_gemm_pallas
from bitorch_engine_tpu_torch import qtensor as tqt
from bitorch_engine_tpu_torch.ops import binary_linear as tbl
from bitorch_engine_tpu_torch.ops import packing
from bitorch_engine_tpu_torch.ops.cuda import binary_gemm as tbg

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4  # a lane's group and thread in group


def _bits(words):
    """(..., 32) 0/1 of uint32 words, bit j at index j."""
    return ((np.asarray(words, np.uint64)[..., None] >> np.arange(32, dtype=np.uint64)) & 1
            ).astype(np.int64)


def _popc(words):
    return _bits(words).sum(-1)


def mma_b1_and(a, b0, b1):
    """``mma.m16n8k256.row.col.s32.b1.b1.s32.and.popc`` from the 32 lanes'
    registers: ``a`` (4, 32), ``b0`` / ``b1`` (32,) uint32; returns the four
    D registers (4, 32) as the lanes hold them."""
    A = np.zeros((16, 256), np.int64)
    B = np.zeros((256, 8), np.int64)
    k = 32 * T[:, None] + np.arange(32)  # (32 lanes, 32 bits): k of a[0] / b0
    A[G[:, None], k] = _bits(a[0])         # row g, k 32t ..
    A[G[:, None] + 8, k] = _bits(a[1])     # row g + 8
    A[G[:, None], 128 + k] = _bits(a[2])   # row g, k 128 + 32t ..
    A[G[:, None] + 8, 128 + k] = _bits(a[3])
    B[k, G[:, None]] = _bits(b0)           # column g
    B[128 + k, G[:, None]] = _bits(b1)
    d = A @ B
    return np.stack([d[G, 2 * T], d[G, 2 * T + 1], d[G + 8, 2 * T], d[G + 8, 2 * T + 1]])


def _quad_sum(v):
    """Sum over the 4 lanes of each quad (the kernel's two xor shuffles)."""
    return np.repeat(v.reshape(8, 4).sum(-1), 4)


def kernel_model(xw, ww, k_logical, sms, fused=False):
    """The kernel on sign words ``xw`` (M, Kw), ``ww`` (N, Kw) (uint32),
    launched as ``xnor_plan`` picks for a card of ``sms`` SMs: the f32 out
    (M, N) before the scales."""
    m, kw = xw.shape
    n = ww.shape[0]
    mt, wk, tpb, _ = tbg.xnor_plan(m, n, kw, sms, fused)
    nt = tbg.col_tile(mt) // 16
    cw = 16 * nt
    bn = (tbg.WARPS // wk) * cw
    n_slabs = -(-kw // 8)
    wpad = np.zeros((n, 8 * n_slabs), np.uint64)  # the ring: words past Kw zero
    wpad[:, :kw] = ww
    out = np.full((m, n), np.nan, np.float32)
    grid_x = -(-n // (bn * tpb))
    for by in range(-(-m // (8 * mt))):
        m0 = by * 8 * mt
        xs = np.zeros((8 * mt, 8 * n_slabs), np.uint64)  # the block's rows, past M and Kw zero
        rows = min(8 * mt, m - m0)
        xs[:rows, :kw] = xw[m0:m0 + rows]
        for bx in range(grid_x):
            for tile in range(tpb):
                nb = (bx * tpb + tile) * bn
                if nb >= n:
                    break
                for wn in range(tbg.WARPS // wk):
                    n0 = nb + wn * cw
                    total = np.zeros((mt, nt, 4, 32), np.int64)
                    for wki in range(wk):  # the K runs, summed in warp order
                        s_lo, s_hi = wki * n_slabs // wk, (wki + 1) * n_slabs // wk
                        run_words = min(8 * s_hi, kw) - min(8 * s_lo, kw)
                        acc = np.zeros((mt, nt, 4, 32), np.int64)
                        px = np.zeros((mt, 32), np.int64)
                        pw = np.zeros((nt, 2, 32), np.int64)
                        for s in range(s_lo, s_hi):
                            b = [(xs[8 * i + G, 8 * s + T], xs[8 * i + G, 8 * s + 4 + T])
                                 for i in range(mt)]
                            for i in range(mt):
                                px[i] += _popc(b[i][0]) + _popc(b[i][1])
                            for j in range(nt):
                                lo = np.minimum(n0 + 16 * j + G, n - 1)  # columns past N: never stored
                                hi = np.minimum(n0 + 16 * j + 8 + G, n - 1)
                                a = [wpad[lo, 8 * s + T], wpad[hi, 8 * s + T],
                                     wpad[lo, 8 * s + 4 + T], wpad[hi, 8 * s + 4 + T]]
                                pw[j, 0] += _popc(a[0]) + _popc(a[2])
                                pw[j, 1] += _popc(a[1]) + _popc(a[3])
                                for i in range(mt):
                                    acc[i, j] += mma_b1_and(a, *b[i])
                        for i in range(mt):
                            q = _quad_sum(px[i])  # row 8 i + g, in quad g
                            p0, p1 = q[8 * T], q[8 * T + 4]  # rows 8 i + 2t, 8 i + 2t + 1
                            for j in range(nt):
                                for r in range(4):
                                    total[i, j, r] += (32 * run_words - 2 * (p1 if r & 1 else p0)
                                                       - 2 * _quad_sum(pw[j, r >> 1])
                                                       + 4 * acc[i, j, r])
                    for i in range(mt):
                        for j in range(nt):
                            for r in range(4):
                                rr = m0 + 8 * i + 2 * T + (r & 1)
                                cc = n0 + 16 * j + G + 8 * (r >> 1)
                                ok = (rr < m) & (cc < n)
                                out[rr[ok], cc[ok]] = (total[i, j, r] - (32 * kw - k_logical))[ok]
    assert not np.isnan(out).any(), "an output the launch never wrote"
    return out


def _words(rng, rows, k, pad=-1.0):
    x = rng.standard_normal((rows, k)).astype(np.float32)
    xp, _ = packing.pad_to_multiple(torch.from_numpy(x), 1, 32, value=pad)
    return x, packing.pack_signs(xp)


def test_b1_slab_takes_every_word_once():
    """Lane t's registers take words 8 s + t (a[0], a[1], b0) and 8 s + 4 +
    t (a[2], a[3], b1) of slab s: the 4 lanes of a quad cover the slab's 8
    words once, and A and B pair the same words, so the AND-popcount of the
    product is the slab's popc(x & w) whatever the bits' order in a word."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, (8, 8), dtype=np.uint64)   # 8 rows, one slab
    w = rng.integers(0, 2**32, (16, 8), dtype=np.uint64)  # 16 columns
    a = [w[G, T], w[G + 8, T], w[G, 4 + T], w[G + 8, 4 + T]]
    d = mma_b1_and(a, x[G, T], x[G, 4 + T])
    want = _popc(w[:, None, :] & x[None, :, :]).sum(-1)  # (16, 8)
    np.testing.assert_array_equal(d, np.stack([want[G, 2 * T], want[G, 2 * T + 1],
                                               want[G + 8, 2 * T], want[G + 8, 2 * T + 1]]))
    assert sorted(set(T) | set(4 + T)) == list(range(8))


@pytest.mark.parametrize("m,k,n", [(1, 1024, 256), (3, 1000, 70), (8, 1024, 128),
                                   (9, 96, 48), (128, 256, 64), (8, 784, 1024)])
def test_model_gives_the_plain_version_and_the_pallas_kernel(m, k, n):
    rng = np.random.default_rng(m * 7 + k)
    _, xw = _words(rng, m, k)
    _, ww = _words(rng, n, k)
    want = tbg.xnor_gemm_ref(xw, ww, k).numpy()
    pallas = np.asarray(xnor_gemm_pallas(jnp.asarray(xw.numpy().view(np.uint32)),
                                         jnp.asarray(ww.numpy().view(np.uint32)), k,
                                         interpret=True))
    np.testing.assert_array_equal(want, pallas)
    xu, wu = xw.numpy().view(np.uint32), ww.numpy().view(np.uint32)
    for sms, fused in ((132, False), (132, True), (8, True)):  # K split across warps, or not
        np.testing.assert_array_equal(kernel_model(xu, wu, k, sms, fused), want)


def test_model_subtracts_the_pad_as_the_plain_version_for_any_pad_bits():
    """Pad bits that differ between x and w (a caller's, not the packers')
    still give the plain version's integers: the kernel subtracts the pad
    count as the JAX wrapper does, it does not mask."""
    rng = np.random.default_rng(3)
    m, k, n = 9, 1000, 70
    _, xw = _words(rng, m, k, pad=1.0)
    _, ww = _words(rng, n, k, pad=-1.0)
    want = tbg.xnor_gemm_ref(xw, ww, k).numpy()
    got = kernel_model(xw.numpy().view(np.uint32), ww.numpy().view(np.uint32), k, 132)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x_dtype,b_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.float16, torch.float16),
                                             (torch.float16, torch.bfloat16)])
def test_kernel_sign_rule_is_the_sign_of_the_promoted_add(x_dtype, b_dtype):
    """The kernel's bit is ``f32(x) + f32(bias) >= 0``; the plain path packs
    ``(x + bias_a).float()`` in PyTorch's promotion of the two dtypes.  They
    agree at ties (x == -bias, -0.0), NaN, infinities and overflow."""
    rng = np.random.default_rng(11)
    k = 96
    x = torch.from_numpy(rng.standard_normal((6, k)).astype(np.float32)).to(x_dtype)
    bias = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(b_dtype)
    x[0, :8] = -bias[:8].to(x_dtype)                     # ties, where representable
    x[1, :4] = torch.tensor([-0.0, 0.0, -0.0, 0.0]).to(x_dtype)
    bias[:4] = torch.tensor([-0.0, -0.0, 0.0, 0.0]).to(b_dtype)
    x[2, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")]).to(x_dtype)
    big = torch.finfo(x_dtype).max
    x[3, 8:12] = torch.tensor([big, -big, big, -big]).to(x_dtype)
    bias[8:12] = torch.tensor([big, -big, -big, big]).clamp(
        -torch.finfo(b_dtype).max, torch.finfo(b_dtype).max).to(b_dtype)
    want = packing.pack_signs((x + bias).float())
    kern = ((x.float() + bias.float()).numpy() >= 0)
    bits = (kern.reshape(6, k // 32, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    np.testing.assert_array_equal(bits.astype(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("m,k,n,dtype", [(8, 1024, 256, torch.float32), (3, 1000, 70, torch.float32),
                                         (9, 100, 48, torch.bfloat16), (5, 200, 40, torch.float16)])
def test_fused_plain_version_is_the_jax_packed_forward(m, k, n, dtype):
    """``binary_packed_linear_ref`` (what the fused entry computes) and the
    port's packed ``binary_linear`` against the JAX package's
    ``_binary_forward_math`` (its CPU branch) on the same x, bias_a,
    scale_a and packed words, with rows where ``x == -bias_a``."""
    rng = np.random.default_rng(m + n)
    jb = jq.pack_binary_weight(jq.init_binary_weight(
        jnp.asarray(rng.standard_normal((n, k)).astype(np.float32) * 0.05)))
    x = rng.standard_normal((m, k)).astype(np.float32)
    ba = (rng.standard_normal(k) * 0.1).astype(np.float32)
    x[0] = -ba  # sign(0) = +1 along a whole row
    x[-1, ::3] = -ba[::3]
    sa = np.float32(0.37)
    jx = jnp.asarray(x).astype({torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                                torch.float16: jnp.float16}[dtype])
    want, _ = jbl._binary_forward_math(jx, jb, jnp.asarray(sa), jnp.asarray(ba))
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.from_numpy(x).to(dtype)
    words = torch.from_numpy(np.array(jb.data).view(np.int32))
    scale_w = torch.from_numpy(np.asarray(jb.scale_w))
    got = tbg.binary_packed_linear_ref(tx, words, torch.tensor(sa), torch.from_numpy(ba), scale_w, k)
    np.testing.assert_array_equal(got.float().numpy(), want)
    qt = tqt.BinaryQTensor(data=words, scale_w=scale_w, packed=True, in_features=k)
    out = tbl.binary_linear(tx, qt, torch.tensor(sa), torch.from_numpy(ba))
    np.testing.assert_array_equal(out.float().numpy(), want)


def test_wrappers_run_their_plain_versions_on_the_cpu_uncounted():
    rng = np.random.default_rng(5)
    x, _ = _words(rng, 4, 64)
    _, ww = _words(rng, 16, 64)
    tx, bias = torch.from_numpy(x), torch.zeros(64)
    sa, sw = torch.tensor(0.5), torch.tensor(0.25)
    before = (tbg.xnor_gemm.launches, tbg.binary_packed_linear.launches)
    got = tbg.binary_packed_linear(tx, ww, sa, bias, sw, 64)
    np.testing.assert_array_equal(got.numpy(),
                                  tbg.binary_packed_linear_ref(tx, ww, sa, bias, sw, 64).numpy())
    assert (tbg.xnor_gemm.launches, tbg.binary_packed_linear.launches) == before
    with pytest.raises(ValueError, match="one value"):
        tbg.binary_packed_linear(tx, ww, torch.ones(2), bias, sw, 64)
    with pytest.raises(ValueError, match="k_logical"):
        tbg.binary_packed_linear(tx, ww, sa, torch.zeros(63), sw, 64)
    with pytest.raises(ValueError, match="does not fit"):
        tbg.binary_packed_linear(tx, ww[:, :1].contiguous(), sa, bias, sw, 64)


@pytest.mark.parametrize("m,n,kw,fused,plan", [
    (8, 1024, 32, True, (1, 4, 1, 1)),      # the packed MLP at b8: 4 slabs, 4 runs; x in one pass
    (128, 1024, 32, True, (8, 4, 1, 8)),    # b128: 8 blocks share the rows' words
    (8, 4096, 128, False, (1, 8, 1, 1)),    # 256 column tiles, 8 runs of K: 256 blocks
    (8, 4096, 128, True, (1, 2, 1, 4)),     # fused: 64 blocks, clusters of 4
    (2048, 4096, 128, True, (8, 1, 2, 8)),  # 32 x 16 blocks: two column tiles a block
    (2048, 1024, 32, False, (8, 2, 1, 1)),  # 128 blocks unsplit: 2 runs of K
    (3, 70, 32, True, (1, 4, 1, 1)),
    (1, 1024, 1, False, (1, 1, 1, 1)),      # one slab: no split
])
def test_xnor_plan(m, n, kw, fused, plan):
    assert tbg.xnor_plan(m, n, kw, 132, fused) == plan


def test_xnor_route_boundaries():
    """The kernel serves every m whose rows of words fit shared memory;
    beyond that the unpack branch."""
    for m in (1, 8, 16, 17, 128, 2048, 65536):
        assert tbl.xnor_route(m, 4096, 4096) == "kernel"
    # 64-row tiles: 227 KiB less the 64 KiB of partials holds 648 words a row
    assert tbg.smem_bytes(8, 648) <= tbg.MAX_SHARED < tbg.smem_bytes(8, 649)
    assert tbl.xnor_route(65, 648 * 32, 1024) == "kernel"
    assert tbl.xnor_route(65, 648 * 32 + 1, 1024) == "unpack"
    assert tbl.xnor_route(32, 648 * 32 + 1, 1024) == "kernel"  # 32-row tiles
    assert tbl.xnor_route(1, 200_000, 1024) == "kernel"
    assert tbl.xnor_route(1, 6744 * 32 + 1, 1024) == "unpack"


def test_xnor_route_takes_the_kernel_for_the_dtypes_it_reads():
    """f32, bf16 and f16 (``BinaryLinear``'s ``dtype``, any mix of x,
    bias_a and the scales) go to the fused entry; any other dtype to the
    unpack branch, which computes ``(x + bias_a).float()`` in PyTorch."""
    for dtypes in ((torch.float32,), (torch.bfloat16,), (torch.float16,),
                   (torch.float16, torch.float32, torch.bfloat16, torch.float32)):
        assert tbl.xnor_route(8, 1024, 1024, dtypes) == "kernel"
    assert tbl.xnor_route(8, 1024, 1024, (torch.float64,)) == "unpack"
    assert tbl.xnor_route(8, 1024, 1024, (torch.float32, torch.float64)) == "unpack"
