"""The bf16 body of kernels 7 and 1 (``csrc/mbwq_matmul.cu``) modelled in
plain torch on the CPU: the k permutation inside each k16 slab, codes
converted through the 128 bias (widths 1, 2, 4) or exactly (width 8), the
warps' balanced K runs (``warp_cuts``) that cut groups and segments, the
per-run factored partials ``s · dot − z · Σx`` summed in warp order, and the
cluster of blocks along K (``k_splits``) whose partials are added in rank
order.  The model is held to the plain versions ``mbwq_matmul_ref`` and
``mpq_matmul_ref`` (kernel 1: one segment) and, at one shape each, to the
JAX fused kernels in interpret mode.  The CUDA kernel itself runs only on
the card (``chip_smoke.py`` phases 2 and 8b).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import mbwq_linear as jmb
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.pallas.dequant_matmul import mpq_matmul_pallas
from bitorch_engine_tpu.ops.pallas.mbwq_matmul import mbwq_matmul_pallas
from bitorch_engine_tpu_torch.ops import mbwq_linear as tmb
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as tdm
from bitorch_engine_tpu_torch.ops.cuda.mbwq_matmul import (
    block_warps, chunk_words, k_splits, mbwq_matmul_ref, tiles_group, warp_cuts,
)
from bitorch_engine_tpu_torch.utils.convert import _mpq
from bitorch_engine_tpu_torch.ops.quant import quantize_mpq
from bitorch_engine_tpu_torch.qtensor import MBWQTensor


def _code_pairs(words: torch.Tensor, w_bit: int, j: int):
    """The kernel's ``code_pair<W>(word, j)``: codes j and j + 16/W of each
    int32 word as the two halves of a bf16x2, as f32 (low, high)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    if w_bit == 8:
        return ((w >> (8 * j)) & 0xFF).float(), ((w >> (8 * j + 16)) & 0xFF).float()
    mask = ((1 << w_bit) - 1) * 0x10001
    v = ((w >> (j * w_bit)) & mask) | 0x43004300  # 128 + q in each half
    halves = []
    for shift in (0, 16):
        bits = ((v >> shift) & 0xFFFF).to(torch.int32) << 16
        halves.append(bits.view(torch.float32) - 128.0)  # bf16 → f32 is exact
    return halves[0], halves[1]


def _slab(words: torch.Tensor, w_bit: int, c: int, s: int):
    """Slab ``s`` of a chunk (``words``: its ``c`` word rows, ``(c, N)``):
    the A operand ``(16 κ, N)`` as the lanes fill it, and each κ's
    chunk-relative k, by the lane rule of the source note."""
    ppw, half = 32 // w_bit, 16 // w_bit
    n_slabs = c * ppw // 16
    tpw = 4 // c
    rows, ks = [], []
    for kappa in range(16):
        t = (kappa % 8) // 2
        widx, jb = t // tpw, (t % tpw) * 2 * n_slabs
        j = jb + 2 * s + (kappa >= 8)           # a0 / a2: pair jb + 2s, jb + 2s + 1
        lo, hi = _code_pairs(words[widx], w_bit, j)
        high = kappa % 2 == 1                    # odd κ: the pair's second code
        rows.append(hi if high else lo)
        ks.append(widx * ppw + j + (half if high else 0))
    return torch.stack(rows), ks


def kernel_model(x: torch.Tensor, qt: MBWQTensor, n_split: int = 1) -> torch.Tensor:
    """The f32 output of ``mbwq_mma_kernel`` in its arithmetic order (each
    MMA as one f32 product of 16 k), over a cluster of ``n_split`` blocks
    along K: each rank sums its warps' partials in warp order, then the
    ranks' sums are added in rank order."""
    segs = qt.segments
    m, n = x.shape[0], segs[0].out_features
    n_warps = block_warps(m)  # a column's sum does not depend on the block's width
    chunks = [chunk_words(s.w_bit, s.group_size) for s in segs]
    cuts = warp_cuts([(s.in_features, c * 32 // s.w_bit) for s, c in zip(segs, chunks)],
                     n_warps * n_split)
    out = torch.zeros(m, n)
    for rank in range(n_split):
        part = torch.zeros(m, n)
        for w in range(rank * n_warps, (rank + 1) * n_warps):
            part = part + _warp_partial(x, segs, chunks, cuts, w)
        out = out + part
    return out


def _warp_partial(x, segs, chunks, cuts, w):
    """Warp ``w``'s factored partial over its K run ``[cuts[w], cuts[w + 1])``."""
    m, n = x.shape[0], segs[0].out_features
    acc = torch.zeros(m, n)
    k_off = 0
    for seg, c in zip(segs, chunks):
        ck = c * 32 // seg.w_bit
        lo, hi = max(cuts[w], k_off), min(cuts[w + 1], k_off + seg.in_features)
        dot, xs = torch.zeros(m, n), torch.zeros(m)
        for i in range((lo - k_off) // ck, (hi - k_off) // ck):
            seen = []
            for s in range(ck // 16):
                a, ks = _slab(seg.packed[i * c : (i + 1) * c], seg.w_bit, c, s)
                xb = x[:, [k_off + i * ck + k for k in ks]]
                dot = dot + xb @ a
                xs = xs + xb.sum(dim=1)
                seen += ks
            assert sorted(seen) == list(range(ck))  # a permutation of the chunk
            if i + 1 == (hi - k_off) // ck or (i + 1) * ck % seg.group_size == 0:
                grp = i * ck // seg.group_size
                acc = acc + (dot * seg.scales[grp].float() - xs[:, None] * seg.zeros[grp].float())
                dot, xs = torch.zeros(m, n), torch.zeros(m)
        k_off += seg.in_features
    return acc


# two-segment mixes (w_bit, group size, rows) covering widths 1, 2, 4, 8 and
# chunks of 4, 2 and 1 words
MIXES = {
    "w4g64_w2g128": ((4, 64, 256), (2, 128, 384)),
    "w8g64_w1g128": ((8, 64, 128), (1, 128, 512)),
    "w2g32_w1g32": ((2, 32, 320), (1, 32, 192)),
    "w4g16_w2g16": ((4, 16, 208), (2, 16, 176)),
}


def _mix(name, n=40, seed=0):
    rng = np.random.default_rng(seed)
    segs = []
    for w_bit, gs, k in MIXES[name]:
        w = torch.from_numpy((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
        segs.append(tdm.prepare_for_kernel(quantize_mpq(w, w_bit, gs), torch.bfloat16))
    return MBWQTensor(segments=tuple(segs))


@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("name", list(MIXES))
def test_kernel_order_matches_ref(name, m):
    """The model of the bf16 body equals the plain version to f32 summation
    order (rel 1e-5), at a ragged N and, where chunks are shorter than a
    group, at a K whose warp runs cut groups."""
    qt = _mix(name)
    segs = qt.segments
    chunks = [chunk_words(s.w_bit, s.group_size) for s in segs]
    assert {c for c in chunks} <= {1, 2, 4}
    cuts = warp_cuts([(s.in_features, c * 32 // s.w_bit) for s, c in zip(segs, chunks)],
                     block_warps(m))
    k = sum(s.in_features for s in segs)
    runs = np.diff(cuts)
    assert cuts[0] == 0 and cuts[-1] == k and runs.min() >= 0
    assert runs.max() - runs.min() <= max(c * 32 // s.w_bit for s, c in zip(segs, chunks))
    bounds, off = [], 0
    for s in segs:
        bounds.append((off, off + s.in_features, s.group_size))
        off += s.in_features
    if name in ("w4g64_w2g128", "w8g64_w1g128"):  # chunks shorter than a group
        assert any(lo < cut < hi and (cut - lo) % gs for cut in cuts for lo, hi, gs in bounds)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, k)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    want = mbwq_matmul_ref(x, qt, torch.float32)
    got = kernel_model(x, qt)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("w_bit,gs,want", [
    (1, 128, 4), (1, 64, 2), (1, 32, 1), (2, 64, 4), (2, 32, 2), (2, 16, 1),
    (4, 32, 4), (4, 16, 2), (8, 16, 4), (8, 8, None), (4, 24, None),
])
def test_chunk_words(w_bit, gs, want):
    """A chunk is 4 words of a column, or 2 / 1 inside a shorter group, and
    always whole k16 slabs; the bf16 body refuses group sizes that are not
    multiples of 16."""
    if want is None:
        with pytest.raises(ValueError, match="multiples of 16"):
            chunk_words(w_bit, gs)
    else:
        assert chunk_words(w_bit, gs) == want


def test_kernel_order_matches_pallas():
    """The model against the JAX fused kernel in interpret mode (w8 / w4 / w2
    at g64: three segments, one launch), at that kernel's test tolerance."""
    strategy = {"bits": [8, 4, 2], "bits_prop": [0.25, 0.5, 0.25],
                "group_size": {"8": 64, "4": 64, "2": 64}}
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((1024, 128)) * 0.02).astype(np.float32)
    x = rng.standard_normal((8, 1024)).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    jqt = jmb.quantize_mbwq(jnp.asarray(w), strategy)
    want = np.asarray(mbwq_matmul_pallas(jnp.asarray(x)[:, jqt.q_perm], jqt, interpret=True))
    tqt = tmb.quantize_mbwq(torch.from_numpy(w), strategy)
    tqt = tqt.replace(segments=tuple(tdm.prepare_for_kernel(s) for s in tqt.segments))
    got = kernel_model(tmb.gather_activations(torch.from_numpy(x), tqt), tqt).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-4)


# kernel 1 on the same body: one MPQ tensor (w_bit, group size, K, N), N
# ragged against the 64-column tile
MPQ_CASES = {
    "w4g128": (4, 128, 512, 200),
    "w2g64": (2, 64, 384, 100),
    "w8g64": (8, 64, 256, 40),
    "w1g128": (1, 128, 512, 68),
}


def _mpq_case(name, seed=0):
    w_bit, gs, k, n = MPQ_CASES[name]
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    return tdm.prepare_for_kernel(quantize_mpq(w, w_bit, gs), torch.bfloat16)


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("name", list(MPQ_CASES))
def test_kernel1_split_order_matches_ref(name, m, n_split):
    """Kernel 1 as the body's one-segment case, its K cut for a cluster of
    ``n_split`` ranks, equals ``mpq_matmul_ref`` to f32 summation order."""
    qt = _mpq_case(name)
    k = qt.in_features
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, k)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    want = tdm.mpq_matmul_ref(x, qt, torch.float32)
    got = kernel_model(x, MBWQTensor(segments=(qt,)), n_split)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_kernel1_model_matches_pallas():
    """Kernel 1's model (w4 g128, a cluster of 2) against the JAX
    ``_mpq_kernel`` in interpret mode, at the tolerance of
    ``test_torch_dequant_matmul.py::test_mpq_matmul_ref_matches_pallas``."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((512, 256)) * 0.02).astype(np.float32)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    jqt = jq.quantize_mpq(jnp.asarray(w), w_bit=4, group_size=128)
    want = np.asarray(mpq_matmul_pallas(jnp.asarray(x), jqt, interpret=True))
    tqt = tdm.prepare_for_kernel(_mpq(jax.tree_util.tree_map(np.asarray, jqt), "cpu"))
    got = kernel_model(torch.from_numpy(x), MBWQTensor(segments=(tqt,)), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("n,m,want", [
    # Llama-3-8B serving at decode: qkv, o, gate_up, down, head
    (6144, 8, 1), (4096, 8, 2), (28672, 8, 1), (4096, 8, 2), (129024, 8, 1),
    # Llama-2-7B MBWQ-2.5: qkv, gate_up (o and down are N = 4096 as above)
    (12288, 8, 1), (22528, 8, 1),
    # a narrow N: clusters stay at 2
    (2048, 8, 2), (3072, 8, 2),
    # 16-row tiles of 32 columns: 128 tiles fill the card
    (4096, 16, 1), (2048, 16, 2), (4096, 64, 1), (6144, 512, 1),
])
def test_k_splits(n, m, want):
    """Kernel 7's cluster of 2 along K only where the split grid still runs
    in one wave on 132 SMs."""
    assert k_splits(n, m, sms=132) == want


@pytest.mark.parametrize("x_dtype,w_bit,gs,want", [
    (torch.bfloat16, 4, 128, "mma"), (torch.bfloat16, 2, 64, "mma"),
    (torch.bfloat16, 8, 64, "mma"), (torch.bfloat16, 1, 128, "mma"),
    (torch.float32, 4, 128, "scalar"), (torch.float32, 2, 64, "scalar"),
    (torch.bfloat16, 4, 8, "scalar"), (torch.bfloat16, 4, 48, "scalar"),
])
def test_mpq_matmul_route(x_dtype, w_bit, gs, want):
    """Kernel 1's body is picked up front from the activations' dtype and the
    group size: bf16 with a group the chunks tile runs the tensor-core body,
    f32 and untileable groups the scalar body."""
    k = 2 * max(gs, 32 // w_bit * 4)
    w = torch.from_numpy((np.random.default_rng(0).standard_normal((k, 8)) * 0.02).astype(np.float32))
    qt = tdm.prepare_for_kernel(quantize_mpq(w, w_bit, gs))
    assert tiles_group(w_bit, gs) == (gs not in (8, 48))
    assert tdm.mpq_matmul_route(x_dtype, qt) == want
