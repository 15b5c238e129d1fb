"""Kernel 2's grouped entry, ``dequant_mpq_grouped``: on the CPU its plain
version (one ``dequant_mpq_ref`` a record) and the group's checks; on the
card (tests marked ``card``, skipped without one) bit-equal to one
``dequant_mpq`` a record and profiled under kernel 2's name.

This file imports no JAX, so that the card's tests run on the card's
machine: ``python -m pytest -m card --noconftest -p no:cacheprovider
tests/test_torch_dequant_grouped.py``.
"""

import re

import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu_torch.ops.cuda import dequant_matmul as dm
from bitorch_engine_tpu_torch.ops.quant import quantize_mpq

K, N = 256, 520


def _records(kind, count, device, n=N, seed=0):
    """``count`` records of one shape: "sym" (the kernels' form, bf16
    metadata), "asym" (packed integer zeros, bf16 scales), "act_order"
    (sym with a random ``q_perm`` each) or "asym_act_order"."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(count):
        w = torch.randn(K, n, generator=gen, device=device) * 0.02
        qt = quantize_mpq(w, w_bit=4, group_size=64, asym=kind.startswith("asym"))
        if kind.startswith("asym"):
            qt = qt.replace(scales=qt.scales.to(torch.bfloat16))
        else:
            qt = dm.prepare_for_kernel(qt, torch.bfloat16)
        if kind.endswith("act_order"):
            perm = torch.randperm(K, generator=gen, device=device).to(torch.int32)
            qt = qt.replace(q_perm=perm)
        out.append(qt)
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 2's grouped entry runs only there")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["sym", "asym", "act_order", "asym_act_order"])
def test_plain_grouped_is_one_plain_dequant_a_record(kind, dtype):
    qts = _records(kind, 3, "cpu")
    got = dm.dequant_mpq_grouped(qts, dtype)
    assert got.shape == (3, K, N) and got.dtype == dtype
    assert torch.equal(got, torch.stack([dm.dequant_mpq_ref(qt, dtype) for qt in qts]))


def test_a_group_takes_records_of_one_key_and_knows_them():
    qts = _records("sym", 3, "cpu")
    group = dm.DequantGroup(qts)
    assert group.size == 3 and group.shape == (K, N)
    assert group.holds(qts) and group.holds(list(qts))
    assert not group.holds(qts[:2])
    assert not group.holds([qts[0], qts[1], qts[2].replace(scales=qts[2].scales.clone())])
    for bad in (qts[2].replace(group_size=128), qts[2].replace(scales=qts[2].scales.float(),
                                                               zeros=qts[2].zeros.float())):
        with pytest.raises(ValueError, match="record 2 differs"):
            dm.DequantGroup([qts[0], qts[1], bad])
    with pytest.raises(ValueError, match="at least one"):
        dm.DequantGroup([])


@pytest.mark.card
@pytest.mark.parametrize("count", [3, 17], ids=["one_launch", "two_launches"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,n", [("sym", N), ("sym", 518), ("asym", N), ("act_order", N),
                                    ("act_order", 518), ("asym_act_order", N)])
def test_grouped_kernel_equals_one_launch_a_record(card, kind, n, dtype, count):
    """N = 518 takes the column-at-a-time path (asym zeros, packed along N,
    want N a multiple of 8 at w4)."""
    qts = _records(kind, count, "cuda", n=n)
    want = torch.stack([dm.dequant_mpq(qt, dtype) for qt in qts])
    before = dm.dequant_mpq_grouped.launches
    group = dm.DequantGroup(qts)
    got = dm.dequant_mpq_grouped(qts, dtype, group)
    torch.cuda.synchronize()
    assert dm.dequant_mpq_grouped.launches - before == -(-count // dm.DQ_MAX_SEGS)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="other records"):
        dm.dequant_mpq_grouped(qts[1:], dtype, group)


@pytest.mark.card
def test_grouped_kernel_is_profiled_as_kernel_2(card):
    qts = _records("sym", 16, "cuda")
    dm.dequant_mpq_grouped(qts)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        dm.dequant_mpq_grouped(qts)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [k for k in names if not k.startswith(("Memset", "Memcpy"))]
    assert kernels and all(re.search(r"\bdequant_kernel\b", k) for k in kernels), names
