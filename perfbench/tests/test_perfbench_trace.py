"""Kernel names: every kernel of a traced stretch is claimed by a pattern
under ``kernels/``, or the traced run fails."""

import pytest

from perfbench.lib.bench import ROOT, plan
from perfbench.lib.trace import parse, unclaimed

SPAN = {"ph": "X", "cat": "user_annotation", "name": "perfbench.admit", "ts": 0.0, "dur": 100.0}


def trace_of(kernels):
    """A trace of one span whose kernels were launched by ``(op, name)``."""
    events = [SPAN]
    for i, (op, name) in enumerate(kernels):
        ts = 1.0 + 10 * i
        events += [
            {"ph": "X", "cat": "cpu_op", "name": op, "ts": ts, "dur": 3.0, "tid": 1,
             "args": {"External id": i}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts + 1, "dur": 1.0,
             "args": {"correlation": 100 + i, "External id": i}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": ts + 2, "dur": 4.0,
             "args": {"correlation": 100 + i}},
        ]
    return parse(events)


CLAIMED = [
    ("aten::mm", "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT"),
    ("aten::add", "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add"
                  "<float>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, "
                  "std::array<char*, 3ul>)"),
    ("aten::cumsum", "void at_cuda_detail::cub::DeviceScanKernel<int>(int*)"),
    ("", "void (anonymous namespace)::dequant_kernel<4, false>(unsigned int const*)"),
    ("", "void (anonymous namespace)::flash_bwd_dkv_kernel<128>(float const*)"),
]


def test_the_ports_kernels_and_torchs_families_are_claimed():
    p = plan("mixtral-rag-32c", ROOT)
    assert unclaimed(trace_of(CLAIMED), p.kernel_class) == []


@pytest.mark.parametrize("op,name", [
    ("", "void grouped_expert_mma_kernel<64>(__nv_bfloat16 const*)"),
    ("aten::mm", "void at::native::vectorized_elementwise_kernel<4, float>(int)"),
    ("aten::_scaled_dot_product_flash_attention", "void pytorch_flash::flash_fwd_splitkv<128>()"),
])
def test_an_unclaimed_kernel_is_named(op, name):
    p = plan("mixtral-rag-32c", ROOT)
    bad = unclaimed(trace_of(CLAIMED + [(op, name)]), p.kernel_class)
    assert bad and all(name[:60] in b for b in bad)
