"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Sources live in ``bitorch_engine_tpu_torch/csrc``; ``_build`` compiles them
with ``nvcc`` at first use.  Importing this package builds nothing.
"""

from __future__ import annotations

from typing import Dict

from .binary_gemm import binary_packed_linear, xnor_gemm
from .dequant_matmul import dequant_mpq, mpq_matmul
from .flash_attention import flash_attention, flash_attention_bwd
from .mbwq_matmul import mbwq_matmul
from .paged_attention import paged_prefix_attention, paged_prefix_attention_update
from .quad_matmul import mpq_matmul_a8

# every kernel wrapper of the port, by name
KERNELS = {
    "mpq_matmul": mpq_matmul,
    "dequant_mpq": dequant_mpq,
    "flash_attention": flash_attention,
    "paged_prefix_attention": paged_prefix_attention,
    "paged_prefix_attention_update": paged_prefix_attention_update,
    "mpq_matmul_a8": mpq_matmul_a8,
    "mbwq_matmul": mbwq_matmul,
    "flash_attention_bwd": flash_attention_bwd,
    "xnor_gemm": xnor_gemm,
    "binary_packed_linear": binary_packed_linear,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
