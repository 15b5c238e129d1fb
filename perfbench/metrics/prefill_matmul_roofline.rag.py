"""The prefill matmuls' share of their roofline: the least time the traced
admission waves' true prompt tokens need for their matmuls (top-k
routing; every weight read once a chunk forward), over the device time of
the kernels that carry matmuls (``kernels/*.json`` of class ``matmul``:
kernel 2 and cuBLAS in the reconstruct-then-GEMM regime) inside the traced
admission spans."""

from perfbench.lib import reading
from perfbench.lib.trace import class_seconds


def read(run):
    iters = reading.traced_iters(run)
    spans = run.trace.spans_named("admit")
    if len(spans) != len(iters):
        raise RuntimeError(f"{len(spans)} traced admission spans for {len(iters)} traced iterations")
    waves = [w for it in iters for w in it.waves]
    kernels = [k for sp in spans for k in sp.kernels]
    t = class_seconds(kernels, run.classify, "matmul")
    if not waves or t == 0:
        return None
    return 100.0 * reading.prefill_least_s(run, waves) / t
