"""The train step's matmuls' share of their roofline: the least time of the
model's matmul operations a step (6 × matmul parameters × tokens; every
weight's packed bytes read once) over the device time of the kernels of
class ``matmul`` (kernel 2 and cuBLAS) in the traced steps, DiodeMix's
own (its ``optimizer`` span) left out."""

from perfbench.lib.flops import train_step_flops, weight_bytes_per_forward
from perfbench.lib.peaks import least_seconds
from perfbench.lib.trace import class_seconds


def read(run):
    mix = run.plan.mix
    spans = run.trace.spans_named("train_step")
    t = sum(class_seconds(sp.kernels, run.classify, "matmul") for sp in spans)
    if not spans or t == 0:
        return None
    ops = train_step_flops(run.shape, mix["batch"], mix["seq_len"])["matmul"]
    least = least_seconds(ops, weight_bytes_per_forward(run.shape), run.peaks)
    return 100.0 * least * len(spans) / t
