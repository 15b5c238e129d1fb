"""Causal attention's share of its roofline in the train step: its forward
(2 products) and backward (5 products) operations over the device time of
the kernels of the attention classes (kernels 3 and 4) in the traced
steps."""

from perfbench.lib.flops import train_step_flops
from perfbench.lib.trace import class_seconds


def read(run):
    mix = run.plan.mix
    spans = run.trace.spans_named("train_step")
    t = sum(class_seconds(sp.kernels, run.classify, c) for sp in spans
            for c in ("attention_forward", "attention_backward"))
    if not spans or t == 0:
        return None
    f = train_step_flops(run.shape, mix["batch"], mix["seq_len"])
    ops = f["attention_forward"] + f["attention_backward"]
    return 100.0 * ops / run.peaks["bf16_flops"] * len(spans) / t
