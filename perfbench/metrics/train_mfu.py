"""The whole train step's share of the card's bf16 peak: the model's
operations a step (6 × the matmul parameters × tokens, plus causal
attention's forward and backward products; remat's recomputation not
counted) over the median host wall of the window's unprofiled steps."""

from perfbench.lib.cells import percentile
from perfbench.lib.flops import train_step_flops


def read(run):
    mix = run.plan.mix
    walls = [s["t1"] - s["t0"] for s in run.data["window_steps"] if not s["profiled"]]
    if not walls:
        return None
    ops = train_step_flops(run.shape, mix["batch"], mix["seq_len"])["total"]
    return 100.0 * ops / percentile(walls, 50) / run.peaks["bf16_flops"]
