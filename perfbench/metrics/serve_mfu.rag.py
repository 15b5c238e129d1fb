"""The whole model step's share of the card's bf16 peak: the operations
the tokens served outside the profiled stretch need (true prompt lengths,
top-k routing, causal attention over the real context, the head for every
token whose logits are sampled), over the unprofiled wall of the window."""

from perfbench.lib import reading
from perfbench.lib.flops import attn_flops_prompt, attn_flops_token, head_flops, token_matmul_flops


def read(run):
    s = run.shape
    per_tok, head = token_matmul_flops(s), head_flops(s)
    ops = 0.0
    for r in run.data["recs"]:
        if r.t_first is not None and reading.unprofiled(run, r.t_first):
            n = r.prompt_len
            ops += n * per_tok + attn_flops_prompt(s, n) + head
        for k, t in enumerate(r.token_times[1:], start=1):
            if reading.unprofiled(run, t):
                ops += per_tok + attn_flops_token(s, r.prompt_len + k) + head
    wall = reading.unprofiled_wall(run)
    if ops == 0 or wall <= 0:
        return None
    return 100.0 * ops / wall / run.peaks["bf16_flops"]
