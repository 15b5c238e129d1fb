"""The share of the prefill's tokens that are prompt tokens: the true
prompt tokens of the window's admission waves over the tokens their
power-of-2 buckets compute (the program's ``bie.batcher.wave`` counts)."""

from perfbench.lib import spans


def read(run):
    recs = spans.window_records(run)
    if recs is None:
        return None  # the program keeps no spans
    waves = spans.named(recs, "bie.batcher.wave")
    padded = spans.count_sum(waves, "padded_tokens")
    return 100.0 * spans.count_sum(waves, "true_tokens") / padded if padded else None
