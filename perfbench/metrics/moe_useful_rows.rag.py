"""The share of the rows the MoE experts compute that a token was routed
to: ``moe_routed_rows`` (T·k a layer call) over ``moe_computed_rows``
(E·C), summed over the program's spans in the window (every layer call
counts, profiled or not)."""

from perfbench.lib import spans


def read(run):
    recs = spans.window_records(run)
    if recs is None:
        return None  # the program keeps no spans
    computed = spans.count_sum(recs, "moe_computed_rows")
    return 100.0 * spans.count_sum(recs, "moe_routed_rows") / computed if computed else None
