"""The share of the rows the MoE experts compute that take the grouped
route (one grouped kernel-2 launch for a layer's gates and ups, one for
its downs, batched GEMMs): ``moe_grouped_rows`` over ``moe_computed_rows``
(both E·C a layer call), summed over the program's spans in the window.
Nothing where the program keeps no ``moe_grouped_rows`` count."""

from perfbench.lib import spans


def read(run):
    recs = spans.window_records(run)
    if recs is None or not any("moe_grouped_rows" in r.counts for r in recs):
        return None
    computed = spans.count_sum(recs, "moe_computed_rows")
    return 100.0 * spans.count_sum(recs, "moe_grouped_rows") / computed if computed else None
