"""The device's idle share of the unprofiled window: 1 − (device busy a
unit of work in the traced stretch, as the union of kernel, copy and set
intervals) × (the units the unprofiled window did) ÷ its wall.  Units: a
decode step, and a padded prefill token (the traced admission spans'
busy time over their padded tokens).  The profiled wall is not used: the
profiler slows the host, not the device."""

from perfbench.lib import reading


def read(run):
    if not run.trace.device:
        return None  # no device event in the trace
    tr = run.trace
    iters = reading.traced_iters(run)
    steps, admits = tr.spans_named("step"), tr.spans_named("admit")
    padded = reading.padded_tokens([w for it in iters for w in it.waves])
    if not steps or not padded:
        return None
    per_step = sum(tr.busy_s(sp.start, sp.end) for sp in steps) / len(steps)
    per_token = sum(tr.busy_s(sp.start, sp.end) for sp in admits) / padded
    plain = reading.plain_iters(run)
    busy = (per_step * sum(it.step is not None for it in plain)
            + per_token * reading.padded_tokens([w for it in plain for w in it.waves]))
    wall = sum((it.step[1] if it.step else it.admit[1]) - it.admit[0] for it in plain)
    return 100.0 * (1.0 - busy / wall)
