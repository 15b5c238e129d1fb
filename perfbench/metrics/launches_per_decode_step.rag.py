"""Device kernels a decode step launches: the kernels in the traced
``step()`` spans over their count."""


def read(run):
    if not run.trace.device:
        return None  # no device event in the trace
    spans = run.trace.spans_named("step")
    if not spans:
        return None
    return sum(len(sp.kernels) for sp in spans) / len(spans)
