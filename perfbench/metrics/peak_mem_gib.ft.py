"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), in GiB."""


def read(run):
    peak = run.data["peak"]
    return peak / 2**30 if peak else None
