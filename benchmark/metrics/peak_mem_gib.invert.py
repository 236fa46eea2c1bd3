"""The device allocator's peak over the window, after a reset at its
start (`torch.cuda.max_memory_allocated`), in GiB."""


def read(run):
    return run.window.peak_bytes / 2 ** 30 if run.window.peak_bytes else None
