"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window
(reset at its start), in GiB."""

from benchmark.record import GIB


def read(run):
    return run.window_peak_bytes / GIB if run.window_peak_bytes else None
