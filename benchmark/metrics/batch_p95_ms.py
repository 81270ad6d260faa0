"""batch_p95_ms: the 95th percentile of every call's milliseconds in the
window, from the call to the end of the synchronize after it (the call
ends in detection's host read)."""

from benchmark.record import quantile


def read(run):
    return quantile(run.call_ms(), 0.95) if run.mode == 'infer' else None
