"""batch_p50_ms: the median call of the (untraced) window, as
``batch_p95_ms`` times it: the entry layer's steady time, beside its
tail."""

from benchmark.record import quantile


def read(run):
    return quantile(run.call_ms(), 0.5) if run.mode == 'infer' else None
