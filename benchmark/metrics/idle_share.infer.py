"""idle_share.infer: percent of the profiled slice of Pipeline calls
in which no kernel, copy or set ran on the card: one less the slice's
busy seconds over its length (``record.py:idle_share``); none where the
profile lost kernel events."""

from benchmark.record import idle_share


def read(run):
    return idle_share(run) if run.mode == 'infer' else None
