"""idle_share.train: percent of the profiled slice of trainer iteration (loader call and step)s
in which no kernel, copy or set ran on the card: one less the slice's
busy seconds over its length (``record.py:idle_share``); none where the
profile lost kernel events."""

from benchmark.record import idle_share


def read(run):
    return idle_share(run) if run.mode == 'train' else None
