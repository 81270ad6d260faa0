"""nchw_maps.infer: feature maps a Pipeline call hands between the model's
layers (trunk stage outputs, FPN levels, prototypes, head inputs) that are
not channels_last, the program's ``nchw_maps`` counter: the median over
the profiled slice's first pass (``spans.py``); none without a trace, or
where the program never takes such a counter (a call that takes it counts
0 or more)."""

from benchmark.spans import counter, first_pass_roots

NAME = 'nchw_maps'


def read(run):
    if run.mode != 'infer':
        return None
    roots = first_pass_roots(run, 'call')
    if roots is None or not any(NAME in r.counters for r in roots):
        return None
    return counter(run, NAME)
