"""early_stages_device_ms.infer: device ms a Pipeline call of the program's
``early_stages`` span, inside ``backbone``: the DarkNet trunk's pre-conv and
first two stages (the 550², 275² and 138² maps, which no FPN level reads),
the median over the profiled slice's first pass (``spans.py``); none
without a trace, on the CPU, or where the program has no such span."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, 'early_stages') if run.mode == 'infer' else None
