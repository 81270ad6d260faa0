"""masks_device_ms.infer: device ms a Pipeline call of the program's
``masks`` span, mask assembly and crop (``postprocess_device``): the
median over the profiled slice's first pass (``spans.py``); none
without a trace, on the CPU, or where the program has no such span."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, 'masks') if run.mode == 'infer' else None
