"""input_copy_device_ms.infer: device ms a Pipeline call of the program's
``input`` span, the frames' copy to the card (``torch.as_tensor`` in
``Pipeline.__call__``): the median over the profiled slice's first
pass (``spans.py``); none without a trace, on the CPU, or where the
program has no such span."""

from benchmark.spans import span_ms


def read(run):
    return span_ms(run, 'input') if run.mode == 'infer' else None
