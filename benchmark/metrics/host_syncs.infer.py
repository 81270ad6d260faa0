"""host_syncs.infer: device-to-host reads a Pipeline call makes on its
hot path, the program's ``host_syncs`` counter (detection's candidate
check, ``detect.fits_read``): the median over the profiled slice's first
pass (``spans.py``); none without a trace or where the program has no
such counter."""

from benchmark.spans import counter


def read(run):
    return counter(run, 'host_syncs') if run.mode == 'infer' else None
