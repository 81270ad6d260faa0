"""stem_s2d_roofline.infer: percent of the stem_s2d kernel's device
time a Pipeline call (``stem_s2d_mma_kernel``, every launch of it) that its
least time at the cell's shapes is (``yardstick.py``); none where the
path does not launch it or the profile lost its events."""

from benchmark.record import roofline


def read(run):
    if run.mode != 'infer':
        return None
    return roofline(run, 'stem_s2d_mma_kernel')
