"""stem_s2d_roofline.train: percent of the stem_s2d kernel's device
time a train step (``stem_s2d_mma_kernel``, every launch of it) that its
least time at the cell's shapes is (``yardstick.py``); none where the
step does not launch it or the profile lost its events."""

from benchmark.record import roofline


def read(run):
    if run.mode != 'train':
        return None
    return roofline(run, 'stem_s2d_mma_kernel')
