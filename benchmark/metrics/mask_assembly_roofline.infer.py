"""mask_assembly_roofline.infer: percent of the mask_assembly kernel's device
time a Pipeline call (``mask_assembly_kernel``, every launch of it) that its
least time at the cell's shapes is (``yardstick.py``); none where the
path does not launch it or the profile lost its events."""

from benchmark.record import roofline


def read(run):
    if run.mode != 'infer':
        return None
    return roofline(run, 'mask_assembly_kernel')
