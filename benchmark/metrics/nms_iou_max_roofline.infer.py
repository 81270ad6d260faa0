"""nms_iou_max_roofline.infer: percent of the nms_iou_max kernel's device
time a Pipeline call (``fast_nms_iou_max_kernel``, every launch of it) that its
least time at the cell's shapes is (``yardstick.py``); none where the
path does not launch it or the profile lost its events."""

from benchmark.record import roofline


def read(run):
    if run.mode != 'infer':
        return None
    return roofline(run, 'fast_nms_iou_max_kernel')
