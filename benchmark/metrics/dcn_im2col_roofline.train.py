"""dcn_im2col_roofline.train: percent of the dcn_im2col kernel's device
time a train step (``dcn_im2col_kernel``, every launch of it) that its
least time at the cell's shapes is (``yardstick.py``); none where the
step does not launch it or the profile lost its events."""

from benchmark.record import roofline


def read(run):
    if run.mode != 'train':
        return None
    return roofline(run, 'dcn_im2col_kernel')
