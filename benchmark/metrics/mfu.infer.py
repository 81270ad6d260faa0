"""mfu.infer: the frozen FLOPs of the reference's forward an image times
the window's frames a second, over the card's dense bfloat16 peak (989
TFLOP/s), in percent: the whole model step's share of the peak."""

from benchmark.record import mfu
from benchmark.yardstick import BF16_TENSOR_OPS_PER_S


def read(run):
    return mfu(run, BF16_TENSOR_OPS_PER_S) if run.mode == 'infer' else None
