"""mfu.train: three times the frozen FLOPs of the reference's forward an
image (forward and two gradient passes; recomputation not counted) times
the window's images a second, over the card's dense bfloat16 peak (989
TFLOP/s), in percent: the whole train step's share of the peak."""

from benchmark.record import mfu
from benchmark.yardstick import BF16_TENSOR_OPS_PER_S


def read(run):
    return mfu(run, BF16_TENSOR_OPS_PER_S) if run.mode == 'train' else None
