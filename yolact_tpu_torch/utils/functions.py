"""Small host-side helpers of the eval loop: moving average and progress
bar, the port's copy of ``yolact_tpu/utils/functions.py``.  Behavioural
parity with the reference ``utils/functions.py``."""

from __future__ import annotations

import math
from collections import deque


class MovingAverage:
    """Sliding-window mean that ignores non-finite entries
    (utils/functions.py:9-48)."""

    def __init__(self, max_window_size: int = 1000):
        self.max_window_size = max_window_size
        self.reset()

    def reset(self):
        self.window = deque()
        self.sum = 0.0

    def add(self, elem: float):
        if not math.isfinite(elem):
            return
        self.window.append(elem)
        self.sum += elem
        while len(self.window) > self.max_window_size:
            self.sum -= self.window.popleft()

    def append(self, elem: float):
        self.add(elem)

    def get_avg(self) -> float:
        return self.sum / max(len(self.window), 1)

    def __len__(self):
        return len(self.window)

    def __repr__(self):
        return repr(self.get_avg())


class ProgressBar:
    """Text progress bar (utils/functions.py:51-86)."""

    def __init__(self, length: int, max_val: float):
        self.max_val = max_val
        self.length = length
        self.cur_val = 0
        self.cur_num_bars = -1
        self.string = ''
        self._update_str()

    def set_val(self, new_val: float):
        self.cur_val = min(max(new_val, 0), self.max_val)
        self._update_str()

    def is_finished(self) -> bool:
        return self.cur_val == self.max_val

    def _update_str(self):
        num_bars = int(self.length * (self.cur_val / self.max_val)) \
            if self.max_val else self.length
        if num_bars != self.cur_num_bars:
            self.cur_num_bars = num_bars
            self.string = '█' * num_bars + '░' * (self.length - num_bars)

    def __repr__(self):
        return self.string
