"""Small host-side helpers of the eval and train loops: moving average,
progress bar and the checkpoint filename codec, the port's copy of
``yolact_tpu/utils/functions.py``.  Behavioural parity with the reference
``utils/functions.py``."""

from __future__ import annotations

import math
import os
from collections import deque
from pathlib import Path
from typing import Optional


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


class SavePath:
    """Checkpoint filename codec ``<config>_<epoch>_<iter>.<ext>``
    (utils/functions.py:98-161), extended to the JAX package's .ckpt
    extension.  The port's trainer names its checkpoints ``.pth``."""

    EXTS = ('.pth', '.ckpt', '.npz', '.msgpack')

    def __init__(self, model_name: str, epoch: int, iteration: int,
                 ext: str = '.ckpt'):
        self.model_name = model_name
        self.epoch = epoch
        self.iteration = iteration
        self.ext = ext

    def get_path(self, root: str = '') -> str:
        name = f'{self.model_name}_{self.epoch}_{self.iteration}{self.ext}'
        return os.path.join(root, name)

    @staticmethod
    def from_str(path: str) -> 'SavePath':
        file_name = os.path.basename(path)
        ext = '.ckpt'
        for e in SavePath.EXTS:
            if file_name.endswith(e):
                ext = e
                file_name = file_name[:-len(e)]
                break
        params = file_name.split('_')
        if file_name.endswith('interrupt'):
            params = params[:-1]
        model_name = '_'.join(params[:-2])
        return SavePath(model_name, int(params[-2]), int(params[-1]), ext)

    @staticmethod
    def remove_interrupt(save_folder: str):
        for p in Path(save_folder).glob('*_interrupt.*'):
            p.unlink()

    @staticmethod
    def get_interrupt(save_folder: str) -> Optional[str]:
        for p in Path(save_folder).glob('*_interrupt.*'):
            return str(p)
        return None

    @staticmethod
    def get_latest(save_folder: str, config: str) -> Optional[str]:
        max_iter, max_name = -1, None
        for p in Path(save_folder).glob(config + '_*'):
            try:
                save = SavePath.from_str(str(p))
            except Exception:
                continue
            if save.model_name == config and save.iteration > max_iter:
                max_iter = save.iteration
                max_name = str(p)
        return max_name
