"""Hierarchical host-side timer with exclusive accounting: the port's copy
of ``yolact_tpu/utils/timer.py`` (the parts the eval loop uses).

Same contract as the reference timer (``utils/timer.py``): starting a timer
pauses the enclosing one so totals are exclusive; `env` is the context
manager around the eval loop's stages; `print_stats` renders the table of
benchmark mode.  It times the host: work queued on the card is timed where
the host waits for it.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional

_total: "OrderedDict[str, float]" = OrderedDict()
_start: Dict[str, float] = {}
_stack: List[str] = []


def start(name: str) -> None:
    now = time.perf_counter()
    if _stack:
        top = _stack[-1]
        _total[top] = _total.get(top, 0.0) + (now - _start[top])
    _stack.append(name)
    _start[name] = now
    _total.setdefault(name, 0.0)


def stop(name: Optional[str] = None) -> None:
    now = time.perf_counter()
    if not _stack:
        return
    top = _stack.pop()
    _total[top] = _total.get(top, 0.0) + (now - _start[top])
    if _stack:
        _start[_stack[-1]] = now


@contextmanager
def env(name: str):
    start(name)
    try:
        yield
    finally:
        stop(name)


def total_time() -> float:
    return sum(_total.values())


def print_stats() -> None:
    if not _total:
        print(' No timing data ')
        return
    width = max(max(len(k) for k in _total), 30)
    print()
    print(f'{"Timer":>{width}} | Time (ms)')
    print('-' * (width + 13))
    for k, v in _total.items():
        print(f'{k:>{width}} | {v * 1000:9.2f}')
    print('-' * (width + 13))
    print(f'{"Total":>{width}} | {total_time() * 1000:9.2f}')
    print()
