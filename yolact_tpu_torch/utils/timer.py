"""The port's span and counter recorder, grown from the hierarchical host
timer of ``yolact_tpu/utils/timer.py``.

Two ways in, one stack of frames per thread:

* ``env`` / ``start`` / ``stop`` are the reference timer's contract: they
  always run, and starting a timer pauses the enclosing one, so the
  totals ``print_stats`` renders (the eval loop's ``--benchmark`` table)
  are exclusive host time.  ``stop(name)`` raises unless `name` is the
  frame on top.
* ``span(name)`` marks a layer boundary of the hot path.  It records only
  while a ``torch.profiler`` session records (``torch.autograd.
  _profiler_enabled()``) or inside a ``recording()`` block, and never
  while ``torch.export`` or ``torch.compile`` traces.  Off, a span costs
  that check and returns a shared null context: no allocation, no CUDA
  event, no ``record_function``, no synchronize.

While recording, every frame, ``env``'s too, is a :class:`Span`: its name,
its parent, host start and end (``time.perf_counter_ns``) and its self
time (duration less its children's).  A frame with no recorded parent is
a root, and a :class:`Root` holds the spans of its tree under one id, with
the counters (``count``) taken inside it.  Under a profiler each span
opens a ``torch.profiler.record_function`` range of its name, so the
spans sit in the profile on the device trace's clock, and the GPU user
annotations they leave bracket the kernels they launched (a range costs
more host time than the rest of a span, and records nothing without a
profiler).  On a CUDA device (the root's
``device``, which its spans inherit) a span records a timing
``torch.cuda.Event`` on the current stream at entry and exit: its
:attr:`Span.device_ms` is the stream's interval for the layer on the
device clock, idle inside it included, read lazily, after the caller's
own synchronize.  Elsewhere it is None.

The recorder keeps the first ``MAX_ROOTS`` roots of a recording (since
``reset()``, or since the outermost ``recording()`` began) and counts the
roots it dropped after them.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Union

import torch

from yolact_tpu_torch.kernels._build import tracing

MAX_ROOTS = 1024

# exclusive host seconds by frame name, in the order first started
_total: "OrderedDict[str, float]" = OrderedDict()
_roots: List["Root"] = []
_dropped = 0
_forced = 0                     # depth of recording() blocks
_ids = itertools.count()
_local = threading.local()      # .stack: this thread's open frames
_lock = threading.Lock()        # the totals and the roots, across threads
_OFF = nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class Root:
    """The recorded tree of one root frame: its spans in the order they
    opened (the root first) and the counters taken inside it."""

    __slots__ = ('id', 'spans', 'counters', 'kept')

    def __init__(self, kept: bool):
        self.id = next(_ids)
        self.spans: List[Span] = []
        self.counters: Dict[str, object] = {}
        self.kept = kept

    @property
    def name(self) -> str:
        return self.spans[0].name

    def counter(self, name: str) -> Optional[float]:
        """The counter's total in this tree (a count summed on the device
        is read here), or None where it was never taken."""
        v = self.counters.get(name)
        return v.item() if isinstance(v, torch.Tensor) else v

    def device_ms(self, name: str) -> Optional[float]:
        """Device ms of the spans called `name`, summed; None where none
        ran or none was on a CUDA device."""
        ms = [s.device_ms for s in self.spans if s.name == name]
        ms = [m for m in ms if m is not None]
        return sum(ms) if ms else None


class Span:
    """One frame of the stack; recorded (``root`` set) while recording."""

    __slots__ = ('name', 'device', 'parent', 'root', 'start_ns', 'end_ns',
                 'child_ns', '_events', '_range')

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.parent: Optional[Span] = None
        self.root: Optional[Root] = None
        self.start_ns = self.end_ns = self.child_ns = 0
        self._events = self._range = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_host_ms(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])

    def __enter__(self) -> 'Span':
        _open(self, True)      # span() made it while recording
        return self

    def __exit__(self, *exc) -> None:
        _close(self)


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def active() -> bool:
    """Whether spans and counters record now (the module docstring)."""
    return bool(_forced or _profiler_enabled()) and not tracing()


def _record(s: Span, parent: Optional[Span]) -> None:
    global _dropped
    if parent is not None and parent.root is not None:
        s.parent, s.root = parent, parent.root
        if s.device is None:
            s.device = parent.device
    else:
        with _lock:
            s.root = Root(kept=len(_roots) < MAX_ROOTS)
            if s.root.kept:
                _roots.append(s.root)
            else:
                _dropped += 1
    if _profiler_enabled():
        s._range = torch.profiler.record_function(s.name)
        s._range.__enter__()
    if not s.root.kept:
        return
    s.root.spans.append(s)
    if s.device is not None and s.device.type == 'cuda':
        stream = torch.cuda.current_stream(s.device)
        s._events = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
        s._events[0].record(stream)


def _open(s: Span, record: bool) -> None:
    stack = _stack()
    _total.setdefault(s.name, 0.0)      # one call: atomic under the GIL
    if record:
        _record(s, stack[-1] if stack else None)
    stack.append(s)
    s.start_ns = time.perf_counter_ns()


def _close(s: Span) -> None:
    end = time.perf_counter_ns()
    stack = _stack()
    if not stack or stack[-1] is not s:
        top = stack[-1].name if stack else None
        raise RuntimeError(f'timer: {s.name!r} stopped while {top!r} is '
                           f'the open frame')
    stack.pop()
    s.end_ns = end
    duration = end - s.start_ns
    with _lock:
        _total[s.name] = _total.get(s.name, 0.0) + \
            (duration - s.child_ns) / 1e9
    if stack:
        stack[-1].child_ns += duration
    if s._events is not None:
        s._events[1].record(torch.cuda.current_stream(s.device))
    if s._range is not None:
        s._range.__exit__(None, None, None)


def span(name: str, device: Union[str, torch.device, None] = None):
    """A layer's span, to use as ``with timer.span(name):``.  `device`
    (a root's): where its spans record CUDA events; a child inherits its
    parent's."""
    if not (_forced or _profiler_enabled()) or tracing():
        return _OFF
    return Span(name, device)


def count(name: str, n: Union[int, float, torch.Tensor] = 1) -> None:
    """Add `n` to the counter `name` of the open root, while recording.
    A device tensor is summed on the device and read when exported; a
    counter taken outside any recorded frame is not kept."""
    if not (_forced or _profiler_enabled()) or tracing():
        return
    stack = _stack()
    root = stack[-1].root if stack else None
    if root is not None and root.kept:
        root.counters[name] = root.counters.get(name, 0) + n


def count_copy(src, device: Union[str, torch.device]) -> None:
    """Count ``h2d_bytes`` and ``h2d_pageable_bytes`` of copying `src` (a
    numpy array or a tensor) from the host to a CUDA `device`, while
    recording.  Host memory is pageable unless it is a pinned tensor."""
    if not active() or torch.device(device).type != 'cuda':
        return
    pinned = False
    if isinstance(src, torch.Tensor):
        if src.device.type != 'cpu':
            return
        pinned = src.is_pinned()
    n = getattr(src, 'nbytes', 0)
    count('h2d_bytes', n)
    if not pinned:
        count('h2d_pageable_bytes', n)


@contextmanager
def recording():
    """Record spans and counters without a profiler: for operators and
    probes.  The outermost block starts a new recording (its roots only)."""
    global _forced
    if not _forced:
        _clear_roots()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def roots() -> List[Root]:
    """The kept roots of the recording, in the order they opened."""
    return list(_roots)


def dropped() -> int:
    """Roots recorded past ``MAX_ROOTS`` and not kept."""
    return _dropped


def _clear_roots() -> None:
    global _dropped
    with _lock:
        _roots.clear()
        _dropped = 0


def reset() -> None:
    """Forget the totals, the recording and this thread's open frames."""
    _total.clear()
    _clear_roots()
    _stack().clear()


def start(name: str) -> None:
    _open(Span(name), active())


def stop(name: Optional[str] = None) -> None:
    """Stop the open frame; with `name`, raise unless it is that frame."""
    stack = _stack()
    if not stack or (name is not None and stack[-1].name != name):
        top = stack[-1].name if stack else None
        raise RuntimeError(f'timer: stop({name!r}) while {top!r} is the '
                           f'open frame')
    _close(stack[-1])


@contextmanager
def env(name: str):
    start(name)
    try:
        yield
    finally:
        stop(name)


def total_time() -> float:
    return sum(_total.values())


def device_totals() -> Dict[str, float]:
    """Exclusive device ms by span name over the kept roots: each span's
    device interval less its recorded children's."""
    out: Dict[str, float] = defaultdict(float)
    for root in _roots:
        ms = {id(s): s.device_ms for s in root.spans}
        inner: Dict[int, float] = defaultdict(float)
        for s in root.spans:
            if s.parent is not None and ms[id(s)] is not None:
                inner[id(s.parent)] += ms[id(s)]
        for s in root.spans:
            if ms[id(s)] is not None:
                out[s.name] += ms[id(s)] - inner[id(s)]
    return dict(out)


def print_stats() -> None:
    if not _total:
        print(' No timing data ')
        return
    device = device_totals()
    width = max(max(len(k) for k in _total), 30)
    extra = ' | Device (ms)' if device else ''
    print()
    print(f'{"Timer":>{width}} | Time (ms){extra}')
    print('-' * (width + 13 + len(extra)))
    for k, v in _total.items():
        cell = f' | {device[k]:11.2f}' if k in device else ''
        print(f'{k:>{width}} | {v * 1000:9.2f}{cell}')
    print('-' * (width + 13 + len(extra)))
    print(f'{"Total":>{width}} | {total_time() * 1000:9.2f}')
    print()
