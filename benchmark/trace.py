"""The profiled slice: ``torch.profiler`` over a few calls or steps after
the window, and what the per-layer metrics read from it.

Device events are the profiler's CUDA kernels, copies and sets (the
annotations that ``record_function`` ranges leave on the device are not
work and are left out).  Busy time is the union of their intervals; the
slice's length is the host clock's, from the first call's start to the
last call's end (each ends in a synchronize).  The slice records the
CUDA activity alone (the device's events and the runtime's calls), which
lengthens a call by a few percent where the host's operators lengthen
it by a fifth or more: its busy time, its length and its kernels' times
are all of one trace.  The profiler can lose device events on an H100:
the slice counts the host's kernel launches (the runtime and driver
launch calls it records) against the kernels it kept, a slice that lost
any is profiled again, up to ``TRIES`` times, and one that lost some
every time is flagged (``lost``), so that readers that need a whole
profile give no number.  A second pass over as many calls records the
host's operators too, and only names the idle gaps by what the host ran
in them.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch

LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaLaunchKernelExC',
            'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel')
COPIES = ('Memcpy', 'Memset')
TOP = 10
TRIES = 3
SCAN = 256         # host operations searched back for a gap's label
SHORT_GAP_US = 10  # shorter idle gaps are summed under one label


@dataclasses.dataclass
class DeviceTrace:
    calls: int
    window_s: float
    busy_s: float
    launches: int            # kernel launches the host made
    kernels: int             # kernel events the profiler kept
    # device event name -> (seconds, events)
    by_name: Dict[str, Tuple[float, int]]
    # idle gaps: what the host was running -> seconds
    gaps: Dict[str, float]

    @property
    def lost(self) -> int:
        return max(0, self.launches - self.kernels)

    def kernel_seconds(self, symbol: str) -> Tuple[float, int]:
        """(seconds, events) of the device events whose name holds
        `symbol` (a kernel's CUDA symbol)."""
        s = n = 0
        for name, (sec, count) in self.by_name.items():
            if symbol in name:
                s += sec
                n += count
        return s, n

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {'device_ops': [[k, v[0]] for k, v in ops],
                'idle_gaps': [[k, v] for k, v in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def _gap_label(cpu: List[Tuple[float, float, str]], starts: List[float],
               t: float) -> str:
    """The innermost host operation running at time `t` (µs): of the last
    few hundred to start before it, the shortest that covers it."""
    best, label = None, 'host'
    i = bisect.bisect_right(starts, t)
    for start, end, name in cpu[max(0, i - SCAN):i]:
        if end >= t and (best is None or end - start < best):
            best, label = end - start, name
    return label


def read(prof, calls: int, window_s: float) -> DeviceTrace:
    events = prof.events()
    device, cpu = [], []
    launches = kernels = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, 'is_user_annotation', False):
                continue
            device.append(e)
            if not e.name.startswith(COPIES):
                kernels += 1
        else:
            if e.name.startswith(LAUNCHES):
                launches += 1
            elif not getattr(e, 'is_user_annotation', False) and \
                    not e.name.startswith(('cuda', 'cu')):
                cpu.append((e.time_range.start, e.time_range.end, e.name))
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    intervals = []
    for e in device:
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        by_name[e.name][0] += (end - start) / 1e6
        by_name[e.name][1] += 1
    busy = _union(intervals)
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = collections.Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = (_gap_label(cpu, starts, (a + b) / 2)
                 if b - a >= SHORT_GAP_US else f'gaps under {SHORT_GAP_US} us')
        gaps[label] += (b - a) / 1e6
    return DeviceTrace(calls=calls, window_s=window_s,
                       busy_s=sum(b - a for a, b in busy) / 1e6,
                       launches=launches, kernels=kernels,
                       by_name={k: (v[0], int(v[1]))
                                for k, v in by_name.items()},
                       gaps=dict(gaps))


def _pass(call: Callable[[], None], calls: int, cpu: bool) -> DeviceTrace:
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            call()
        window_s = time.perf_counter() - start
    return read(prof, calls, window_s)


def profile(call: Callable[[], None], calls: int) -> DeviceTrace:
    """`calls` calls of `call` (each ending in a synchronize) profiled with
    the CUDA activity alone, again where it lost kernel events; its idle
    gaps named from a second pass that records the host's operators (the
    module docstring)."""
    for _ in range(TRIES):
        device = _pass(call, calls, cpu=False)
        if not device.lost:
            break
    host = _pass(call, calls, cpu=True)
    return dataclasses.replace(device, gaps=host.gaps)
