"""What one run records, for the metric readers (``metrics/*.py``).

A reader takes the :class:`Run` and returns its number, or None where the
run has nothing for it to read (a kernel the path did not launch, a trace
that lost events).  The arithmetic the readers share is here, so that
every metric of one kind is computed the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

GIB = 2 ** 30


@dataclasses.dataclass
class Run:
    cell: str
    mode: str
    seed: int
    seconds: float
    trace: bool
    t0: float
    setup_s: float = 0.0
    # the window, host clock: (start, end) of every call or step in it,
    # and the items (frames or images) each completed
    calls: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    items_per_call: int = 0
    # items of calls or steps that failed (a skipped non-finite step)
    failed: int = 0
    # host seconds the loop waited for its input (the loader), per step
    waits: List[float] = dataclasses.field(default_factory=list)
    # torch.cuda.max_memory_allocated() over the window, and over the run
    window_peak_bytes: int = 0
    memory_peak_bytes: int = 0
    # the frozen count of the cell's work: FLOPs an item (yardstick.py)
    flops_per_item: float = 0.0
    # kernel name -> least seconds a call or step of its launches could
    # take at the cell's shapes (yardstick.py), and launches per call
    kernel_bounds: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the profiled slice after the window (trace.py), with --trace 1
    device_trace: Optional[object] = None

    @property
    def window_s(self) -> float:
        """From the first call's start to the last one's end."""
        return self.calls[-1][1] - self.calls[0][0] if self.calls else 0.0

    @property
    def attempted(self) -> int:
        return len(self.calls) * self.items_per_call

    @property
    def items_per_s(self) -> float:
        """Every item completed in the window over the window's length
        (failed items are not completed)."""
        done = self.attempted - self.failed
        return done / self.window_s if self.window_s > 0 else 0.0

    def call_ms(self) -> List[float]:
        return [(end - start) * 1e3 for start, end in self.calls]


def quantile(values: List[float], q: float) -> float:
    """The `q` quantile (0 < q < 1) of `values` by linear interpolation
    between order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError('quantile of no values')
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mfu(run: Run, peak_flops: float) -> Optional[float]:
    """Percent of `peak_flops` that the frozen work an item at the
    window's rate is: the whole step's share of the card's peak."""
    if not run.flops_per_item or not run.calls:
        return None
    return run.flops_per_item * run.items_per_s / peak_flops * 100


def idle_share(run: Run) -> Optional[float]:
    """Percent of the profiled slice in which no operation ran on the
    card: one less the device's busy seconds (the union of its kernels,
    copies and sets) over the slice's own length, both of one trace, as
    ``device.busy_s`` and ``device.window_s`` give them.  None where the
    profile lost kernel events."""
    t = run.device_trace
    if t is None or t.lost or t.window_s <= 0:
        return None
    return (1 - t.busy_s / t.window_s) * 100


def roofline(run: Run, symbol: str) -> Optional[float]:
    """Percent of a kernel's time that its least time at the cell's shapes
    is (``yardstick.py``): the bound of a call's launches over the
    kernel's device time a call in the profiled slice.  None where the
    path did not launch it or the profile kept another number of its
    events than the program's counter launched."""
    t = run.device_trace
    if t is None or symbol not in run.kernel_bounds:
        return None
    launches = run.kernel_launches.get(symbol, 0)
    seconds, events = t.kernel_seconds(symbol)
    if not launches or events != launches * t.calls or seconds <= 0:
        return None
    return run.kernel_bounds[symbol] / (seconds / t.calls) * 100
