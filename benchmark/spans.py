"""Per-layer readings from the program's own spans and counters (the
recorder of ``yolact_tpu_torch/utils/timer.py``).

The recorder records while a profiler session does, so the profiled
slice (``trace.profile``) leaves one root span a call; its first pass,
which records the CUDA activity alone, made the first ``calls`` of them.
A reading is the median over those calls.  None where the run has no
trace, the program has no recorder (an older tree) or made fewer roots,
or the span never ran or ran off a CUDA device.
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def first_pass_roots(run, root: str) -> Optional[List]:
    """The recorder's roots named `root` of the slice's first pass."""
    t = run.device_trace
    if t is None:
        return None
    from yolact_tpu_torch.utils import timer
    read = getattr(timer, 'roots', None)
    if read is None:
        return None
    roots = [r for r in read() if r.name == root][:t.calls]
    return roots if roots and len(roots) == t.calls else None


def span_ms(run, name: str, root: str = 'call') -> Optional[float]:
    """The median device ms a call of the span `name` (summed within a
    call)."""
    roots = first_pass_roots(run, root)
    if roots is None:
        return None
    ms = [r.device_ms(name) for r in roots]
    return None if None in ms else statistics.median(ms)


def counter(run, name: str, root: str = 'call') -> Optional[float]:
    """The median count a call of the counter `name` (0 where a call
    took none)."""
    roots = first_pass_roots(run, root)
    if roots is None:
        return None
    return statistics.median(r.counter(name) or 0 for r in roots)
