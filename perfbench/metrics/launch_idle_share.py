"""launch_idle_share (%): the share of the profiled stretch in which the
card idled while the training thread was inside the program's superstep
(its ``zoo.superstep`` span, utils/profiling.py): the gaps between the
card's events, on their union as ``Trace.idle_gaps`` builds it and every gap
counted, that open inside such a span, 100 · Σ their seconds / the
stretch's seconds (device_idle_share's denominator). Nothing to read where
the program records no such span."""
from __future__ import annotations

import bisect
from typing import Iterable, Optional


def idle_share_opening_in(trace, names: Iterable[str]) -> Optional[float]:
    """100 · the seconds of the card's idle gaps that open while one of the
    host spans ``names`` is open / the stretch's seconds; None where the
    trace holds no such span or no card event."""
    names = set(names)
    within = sorted((s, e) for name, s, e, _ in trace.host_ops
                    if name in names)
    if not within or not trace.kernels or trace.stretch_s <= 0:
        return None
    merged = []                 # the spans' union: nested ones count once
    for s, e in within:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    idle_us, end = 0.0, None
    for s, e in sorted((s, e) for _, s, e in trace.kernels):
        if end is not None and s > end:
            i = bisect.bisect_right(starts, end) - 1
            if i >= 0 and end < merged[i][1]:
                idle_us += s - end
        end = e if end is None else max(end, e)
    return 100.0 * idle_us / 1e6 / trace.stretch_s


def read(ctx):
    return idle_share_opening_in(ctx.trace, ("zoo.superstep",))
