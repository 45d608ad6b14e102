"""The arithmetic of the end-to-end metrics, kept apart so tests can hold
it to hand-made cases."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Sequence

#: An age that cannot be a number (a CPI never served) is reported as this
#: many ms when a percentile falls on it; ``failed`` counts such CPIs.
NEVER_MS = 1e9


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-quantile (0..1) of ``values`` by linear interpolation
    between order statistics; ``inf`` entries sort last and count."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    pos = q * (len(v) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if v[hi] == math.inf:
        return math.inf if pos > lo or v[lo] == math.inf else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def ages_ms(due: Dict[int, float], held: Dict[int, float],
            t_end: float, lost_from: Optional[int] = None) -> List[float]:
    """Per CPI due by ``t_end``: held − due in ms, or inf where it was never
    held or a ring dropped samples at or before it (``lost_from``)."""
    out = []
    for k, t_due in sorted(due.items()):
        if t_due > t_end:
            continue
        if (lost_from is not None and k >= lost_from) or k not in held:
            out.append(math.inf)
        else:
            out.append((held[k] - t_due) * 1e3)
    return out


def reported(value: float) -> float:
    return NEVER_MS if value == math.inf else value


def throughput_msps(held: Iterable[float], t0: float, t_end: float,
                    samples_per_cpi: int) -> float:
    """Samples (a channel) of every CPI held within [t0, t_end], over the
    window's seconds, in millions a second."""
    count = sum(1 for t in held if t0 <= t <= t_end)
    return count * samples_per_cpi / (t_end - t0) / 1e6


def spread(values: Sequence[float]) -> float:
    """Quartile distance over the median, as ``statistics.quantiles`` gives
    the quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
