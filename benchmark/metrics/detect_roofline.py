"""The map-mode detect kernel's share of its bandwidth roofline, in %: the
bytes its call must move (``roofline.detect_bytes`` of the map's shape) at
3.35 TB/s, over the mean device time of its records in the trace."""

from benchmark import roofline


def read(run):
    if run.trace is None:
        return None
    hits = [v for k, v in run.trace["kernels"].items()
            if roofline.DETECT_KERNEL in k]
    count = sum(n for _, n in hits)
    if not count:
        return None
    g = run.geometry
    return roofline.detect_roofline_pct(
        g.nd, g.delay_max - g.delay_min + 1, sum(s for s, _ in hits) / count)
