"""95th percentile of how late the traffic generator pushed each chunk into
the rings, against its schedule, in ms."""

from benchmark.stats import percentile


def read(run):
    return percentile(run.lags_ms, 0.95) if run.lags_ms else None
