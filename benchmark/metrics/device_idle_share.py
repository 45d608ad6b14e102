"""1 - the union of kernels, copies and memsets in the profiler's trace over
the traced window's length (``trace.py``)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
