"""The union of kernels, copies and memsets in the traced window, in ms,
over the CPIs the API held in that window (all of them, judged or not)."""


def read(run):
    if run.trace is None or not run.trace_cpis:
        return None
    return run.trace["busy_s"] * 1e3 / run.trace_cpis
