"""Mean over the window's judged fused CPIs of the timing product's
``device`` key, in ms: a CPI's time on the card by two timing CUDA events
the program records on its compute stream (at the start of its graph's
body, after its product copies). Staged samples (``dispatch`` 0) are left
out: their ``device`` is the host's wall of four stages, each waited for.
None where the program's timing product has no such key."""

from statistics import fmean


def read(run):
    vals = [doc["device"] for doc in run.timing
            if "device" in doc and doc.get("dispatch", 0.0) > 0.0]
    return fmean(vals) if vals else None
