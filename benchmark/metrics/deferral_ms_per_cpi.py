"""Mean over the window's judged CPIs of the timing product's ``deferral``
key, in ms: how long a CPI's products wait on the card, from the end of
its dispatch to the start of the flush that emits them, behind the next
CPI (``runtime/radar.py``). None where the program's timing product has
no such key."""

from statistics import fmean


def read(run):
    vals = [doc["deferral"] for doc in run.timing if "deferral" in doc]
    return fmean(vals) if vals else None
