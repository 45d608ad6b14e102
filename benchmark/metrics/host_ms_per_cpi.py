"""Mean of the timing product's ``cpi`` key over the window's CPIs: the
runtime loop's host wall a CPI (extract, dispatch, fetch wait, serialising,
tracker), as ``runtime/radar.py`` measures it."""

from statistics import fmean


def read(run):
    vals = [doc["cpi"] for doc in run.timing if "cpi" in doc]
    return fmean(vals) if vals else None
