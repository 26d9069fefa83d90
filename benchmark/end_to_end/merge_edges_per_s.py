"""Edges retired per second over the window: the sum of E + merges of
every call completed in it over its time (bench.py's edge count, over the
whole window instead of a median of 5 calls)."""

UNIT = "edges/s"


def value(window):
    return window.rate()
