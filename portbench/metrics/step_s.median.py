"""Median device seconds between consecutive steps of one call in the
window (the step loops: pipeline/core.py, pnp.py)."""

import statistics


def read(r):
    return statistics.median(r.step_intervals) if r.step_intervals else None
