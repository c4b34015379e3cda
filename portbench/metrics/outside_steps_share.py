"""Share of the window, in %, outside the steps: the calls' preparation
(encodes, trajectory upload, mask pyramids) at the entry points:
100 * (1 - steps * median step seconds / window)."""

import statistics


def read(r):
    if not r.step_intervals or r.seconds <= 0:
        return None
    return 100.0 * (1.0 - r.steps * statistics.median(r.step_intervals) / r.seconds)
