"""Device idle ms a traced step while the innermost program span on the
host is `step` or `step/...` (the step loops: noise fusion, the capture
bookkeeping, guidance and the DDIM update; portbench/spans.py)."""

from portbench.spans import idle_ms_per_step


def read(r):
    return idle_ms_per_step(r, "step")
