"""Device idle ms a traced step while the innermost program span on the
host is `int8/...` (the int8 layers: activation quantize, im2col, bias and
K3's host work and launch; portbench/spans.py)."""

from portbench.spans import idle_ms_per_step


def read(r):
    return idle_ms_per_step(r, "int8")
