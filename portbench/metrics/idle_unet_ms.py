"""Device idle ms a traced step while the innermost program span on the
host is `I2VGenXLUNet` or `I2VGenXLUNet/...` (the UNet forward outside
the int8 glue; portbench/spans.py)."""

from portbench.spans import idle_ms_per_step


def read(r):
    return idle_ms_per_step(r, "I2VGenXLUNet")
