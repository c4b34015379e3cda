"""What a run hands the per-layer metric readers (portbench/metrics/*.py,
one file per metric, each `read(r: Readings) -> float | None`: None where
it finds nothing to read, and the harness then leaves the metric out)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from portbench.reference.count import StepCount
from portbench.trace import Stretch


@dataclasses.dataclass
class Readings:
    """seconds: the window; steps: the steps the device finished in it
    (fractional: the step in flight at its close counts its share);
    entries: videos or composites each step carries; step_intervals: device
    seconds between consecutive steps of one call; count: one step's
    operations and launches (portbench/reference/count.py); act_bytes:
    bytes of an activation element; stretch: the traced steps, if any."""

    seconds: float
    steps: float
    entries: int
    step_intervals: list
    count: Optional[StepCount]
    act_bytes: int
    stretch: Optional[Stretch]
