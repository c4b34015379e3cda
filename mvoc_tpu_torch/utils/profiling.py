"""Profiling and run records of the CLIs (the port's own copy of
mvoc_tpu/utils/profiling.py, over torch.profiler):

  * `trace(dir)`: torch.profiler around a block, written as a Chrome trace
    (trace.json) into `dir`;
  * `StepTimer`: wall-clock time per named stage, with a JSON summary;
  * `save_run_config`: the merged config beside the outputs, so that every
    run can be repeated from its artifacts.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any

logger = logging.getLogger("mvoc_tpu_torch.profiling")


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """A torch.profiler trace of the block (CPU, and CUDA when present) into
    trace_dir/trace.json when a directory is given, else nothing."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s", path)


class StepTimer:
    """Accumulates named wall-clock stage timings."""

    def __init__(self):
        self.records: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.records[name] = self.records.get(name, 0.0) + dt
            logger.info("[timing] %s: %.3fs", name, dt)

    def summary(self) -> dict[str, float]:
        return dict(self.records)

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


def save_run_config(config: Any, out_dir: str, name: str = "run_config.yaml") -> str:
    from mvoc_tpu_torch import config as cfglib

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        if hasattr(config, "_data"):
            f.write(cfglib.to_yaml(config))
        else:
            json.dump(config, f, indent=2, default=str)
    return path
