"""Profiling and run records of the CLIs (the port's own copy of
mvoc_tpu/utils/profiling.py, over torch.profiler):

  * `trace(dir)`: torch.profiler around a block, written as a Chrome trace
    (trace.json) into `dir`;
  * `device_op_breakdown(dir)`: that trace's device time by kernel group
    (`KERNEL_GROUPS`) and by UNet module;
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
from bisect import bisect_right
from collections import defaultdict
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


# kernel-name fragments -> the group a kernel's device time is booked under
# (first match wins; lower-cased names)
KERNEL_GROUPS = (("flash_", "K1 flash attention"), ("frame_", "K2 frame attention"),
                 ("s8_", "K3 s8 GEMM"), ("conv", "convolution"), ("fprop", "convolution"),
                 ("implicit", "convolution"), ("gemm", "GEMM"), ("cutlass", "GEMM"),
                 ("cublas", "GEMM"), ("nvjet", "GEMM"), ("norm", "normalisation"),
                 ("reduce", "reductions"),
                 ("copy", "copies and layout"), ("cat", "copies and layout"),
                 ("elementwise", "elementwise"), ("vectorized", "elementwise"))
UNET_SCOPE = "I2VGenXLUNet/"  # the UNet forward's profiler scopes (models/unet_i2vgen.py)
OUTSIDE = "(outside unet)"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def kernel_group(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in KERNEL_GROUPS if frag in low), "other")


class _Scopes:
    """The UNet scopes of one host thread, to find the innermost one around
    an instant."""

    def __init__(self, events):
        events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in events]
        self.ends = [e["ts"] + e["dur"] for e in events]
        self.names = [e["name"][len(UNET_SCOPE):].split("/")[0] for e in events]
        self.parent, stack = [], []
        for i, e in enumerate(events):
            while stack and self.ends[stack[-1]] <= e["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, ts: float) -> str:
        # the last scope opened by ts, else the innermost one around it,
        # which (scopes nest) encloses that one
        i = bisect_right(self.starts, ts) - 1
        while i >= 0 and self.ends[i] < ts:
            i = self.parent[i]
        return self.names[i] if i >= 0 else OUTSIDE


def _self_times(events):
    """(event, self time) of one thread's cpu_op events: each op's duration
    less its children's (a child is an op that starts inside another), so
    nested ops count nothing twice."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    own = [e["dur"] for e in events]
    stack = []
    for i, e in enumerate(events):
        while stack and events[stack[-1]]["ts"] + events[stack[-1]]["dur"] <= e["ts"]:
            stack.pop()
        if stack:
            own[stack[-1]] -= e["dur"]
        stack.append(i)
    return [(e, max(0.0, t)) for e, t in zip(events, own)]


def device_op_breakdown(trace_dir: str, top: int = 25) -> dict[str, Any]:
    """Where the time of the newest `trace.json` under `trace_dir` (what
    `trace()` and the CLIs' --profile_dir write) went: device time by kernel
    group (`by_category`, KERNEL_GROUPS) and by top-level UNet child
    (`by_module`: `conv_in`, `down_blocks.0`, `mid_block`, `up_blocks.3`, ...,
    and "(outside unet)"), the two crossed (`by_module_category`), and the
    `top` kernels by time (`top_ops`), all in seconds, with `total_s` and
    the `trace` read.  A kernel is booked to the module whose profiler
    scope (models/unet_i2vgen.py) was innermost around its launch on the
    host: its correlation id names the launch.  A trace without device
    kernels (a CPU run) books the host's ops instead, each by its self time
    (its duration less its children's) to the scope around its start.  Every event is counted once, so by_category and
    by_module each sum to total_s.  (The counterpart of the JAX package's
    function over its perfetto traces.)"""
    import glob

    paths = glob.glob(os.path.join(trace_dir, "**", "trace.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace.json under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    by_thread = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(UNET_SCOPE):
            by_thread[(e["pid"], e["tid"])].append(e)
    scopes = {k: _Scopes(v) for k, v in by_thread.items()}

    def scope_at(pid, tid, ts):
        s = scopes.get((pid, tid))
        return s.at(ts) if s is not None else OUTSIDE

    booked = []  # (name, duration in µs, module)
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if device:
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
        for e in device:
            launch = launches.get(e.get("args", {}).get("correlation"))
            module = (scope_at(launch["pid"], launch["tid"], launch["ts"])
                      if launch is not None else OUTSIDE)
            booked.append((e["name"], e["dur"], module))
    else:
        ops = defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op":
                ops[(e["pid"], e["tid"])].append(e)
        for (pid, tid), thread_ops in ops.items():
            for e, own in _self_times(thread_ops):
                booked.append((e["name"], own, scope_at(pid, tid, e["ts"])))

    cat, mod, names = defaultdict(float), defaultdict(float), defaultdict(float)
    cross = defaultdict(lambda: defaultdict(float))
    for name, dur, module in booked:
        group = kernel_group(name)
        cat[group] += dur
        mod[module] += dur
        names[name] += dur
        cross[module][group] += dur
    us = 1e6

    def table(d, n=None):
        return {k: v / us for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}

    return {"trace": path, "total_s": sum(dur for _, dur, _ in booked) / us,
            "by_category": table(cat), "by_module": table(mod),
            "by_module_category": {m: table(cross[m]) for m in table(mod)},
            "top_ops": table(names, top)}


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
