"""Profiling and run records of the CLIs (the port's own copy of
mvoc_tpu/utils/profiling.py, over torch.profiler):

  * `span(name)`: a `record_function` scope while a torch profiler
    records, else a shared no-op (one flag read): the port's spans at its
    layer boundaries, on the profiler's clock beside the device's kernels;
  * `trace(dir)`: torch.profiler around a block, written as a Chrome trace
    (trace.json) into `dir`;
  * `device_op_breakdown(dir)`: that trace's device time by kernel group
    (`KERNEL_GROUPS`), by UNet module, by the innermost span and by the
    aten op around each kernel's launch;
  * `StepTimer`: wall-clock time per named stage, each stage a span too;
  * `save_run_config`: the merged config beside the outputs, so that every
    run can be repeated from its artifacts.

The spans, by layer (their names are read by name by the benchmark's
readers too, so they are a contract):

  entry points  `entry/<entry point>` around each call of sample_composite,
                sample_composite_batch, invert and invert_batch; inside
                them `entry/encode_prompt`, `entry/encode_image` (CLIP),
                `entry/encode_vae`, `entry/trajectory_upload`,
                `entry/mask_pyramids`, `entry/decode`;
  step loops    `step` around one step's body (closed before the step
                callback), inside it `step/fusion`, `step/capture`,
                `step/edit`, `step/guidance_ddim`;
  models        `I2VGenXLUNet` around the UNet forward, its top-level
                children `I2VGenXLUNet/<child>` and their sub-blocks
                `I2VGenXLUNet/<child>/<sub>` (resnets.i, attentions.i,
                temp_convs.i, temp_attentions.i, upsamplers.0,
                downsamplers.0);
  int8 glue     `int8/linear` / `int8/conv` around each quantized layer,
                inside them `int8/quantize`, `int8/im2col`,
                `int8/s8_matmul` (K3's host work and launch);
  CLI stages    `stage/<name>` around each StepTimer stage.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from bisect import bisect_right
from collections import defaultdict
from typing import Any

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("mvoc_tpu_torch.profiling")


# the first component of every span name of the port (see the module doc)
SPAN_ROOTS = ("entry", "stage", "step", "I2VGenXLUNet", "int8")
NO_SPAN = "(no span)"
NO_OP = "(no aten op)"
_NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """`record_function(name)` while a torch profiler records, else one
    shared no-op context: with the profiler off a span costs one read of
    the flag torch.autograd.profiler sets while a profiler is enabled."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL_SPAN


def spanned(name: str):
    """A decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def is_span(name: str) -> bool:
    """Whether a profiler event's name is one of the port's spans."""
    return name.split("/", 1)[0] in SPAN_ROOTS


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """A torch.profiler trace of the block (CPU, and CUDA when present) into
    trace_dir/trace.json when a directory is given, else nothing."""
    if not trace_dir:
        yield
        return
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
    """Nested scopes of one host thread (events named by `name(event)`), to
    find the innermost one around an instant (`outside` where none is)."""

    def __init__(self, events, name, outside: str):
        events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in events]
        self.ends = [e["ts"] + e["dur"] for e in events]
        self.names = [name(e) for e in events]
        self.outside = outside
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
        return self.names[i] if i >= 0 else self.outside


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
    `trace()` and the CLIs' --profile_dir write) went, in seconds: device
    time by kernel group (`by_category`, KERNEL_GROUPS), by top-level UNet
    child (`by_module`: `conv_in`, `down_blocks.0`, `mid_block`,
    `up_blocks.3`, ..., and "(outside unet)"), by the innermost span around
    the launch at its full name (`by_span`: `I2VGenXLUNet/up_blocks.3/
    resnets.0`, `int8/s8_matmul`, `step/fusion`, `entry/encode_vae`, ...,
    and "(no span)"), by the innermost aten op around the launch (`by_op`:
    "(no aten op)" where none is, as for K1-K3, launched through ctypes),
    module, span and op each crossed with the groups (`by_module_category`,
    `by_span_category`, `by_op_category`), and the `top` kernels by time
    (`top_ops`), with `total_s` and the `trace` read.  A kernel is booked
    through its correlation id to its launch on the host and the scopes
    open around that launch on the launching thread.  A trace without
    device kernels (a CPU run) books the host's ops instead, each by its
    self time (its duration less its children's) to the scopes around its
    start, and to itself in by_op.  Every event is counted once, so each
    table sums to total_s.  (The counterpart of the JAX package's function
    over its perfetto traces.)"""
    import glob

    paths = glob.glob(os.path.join(trace_dir, "**", "trace.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace.json under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    units, spans, ops = defaultdict(list), defaultdict(list), defaultdict(list)
    for e in events:
        thread = (e["pid"], e["tid"])
        if e.get("cat") == "user_annotation" and is_span(e["name"]):
            spans[thread].append(e)
            if e["name"].startswith(UNET_SCOPE):
                units[thread].append(e)
        elif e.get("cat") == "cpu_op":
            ops[thread].append(e)
    scopes = {  # per table: {thread: _Scopes}
        "module": {k: _Scopes(v, lambda e: e["name"][len(UNET_SCOPE):].split("/")[0], OUTSIDE)
                   for k, v in units.items()},
        "span": {k: _Scopes(v, lambda e: e["name"], NO_SPAN) for k, v in spans.items()},
        "op": {k: _Scopes(v, lambda e: e["name"], NO_OP) for k, v in ops.items()}}
    outside = {"module": OUTSIDE, "span": NO_SPAN, "op": NO_OP}

    def around(table, thread, ts):
        s = scopes[table].get(thread)
        return s.at(ts) if s is not None else outside[table]

    booked = []  # (name, duration in µs, module, span, op)
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if device:
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
        for e in device:
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                booked.append((e["name"], e["dur"], OUTSIDE, NO_SPAN, NO_OP))
                continue
            thread, ts = (launch["pid"], launch["tid"]), launch["ts"]
            booked.append((e["name"], e["dur"], around("module", thread, ts),
                           around("span", thread, ts), around("op", thread, ts)))
    else:
        for thread, thread_ops in ops.items():
            for e, own in _self_times(thread_ops):
                booked.append((e["name"], own, around("module", thread, e["ts"]),
                               around("span", thread, e["ts"]), e["name"]))

    cat, names = defaultdict(float), defaultdict(float)
    by = {k: defaultdict(float) for k in outside}
    cross = {k: defaultdict(lambda: defaultdict(float)) for k in outside}
    for name, dur, *keys in booked:
        group = kernel_group(name)
        cat[group] += dur
        names[name] += dur
        for table, key in zip(outside, keys):
            by[table][key] += dur
            cross[table][key][group] += dur
    us = 1e6

    def table(d, n=None):
        return {k: v / us for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}

    out = {"trace": path, "total_s": sum(b[1] for b in booked) / us,
           "by_category": table(cat)}
    for t in outside:
        out[f"by_{t}"] = table(by[t])
        out[f"by_{t}_category"] = {k: table(cross[t][k]) for k in out[f"by_{t}"]}
    out["top_ops"] = table(names, top)
    return out


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates named wall-clock stage timings.  Each stage is also the
    span `stage/<name>`, and on CUDA it synchronises at its start and end,
    so that it times the stage's device work, not its enqueue."""

    def __init__(self):
        self.records: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            with span(f"stage/{name}"):
                yield
                _sync()
        finally:
            dt = time.perf_counter() - t0
            self.records[name] = self.records.get(name, 0.0) + dt
            logger.info("[timing] %s: %.3fs", name, dt)

    def summary(self) -> dict[str, float]:
        return dict(self.records)


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
