"""Run one cell of the benchmark of `mvoc_tpu_torch` once and print its
result as the last line of standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of BENCHMARK.json's `workloads`; its files are found by
name: portbench/workloads/<cell>.json (entry point, path, call geometry and
schedule, the comparison's limits) and portbench/configs/<config>.json (the
model's widths, dtype and int8 mode).  A per-layer metric is read by
portbench/metrics/<metric>.py.

A run builds the port's pipeline around weights made on the card from the
seed, makes the inputs, warms up with one call of the cell's own shapes cut
after a few steps (set-up ends there), then calls the entry point back to
back for --seconds (the window: one caller, each call's preparation
inside), reads the peak memory, frees the program and compares the window's
first call with the plain float32 reference (portbench/check.py).  With
--trace 1 it also traces a few steps of one more call after the window and
reports the per-layer metrics instead of the end-to-end ones.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "mvoc_tpu")
GIB = float(1 << 30)


class WindowClosed(Exception):
    """Raised from a step callback to end a call at the window's close."""


class CallCut(Exception):
    """Raised from a step callback to end a warm-up or traced call."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> tuple:
    """(manifest, the cell's entry, its workload file, its configuration file)."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(os.path.join(root, "portbench", "workloads", f"{cell['traffic']}.json"))
    cfg = load_json(os.path.join(root, "portbench", "configs", f"{cell['config']}.json"))
    return manifest, cell, wl, cfg


def log(msg: str) -> None:
    print(f"portbench [{time.perf_counter() - T_START:8.1f} s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Timeline:
    """Seconds since start() of marks set at step ends: CUDA events on the
    card (read once the device has finished), the host clock on the CPU
    (where every op has finished when it returns)."""

    def __init__(self, device):
        import torch

        self.torch, self.cuda = torch, device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self):
        self.sync()
        self.t0 = time.perf_counter()
        if self.cuda:
            self.e0 = self.torch.cuda.Event(enable_timing=True)
            self.e0.record()

    def host(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self):
        if not self.cuda:
            return self.host()
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, mark) -> float:
        return mark if not self.cuda else self.e0.elapsed_time(mark) / 1e3


def finished_steps(times: list, seconds: float) -> float:
    """Steps finished by `seconds`, with the step in flight at the close
    counted by the share of its interval that lies inside."""
    times = sorted(times)
    done = [t for t in times if t <= seconds]
    later = [t for t in times if t > seconds]
    prev = done[-1] if done else 0.0
    frac = (seconds - prev) / (later[0] - prev) if later and later[0] > prev else 0.0
    return len(done) + frac


def step_intervals(records: list) -> list:
    """Seconds between consecutive step ends of one call: records (call,
    step, seconds)."""
    out = []
    for (c0, i0, t0), (c1, i1, t1) in zip(records, records[1:]):
        if c0 == c1 and i1 == i0 + 1:
            out.append(t1 - t0)
    return out


@dataclasses.dataclass
class Geometry:
    """Test-only replacement of the configuration's widths and the call's
    sizes (CPU rehearsals at a tiny geometry)."""

    config: dict
    call: dict


def _per_layer(manifest: dict, cell: dict, readings) -> dict:
    out = {}
    for m in manifest["per_layer"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        path = os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             geometry: Geometry | None = None, root: str = ROOT,
             fault=None, control: dict | None = None) -> dict:
    """One run of cell `name`; returns the result line's object.  device:
    CUDA unless given (tests pass "cpu" with a tiny geometry).  fault(pipe):
    a test's planted fault, applied to the program after set-up.  control:
    {"int8": {...}} runs the program with that int8 mode on (the control of
    a bf16 configuration); {"qmax": q} puts the reference at q levels in
    the program's place in the comparison (the control of an int8 one).
    The window closes at the first step end after `seconds` once the first
    call has finished (the comparison reads that call)."""
    import torch

    from portbench import check as C
    from portbench import inputs as I
    from portbench import program as P
    from portbench import trace as T
    from portbench.readings import Readings
    from portbench.reference import count as K

    manifest, cell, wl, cfg = load_cell(name, root)
    if geometry is not None:
        cfg = {**cfg, **geometry.config}
        wl = {**wl, "call": {**wl["call"], **geometry.call}}
    control = control or {}
    prog_cfg = {**cfg, "int8": control["int8"]} if "int8" in control else cfg
    call = wl["call"]
    dev = torch.device(device or "cuda")
    os.environ["MVOC_TORCH_BUILD_DIR"] = os.path.join(root, "build", "kernels")

    # -- set-up: weights, pipeline, inputs, warm-up ----------------------------
    dtype = getattr(torch, cfg["dtype"])

    def make_weights(modules):
        return {part: I.make_weights(modules[part], I.sub_seed(seed, "weights", part), dev,
                                     dtype) for part in P.PARTS}
    modules = P.meta_modules(prog_cfg)
    tok = I.Tokenizer(cfg["text_encoder"]["vocab_size"],
                      cfg["text_encoder"]["max_position_embeddings"])
    pipe = P.build(prog_cfg, modules, make_weights(modules), tok, dev)
    if fault is not None:
        fault(pipe)
    scale = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    rng = np.random.default_rng(I.sub_seed(seed, "calls"))
    call_seeds = [int(s) for s in rng.integers(0, 2 ** 31 - 1, size=4096)]
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    j = call["entries"]
    if wl["path"] == "inversion":
        videos = I.inversion_videos(seed, call)
        ids = tok([call.get("prompt", "")], padding="max_length",
                  max_length=tok.model_max_length)["input_ids"]

        def call_inputs(c):
            return (videos, call.get("prompt", ""), call_seeds[c])

        def check_entries(c):
            return (videos, ids, call_seeds[c])
        n_branches = 1
    else:
        base = [I.composite_entry(I.sub_seed(seed, "entry", e), call, tok, scale,
                                  cfg["unet"]["in_channels"], dev) for e in range(j)]
        stores = [P.write_stores(os.path.join(tmp.name, f"entry{e}"), base[e]) for e in range(j)]

        def check_entries(c):
            return [dataclasses.replace(base[e], seed=call_seeds[c * j + e]) for e in range(j)]

        def call_inputs(c):
            return list(zip(check_entries(c), stores))
        n_branches = call["objects"] + 3
    tap = P.StateTap(pipe, wl["entry_point"], n_branches)
    tl = Timeline(dev)

    def cut_after(n):
        def cb(i):
            if i + 1 >= n:
                raise CallCut
        return cb
    try:
        P.run_call(pipe, wl["entry_point"], call, call_inputs(len(call_seeds) - 1),
                   cut_after(wl["warmup_steps"]))
    except CallCut:
        pass
    tl.sync()
    setup_s = time.perf_counter() - T_START
    log(f"set-up done: {setup_s:.2f} s")

    # -- the window --------------------------------------------------------------
    n_run = C.run_length(wl)
    steps_checked = C.draw_steps(seed, n_run, wl["check"]["later_steps"])
    records, calls = [], [0]
    final0 = None

    def on_step(i):
        if calls[0] == 0:
            tap.stepped(i)
        records.append((calls[0], i, tl.mark()))
        if tl.host() > seconds and calls[0] >= 1:
            raise WindowClosed

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tap.arm(C.tapped_steps(steps_checked, n_run))
    tl.start()
    try:
        while True:
            out = P.run_call(pipe, wl["entry_point"], call, call_inputs(calls[0]), on_step)
            if calls[0] == 0:
                final0 = out
                tap.active = False
            calls[0] += 1
    except WindowClosed:
        pass
    tap.active = False
    tl.sync()
    marks = [(c, i, tl.seconds(m)) for c, i, m in records]
    steps = finished_steps([t for _, _, t in marks], seconds)
    intervals = step_intervals(marks)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"window closed: {steps:.4f} steps in {seconds} s over {calls[0] + 1} calls, "
        f"step ends {[round(t, 3) for _, _, t in marks]}, peak {peak / GIB:.3f} GiB")

    # -- a traced stretch after the window ---------------------------------------
    stretch = None
    if trace:
        stretch = _trace(torch, T, P, pipe, wl, call, call_inputs(calls[0] + 1), tl)

    # -- the comparison, with the program's state freed ----------------------------
    states = tap.states
    tap.close()
    del pipe, tap, modules
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    record = C.CallRecord(states=states, final=final0)
    # the same weights made again from the seed: the program's copies are gone
    weights = make_weights(P.meta_modules(cfg))
    log(f"comparing steps {steps_checked}")
    numbers = C.compare(cfg, wl, weights, check_entries(0), record, steps_checked, dev,
                        control_qmax=control.get("qmax"))
    log(f"compared: {numbers}")
    limits = {k: v for k, v in wl["check"]["limits"].items() if v is not None}
    correct = C.verdict(numbers, limits) and bool(limits)
    tmp.cleanup()

    result = {"correct": bool(correct), "attempted": calls[0] + 1, "failed": 0}
    if trace:
        counted = K.unet_step_count(cfg["unet"], call["frames"], call["height"] // scale,
                                    call["width"] // scale,
                                    K.call_batches(wl["path"], j, call.get("objects", 0)),
                                    int8=cfg.get("int8") is not None,
                                    text_len=cfg["text_encoder"]["max_position_embeddings"],
                                    min_k=(cfg.get("int8") or {}).get("min_k", 1280))
        readings = Readings(seconds=seconds, steps=steps, entries=j, step_intervals=intervals,
                            count=counted, act_bytes=torch.finfo(dtype).bits // 8,
                            stretch=stretch)
        result["metrics"] = _per_layer(manifest, cell, readings)
        log("per-layer metrics read")
    else:
        result["metrics"] = {
            "video_steps_per_s": {"value": steps * j / seconds if seconds > 0 else 0.0,
                                  "unit": "steps/s"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": 1, "memory_peak_bytes": int(peak)}
    if stretch is not None:
        result["device"].update(busy_s=stretch.busy_s(), window_s=stretch.wall_s)
        result["breakdown"] = {"device_ops": T.top(stretch.by_group()),
                               "idle_gaps": T.top(stretch.idle_gaps())}
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def _trace(torch, T, P, pipe, wl, call, inputs, tl):
    """A profiled stretch of steps from_step+1 .. from_step+steps of one more
    call, with the device idle at both ends."""
    from torch.profiler import ProfilerActivity, profile

    a, k = wl["trace"]["from_step"], wl["trace"]["steps"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if tl.cuda else [])
    prof = profile(activities=acts)
    t = {}

    def cb(i):
        if i == a:
            tl.sync()
            prof.start()
            t["start"] = time.perf_counter()
        elif i == a + k:
            tl.sync()
            t["end"] = time.perf_counter()
            prof.stop()
            raise CallCut
    try:
        P.run_call(pipe, wl["entry_point"], call, inputs, cb)
    except CallCut:
        pass
    return T.from_profiler(prof, t["end"] - t["start"], k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: needs {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: loaded once the window closed: {', '.join(loaded)}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
