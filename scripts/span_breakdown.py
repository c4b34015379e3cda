"""Where a benchmark cell's traced steps spend the card's time, by the
program's spans: one cell of BENCHMARK.json set up as `portbench.run`
sets it up (weights and inputs from the seed, a warm-up call cut after its
warm-up steps), then a few steps of one more call under torch.profiler,
started and stopped in the step callback as the benchmark's traced stretch
is.  The stretch's Chrome trace goes through
`utils.profiling.device_op_breakdown` (by kernel group, UNet module, span
and aten op) and through the benchmark's own reduction
(`portbench.trace.from_profiler`, `portbench.spans.idle_by_span`).

    python3 scripts/span_breakdown.py --workload composite-512-stream-int8 \\
        [--seed 1] [--steps 3] [--out DIR]

Needs a CUDA card.  Prints one JSON line (with --out, also written to
DIR/<cell>.json): the device time of the five UNet sub-blocks with the
most elementwise time, of the five aten ops that launch the most work of
the no-operation groups, the largest rows by span, the idle time a step by
the innermost span, with the share no span covers, and the fused norms'
launches and plain calls (ops/norm.py) over the cell's calls.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NO_OP_GROUPS = ("elementwise", "copies and layout", "reductions", "normalisation")


class _Cut(Exception):
    pass


def _top(d: dict, n: int) -> dict:
    return {k: round(1e3 * v, 3) for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}


def breakdown(workload: str, seed: int, steps=None, out_dir=None, device=None,
              geometry=None) -> dict:
    """The reading of one cell (see the module doc); device "cpu" with a
    tiny `portbench.run.Geometry` rehearses it without a card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvoc_tpu_torch.ops import norm
    from mvoc_tpu_torch.utils import profiling
    from portbench import inputs as I
    from portbench import program as P
    from portbench import run as R
    from portbench import spans as S
    from portbench import trace as T

    _, _, wl, cfg = R.load_cell(workload)
    if geometry is not None:
        cfg = {**cfg, **geometry.config}
        wl = {**wl, "call": {**wl["call"], **geometry.call}}
    call, dev = wl["call"], torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    os.environ["MVOC_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "kernels")
    dtype = getattr(torch, cfg["dtype"])
    modules = P.meta_modules(cfg)
    weights = {part: I.make_weights(modules[part], I.sub_seed(seed, "weights", part), dev,
                                    dtype) for part in P.PARTS}
    tok = I.Tokenizer(cfg["text_encoder"]["vocab_size"],
                      cfg["text_encoder"]["max_position_embeddings"])
    pipe = P.build(cfg, modules, weights, tok, dev)
    scale = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    tmp = tempfile.mkdtemp(prefix="span_breakdown-")
    rng = np.random.default_rng(I.sub_seed(seed, "calls"))
    entries = []
    for e in range(call["entries"]):
        entry = I.composite_entry(I.sub_seed(seed, "entry", e), call, tok, scale,
                                  cfg["unet"]["in_channels"], dev)
        entry = dataclasses.replace(entry, seed=int(rng.integers(0, 2 ** 31 - 1)))
        entries.append((entry, P.write_stores(os.path.join(tmp, f"entry{e}"), entry)))

    norm.reset_launch_counts()

    def cut_after(n):
        def cb(i):
            if i + 1 >= n:
                raise _Cut
        return cb
    try:
        P.run_call(pipe, wl["entry_point"], call, entries, cut_after(wl["warmup_steps"]))
    except _Cut:
        pass
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()

    a = wl["trace"]["from_step"]
    k = steps or wl["trace"]["steps"]
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    t = {}

    def traced(i):
        if i == a:
            sync()
            prof.start()
            t["start"] = time.perf_counter()
        elif i == a + k:
            sync()
            t["end"] = time.perf_counter()
            prof.stop()
            raise _Cut
    try:
        P.run_call(pipe, wl["entry_point"], call, entries, traced)
    except _Cut:
        pass
    trace_dir = os.path.join(tmp, "trace")
    os.makedirs(trace_dir)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    booked = profiling.device_op_breakdown(trace_dir)

    # the benchmark's reduction of the same stretch
    stretch = T.from_profiler(prof, t["end"] - t["start"], k)
    span_kernels = sorted({n for n, *_ in stretch.kernels if profiling.is_span(n)})
    idle = S.idle_by_span(stretch)
    gap = sum(idle.values())
    by_layer = {}
    for name, secs in idle.items():
        layer = S.root(name) if name is not None else "(no span)"
        by_layer[layer] = by_layer.get(layer, 0.0) + secs

    per_step = {key: {n: v / k for n, v in booked[key].items()}
                for key in ("by_span", "by_op", "by_module")}
    sub_elem = {s: row.get("elementwise", 0.0) / k
                for s, row in booked["by_span_category"].items()
                if s.startswith(profiling.UNET_SCOPE) and s.count("/") == 2}
    op_noops = {op: sum(row.get(g, 0.0) for g in NO_OP_GROUPS) / k
                for op, row in booked["by_op_category"].items()}
    span_noops = {s: sum(row.get(g, 0.0) for g in NO_OP_GROUPS) / k
                  for s, row in booked["by_span_category"].items()}
    out = {
        "workload": workload, "seed": seed, "steps": k,
        "card": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "torch": torch.__version__,
        "device_ms_per_step": round(1e3 * booked["total_s"] / k, 3),
        "by_category_ms": _top({g: v / k for g, v in booked["by_category"].items()}, 12),
        "elementwise_ms_by_sub_block_top5": _top(sub_elem, 5),
        "no_op_ms_by_aten_op_top5": _top(op_noops, 5),
        "no_op_ms_by_span_top10": _top(span_noops, 10),
        "by_span_ms_top15": _top(per_step["by_span"], 15),
        "by_op_ms_top10": _top(per_step["by_op"], 10),
        "by_module_ms": _top(per_step["by_module"], 30),
        "idle_gap_ms_per_step": round(1e3 * gap / k, 3),
        "idle_ms_per_step_by_layer": _top({n: v / k for n, v in by_layer.items()}, 10),
        "idle_ms_per_step_by_span_top15": _top({str(n): v / k for n, v in idle.items()}, 15),
        "unbooked_idle_share": (idle.get(None, 0.0) / gap) if gap else None,
        "busy_s": stretch.busy_s(), "wall_s": stretch.wall_s,
        # the fused norms over the warm-up and the traced call: launches, and
        # CUDA tensors that took a plain version (0 when the kernels serve all)
        "norm_launches": dict(norm.LAUNCHES), "norm_plain_calls": dict(norm.PLAIN_CALLS),
        "span_names_among_kernels": span_kernels,
        "device_user_annotations": sum(1 for e in prof.events()
                                       if e.device_type == torch.autograd.DeviceType.CUDA
                                       and getattr(e, "is_user_annotation", False)),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{workload}.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--steps", type=int, default=None, help="traced steps (the cell's own)")
    ap.add_argument("--out", default=None, help="a directory for <cell>.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    out = breakdown(args.workload, args.seed, args.steps, args.out)
    print(json.dumps(out))
    return 1 if out["span_names_among_kernels"] else 0


if __name__ == "__main__":
    sys.exit(main())
