"""Readings that the comparison's limits are set from: the numbers of the
program over many seeds, and of the cell's control over a few, each seed a
full set-up and the window's first call at the cell's own size, in one
process (no measured window: it closes as soon as that call has finished).

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--control int8:mixed | int8:full | qmax:7]

The control of a bf16 configuration is the program with its own int8 path
on (int8:<mode>); of an int8 configuration, the reference at w4a4 in the
program's place (qmax:7).  One JSON line per run on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def parse_control(text: str) -> dict:
    kind, _, value = text.partition(":")
    if kind == "int8":
        return {"int8": {"mode": value}}
    if kind == "qmax":
        return {"qmax": float(value)}
    raise SystemExit(f"--control {text!r}: int8:<mode> or qmax:<levels>")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control", action="append", default=[])
    args = ap.parse_args(argv)
    import torch

    from portbench import run as R

    def seeds(text):
        return [int(s) for s in text.split(",") if s]
    runs = [(s, "program", None) for s in seeds(args.seeds)]
    runs += [(s, c, parse_control(c)) for c in args.control for s in seeds(args.control_seeds)]
    for seed, label, control in runs:
        try:
            res = R.run_cell(args.workload, seed, 0.0, False, control=control)
            line = {"seed": seed, "run": label,
                    "numbers": {k: v["value"] for k, v in res["checks"].items()},
                    "peak_gib": res["metrics"]["peak_mem_gib"]["value"]}
        except Exception as e:  # a control that crashes has failed and gives no number
            line = {"seed": seed, "run": label, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
