"""Hold one composite step of this checkout's mvoc_tpu_torch against another
checkout's, on the card, from the same seeded inputs:

    python scripts/compare_checkouts.py <root of the other checkout> [--size 512] [--seed 0]

Each checkout's package runs in a process of its own (they share the name
mvoc_tpu_torch): the seeded bf16 pipeline at full I2VGen-XL width
(utils.testing.build_full_pipeline), three synthetic 16-frame videos
inverted in 3 steps, then the composite's first run step (N = 2 rectangle
masks) through each two_pass path, with the injection gates as scheduled
and all off.  Prints, per case, the max |diff| between the checkouts and
whether they are bitwise equal, and the wall time of each case, after the
card's name and power limit; exits 1 when a case differs.  Put the other checkout in a directory .gitignore
lists, e.g. `git archive <commit> | tar x -C build/parent`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(two_pass, gates) for gates in ("scheduled", "off") for two_pass in (False, True, "stream")]


def worker(root: str, out: str, size: int, seed: int) -> None:
    """The cases with the package of the checkout at `root`, saved to `out`."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from mvoc_tpu_torch.io.trajectory import TrajectoryStore
    from mvoc_tpu_torch.pipeline import core
    from mvoc_tpu_torch.utils import testing as tt

    pipe = tt.build_full_pipeline(seed=seed)
    rng = np.random.default_rng(seed)
    nf, steps = 16, 3
    videos = [tt.synthetic_video(rng, nf, size) for _ in range(3)]
    lat = size // pipe.vae_scale_factor
    masks = np.zeros((2, nf, lat, lat), np.float32)
    masks[0, :, lat // 8: lat // 2, lat // 8: lat // 2] = 1.0
    masks[1, :, lat // 2: 7 * lat // 8, 3 * lat // 8: 7 * lat // 8] = 1.0
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, str(j)) for j in range(3)]
        for d, frames in zip(dirs, videos):
            pipe.invert(frames, height=size, width=size, num_frames=nf,
                        num_inference_steps=steps, seed=seed, output_dir=d)
        stores = [TrajectoryStore(d) for d in dirs]
        init, cond, sched, ms, pb, ps, cw = pipe._prepare_composite(
            "a red boat and a surfer on the sea", videos[0][0], videos[0], videos[0],
            videos[1:], masks, masks, stores[0], stores[1:], height=size, width=size,
            num_frames=nf, num_inference_steps=steps, guidance_scale=9.0, seed=seed,
            two_pass="stream")
    one = dataclasses.replace(sched, **{f.name: getattr(sched, f.name)[:1]
                                        for f in dataclasses.fields(sched)
                                        if f.name != "obj_fusion_lat"})
    off = np.zeros_like(one.gate_spatial)
    for two_pass, gates in CASES:
        s = one if gates == "scheduled" else dataclasses.replace(
            one, gate_spatial=off, gate_temporal=off, gate_conv=off)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = core.pnp_composite_core(pipe.unet, pipe.ddim, init, cond, s, ms, pb, ps,
                                    num_inference_steps=steps, guidance_scale=9.0,
                                    two_pass=two_pass,
                                    capture_weights=cw if two_pass == "stream" else None)
        torch.cuda.synchronize()
        results[repr((two_pass, gates))] = (x.cpu(), time.perf_counter() - t0)
    torch.save(results, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "OUT"))
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.size, args.seed)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("compare_checkouts: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no card line")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, root in (("this", ROOT), ("other", os.path.abspath(args.other))):
            out = os.path.join(tmp, f"{tag}.pt")
            # the seeded pipelines' prompt ids come from Python's salted hash
            # (utils.testing.DummyTokenizer): one salt for both processes
            subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root, out,
                            "--size", str(args.size), "--seed", str(args.seed)], check=True,
                           env=dict(os.environ, PYTHONHASHSEED="0"))
            runs[tag] = torch.load(out)
    differ = 0
    for key in runs["this"]:
        (a, ta), (b, tb) = runs["this"][key], runs["other"][key]
        diff = (a - b).abs().max().item()
        differ += not torch.equal(a, b)
        print(f"{key}: max |this - other| {diff:.6g} of max |x| {b.abs().max().item():.6g}; "
              f"bitwise {torch.equal(a, b)}; step {ta:.3f} s this, {tb:.3f} s other")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
