"""On-card smoke run of mvoc_tpu_torch: builds the CUDA kernels, drives the
main path (invert -> stream composite -> decode) at full I2VGen-XL width on
one CUDA card, and holds every kernel against its plain PyTorch version at
every shape that run launched it with.

    python3 chip_smoke.py [--steps 3] [--seed 0]

Phases, in order (each failure ends the run with a non-zero exit):
  0. the card (nvidia-smi name and power limit), torch / CUDA versions, TF32;
  1. the kernel build (nvcc, one process per source, in parallel);
  2. the slice at full width, bf16 weights from a seed, fp32 latents:
     invert a background and two object videos, then
     sample_composite(two_pass="stream") with N=2 rectangle masks in the
     natural temporal layout and a VAE decode.  Every kernel launch count is
     set to 0 just before and read just after; per composite step launches,
     wall times and peak memory are printed;
  3. one composite step through the fused path (two_pass=False) from the same
     inputs, against the stream path;
  4. a reference check on a small input: the full-width UNet in fp32 on the
     card (kernels) against the same UNet in fp32 on the CPU (plain versions);
  5. kernel phases: K1 and K2 at every distinct shape the slice launched, plus
     a ragged 14400-token K1 case; each against its plain version computed in
     fp32 from the same bf16 inputs, with its time, the plain version's time,
     the time of one PyTorch library call of the same function (a yardstick
     the port never calls), and the least time the card could take.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  The per-shape table also goes to
chiprun_out/chip_smoke_phases.json.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# bf16 kernel vs fp32 plain on unit-variance inputs: |err| <= TOL_BF16 * max|plain|.
# Tied to the output's own scale (which falls as 1/sqrt(Sk) for K1): the
# bf16 roundings of the pre-scaled q, of p and of the output each cost up to
# 2^-9 of what they round, so the kernel's error stays a few 1e-3 of max|plain|
TOL_BF16 = 2e-2
TOL_REF = 1e-3             # fp32 card vs fp32 CPU, relative to max |output|

KERNELS = {
    "flash_attention": dict(source="mvoc_tpu_torch/csrc/flash_attention.cu",
                            replaces="mvoc_tpu/ops/attention.py:148"),
    "frame_attention": dict(source="mvoc_tpu_torch/csrc/frame_attention.cu",
                            replaces="mvoc_tpu/ops/attention.py:270"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of fn over `reps` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_video(rng, frames: int, size: int):
    """A seeded smooth colour field with a moving bright square."""
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.uniform(0, 2 * np.pi, 3)
    base = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy) + p) for p in phase], -1)
    out = []
    for i in range(frames):
        img = base.copy()
        x0 = (size // 8 + i * size // (4 * frames)) % (size - size // 4)
        img[size // 3: size // 3 + size // 6, x0: x0 + size // 6] = 1.0
        out.append(Image.fromarray((img * 255).astype(np.uint8)))
    return out


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def _chunked(fn, n: int, chunk: int, *args):
    import torch

    if n <= chunk:
        return fn(*args)
    return torch.cat([fn(*(a[i:i + chunk] for a in args)) for i in range(0, n, chunk)])


def flash_phase(sig, gen):
    import torch
    import torch.nn.functional as F

    from mvoc_tpu_torch.ops import attention as A

    b, h, sq, sk, d, _ = sig
    dev = torch.device("cuda")
    # the main path's layout: [B, S, H, D] projections viewed as [B, H, S, D]
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
               .transpose(1, 2) for s in (sq, sk, sk))
    out = A.flash_attention(q, k, v)
    # plain version in fp32 from the same bf16 inputs, batch-chunked to keep
    # its [Sq, Sk] logits under ~4 GB
    chunk = max(1, int(4e9 // (h * sq * sk * 4)))
    ref = _chunked(A.flash_attention_plain, b, chunk, q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    tol = TOL_BF16 * ref.abs().max().item()
    ms = cuda_ms(lambda: A.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: _chunked(A.flash_attention_plain, b, chunk, q, k, v), reps=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4.0 * b * h * sq * sk * d
    nbytes = 2.0 * (2 * b * h * sq * d + 2 * b * h * sk * d)
    return dict(err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, flops=flops,
                bytes=nbytes)


def frame_phase(sig, gen):
    import torch
    import torch.nn.functional as F

    from mvoc_tpu_torch.ops import attention as A

    layout, b, f, s, heads, d, _, masked = sig
    dev = torch.device("cuda")
    shape = (b, f, s, heads * d) if layout == "natural" else (s, f, heads * d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    mask = None
    if masked:
        idx = torch.arange(f, device=dev)
        mask = (idx[:, None] - idx[None, :]).abs() <= 4
    out = A.frame_attention(q, k, v, heads, mask=mask, layout=layout)
    ref = A.frame_attention_plain(q.float(), k.float(), v.float(), heads, mask=mask,
                                  layout=layout)
    err = (out.float() - ref).abs().max().item()
    tol = TOL_BF16 * ref.abs().max().item()
    ms = cuda_ms(lambda: A.frame_attention(q, k, v, heads, mask=mask, layout=layout))
    plain_ms = cuda_ms(lambda: A.frame_attention_plain(q, k, v, heads, mask=mask,
                                                       layout=layout), reps=2)

    def relaid(t):  # [B*S, H, F, D], laid out once, outside the timed call
        n = A._as_natural(t, layout)
        return n.reshape(n.shape[0], f, s, heads, d).permute(0, 2, 3, 1, 4).reshape(
            -1, heads, f, d).contiguous()

    qr, kr, vr = relaid(q), relaid(k), relaid(v)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask))
    n = b * s * heads
    flops = 4.0 * n * f * f * d
    nbytes = 4.0 * n * f * d * 2
    return dict(err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, flops=flops,
                bytes=nbytes)


def bound(ph):
    t_ops = ph["flops"] / PEAK_BF16_FLOPS
    t_bytes = ph["bytes"] / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="inversion steps = schedule length; "
                    "the composite runs steps-1 of them")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card and has no CPU mode",
              file=sys.stderr)
        return 2

    # 0. the card
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    from mvoc_tpu_torch.io.trajectory import TrajectoryStore
    from mvoc_tpu_torch.ops import _build
    from mvoc_tpu_torch.ops import attention as A
    from mvoc_tpu_torch.pipeline import core
    from mvoc_tpu_torch.utils import testing as tt

    # 1. build
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s into {_build.build_dir()} "
        f"(per source, s since start: {json.dumps({k: round(v, 1) for k, v in built.items()})})")
    for stem, text in _build.build_logs.items():  # nvcc -Xptxas -v, per source
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"  {stem}: {len(regs)} kernel instantiations, registers <= {max(regs)}, "
            f"spill stores <= {max(spills)} bytes")
    for stem in KERNELS:
        _build.load(stem)

    # 2. the slice at full width
    rng = np.random.default_rng(args.seed)
    size, nf, steps = 512, 16, args.steps  # the main path: 16 frames at 512 px
    pipe, t_build = sync_time(lambda: tt.build_full_pipeline(seed=args.seed))
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder,
                                       pipe.image_encoder) for p in m.parameters())
    log(f"pipeline: full I2VGen-XL geometry, bf16, random weights (seed {args.seed}), "
        f"built in {t_build:.1f} s; {n_params / 1e9:.3f} B parameters")
    videos = [synthetic_video(rng, nf, size) for _ in range(3)]
    lat = size // pipe.vae_scale_factor
    masks = np.zeros((2, nf, lat, lat), np.float32)
    masks[0, :, lat // 8: lat // 2, lat // 8: lat // 2] = 1.0
    masks[1, :, lat // 2: 7 * lat // 8, 3 * lat // 8: 7 * lat // 8] = 1.0

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="mvoc_smoke_")
    dirs = [os.path.join(tmp, name) for name in ("bg", "obj0", "obj1")]
    t_main = time.perf_counter()
    for d, frames in zip(dirs, videos):
        (_, traj), secs = sync_time(lambda: pipe.invert(
            frames, height=size, width=size, num_frames=nf, num_inference_steps=steps,
            seed=args.seed, output_dir=d))
        if not np.isfinite(traj).all():
            raise RuntimeError(f"inversion of {d} gave non-finite latents")
        log(f"invert {os.path.basename(d)}: {steps} steps in {secs:.2f} s "
            f"(trajectory {traj.shape})")
    before = dict(A.LAUNCHES)
    before_shapes = {k: dict(v) for k, v in A.LAUNCH_SHAPES.items()}
    step_times = []
    last = [time.perf_counter()]

    def on_step(i):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_times.append(now - last[0])
        last[0] = now

    main_frames = videos[0]
    comp_kwargs = dict(height=size, width=size, num_frames=nf, num_inference_steps=steps,
                       guidance_scale=9.0, seed=args.seed)
    stores = [TrajectoryStore(d) for d in dirs]

    def composite():
        last[0] = time.perf_counter()
        return pipe.sample_composite(
            "a red boat and a surfer on the sea", main_frames[0], main_frames, videos[0],
            videos[1:], masks, masks, stores[0], stores[1:], two_pass="stream",
            decode=False, step_callback=on_step, **comp_kwargs)

    final, secs = sync_time(composite)
    n_comp = len(step_times)
    comp_launch = {k: A.LAUNCHES[k] - before[k] for k in A.LAUNCHES}
    comp_shapes = {k: {sig: n - before_shapes[k].get(sig, 0) for sig, n in v.items()}
                   for k, v in A.LAUNCH_SHAPES.items()}
    video, dec_secs = sync_time(lambda: pipe.decode_latents(final, decode_chunk_size=1))
    main_secs = time.perf_counter() - t_main
    launches = dict(A.LAUNCHES)
    shapes = {k: dict(v) for k, v in A.LAUNCH_SHAPES.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (torch.isfinite(final).all() and np.isfinite(video).all()):
        raise RuntimeError("composite or decode gave non-finite values")
    if video.shape != (nf, size, size, 3):
        raise RuntimeError(f"decoded video shape {video.shape}")
    log(f"composite (stream, N=2, natural layout): {n_comp} steps in {secs:.2f} s, "
        f"s/step {[round(t, 3) for t in step_times]}; decode {dec_secs:.2f} s; "
        f"main path {main_secs:.1f} s; peak memory {peak:.2f} GiB")
    log(f"launches on the main path: {launches}; per composite step: "
        f"{ {k: v / max(n_comp, 1) for k, v in comp_launch.items()} }")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{name} was never launched on the main path")
        if comp_launch[name] <= 0:
            raise RuntimeError(f"{name} was never launched in the composite steps")

    # 3. one fused step against one stream step, same inputs
    prep = pipe._prepare_composite(
        "a red boat and a surfer on the sea", main_frames[0], main_frames, videos[0], videos[1:],
        masks, masks, stores[0], stores[1:], two_pass="stream", **comp_kwargs)
    init, cond, sched, ms, pb, ps, cw = prep
    one = dataclasses.replace(
        sched, bg_traj=sched.bg_traj[:1], obj_traj=sched.obj_traj[:1],
        gate_spatial=sched.gate_spatial[:1], gate_temporal=sched.gate_temporal[:1],
        gate_conv=sched.gate_conv[:1], fusion_mask=sched.fusion_mask[:1],
        timesteps=sched.timesteps[:1])
    outs = {}
    for tp_mode in ("stream", False):
        outs[tp_mode], secs = sync_time(lambda: core.pnp_composite_core(
            pipe.unet, pipe.ddim, init, cond, one, ms, pb, ps, num_inference_steps=steps,
            guidance_scale=9.0, two_pass=tp_mode, capture_weights=cw))
        log(f"one composite step, two_pass={tp_mode!r}: {secs:.2f} s")
    diff = (outs["stream"] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    log(f"stream vs fused, one step (bf16): max |diff| {diff:.4g}, max |x| {scale:.4g}")
    if not math.isfinite(diff):
        raise RuntimeError("stream/fused step gave non-finite values")
    shutil.rmtree(tmp)

    # 4. reference on a small input: fp32 UNet on the card vs on the CPU
    unet32 = copy.deepcopy(pipe.unet).float()
    del pipe
    torch.cuda.empty_cache()
    g = np.random.default_rng(args.seed + 1)
    rf, rl = 4, 16
    d_ctx = unet32.config.cross_attention_dim
    inp = [g.standard_normal(s).astype(np.float32) for s in
           ((1, rf, rl, rl, 4),)] + [np.array([501]), np.array([8])] + [
        g.standard_normal(s).astype(np.float32) for s in
        ((1, rf, rl, rl, 4), (1, rf, rl, rl, 4), (1, rf, d_ctx), (1, 77, d_ctx))]
    with torch.inference_mode():
        out_gpu = unet32(*(torch.as_tensor(x, device="cuda") for x in inp)).float().cpu()
        unet_cpu = unet32.cpu()
        out_cpu = unet_cpu(*(torch.as_tensor(x) for x in inp))
    del unet32, unet_cpu
    ref_err = (out_gpu - out_cpu).abs().max().item()
    ref_scale = out_cpu.abs().max().item()
    log(f"reference: full-width UNet fp32, {rf} frames at {rl}x{rl} latents, card (kernels) "
        f"vs CPU (plain): max |diff| {ref_err:.3g} of max |out| {ref_scale:.3g} "
        f"(tolerance {TOL_REF} relative)")
    if not (ref_err <= TOL_REF * ref_scale):
        raise RuntimeError("full-width UNet on the card disagrees with the CPU reference")

    # 5. kernel phases at every shape the main path launched, + ragged 14400
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    table = []
    extra = {"flash_attention": [(1, 5, 14400, 14400, 64, "torch.bfloat16")],
             "frame_attention": []}
    for name, run in (("flash_attention", flash_phase), ("frame_attention", frame_phase)):
        sigs = sorted(shapes[name]) + extra[name]
        for sig in sigs:
            ph = run(sig, gen)
            b_ms, basis = bound(ph)
            row = dict(kernel=name, shape=list(sig), launches=shapes[name].get(sig, 0),
                       max_abs_err=ph["err"], tol=ph["tol"], ms=ph["ms"],
                       plain_ms=ph["plain_ms"], library_ms=ph["library_ms"], bound_ms=b_ms,
                       bound_by=basis)
            table.append(row)
            log(f"phase {name} {sig}: max_abs_err {ph['err']:.3g} (tol {ph['tol']:.3g}) "
                f"kernel_ms {ph['ms']:.4f} plain_ms {ph['plain_ms']:.4f} "
                f"library_ms {ph['library_ms']:.4f} bound_ms {b_ms:.4f} ({basis}: "
                f"{'FLOPs at 989 TF/s' if basis == 'operations' else 'bytes at 3.35 TB/s'}) "
                f"main-path launches {row['launches']}")
            if not ph["err"] <= ph["tol"]:
                raise RuntimeError(f"{name} {sig}: error {ph['err']} over {ph['tol']}")
            torch.cuda.empty_cache()

    # each kernel's device time in one composite step: its composite-only
    # launches at each shape times that shape's measured kernel time
    per_step_ms = {}
    for name in KERNELS:
        ms_of = {tuple(r["shape"]): r["ms"] for r in table if r["kernel"] == name}
        per_step_ms[name] = sum(n * ms_of[sig] for sig, n in comp_shapes[name].items()) / max(
            n_comp, 1)
    log(f"kernel device time per composite step (launches x phase kernel_ms): "
        f"{ {k: round(v, 2) for k, v in per_step_ms.items()} } ms of "
        f"{1e3 * sum(step_times) / max(n_comp, 1):.1f} ms wall")

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_phases.json"), "w") as f:
        json.dump(dict(card=card, launches=launches, per_step=comp_launch, steps=n_comp,
                       step_s=step_times, kernel_ms_per_step=per_step_ms, peak_gib=peak,
                       phases=table), f, indent=1)

    kernels = []
    for name, meta in KERNELS.items():
        rows = [r for r in table if r["kernel"] == name and r["launches"] > 0]
        head = max(rows, key=lambda r: r["bound_ms"] * r["launches"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in table if r["kernel"] == name),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"], shape=head["shape"]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
