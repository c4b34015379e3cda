"""On-card smoke run of mvoc_tpu_torch: builds the CUDA kernels, drives the
main paths (invert -> stream composite -> decode in bf16, then the same in
int8, then a full-width diffusers checkpoint written, loaded and verified,
then both CLIs from that checkpoint at the templates' 1280 x 720 and a tiled
decode of their composite, then both CLIs again with their entries batched,
and every reuse and broadcast mode at 512 px and through both CLIs) at full
I2VGen-XL width on one CUDA card, and holds every kernel against its plain
PyTorch version at every shape those runs launched it with.

    python3 chip_smoke.py [--steps 3] [--seed 0]

Phases, in order (each failure ends the run with a non-zero exit):
  0. the card (nvidia-smi name and power limit), torch / CUDA versions, TF32,
     and whether safetensors, transformers, regex and ftfy import there (the
     port needs none of them);
  1. the kernel build (nvcc, one process per source, in parallel);
  2. the bf16 slice at full width, bf16 weights from a seed, fp32 latents:
     invert a background and two object videos, then
     sample_composite(two_pass="stream") with N=2 rectangle masks in the
     natural temporal layout and a VAE decode.  Every kernel launch count is
     set to 0 just before and read just after; per composite step launches,
     wall times and peak memory are printed.  K3 must not launch here, and
     every norm (UNet, VAE, CLIP) must take the fused kernels: a norm on a
     CUDA tensor that takes its plain version (ops/norm.PLAIN_CALLS) fails
     this slice and phase 5's;
  3. one composite step through the fused path (two_pass=False) and one
     through two_pass=True (the batched capture, then the consume) from the
     same inputs as one stream step: each step's wall time and peak memory,
     two_pass=True and stream within TOL_TWO_PASS of the fused step; then
     two planted faults through two_pass=True (the injection dropped, the
     objects' masks swapped), each of which must land beyond TOL_TWO_PASS;
  4. a reference check on a small input: the full-width UNet in fp32 on the
     card (kernels) against the same UNet in fp32 on the CPU (plain
     versions); then the same UNet quantized with enable_int8's "full"
     selection, the card replaying the CPU run's int8 activations
     (utils.testing.ActivationTape), whose difference must stay under a
     tenth of the int8-vs-fp32 drift on the CPU;
  5. the int8 slice: enable_int8(mode="mixed") on the same weights, then the
     phase-2 path again (3 inversions, the stream composite, the decode),
     with counts reset just before and read just after; K3 must launch in
     the inversions and in the composite steps;
  6. one stream composite step with enable_int8(mode="full") on the same
     seeded weights (a fresh pipeline), so that the im2col convolutions
     reach the card;
     (after phase 3 and after phase 5, one steady stream composite step of
     the bf16 and of the int8-mixed path runs again under torch.profiler:
     its wall time with and without the profiler, the device's busy time
     and idle share, and device time by kernel group; its warm-up call is
     counted by utils.flops: TF per step by class, achieved TF/s, mfu (over
     989 TF/s bf16), each class's TF/s in its kernel group's device time,
     and the speed-of-light floor, each class's operations over its peak,
     which a step measured faster than fails the run.  After phase 3's
     profile, the route check: one full-width 5-branch UNet forward counted
     on the card and shape-only on meta, equal class by class; after phase
     5's, one int8-mixed fused step counted shape-only, phase 9's
     one-process count);
  6b. (on phase 2's bf16 pipeline, before phase 5 quantizes it) every reuse
     and broadcast mode through the entry points at 512 px: inversions of
     the background video (6 steps: exact, encoder reuse k = 2, k = 2 deep,
     k = 3 at depth 2, every knob at 1) and invert_batch of the three
     videos (exact, k = 2 deep); composites of 6 run steps over exact
     inversions (exact on all three paths, encoder reuse k = 2 on each,
     k = 2 at depth 2 and PAB k = 2 on the fused path, capture reuse k = 2
     on two_pass=True and stream, deep capture reuse k = 3 on stream, one
     capture broadcast over every step, the knobs at 1, and a J = 2
     sample_composite_batch at deep capture reuse k = 3 whose second entry
     has the objects' masks exchanged).  Per run: seconds per fresh and per
     cached step (synced, through step_callback), K1 and K2 launches per
     fresh and per cached step, the bytes of the caches, peak memory, the
     mean step against the exact run of its path and the drift from it.
     Checks: every output finite; the knobs at 1 bitwise the exact run;
     every k > 1 mode away from it; a cached step launching fewer K1 + K2
     than a fresh one; the stale capture drifting further than k = 2; the
     batched entries within TOL_BATCH of their single runs and the
     exchanged-masks entry beyond it; FreeU on one fused step away from the
     plain step and, after disable_freeu, bitwise it; frameinit and
     warp_affine on the card within 1e-5 of max |x| of the CPU's;
  7a. the checkpoint phase: the seeded bf16 pipeline written as a diffusers
     I2VGen-XL directory (utils.testing.write_checkpoint: fp16 safetensors
     UNet and image tower, fp32 safetensors VAE, a torch .bin text tower,
     every config.json in diffusers / HF keys, the scheduler config, a
     synthetic tokenizer), with its bytes and seconds; loaded back with
     models.convert.load_pipeline (seconds, peak host and device memory),
     every tensor equal to the written one cast to bf16, bit for bit; then
     `python -m mvoc_tpu_torch.models.convert <dir> --verify` as a
     subprocess, which must exit 0;
  7. the CLI phase: a demo tree of three synthetic 16-frame 1280 x 720
     videos (bg, obj1, obj2) as PNG frame directories, an edited first
     frame and two rectangle masks authored at 1280 x 720, with group JSONs
     over the shipped configs/group_*/template.yaml (cut: inversion and
     composite n_steps = --steps, recon from t_idx 1, composite from t_idx 1
     with fusion_step [0, 1]; every other key the template's: cfg 9, the
     fused two_pass=False path, natural layout, decode_chunk_size 1); the
     pipeline from cli.common.build_pipeline with --checkpoint <the 7a
     directory> (bf16), through the CLIs' apply_unet_options and
     apply_quantize, then cli.inverse.run (3 inversions, the reconstruction
     of bg scored by PSNR / SSIM) and cli.composite.run, counts set to 0
     just before and read just after; per CLI stage its wall time and
     K1 / K2 / K3 launches (K1, K2 > 0 and K3 = 0 required), the peak
     device memory, the trajectory container written, the files written
     (16 frames at 1280 x 720, the gif, and the mp4 when OpenCV exists);
     then the composite's final latents decoded again with
     enable_vae_tiling() (6 tiles of 64 x 64 latents a frame, K1 at the
     VAE's [1, 1, 4096, 4096, 512]): its max difference from the untiled
     decode, both peaks, K1's launches;
  7b. the batched CLIs, on phase 7's pipeline and demo tree: the three
     videos' stores removed, cli.inverse.run with batching on (one batched
     step loop of J = 3 videos, then bg's reconstruction), and
     cli.composite.run with batching on over a group JSON of two entries
     over the same sources (the second with another prompt and seed and the
     objects' masks exchanged): one fused step loop of J = 2 entries, then
     both exports; counts set to 0 just before and read just after, per
     stage its wall time, K1 / K2 / K3 launches (K1, K2 > 0, K3 = 0) and
     peak memory, and seconds per step, per video and per entry beside
     phase 7's; the batched trajectories and final latents within TOL_BATCH
     of max |x| of the sequential ones (phase 7's, and entry 1 through
     sample_composite), and two planted faults inside the batch (the
     entries' conditioning exchanged, their masks exchanged) beyond it;
     then one steady batched step under torch.profiler, its trace booked
     by utils.profiling.device_op_breakdown to kernel groups and UNet
     modules, with its operations (counted as above) by class and by UNet
     module beside those device times;
  7c. both CLIs with the reuse modes, on phase 7's pipeline and demo tree:
     cli.inverse.run on bg (recon on) with `encoder_reuse_interval: auto`
     (candidates [3, 2], 4 probe steps, deep_reuse), its store recomputed,
     then cli.composite.run on the one entry with `pab_interval: 2`; the
     auto report, per stage its wall time, launches and peak memory, the
     PAB dict's bytes, and the drift from the exact composite on the same
     stores;
  9. the mesh (after 7c; its NCCL part on phase 7's pipeline before that
     pipeline is freed): MESH_WORLD = 4 ranks spawned on the one card
     (torch.multiprocessing) over a gloo process group, since NCCL refuses
     two ranks on one device, so their collectives move CUDA tensors
     through host memory and their times are those of ranks sharing one
     card, not multi-GPU times.  Each rank builds phase 2's seeded bf16
     pipeline and runs, on mesh (job 1, seq 2, model 2): the three
     inversions, the stream and the fused composites and the decode of
     phase 2 (each within TOL_MESH of max |x| of the same run in this
     process), phase 4's fp32 UNet forward (within TOL_REF of the card's
     single-process forward) and the same forward with a planted fault (the
     all-reduce after every row-split projection dropped) beyond TOL_MESH
     of it, a 32-frame
     UNet forward with temporal_window 16 as ring context parallelism
     (within TOL_MESH of the banded forward in one process), one
     1280-channel Ulysses call (20 heads) over seq = 2 and 4 against
     ring_sdpa unsharded; on mesh (job 2, seq 2, model 1) invert_batch of
     the three videos and a J = 2 fused sample_composite_batch (the
     second entry's masks exchanged), within TOL_BATCH of the single runs;
     then enable_int8(mode="mixed") before enable_mesh and one fused
     composite step, K3 on every rank's tensor-parallel shares.  Every
     rank's results must equal rank 0's; per rank its wall time, K1 / K2 /
     K3 and norm launches (required > 0 where its path launches them),
     norms that took their plain version on the card (required 0 in every
     stage: the temporal transformers' GroupNorm over a rank's frames too
     takes the kernels, its partial moments all-gathered over "seq"),
     collective calls and peak memory per stage, its local launch shapes (which join
     phase 8), and its operations on the int8 fused step (utils.flops)
     beside the one-process count over the world size.  Before the spawn,
     which collectives gloo takes on CUDA tensors (all-reduce, all-gather
     and all-to-all must: the port hands them CUDA tensors and stages only
     the ring's point-to-point through host memory).  And one NCCL
     process group of world size 1 through enable_mesh (the launcher's
     environment, the default backend on CUDA): its 1x1x1 mesh's UNet
     forward bitwise the unmeshed one;
  8. kernel phases: K1 and K2 at every distinct shape the bf16 slice, the
     reuse phases, the CLI phases, the mesh and the tiled decode launched,
     plus a ragged 14400-token K1 case and K1 with the temporal-window band as its
     bias (F = 96 in both frame layouts, F = 160), each against its plain
     version computed in fp32 from the same inputs (bf16 within TOL_BF16,
     phase 9's fp32 launches within TOL_FP32 of max |plain|); K3 at every
     (M, K, N, dtype) phases 5 and 6 launched plus a ragged 17x36x9 case,
     bitwise against its plain version.  Each with its device time
     (kernel_ms: TIMED_REPS launches captured in one CUDA graph and
     replayed, so host time between launches does not count; call_ms: the
     same launches back to back from Python, CUDA events around them), the
     plain version's time, the device time of one PyTorch library call of
     the same function (a yardstick the port never calls), and the least
     time the card could take; the design it launched (K1: wgmma or SIMT;
     K2: mma or SIMT; K3: wgmma or mma), its rate, its share of that
     bound, its ratio to the library call, and the device time and error
     of its old design on the same inputs (K1, K2: PR 1's SIMT kernels; K3:
     the mma.sync kernel), its operations from utils.flops.kernel_flops
     (K1's band rows bound by the pairs the function needs, beside the
     kernel's count of every pair); after the build, per-kernel registers
     (-Xptxas -v) and the HGMMA / IGMMA / HMMA / IMMA counts in each
     kernel's SASS (cuobjdump); K3's host cost per launch.  Then the fused
     norms (ops/norm.py) at every (shape, groups, eps, silu, dtype) any
     phase launched, each against its plain version from the same inputs
     (bf16 within TOL_BF16, fp32 within TOL_FP32 of max |plain|) and
     bitwise against a second launch, with the kernel's device time (a CUDA
     graph of NORM_REPS launches), its call's, the plain version's, one
     PyTorch library call's (F.layer_norm; F.group_norm on the channels-
     first view, then F.silu where the norm has it: a yardstick the port
     never calls, with its error against the plain version) and the byte
     floor.  Last, the bf16
     and int8-mixed composite steps with K1's, K2's and K3's shares.
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
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core peak
PEAK_FP32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# bf16 kernel vs fp32 plain on unit-variance inputs: |err| <= TOL_BF16 * max|plain|.
# Tied to the output's own scale (which falls as 1/sqrt(Sk) for K1): the
# bf16 roundings of the pre-scaled q, of p and of the output each cost up to
# 2^-9 of what they round, so the kernel's error stays a few 1e-3 of max|plain|
TOL_BF16 = 2e-2
# an fp32 kernel (phase 9's fp32 forward) vs its fp32 plain version, relative
# to max|plain| (tests/test_torch_kernels.py's fp32 tolerance)
TOL_FP32 = 2e-5
TOL_REF = 1e-3             # fp32 card vs fp32 CPU, relative to max |output|
# int8 card vs int8 CPU, the card replaying the CPU's int8 activations: the
# difference must stay under this share of the int8-vs-fp32 drift (the
# goldens' rule), and the card's own quantization may put at most this
# share of the elements one step from the CPU's (fp32 roundings)
TOL_INT8_SHARE = 0.1
TOL_FLIP_SHARE = 1e-5
# K3 vs its plain version: integer sums are exact, the epilogue is the same
TOL_S8 = 0.0
# one bf16 composite step, two_pass=True or stream vs fused, relative to
# max |latents|: the same function, but the pre-composited capture sums the
# source terms in another order than the fused injection, so bf16 roundings
# (2^-9 of a feature) pass through a random-weight UNet and the x9
# guidance.  Phase 3 also plants two faults (injection dropped, masks
# swapped), which must land above it
TOL_TWO_PASS = 0.1
# batched vs sequential at 1280 x 720 through the CLIs (phase 7b), relative to
# max |x|: the trajectories and final latents of the batched step loops
# against the per-entry ones.  The same function, but cuBLAS / cuDNN pick
# their algorithms by batch size, so the bf16 roundings differ as phase 3's
# reordered sums do; two planted faults (the entries' conditioning or masks
# exchanged inside the batch) must land above it
TOL_BATCH = 0.1
# K1 with the temporal-window band as its bias, (frame layout, pixels, heads,
# F, window): F = 96 in both layouts at the 512 px level-0 geometry, F = 160
# at level 1 (D = 64)
BAND_CASES = (("sf", 4096, 5, 96, 16), ("natural", 4096, 5, 96, 16),
              ("natural", 1024, 10, 160, 16))
# packages the JAX loader imports and the port does without
FOREIGN_PACKAGES = ("safetensors", "transformers", "regex", "ftfy")
# timed launches of every kernel and of its library call at every shape
# (5 moved by up to 28% between runs: PERF.md, PR 2)
TIMED_REPS = 20
# phase 9, the mesh: ranks sharing the card, (job 1, seq 2, model 2); the mesh
# runs against the same runs in one process, relative to max |x| (bf16, like
# TOL_TWO_PASS and TOL_BATCH: the ranks sum tensor-parallel partial products
# and attend over resharded blocks in another order); the ring's 32-frame
# windowed forward; the Ulysses call's pixel count (5 branches x the 8 x 8 level)
MESH_WORLD = 4
TOL_MESH = 0.1
MESH_RING_FRAMES, MESH_RING_WINDOW = 32, 16
MESH_ULYSSES_PIXELS = 320
HOST_CALLS = 200  # K3 wrapper calls timed on the host clock, back to back
NORM_REPS = 5  # timed launches of a fused norm at each shape
# each operation class of utils.flops: the peak rate it can run at on the card
# (the steps' float work is bf16, their int8 products K3's) and the kernel
# group (utils.profiling.KERNEL_GROUPS) whose device time it runs in
CLASS_PEAK = {"conv": PEAK_BF16_FLOPS, "dot": PEAK_BF16_FLOPS,
              "flash_attention": PEAK_BF16_FLOPS, "frame_attention": PEAK_BF16_FLOPS,
              "s8_matmul": PEAK_INT8_OPS}
CLASS_GROUP = {"conv": "convolution", "dot": "GEMM", "flash_attention": "K1 flash attention",
               "frame_attention": "K2 frame attention", "s8_matmul": "K3 s8 GEMM"}

KERNELS = {
    "flash_attention": dict(source="mvoc_tpu_torch/csrc/flash_attention.cu",
                            replaces="mvoc_tpu/ops/attention.py:148"),
    "frame_attention": dict(source="mvoc_tpu_torch/csrc/frame_attention.cu",
                            replaces="mvoc_tpu/ops/attention.py:270"),
    "s8_matmul": dict(source="mvoc_tpu_torch/csrc/s8_gemm.cu",
                      replaces="mvoc_tpu/ops/s8gemm.py:101"),
}
# (library stem, kernel name fragment, SASS op) that must be there: the
# tensor-core designs really run on the tensor cores
# each kernel's rate (K1, K3 operations; K2, bound by HBM, bytes) and the
# design its old-design rows time
RATE = {"flash_attention": lambda ph: (ph["bound_flops"] / ph["ms"] / 1e9, "TF/s"),
        "frame_attention": lambda ph: (ph["bytes"] / ph["ms"] / 1e6, "GB/s"),
        "s8_matmul": lambda ph: (ph["flops"] / ph["ms"] / 1e9, "TOP/s")}
OLD_DESIGN = {"flash_attention": "PR 1 SIMT", "frame_attention": "PR 1 SIMT",
              "s8_matmul": "PR 2 mma.sync"}
SASS_REQUIRED = (("flash_attention", "flash_wgmma_d64", "HGMMA"),
                 ("frame_attention", "frame_mma_kernel", "HMMA"),
                 ("s8_gemm", "s8_wgmma_kernel", "IGMMA"))  # int8 wgmma
PROMPT = "a red boat and a surfer on the sea"
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_SIZE = (1280, 720)  # both shipped templates' image_size
CARD = "cuda"  # the device phase 6b holds the CPU's frameinit / warp_affine against


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call of fn: `reps` calls captured in one CUDA graph
    and replayed, so the host's time between launches (the wrappers'
    Python, argument checks and, for K3, the tensor maps' encoding) does not
    count.  fn has run before (warm-up, and every kernel already built)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# launch counters of every kernel
# ---------------------------------------------------------------------------


def _counter_modules():
    from mvoc_tpu_torch.ops import attention as A
    from mvoc_tpu_torch.ops import norm as N
    from mvoc_tpu_torch.ops import s8gemm as S8

    return A, S8, N


def reset_counts() -> None:
    for mod in _counter_modules():
        mod.reset_launch_counts()


def read_counts():
    """({kernel: launches}, {kernel: {signature: launches}}) of all kernels."""
    launches, shapes = {}, {}
    for mod in _counter_modules():
        launches.update(mod.LAUNCHES)
        shapes.update({k: dict(v) for k, v in mod.LAUNCH_SHAPES.items()})
    return launches, shapes


def read_variants() -> dict:
    """{kernel: {design: launches}} of all kernels."""
    out = {}
    for mod in _counter_modules():
        out.update({k: dict(v) for k, v in getattr(mod, "LAUNCH_VARIANTS", {}).items()})
    return out


def _minus(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()}


# ---------------------------------------------------------------------------
# the slice: invert -> stream composite -> decode
# ---------------------------------------------------------------------------


def run_slice(pipe, videos, masks, steps: int, seed: int, tag: str) -> dict:
    """Invert the three videos, composite (stream, N=2) and decode, with every
    launch count set to 0 just before and read just after.  The trajectory
    stores stay under the returned "root" until the caller removes it."""
    import torch

    from mvoc_tpu_torch.io.trajectory import TrajectoryStore

    nf, size = len(videos[0]), videos[0][0].size[0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tmp = tempfile.mkdtemp(prefix=f"mvoc_smoke_{tag}_")
    dirs = [os.path.join(tmp, name) for name in ("bg", "obj0", "obj1")]
    t_main = time.perf_counter()
    inv_secs, trajs = [], []
    for d, frames in zip(dirs, videos):
        (_, traj), secs = sync_time(lambda: pipe.invert(
            frames, height=size, width=size, num_frames=nf, num_inference_steps=steps,
            seed=seed, output_dir=d))
        if not np.isfinite(traj).all():
            raise RuntimeError(f"{tag}: inversion of {d} gave non-finite latents")
        inv_secs.append(secs)
        trajs.append(traj)
        log(f"{tag} invert {os.path.basename(d)}: {steps} steps in {secs:.2f} s "
            f"(trajectory {traj.shape})")
    inv_launch, inv_shapes = read_counts()
    step_times = []
    last = [time.perf_counter()]

    def on_step(i):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_times.append(now - last[0])
        last[0] = now

    comp_kwargs = dict(height=size, width=size, num_frames=nf, num_inference_steps=steps,
                       guidance_scale=9.0, seed=seed)
    stores = [TrajectoryStore(d) for d in dirs]

    def composite():
        last[0] = time.perf_counter()
        return pipe.sample_composite(
            PROMPT, videos[0][0], videos[0], videos[0], videos[1:], masks, masks, stores[0],
            stores[1:], two_pass="stream", decode=False, step_callback=on_step, **comp_kwargs)

    final, secs = sync_time(composite)
    n_comp = len(step_times)
    launch_c, shapes_c = read_counts()
    comp_launch = _minus(launch_c, inv_launch)
    comp_shapes = {k: _minus(v, inv_shapes[k]) for k, v in shapes_c.items()}
    video, dec_secs = sync_time(lambda: pipe.decode_latents(final, decode_chunk_size=1))
    main_secs = time.perf_counter() - t_main
    launches, shapes = read_counts()
    variants = read_variants()
    peak = torch.cuda.max_memory_allocated() / 2**30
    from mvoc_tpu_torch.ops import norm as N

    if any(N.PLAIN_CALLS.values()):  # every norm of the slice takes the fused kernels
        raise RuntimeError(f"{tag}: norms took the plain version on the card: {N.PLAIN_CALLS}")
    if not (torch.isfinite(final).all() and np.isfinite(video).all()):
        raise RuntimeError(f"{tag}: composite or decode gave non-finite values")
    if video.shape != (nf, size, size, 3):
        raise RuntimeError(f"{tag}: decoded video shape {video.shape}")
    log(f"{tag} composite (stream, N=2, natural layout): {n_comp} steps in {secs:.2f} s, "
        f"s/step {[round(t, 3) for t in step_times]}; decode {dec_secs:.2f} s; "
        f"main path {main_secs:.1f} s; peak memory {peak:.2f} GiB")
    log(f"{tag} launches on the main path: {launches}; in the inversions: {inv_launch}; "
        f"per composite step: { {k: v / max(n_comp, 1) for k, v in comp_launch.items()} }; "
        f"per design on the main path: {variants}")
    return dict(final=final, root=tmp, stores=stores, launches=launches, shapes=shapes,
                variants=variants, trajs=trajs, video=video,
                inv_launch=inv_launch, comp_launch=comp_launch, comp_shapes=comp_shapes,
                steps=n_comp, step_s=step_times, inv_s=inv_secs, decode_s=dec_secs,
                main_s=main_secs, peak_gib=peak)


def one_step_inputs(pipe, videos, masks, stores, steps: int, seed: int, two_pass):
    """The composite's prepared inputs cut to its first step."""
    nf, size = len(videos[0]), videos[0][0].size[0]
    prep = pipe._prepare_composite(
        PROMPT, videos[0][0], videos[0], videos[0], videos[1:], masks, masks, stores[0],
        stores[1:], height=size, width=size, num_frames=nf, num_inference_steps=steps,
        guidance_scale=9.0, seed=seed, two_pass=two_pass)
    init, cond, sched, ms, pb, ps, cw = prep
    one = dataclasses.replace(
        sched, bg_traj=sched.bg_traj[:1], obj_traj=sched.obj_traj[:1],
        gate_spatial=sched.gate_spatial[:1], gate_temporal=sched.gate_temporal[:1],
        gate_conv=sched.gate_conv[:1], fusion_mask=sched.fusion_mask[:1],
        timesteps=sched.timesteps[:1])
    return init, cond, one, ms, pb, ps, cw


def flops_budget(by_class: dict, wall_s: float, groups_ms: dict, tag: str) -> dict:
    """One steady step's operations (utils.flops, by class) against its time:
    TF per step, achieved TF/s and mfu (total operations x steps/s over the
    bf16 dense peak, for every precision), each class's rate in its kernel
    group's device time, and the speed-of-light floor (each class's
    operations over its peak, summed); a step faster than its floor fails
    the run."""
    total = by_class["total"]
    floor_s = sum(by_class[c] / peak for c, peak in CLASS_PEAK.items())
    rates = {}
    for c, group in CLASS_GROUP.items():
        secs = (groups_ms or {}).get(group, 0.0) / 1e3
        rates[c] = by_class[c] / secs / 1e12 if by_class[c] and secs else None
    shares = {c: None if r is None else 1e12 * r / CLASS_PEAK[c] for c, r in rates.items()}
    out = dict(tf_per_step={c: by_class[c] / 1e12 for c in (*CLASS_PEAK, "total")},
               achieved_tf_s=total / wall_s / 1e12, mfu=total / wall_s / PEAK_BF16_FLOPS,
               floor_s=floor_s, class_tf_s=rates, class_peak_share=shares)
    log(f"{tag} operations of one steady step (utils.flops, counted on its warm-up): "
        f"{ {c: round(v, 4) for c, v in out['tf_per_step'].items()} } TF; achieved "
        f"{out['achieved_tf_s']:.2f} TF/s at {1e3 * wall_s:.1f} ms a step, mfu {out['mfu']:.4f} "
        f"(of 989 TF/s bf16); per class, TF/s in its own device time "
        f"{ {c: None if r is None else round(r, 2) for c, r in rates.items()} } (share of its "
        f"peak { {c: None if v is None else round(v, 4) for c, v in shares.items()} }); "
        f"speed-of-light floor {1e3 * floor_s:.2f} ms")
    if not wall_s >= floor_s:
        raise RuntimeError(f"{tag}: a steady step measured {1e3 * wall_s:.2f} ms, under its "
                           f"speed-of-light floor of {1e3 * floor_s:.2f} ms")
    return out


def profile_step(run, tag: str, trace_dir=None) -> dict:
    """One composite step (`run`, warmed up first) under torch.profiler:
    its wall time, the device's busy time (the union of the kernels'
    intervals) and idle share, and the device time by kernel group; its
    Chrome trace written to trace_dir/trace.json when given.  The warm-up
    is counted by utils.flops (flops_budget; `flops_by_module`: by UNet
    child)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvoc_tpu_torch.utils.flops import FlopCounter
    from mvoc_tpu_torch.utils.profiling import is_span, kernel_group

    with FlopCounter() as counter:
        sync_time(run)
    _, wall_s = sync_time(run)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = sync_time(run)
    if trace_dir is not None:
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    # device kernels and copies, not the device lane's copies of the port's
    # spans (user annotations)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not is_span(e.name)]
    if not kernels:
        log(f"{tag} profile: no device events (CUPTI gave none): not measured")
        return dict(wall_s=wall_s, device_busy_ms=None, flops_by_module=counter.modules(),
                    flops=flops_budget(counter.by_class(), wall_s, None, tag))
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    groups, names = {}, {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        group = kernel_group(e.name)
        groups[group] = groups.get(group, 0.0) + dur
        names[e.name] = names.get(e.name, 0.0) + dur
    out = dict(wall_s=wall_s, profiled_wall_s=prof_s, device_busy_ms=busy / 1e3,
               kernel_window_ms=window / 1e3,
               # the profiler slows the host, not the kernels: idle share of
               # the unprofiled step
               idle_share=max(0.0, 1.0 - busy / (1e6 * wall_s)),
               launches=len(kernels),
               groups_ms={g: v / 1e3 for g, v in sorted(groups.items(), key=lambda x: -x[1])},
               top_kernels_ms={n[:120]: v / 1e3 for n, v in
                               sorted(names.items(), key=lambda x: -x[1])[:12]})
    log(f"{tag} profile of one steady composite step: wall {1e3 * wall_s:.1f} ms unprofiled, "
        f"{1e3 * prof_s:.1f} ms profiled; device busy {out['device_busy_ms']:.1f} ms over "
        f"{out['launches']} kernel launches, idle share {out['idle_share']:.3f}; device ms by "
        f"group: { {g: round(v, 2) for g, v in out['groups_ms'].items()} }")
    out.update(flops=flops_budget(counter.by_class(), wall_s, out["groups_ms"], tag),
               flops_by_module=counter.modules())
    return out


def path_flops(pipe, init, cond, one, ms, pb, ps, steps: int) -> dict:
    """TF of one step of the fused and the two_pass=True composite and of one
    inversion step (one branch: cfg 1, bg's conditioning), counted
    shape-only on phase 3's inputs."""
    import torch

    from mvoc_tpu_torch.pipeline import core
    from mvoc_tpu_torch.utils import flops as FL

    out = {}
    with torch.inference_mode():
        for name, two_pass in (("fused", False), ("two_pass", True)):
            out[name] = FL.forward_flops(core.pnp_composite_core, pipe.unet, pipe.ddim, init,
                                         cond, one, ms, pb, ps, num_inference_steps=steps,
                                         guidance_scale=9.0, two_pass=two_pass)
        out["inversion"] = FL.forward_flops(core.ddim_inversion_core, pipe.unet, pipe.ddim, init,
                                            cond.slice(0, 1), one.timesteps[:1], steps)
    log("one step, shape-only count (TF): " + "; ".join(
        f"{name} { {c: round(v / 1e12, 4) for c, v in by.items()} }" for name, by in out.items()))
    return out


def route_check(pipe, init, cond, t: int) -> dict:
    """One full-width UNet forward of the fused batch (N+3 branches) counted
    on the card (the kernels launched) and shape-only on meta
    (utils.flops.forward_flops): equal class by class, or the run fails,
    so that the count sees every launch."""
    import torch

    from mvoc_tpu_torch.utils import flops as FL

    b = cond.encoder_hidden_states.shape[0]
    x = init[None].expand(b, *init.shape)
    fwd = lambda unet, x, **kw: unet(x, t, **kw)  # noqa: E731
    reset_counts()
    with torch.inference_mode():
        card = FL.matmul_flops_by_class(fwd, pipe.unet, x, **cond.unet_kwargs())
        torch.cuda.synchronize()
        launches, _ = read_counts()
        meta, meta_s = sync_time(lambda: FL.forward_flops(fwd, pipe.unet, x,
                                                          **cond.unet_kwargs()))
    log(f"route check, one {b}-branch full-width UNet forward: TF by class on the card "
        f"(launches {launches}) { {c: v / 1e12 for c, v in card.items()} }, shape-only on meta "
        f"({meta_s:.1f} s) { {c: v / 1e12 for c, v in meta.items()} }")
    if card != meta:
        raise RuntimeError(f"the card's count of a forward {card} is not its meta count {meta}")
    if not all(launches[k] > 0 for k in ("flash_attention", "frame_attention")):
        raise RuntimeError(f"the route check's forward launched {launches}")
    return dict(card=card, meta_s=meta_s, launches=launches)


# ---------------------------------------------------------------------------
# the reuse and broadcast modes at 512 px (phase 6b)
# ---------------------------------------------------------------------------


def _nbytes(x) -> int:
    """Bytes of the tensors in a nest of tuples, lists and dicts."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class ReuseProbe:
    """Per step of the step loops run inside it: seconds (synced, from the
    loop's start), K1 and K2 launches, and the bytes of the caches the UNet
    calls of that step returned (the encoder cache, the PAB dict, and under
    capture reuse one capture's features: the summed S the loop keeps).
    Its `on_step` is the entry points' step_callback."""

    LOOPS = ("ddim_inversion_core", "ddim_inversion_batch_core", "pnp_composite_core",
             "pnp_composite_batch_core")

    def __init__(self, pipe, capture_reuse: bool = False):
        self.pipe, self.capture_reuse = pipe, capture_reuse
        self.step_s, self.k1, self.k2, self.cache_bytes = [], [], [], []
        self.call_bytes = []  # (the cache keywords a UNet call had, the bytes it returned)
        self._bytes, self._captured, self._last, self._counts = 0, False, 0.0, None

    def _mark(self):
        import torch

        torch.cuda.synchronize()
        self._last, self._counts = time.perf_counter(), read_counts()[0]

    def on_step(self, i):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.step_s.append(now - self._last)
        counts = read_counts()[0]
        d = _minus(counts, self._counts)
        self.k1.append(d["flash_attention"])
        self.k2.append(d["frame_attention"])
        self.cache_bytes.append(self._bytes)
        self._last, self._counts, self._bytes, self._captured = now, counts, 0, False

    def __enter__(self):
        from mvoc_tpu_torch.pipeline import core

        self._orig = {n: getattr(core, n) for n in self.LOOPS}
        for name, fn in self._orig.items():
            def loop(*a, _fn=fn, **kw):
                self._mark()
                return _fn(*a, **kw)
            setattr(core, name, loop)
        forward = self.pipe.unet.forward

        def recorded(*a, **kw):
            out = forward(*a, **kw)
            if isinstance(out, tuple):
                extra = list(out[1:])
                self.call_bytes.append((tuple(sorted(n for n in ("return_encoder", "pab_capture")
                                                     if kw.get(n))), _nbytes(extra)))
                if kw.get("pnp_capture"):
                    feats = extra.pop(0)
                    if self.capture_reuse and not self._captured:
                        self._bytes += _nbytes(feats)
                        self._captured = True
                self._bytes += _nbytes(extra)
            return out

        self.pipe.unet.forward = recorded
        return self

    def __exit__(self, *exc):
        from mvoc_tpu_torch.pipeline import core

        for name, fn in self._orig.items():
            setattr(core, name, fn)
        del self.pipe.unet.forward


def reuse_stats(probe: ReuseProbe, k: int, peak: float, secs: float) -> dict:
    """A run's per-step figures split into fresh and cached steps."""
    from mvoc_tpu_torch.pipeline import core

    fresh = core.fresh_steps(len(probe.step_s), k)

    def mean(vals, want):
        picked = [v for v, f in zip(vals, fresh) if f == want]
        return sum(picked) / len(picked) if picked else None

    k12 = [a + b for a, b in zip(probe.k1, probe.k2)]
    return dict(step_s=probe.step_s, fresh=fresh, s=secs,
                fresh_step_s=mean(probe.step_s, True), cached_step_s=mean(probe.step_s, False),
                k1k2_fresh=mean(k12, True), k1k2_cached=mean(k12, False),
                k1_fresh=mean(probe.k1, True), k1_cached=mean(probe.k1, False),
                k2_fresh=mean(probe.k2, True), k2_cached=mean(probe.k2, False),
                mean_step_s=sum(probe.step_s) / max(len(probe.step_s), 1),
                cache_bytes=max(probe.cache_bytes or [0]), peak_gib=peak)


def _rel_l2(a, b) -> float:
    import torch

    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    return ((a - b).norm() / b.norm()).item()


def reuse_phase(pipe, videos, masks, seed: int, steps: int = 6) -> dict:
    """Phase 6b: every reuse and broadcast mode through the entry points at
    512 px on the bf16 pipeline of phase 2, its videos and masks.  The
    inversion (`steps` steps of the background video): exact, k = 2, k = 2
    deep, k = 3 at depth 2, and invert_batch of the three videos exact and
    at k = 2 deep.  The composite (`steps` run steps over the trajectories
    of exact inversions, phase 2's gates and fusion): exact on the fused,
    two_pass=True and stream paths, encoder reuse k = 2 on each, k = 2 at
    depth 2 (fused), PAB k = 2 (fused), capture reuse k = 2 (two_pass=True,
    stream), deep capture reuse k = 3 (stream), one capture broadcast over
    every step (stream), and a batch of J = 2 entries (the second with the
    objects' masks exchanged) with deep capture reuse k = 3 on stream.  Per
    run: seconds per fresh and per cached step, K1 and K2 launches per
    fresh and per cached step, the cache's bytes, peak memory, and the
    drift from the exact run of its path.  Then FreeU on and off for one
    fused step, and frameinit / warp_affine on the card against the CPU."""
    import torch

    from mvoc_tpu_torch.io.trajectory import TrajectoryStore
    from mvoc_tpu_torch.ops import affine, freeinit
    from mvoc_tpu_torch.pipeline import core

    nf, size = len(videos[0]), videos[0][0].size[0]
    runs, gates = {}, {}
    reset_counts()

    def run(tag, call, k, capture_reuse=False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with ReuseProbe(pipe, capture_reuse) as probe:
            out, secs = sync_time(lambda: call(probe.on_step))
        out = torch.as_tensor(out)
        if not torch.isfinite(out).all():
            raise RuntimeError(f"reuse {tag}: non-finite output")
        stats = reuse_stats(probe, k, torch.cuda.max_memory_allocated() / 2**30, secs)
        runs[tag] = dict(stats, out=out)
        return out

    inv_kw = dict(height=size, width=size, num_frames=nf, num_inference_steps=steps, seed=seed)
    inv_modes = (("exact", 1, {}), ("k2", 2, dict(encoder_reuse_interval=2)),
                 ("k2 deep", 2, dict(encoder_reuse_interval=2, deep_reuse=True)),
                 ("k3 depth2", 3, dict(encoder_reuse_interval=3, encoder_reuse_depth=2)),
                 ("interval 1", 1, dict(encoder_reuse_interval=1, deep_reuse=True,
                                        encoder_reuse_depth=2)))
    for name, k, kw in inv_modes:
        run(f"invert {name}", lambda cb, kw=kw: pipe.invert(
            videos[0], **inv_kw, **kw, step_callback=cb)[1], k)
    for name, k, kw in (("exact", 1, {}),
                        ("k2 deep", 2, dict(encoder_reuse_interval=2, deep_reuse=True))):
        run(f"invert_batch {name}", lambda cb, kw=kw: pipe.invert_batch(
            videos, **inv_kw, **kw, step_callback=cb)[1], k)

    # the composite's sources: exact inversions over its whole schedule
    tmp = tempfile.mkdtemp(prefix="mvoc_smoke_reuse_")
    try:
        stores = []
        for j, frames in enumerate(videos):
            d = os.path.join(tmp, f"v{j}")
            pipe.invert(frames, **dict(inv_kw, num_inference_steps=steps + 1), output_dir=d)
            stores.append(TrajectoryStore(d))
        comp_kw = dict(height=size, width=size, num_frames=nf, num_inference_steps=steps + 1,
                       guidance_scale=9.0, seed=seed, decode=False)

        def entry(m):
            return dict(prompt=PROMPT, main_first_image=videos[0][0], main_image_list=videos[0],
                        background_image_list=videos[0], objs_image_list=videos[1:],
                        masks_soft=m, masks_binary=m, bg_store=stores[0], obj_stores=stores[1:])

        swapped = masks[::-1].copy()
        comp_modes = (
            ("fused exact", False, 1, {}), ("two_pass exact", True, 1, {}),
            ("stream exact", "stream", 1, {}),
            ("fused k2", False, 2, dict(encoder_reuse_interval=2)),
            ("two_pass k2", True, 2, dict(encoder_reuse_interval=2)),
            ("stream k2", "stream", 2, dict(encoder_reuse_interval=2)),
            ("fused k2 depth2", False, 2, dict(encoder_reuse_interval=2, encoder_reuse_depth=2)),
            ("fused pab k2", False, 2, dict(pab_interval=2)),
            ("two_pass capture k2", True, 2, dict(capture_reuse_interval=2)),
            ("stream capture k2", "stream", 2, dict(capture_reuse_interval=2)),
            ("stream capture deep k3", "stream", 3,
             dict(capture_reuse_interval=3, capture_reuse_deep=True)),
            ("stream capture stale", "stream", 2 * steps,
             dict(capture_reuse_interval=2 * steps)),
            ("fused interval 1", False, 1,
             dict(encoder_reuse_interval=1, encoder_reuse_depth=2, pab_interval=1)),
            ("stream interval 1", "stream", 1,
             dict(capture_reuse_interval=1, capture_reuse_deep=False)),
        )
        for name, two_pass, k, kw in comp_modes:
            run(f"composite {name}", lambda cb, two_pass=two_pass, kw=kw: pipe.sample_composite(
                **entry(masks), **comp_kw, two_pass=two_pass, **kw, step_callback=cb), k,
                capture_reuse="capture" in name)
        deep3 = dict(two_pass="stream", capture_reuse_interval=3, capture_reuse_deep=True)
        run("composite stream capture deep k3, masks exchanged", lambda cb: pipe.sample_composite(
            **entry(swapped), **comp_kw, **deep3, step_callback=cb), 3, capture_reuse=True)
        run("composite_batch stream capture deep k3, J=2", lambda cb: pipe.sample_composite_batch(
            [entry(masks), entry(swapped)], **comp_kw, **deep3, step_callback=cb), 3,
            capture_reuse=True)

        # one fused step with FreeU on, then off
        init, cond, one, ms, pb, ps, _ = one_step_inputs(pipe, videos, masks, stores, steps + 1,
                                                         seed, False)

        def fused_step():
            return core.pnp_composite_core(pipe._unet_apply(), pipe.ddim, init, cond, one, ms,
                                           pb, ps, num_inference_steps=steps + 1,
                                           guidance_scale=9.0)

        plain = fused_step()
        pipe.enable_freeu(s1=0.9, s2=0.2, b1=1.1, b2=1.2)
        freeu_out = fused_step()
        pipe.disable_freeu()
        after = fused_step()
    finally:
        shutil.rmtree(tmp)
    freeu = dict(rel_l2=_rel_l2(freeu_out, plain), finite=bool(torch.isfinite(freeu_out).all()),
                 off_bitwise=bool(torch.equal(after, plain)))
    log(f"reuse: FreeU (s1 0.9, s2 0.2, b1 1.1, b2 1.2), one fused step: rel_l2 {freeu['rel_l2']:.4g}"
        f" from the plain step, finite {freeu['finite']}; after disable_freeu bitwise the plain "
        f"step: {freeu['off_bitwise']}")
    if not (freeu["finite"] and freeu["rel_l2"] > 0 and freeu["off_bitwise"]):
        raise RuntimeError(f"reuse: FreeU on the card {freeu}")

    # frameinit (the noise passed in) and warp_affine: card against CPU, fp32
    g = np.random.default_rng(seed + 7)
    lat = torch.from_numpy(g.standard_normal((nf, 64, 64, 4)).astype(np.float32))
    noise = torch.from_numpy(g.standard_normal((nf, 64, 64, 4)).astype(np.float32))
    alphas = pipe.ddim.alphas_cumprod
    theta = affine.cv_affine_to_normalized(np.array([[0.8, 0.1, 5.0], [-0.1, 1.2, -3.0]]),
                                           (64, 64), (64, 64))
    ops = {"frameinit": lambda dev: freeinit.frameinit(lat.to(dev), alphas, noise=noise.to(dev)),
           "warp_affine nearest": lambda dev: affine.warp_affine(lat.to(dev), theta, (64, 64)),
           "warp_affine bilinear": lambda dev: affine.warp_affine(lat.to(dev), theta, (64, 64),
                                                                  mode="bilinear")}
    extras = {}
    for name, fn in ops.items():
        cpu, card = fn("cpu"), fn(CARD).cpu()
        extras[name] = ((card - cpu).abs().max() / cpu.abs().max()).item()
        log(f"reuse: {name} on the card vs the CPU (fp32): max |diff| {extras[name]:.3g} of "
            f"max |x| (limit 1e-5)")
        if not extras[name] <= 1e-5:
            raise RuntimeError(f"reuse: {name} on the card disagrees with the CPU")

    # drift from the exact run of each path, and the checks
    def exact_of(tag):
        if tag.startswith("invert_batch"):
            return "invert_batch exact"
        if tag.startswith("invert"):
            return "invert exact"
        return "composite " + tag.split()[1] + " exact"

    for tag, r in runs.items():
        if tag.endswith("exact") or "J=2" in tag or "exchanged" in tag:
            continue
        ex = runs[exact_of(tag)]
        r.update(rel_l2=_rel_l2(r["out"], ex["out"]), max_rel=_rel(r["out"], ex["out"]),
                 speed=r["mean_step_s"] / ex["mean_step_s"])
    for tag, r in runs.items():
        gb = r["cache_bytes"] / 1e9
        log(f"reuse {tag}: steps {[round(t, 4) for t in r['step_s']]} s (fresh {r['fresh']}); "
            f"s/step fresh {r['fresh_step_s']:.4f} cached {fmt_ms(r['cached_step_s'])}; K1+K2 "
            f"launches per fresh step {r['k1k2_fresh']} (K1 {r['k1_fresh']}, K2 {r['k2_fresh']}) "
            f"per cached step {r['k1k2_cached']} (K1 {r['k1_cached']}, K2 {r['k2_cached']}); cache "
            f"{gb:.3f} GB; peak {r['peak_gib']:.2f} GiB" + (
                f"; mean s/step {r['speed']:.3f}x the exact run; rel_l2 {r['rel_l2']:.4g}, max "
                f"|diff| / max |x| {r['max_rel']:.4g} from it" if "speed" in r else ""))
        if "interval 1" in tag:
            if not torch.equal(r["out"], runs[exact_of(tag)]["out"]):
                raise RuntimeError(f"reuse {tag}: not bitwise the exact run")
            continue
        if r["k1k2_cached"] is not None:
            if not r["k1k2_cached"] < r["k1k2_fresh"]:
                raise RuntimeError(f"reuse {tag}: a cached step launched {r['k1k2_cached']} K1+K2, "
                                   f"a fresh one {r['k1k2_fresh']}")
            if "speed" in r and not r["rel_l2"] > 0:
                raise RuntimeError(f"reuse {tag}: equal to the exact run: the knob did nothing")
    stale, k2 = runs["composite stream capture stale"], runs["composite stream capture k2"]
    gates["stale capture rel_l2 over k2's"] = (stale["rel_l2"], k2["rel_l2"])
    log(f"reuse: one capture broadcast over all {steps} steps drifts rel_l2 {stale['rel_l2']:.4g} "
        f"from the exact stream run, k = 2 {k2['rel_l2']:.4g} (the stale one must drift further)")
    if not stale["rel_l2"] > k2["rel_l2"]:
        raise RuntimeError("reuse: the stale capture drifts no further than k = 2")
    batch = runs["composite_batch stream capture deep k3, J=2"]["out"]
    singles = (runs["composite stream capture deep k3"]["out"],
               runs["composite stream capture deep k3, masks exchanged"]["out"])
    for name, got, want, fault in (("entry 0 vs its single run", batch[0], singles[0], False),
                                   ("entry 1 vs its single run", batch[1], singles[1], False),
                                   ("entry 1 (masks exchanged) vs entry 0's single run",
                                    batch[1], singles[0], True)):
        rel = _rel(got, want)
        gates[f"batch {name}"] = rel
        log(f"reuse: batched deep capture reuse, {name}: {rel:.4g} of max |x| (TOL_BATCH "
            f"{TOL_BATCH}, {'over' if fault else 'under'} it to pass)")
        if fault != (rel > TOL_BATCH) or not math.isfinite(rel):
            raise RuntimeError(f"reuse: batched {name} at {rel:.4g}")
    launches, shapes = read_counts()
    for r in runs.values():
        r.pop("out")
    return dict(runs=runs, gates=gates, freeu=freeu, extras=extras, shapes=shapes)


# ---------------------------------------------------------------------------
# the checkpoint phase: a full-width diffusers directory written and loaded
# ---------------------------------------------------------------------------


def _rss_gib() -> float:
    """This process's resident set (VmRSS), GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("/proc/self/status has no VmRSS")


class RssPeak:
    """The peak resident set of this process while the `with` body runs,
    sampled every 5 ms by a thread (the card's machine keeps no VmHWM)."""

    def __enter__(self):
        import threading

        self.peak = self.before = _rss_gib()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, _rss_gib())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gib())


def checkpoint_phase(seed: int, ckpt: str) -> dict:
    """The seeded bf16 pipeline written as a diffusers I2VGen-XL directory `ckpt`,
    loaded back with load_pipeline (every tensor the written one cast to
    bf16, bit for bit), then checked by the convert CLI as a user runs it."""
    import torch

    from mvoc_tpu_torch.models import convert
    from mvoc_tpu_torch.models.tokenizer import CLIPTokenizer
    from mvoc_tpu_torch.utils import testing as tt

    src = tt.build_full_pipeline(seed=seed)
    nbytes, write_s = sync_time(lambda: tt.write_checkpoint(
        ckpt, src, corpus=[PROMPT] + tt.template_prompts(), n_merges=500))
    files = {os.path.relpath(os.path.join(d, n), ckpt): os.path.getsize(os.path.join(d, n))
             for d, _, names in os.walk(ckpt) for n in names}
    log(f"checkpoint: {nbytes / 1e9:.3f} GB written in {write_s:.2f} s "
        f"({nbytes / 1e9 / write_s:.2f} GB/s) to {ckpt}; weight files "
        f"{ {k: v for k, v in files.items() if k.endswith(('.safetensors', '.bin'))} }")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev_before = torch.cuda.memory_allocated()
    with RssPeak() as rss:
        pipe, load_s = sync_time(lambda: convert.load_pipeline(ckpt, dtype=torch.bfloat16,
                                                               device="cuda"))
    dev_peak = (torch.cuda.max_memory_allocated() - dev_before) / 2**30
    log(f"checkpoint: loaded in {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} GB/s); peak host "
        f"memory of the load {rss.peak:.2f} GiB resident ({rss.peak - rss.before:.2f} GiB "
        f"above the {rss.before:.2f} GiB before it, sampled every 5 ms), peak device memory "
        f"of the load {dev_peak:.2f} GiB")
    n_tensors = 0
    for folder, (_, file_dtype) in tt.CHECKPOINT_FILES.items():
        want, got = getattr(src, folder).state_dict(), getattr(pipe, folder).state_dict()
        if sorted(want) != sorted(got):
            raise RuntimeError(f"checkpoint: {folder} loaded other keys than it wrote")
        for k, w in want.items():
            if not (got[k].dtype == torch.bfloat16 and got[k].is_cuda
                    and torch.equal(got[k], w.to(file_dtype).to(torch.bfloat16))):
                raise RuntimeError(f"checkpoint: {folder}.{k} differs from the written tensor")
        n_tensors += len(want)
    sc, lc = src.unet.config, pipe.unet.config
    geometry = dict(transformer_in=(lc.transformer_in_heads, lc.transformer_in_head_dim),
                    temporal_encoder=(lc.img_temporal_encoder_heads,
                                      lc.img_temporal_encoder_head_dim))
    # config.json does not carry these two: the loader derives them from the shapes
    inner = lambda heads, dim, default: heads * (dim or default)  # noqa: E731
    if (lc.block_out_channels != sc.block_out_channels
            or inner(lc.transformer_in_heads, lc.transformer_in_head_dim, lc.attention_head_dim)
            != inner(sc.transformer_in_heads, sc.transformer_in_head_dim, sc.attention_head_dim)
            or inner(lc.img_temporal_encoder_heads, lc.img_temporal_encoder_head_dim,
                     lc.in_channels)
            != inner(sc.img_temporal_encoder_heads, sc.img_temporal_encoder_head_dim,
                     sc.in_channels)):
        raise RuntimeError(f"checkpoint: UNet geometry {geometry} is not the written one")
    if not isinstance(pipe.tokenizer, CLIPTokenizer) or pipe.tokenize([PROMPT]).shape != (1, 77):
        raise RuntimeError("checkpoint: the tokenizer did not load")
    log(f"checkpoint: {n_tensors} tensors equal to the written ones cast to bf16, bit for bit; "
        f"UNet geometry {geometry}; tokenizer vocabulary {pipe.tokenizer.vocab_size}")
    del src, pipe
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "mvoc_tpu_torch.models.convert", ckpt, "--verify"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    convert_s = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-3:]
    log(f"checkpoint: `python -m mvoc_tpu_torch.models.convert <dir> --verify` exit "
        f"{proc.returncode} in {convert_s:.1f} s: {tail}")
    if proc.returncode != 0:
        raise RuntimeError(f"convert --verify failed:\n{proc.stderr[-4000:]}")
    return dict(dir=ckpt, bytes=nbytes, write_s=write_s, load_s=load_s,
                host_peak_gib=rss.peak, host_before_gib=rss.before, device_peak_gib=dev_peak,
                tensors=n_tensors, files=files, convert_s=convert_s, convert_tail=tail)


# ---------------------------------------------------------------------------
# the CLI phase: both CLIs at the templates' 1280 x 720
# ---------------------------------------------------------------------------


def run_clis(pipe, inv_cfgs, comp_cfgs, batch: bool, tag: str) -> dict:
    """cli.inverse.run then cli.composite.run on `pipe` (batched when
    `batch`), with every launch count set to 0 just before and read just
    after; per CLI stage and per pipeline call (entry points, step loops,
    decode, media I/O) its wall time, launches and peak device memory.
    K1 and K2 must launch in every stage that runs the UNet, K3 in none."""
    import contextlib

    import torch

    from mvoc_tpu_torch.cli import composite, inverse
    from mvoc_tpu_torch.io import media
    from mvoc_tpu_torch.pipeline import core
    from mvoc_tpu_torch.utils.profiling import StepTimer

    stages, peaks, calls, open_stages, step_s, finals = {}, {}, {}, [], [], []

    class CountingTimer(StepTimer):
        """StepTimer whose stages also record their kernel launches, their
        calls and their peak device memory (nested stages included)."""

        @contextlib.contextmanager
        def stage(self, name):
            torch.cuda.synchronize()
            before = read_counts()[0]
            for n in open_stages:  # the peak so far belongs to every open stage
                peaks[n] = max(peaks.get(n, 0), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            open_stages.append(name)
            with super().stage(name):
                yield
                torch.cuda.synchronize()
            open_stages.pop()
            peak = torch.cuda.max_memory_allocated()
            for n in open_stages + [name]:
                peaks[n] = max(peaks.get(n, 0), peak)
            stages[name] = {k: stages.get(name, {}).get(k, 0) + v
                            for k, v in _minus(read_counts()[0], before).items()}
            calls[name] = calls.get(name, 0) + 1

    timer = CountingTimer()
    last = [0.0]
    loops = ("pnp_composite_core", "pnp_composite_batch_core")

    def on_step(i):  # composite steps, synchronised
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - last[0])
        last[0] = now

    def timed(owner, attr, name):
        """owner.attr as a stage of the timer (sub-stages of the CLI stages:
        the pipeline's entry points, its step loops and the VAE decode);
        returns what undoes it."""
        fn = getattr(owner, attr)

        def wrapped(*a, **kw):
            if attr in loops:
                kw["step_callback"] = on_step
                torch.cuda.synchronize()
                last[0] = time.perf_counter()
            with timer.stage(name):
                out = fn(*a, **kw)
            if attr in loops:
                finals.append(out)
            return out

        setattr(owner, attr, wrapped)
        if owner is pipe:
            return lambda: delattr(pipe, attr)
        return lambda: setattr(owner, attr, fn)

    # the host's share: frame loading and the exports
    undo = [timed(pipe, attr, f"pipe.{attr}") for attr in (
        "invert", "invert_batch", "sample", "sample_composite", "sample_composite_batch",
        "decode_latents")]
    undo += [timed(mod, attr, f"{mod.__name__.split('.')[-1]}.{attr}")
             for mod, attr in ((core, "ddim_inversion_core"), (core, "ddim_inversion_batch_core"),
                               (core, "ddim_sampling_core"), (core, "pnp_composite_core"),
                               (core, "pnp_composite_batch_core"), (media, "load_video_frames"),
                               (media, "export_to_video"), (media, "export_to_gif"),
                               (composite, "_load_frame_dir"), (composite, "load_entry_masks"))]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        inverse.run(pipe, inv_cfgs, timer=timer, batch=batch)
        composite.run(pipe, comp_cfgs, timer=timer, batch=batch)
    finally:
        total_s = time.perf_counter() - t0
        launches, shapes = read_counts()
        for u in undo:
            u()
    peak = max(peaks.values()) / 2**30
    times = timer.summary()
    for name, secs in times.items():
        log(f"{tag} stage {name}: {secs:.2f} s wall over {calls[name]} call(s), peak memory "
            f"{peaks[name] / 2**30:.2f} GiB, launches {stages[name]}")
    log(f"{tag}: composite steps {[round(t, 3) for t in step_s]} s")
    log(f"{tag}: both CLIs in {total_s:.1f} s; launches {launches}; peak device memory "
        f"{peak:.2f} GiB; {card_line()}")
    for name, n in stages.items():
        if n["s8_matmul"] != 0:
            raise RuntimeError(f"{tag} stage {name}: s8_matmul launched on the bf16 path")
    # batched, the per-entry stages after the batch only reconstruct bg
    ran_unet = [n for n in stages if n.startswith(("invert/", "composite/"))
                and (not batch or n.endswith("/batched") or n == "invert/bg")]
    for name in ran_unet:
        n = stages[name]
        if n["flash_attention"] <= 0 or n["frame_attention"] <= 0:
            raise RuntimeError(f"{tag} stage {name}: K1 or K2 was never launched ({n})")
    return dict(launches=launches, shapes=shapes, stages=stages, stage_s=times,
                stage_calls=calls, stage_peak_gib={k: v / 2**30 for k, v in peaks.items()},
                composite_step_s=step_s, total_s=total_s, peak_gib=peak, finals=finals)


def cli_phase(steps: int, seed: int, ckpt: str, tmp: str) -> dict:
    """The inversion CLI (3 videos, the reconstruction round trip on bg) and
    the composite CLI (fused, N = 2) on a demo tree of 16-frame 1280 x 720
    videos, through the CLIs' own configure / build_pipeline (from the
    checkpoint directory `ckpt`) / apply_unet_options / apply_quantize /
    run (run_clis).  Then the composite's final latents decoded again,
    tiled.  The pipeline stays in the result for phase 7b."""
    import torch

    from mvoc_tpu_torch import config as cfglib
    from mvoc_tpu_torch.cli import common, composite, inverse
    from mvoc_tpu_torch.io import media
    from mvoc_tpu_torch.io.trajectory import NATIVE_NAME, STACK_NAME
    from mvoc_tpu_torch.utils import testing as tt

    width, height, nf = CLI_SIZE[0], CLI_SIZE[1], 16
    templates = {k: cfglib.load(os.path.join(ROOT, "configs", f"group_{k}", "template.yaml"))
                 for k in ("inversion", "composite")}
    # only the schedule depth is cut: every other key is the template's
    log(f"cli: templates {', '.join(f'configs/group_{k}/template.yaml' for k in templates)}; "
        f"cuts: inversion n_steps {steps} (template "
        f"{templates['inversion'].inverse_config.n_steps}), recon n_steps {steps} from t_idx 1 "
        f"(template {templates['inversion'].recon_config.n_steps} from "
        f"{templates['inversion'].recon_config.ddim_init_latents_t_idx}), composite n_steps "
        f"{steps} from t_idx 1 with fusion_step [0, 1] (template "
        f"{templates['composite'].n_steps} from {templates['composite'].ddim_init_latents_t_idx}, "
        f"{list(templates['composite'].fusion_step)})")
    paths = tt.write_demo_tree(tmp, width, height, nf, steps, seed=seed)
    device = common.template_device(templates["inversion"])
    args = common.parse_args("configs/group_inversion/template.yaml",
                             ["--configs_json", paths["inversion"], "--checkpoint", ckpt])
    pipe, build_s = sync_time(lambda: common.build_pipeline(args, templates["inversion"]))
    pipe = common.apply_unet_options(pipe, templates["inversion"])
    pipe = common.apply_quantize(pipe, templates["inversion"])
    if pipe.device != device or pipe.dtype != torch.bfloat16:
        raise RuntimeError(f"cli: build_pipeline gave {pipe.dtype} on {pipe.device}")
    log(f"cli: pipeline from --checkpoint {ckpt} (--dtype {args.dtype}) on {device} "
        f"(template device {templates['inversion'].device!r}), loaded in {build_s:.1f} s; "
        f"UNet temporal_natural_layout "
        f"{pipe.unet.config.temporal_natural_layout}, quantize "
        f"{templates['inversion'].get('quantize', None)}")
    if media.cv2 is None:
        log("cli: OpenCV is absent on this machine: the composite and recon exports run "
            "without the mp4 (the CLIs themselves raise without OpenCV)")
        media.export_to_video = lambda frames, path, fps=8: path

    inv_cfgs = inverse.configure(templates["inversion"], cfglib.load_json_list(paths["inversion"]))
    comp_cfgs = composite.configure(templates["composite"],
                                    cfglib.load_json_list(paths["composite"]))
    run = run_clis(pipe, inv_cfgs, comp_cfgs, batch=False, tag="cli")

    containers = {}
    for cfg in inv_cfgs:
        out = cfg.inverse_config.output_dir
        containers[cfg.video_name] = [n for n in (NATIVE_NAME, STACK_NAME)
                                      if os.path.exists(os.path.join(out, n))]
        if not containers[cfg.video_name]:
            raise RuntimeError(f"cli: no trajectory container written in {out}")
    log(f"cli: trajectory containers written: {containers}")
    bg = next(c for c in inv_cfgs if c.video_name == "bg")
    with open(os.path.join(bg.output_dir, "recon_metrics.txt")) as f:
        recon = {k: float(v) for k, v in (line.split("=") for line in f.read().split())}
    log(f"cli: reconstruction of bg (random weights): PSNR {recon['psnr_db']:.4f} dB, "
        f"SSIM {recon['ssim']:.4f}")
    if not all(math.isfinite(v) for v in recon.values()):
        raise RuntimeError(f"cli: non-finite reconstruction scores {recon}")
    check_exports(comp_cfgs[0], nf, width, height, tmp,
                  recon=[os.path.join(bg.output_dir, "ddim_reconstruction.gif")]
                  + ([os.path.join(bg.output_dir, "ddim_reconstruction.mp4")]
                     if media.cv2 is not None else []))
    final = run.pop("finals")[-1]
    tiled = tiled_decode_phase(pipe, final, nf, height, width)
    return dict(run, containers=containers, recon=recon, frames=nf, mp4=media.cv2 is not None,
                build_s=build_s, tiled=tiled, pipe=pipe, final=final, templates=templates,
                paths=paths, inv_cfgs=inv_cfgs, comp_cfgs=comp_cfgs)


def check_exports(cfg, nf: int, width: int, height: int, tmp: str, recon=()) -> None:
    """The files a composite entry (and a reconstruction) exported: 16
    frames at the working size, the gif, and the mp4 when OpenCV exists."""
    from PIL import Image

    from mvoc_tpu_torch.cli import composite
    from mvoc_tpu_torch.io import media

    out_dir = composite.export_dir(cfg)
    want = {"recon": list(recon), "composite": [os.path.join(out_dir, "video.gif")]}
    if media.cv2 is not None:
        want["composite"].append(os.path.join(out_dir, "video.mp4"))
    frames = sorted(f for f in os.listdir(out_dir) if f.startswith("video_") and f.endswith(".png"))
    sizes = {Image.open(os.path.join(out_dir, f)).size for f in frames}
    written = {k: [os.path.relpath(p, tmp) for p in v if os.path.exists(p)] for k, v in want.items()}
    log(f"cli: files written: {len(frames)} composite frames of sizes {sorted(sizes)} in "
        f"{os.path.relpath(out_dir, tmp)!r}; {written}")
    if len(frames) != nf or sizes != {(width, height)}:
        raise RuntimeError(f"cli: expected {nf} composite frames at {width}x{height}")
    for kind, files in want.items():
        for p in files:
            if not os.path.exists(p) or os.path.getsize(p) == 0:
                raise RuntimeError(f"cli: {kind} output {p} missing")
    for p in [f for f in want["recon"] + want["composite"] if f.endswith(".mp4")]:
        cap = media.cv2.VideoCapture(p)
        n, shape = 0, None
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            n, shape = n + 1, fr.shape
        cap.release()
        log(f"cli: {os.path.relpath(p, tmp)} decodes to {n} frames of {shape}")
        if n != nf or shape != (height, width, 3):
            raise RuntimeError(f"cli: {p} holds {n} frames of {shape}")
    gif = Image.open(want["composite"][0])
    if getattr(gif, "n_frames", 1) != nf or gif.size != (width, height):
        raise RuntimeError(f"cli: video.gif holds {getattr(gif, 'n_frames', 1)} frames of "
                           f"{gif.size}")


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    import torch

    a, b = torch.as_tensor(a).float().cpu(), torch.as_tensor(b).float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def batch_cli_phase(cli: dict, steps: int, tmp: str) -> dict:
    """Phase 7b: both CLIs batched on phase 7's pipeline and demo tree.  The
    three videos' stores removed, cli.inverse.run(batch=True) inverts them
    in one batched step loop (J = 3), then reconstructs bg; a group JSON of
    two composite entries over the same sources (the second with another
    prompt and seed and the objects' masks exchanged) goes through
    cli.composite.run(batch=True), the fused path at J = 2, and both
    exports.  The batched trajectories and final latents must lie within
    TOL_BATCH of max |x| of the sequential ones (phase 7's; entry 1's run
    here through sample_composite), and two planted faults inside the batch
    (the entries' conditioning exchanged; their masks exchanged) beyond it.
    Last, one steady batched step under the profiler, booked by
    device_op_breakdown to kernel groups and UNet modules."""
    import json

    from mvoc_tpu_torch import config as cfglib
    from mvoc_tpu_torch.cli import composite, inverse
    from mvoc_tpu_torch.io.trajectory import TrajectoryStore
    from mvoc_tpu_torch.pipeline import core, i2vgen
    from mvoc_tpu_torch.utils.profiling import OUTSIDE, device_op_breakdown

    pipe, templates, paths = cli["pipe"], cli["templates"], cli["paths"]
    width, height, nf = CLI_SIZE[0], CLI_SIZE[1], 16
    seq_traj = {}
    for cfg in cli["inv_cfgs"]:
        store = TrajectoryStore(cfg.inverse_config.output_dir)
        seq_traj[cfg.video_name] = store.gather(store.timesteps)
        shutil.rmtree(cfg.inverse_config.output_dir)
    with open(paths["composite"]) as f:
        (entry,) = json.load(f)
    second = dict(entry, editing_prompt="a yellow kayak and a swimmer on a lake", seed=11,
                  edited_video_name="kayak and swimmer",
                  obj_mask_path=list(reversed(entry["obj_mask_path"])))
    batch_json = os.path.join(tmp, "group_composite_batch.json")
    with open(batch_json, "w") as f:
        json.dump([entry, second], f, indent=1)
    inv_cfgs = inverse.configure(templates["inversion"], cfglib.load_json_list(paths["inversion"]))
    comp_cfgs = composite.configure(templates["composite"], cfglib.load_json_list(batch_json))
    log(f"cli-batched: {len(inv_cfgs)} videos with their stores removed; {len(comp_cfgs)} "
        f"composite entries: {[c.editing_prompt for c in comp_cfgs]}, seeds "
        f"{[c.get('seed', 6) for c in comp_cfgs]}, masks "
        f"{[[os.path.basename(m) for m in c.obj_mask_path] for c in comp_cfgs]}")
    run = run_clis(pipe, inv_cfgs, comp_cfgs, batch=True, tag="cli-batched")
    for name in ("invert/batched", "composite/batched", "pipe.invert_batch",
                 "pipe.sample_composite_batch"):
        if run["stage_calls"].get(name) != 1:
            raise RuntimeError(f"cli-batched: {name} ran {run['stage_calls'].get(name)} times")
    for name in ("pipe.invert", "pipe.sample_composite"):
        if name in run["stage_calls"]:
            raise RuntimeError(f"cli-batched: {name} ran: the batch did not take every entry")
    for cfg in comp_cfgs:
        check_exports(cfg, nf, width, height, tmp)

    # the gates: batched against sequential
    gates = {}
    for cfg in inv_cfgs:
        store = TrajectoryStore(cfg.inverse_config.output_dir)
        gates[f"trajectory {cfg.video_name}"] = _rel(store.gather(store.timesteps),
                                                     seq_traj[cfg.video_name])
    final = run.pop("finals")[-1]
    inputs = [composite._entry_inputs(pipe, cfg) for cfg in comp_cfgs]
    static = inputs[0][1]
    seq_final = [cli["final"], pipe.sample_composite(**inputs[1][0], **static, decode=False)]
    for e in range(2):
        gates[f"final latents, entry {e}"] = _rel(final[e], seq_final[e])
    prep = pipe._prepare_composite_batch([pe for pe, _, _ in inputs], **{
        k: v for k, v in static.items()
        if k not in ("decode_chunk_size", "random_noise_ratio", "obj_random_noise_fusion")})
    init, cond, sched, ms, pb, ps, cw = prep
    core_kw = i2vgen._composite_core_kwargs(static, static["random_noise_ratio"],
                                            static["obj_random_noise_fusion"], None)
    flip = lambda pyr: {r: m.flip(0) for r, m in pyr.items()}  # noqa: E731
    faults = {
        "conditioning exchanged": (core.UNetConditioning(*(
            getattr(cond, f.name).flip(0) for f in dataclasses.fields(cond))), ms, pb, ps),
        "masks exchanged": (cond, ms.flip(0), flip(pb), flip(ps)),
    }
    for name, (c, m, b, s) in faults.items():
        out = core.pnp_composite_batch_core(pipe.unet, pipe.ddim, init, c, sched, m, b, s,
                                            **core_kw)
        for e in range(2):
            gates[f"planted fault, {name}, entry {e}"] = _rel(out[e], seq_final[e])
    for name, rel in gates.items():
        fault = name.startswith("planted")
        log(f"cli-batched: {name} vs sequential: {rel:.4g} of max |x| (gate {TOL_BATCH}, "
            f"{'over' if fault else 'under'} it to pass)")
        if not math.isfinite(rel):
            raise RuntimeError(f"cli-batched: {name} non-finite")
        if fault and not rel > TOL_BATCH:
            raise RuntimeError(f"cli-batched: {name} within the gate: it cannot see the fault")
        if not fault and not rel <= TOL_BATCH:
            raise RuntimeError(f"cli-batched: {name} is {rel:.4g} from the sequential run")

    # seconds per step, per video and per entry, beside phase 7's
    st, seq = run["stage_s"], cli["stage_s"]
    n_comp = steps - 1
    per = dict(
        invert_step_s=st["core.ddim_inversion_batch_core"] / steps,
        invert_step_s_sequential=seq["core.ddim_inversion_core"] / (steps * len(inv_cfgs)),
        invert_per_video_s=st["pipe.invert_batch"] / len(inv_cfgs),
        invert_per_video_s_sequential=seq["pipe.invert"] / len(inv_cfgs),
        composite_step_s=st["core.pnp_composite_batch_core"] / n_comp,
        composite_step_s_sequential=seq["core.pnp_composite_core"] / n_comp,
        composite_per_entry_s=st["pipe.sample_composite_batch"] / len(comp_cfgs),
        composite_per_entry_s_sequential=seq["pipe.sample_composite"],
        composite_stage_per_entry_s=st["composite/batched"] / len(comp_cfgs),
        composite_stage_per_entry_s_sequential=sum(
            v for k, v in seq.items() if k.startswith("composite/")))
    log(f"cli-batched vs sequential (phase 7): inversion {per['invert_step_s']:.3f} s a batched "
        f"step of {len(inv_cfgs)} videos vs {per['invert_step_s_sequential']:.3f} s a step of "
        f"one; per video {per['invert_per_video_s']:.2f} s vs "
        f"{per['invert_per_video_s_sequential']:.2f} s (pipe.invert*); composite "
        f"{per['composite_step_s']:.3f} s a batched step of {len(comp_cfgs)} entries vs "
        f"{per['composite_step_s_sequential']:.3f} s a step of one; per entry "
        f"{per['composite_per_entry_s']:.2f} s vs {per['composite_per_entry_s_sequential']:.2f} "
        f"s (pipe.sample_composite*), {per['composite_stage_per_entry_s']:.2f} s vs "
        f"{per['composite_stage_per_entry_s_sequential']:.2f} s with the exports")

    # one steady batched step, by kernel group and by UNet module
    one = dataclasses.replace(sched, **{f.name: getattr(sched, f.name)[:, :1]
                                        for f in dataclasses.fields(sched)
                                        if f.name != "obj_fusion_lat"})

    def step():
        return core.pnp_composite_batch_core(pipe.unet, pipe.ddim, init, cond, one, ms, pb, ps,
                                             **core_kw)

    with tempfile.TemporaryDirectory(prefix="mvoc_smoke_trace_") as trace_dir:
        profile = profile_step(step, "cli-batched", trace_dir=trace_dir)
        breakdown = device_op_breakdown(trace_dir)
    total = breakdown["total_s"]
    cross = breakdown["by_module_category"]
    elem = breakdown["by_category"].get("elementwise", 0.0)
    elem_in = sum(v.get("elementwise", 0.0) for m, v in cross.items() if m != OUTSIDE)
    unet_share = 1.0 - breakdown["by_module"].get(OUTSIDE, 0.0) / total
    log(f"cli-batched: one steady batched step (J = 2, fused, {width}x{height}) by "
        f"device_op_breakdown: {1e3 * total:.1f} ms of device time; by module (ms) "
        f"{ {k: round(1e3 * v, 2) for k, v in breakdown['by_module'].items()} }; by group (ms) "
        f"{ {k: round(1e3 * v, 2) for k, v in breakdown['by_category'].items()} }; elementwise "
        f"{1e3 * elem:.1f} ms, {elem_in / elem if elem else 0.0:.4f} of it booked to UNet "
        f"modules; all device time booked to UNet modules: {unet_share:.4f}")
    log(f"cli-batched: elementwise ms by module "
        f"{ {m: round(1e3 * v.get('elementwise', 0.0), 2) for m, v in cross.items()} }")
    # the roofline budget by UNet child: its operations (the counted warm-up)
    # over its device time, and its speed-of-light floor
    by_module = {}
    for m, row in profile["flops_by_module"].items():
        secs = breakdown["by_module"].get(m, 0.0)
        floor = sum(row[c] / peak for c, peak in CLASS_PEAK.items())
        by_module[m] = dict(tf=row["total"] / 1e12, device_ms=1e3 * secs, floor_ms=1e3 * floor,
                            tf_s=row["total"] / secs / 1e12 if secs else None,
                            classes_tf={c: row[c] / 1e12 for c in CLASS_PEAK if row[c]})
    log("cli-batched: by module, TF / device ms / TF/s / floor ms: " + "; ".join(
        f"{m} {v['tf']:.4f} / {v['device_ms']:.2f} / "
        f"{'-' if v['tf_s'] is None else round(v['tf_s'], 2)} / {v['floor_ms']:.2f}"
        for m, v in sorted(by_module.items(), key=lambda kv: -kv[1]["device_ms"])))
    breakdown.pop("trace")
    return dict(run, gates=gates, per=per, profile=profile, breakdown=breakdown,
                elementwise_booked_share=elem_in / elem if elem else None,
                unet_share=unet_share, flops_by_module=by_module)

def cli_reuse_phase(cli: dict, tmp: str) -> dict:
    """Phase 7c: both CLIs with the reuse modes at 1280 x 720 on phase 7's
    pipeline and demo tree.  The inversion CLI on the bg entry (its
    reconstruction on) with `encoder_reuse_interval: auto`,
    reuse_auto_candidates [3, 2], reuse_auto_probe_steps 4 and deep_reuse,
    its store recomputed; the composite CLI on the one entry with
    pab_interval: 2 on its fused path (the template otherwise unchanged),
    then the same composite exact through sample_composite for the drift.
    Prints the auto report, the stage times, the launches, the peak memory
    and the PAB cache's bytes."""
    import torch

    from mvoc_tpu_torch import config as cfglib
    from mvoc_tpu_torch.cli import composite, inverse

    pipe, templates, paths = cli["pipe"], cli["templates"], cli["paths"]
    inv_cfgs = [c for c in inverse.configure(templates["inversion"],
                                             cfglib.load_json_list(paths["inversion"]))
                if c.video_name == "bg"]
    for cfg in inv_cfgs:
        inv = cfg.inverse_config
        inv.encoder_reuse_interval = "auto"
        inv.reuse_auto_candidates = [3, 2]
        inv.reuse_auto_probe_steps = 4
        inv.deep_reuse = True
        cfg.inverse_config = inv
        cfg.force_recompute_latents = True
    comp_cfgs = composite.configure(cfglib.merge(templates["composite"], {"pab_interval": 2}),
                                    cfglib.load_json_list(paths["composite"]))
    with ReuseProbe(pipe) as probe:  # the PAB dict's bytes (no step callback: the CLI's)
        run = run_clis(pipe, inv_cfgs, comp_cfgs, batch=False, tag="cli-reuse")
    inv = inv_cfgs[0].inverse_config
    report = [dict(r) for r in inv.get("reuse_auto_report", [])]
    log(f"cli-reuse: encoder_reuse_interval auto for bg chose k = {inv.encoder_reuse_interval} "
        f"(deep_reuse {inv.deep_reuse}); probes (4 steps each, random weights: the PSNR only "
        f"shows that the probe ran): {report}")
    if not report or not all(math.isfinite(r["psnr_db"]) for r in report):
        raise RuntimeError(f"cli-reuse: the auto probe did not run: {report}")
    cache_gb = max(b for tags, b in probe.call_bytes if tags == ("pab_capture",)) / 1e9
    final = run.pop("finals")[-1]
    per_entry, static, _ = composite._entry_inputs(pipe, comp_cfgs[0])
    exact = pipe.sample_composite(**per_entry, **dict(static, pab_interval=1), decode=False)
    drift = dict(rel_l2=_rel_l2(final, exact), max_rel=_rel(final, exact))
    log(f"cli-reuse: the PAB composite (pab_interval 2, fused, {CLI_SIZE[0]}x{CLI_SIZE[1]}): "
        f"steps {[round(t, 3) for t in run['composite_step_s']]} s (fresh, cached); PAB cache "
        f"{cache_gb:.3f} GB; drift from the exact composite on the same stores: rel_l2 "
        f"{drift['rel_l2']:.4g}, max |diff| / max |x| {drift['max_rel']:.4g}")
    if not (torch.isfinite(final).all() and drift["rel_l2"] > 0):
        raise RuntimeError(f"cli-reuse: PAB composite non-finite or exact ({drift})")
    return dict(run, report=report, k=int(inv.encoder_reuse_interval), pab_cache_gb=cache_gb,
                drift=drift)


def tiled_decode_phase(pipe, final, nf: int, height: int, width: int) -> dict:
    """The composite's final latents decoded as the CLI did (untiled, one
    frame a call) and with enable_vae_tiling() (64 x 64-latent tiles, 8 of
    overlap), each with its wall time and peak device memory; the tiled
    decode's K1 launches (the VAE's [1, 1, 4096, 4096, 512] per tile)."""
    import torch

    decode = type(pipe).decode_latents  # the pipeline's own, not the CLI phase's timed wrapper
    out = {}
    for mode in ("untiled", "tiled"):
        if mode == "tiled":
            pipe.enable_vae_tiling()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        video, secs = sync_time(lambda: decode(pipe, final, decode_chunk_size=1))
        launches, shapes = read_counts()
        peak = torch.cuda.max_memory_allocated()
        out[mode] = dict(video=video, s=secs, peak_gib=peak / 2**30,
                         activation_peak_gib=(peak - base) / 2**30, launches=launches,
                         shapes=shapes)
        log(f"decode of the composite latents {tuple(final.shape)}, {mode}: {secs:.2f} s, peak "
            f"device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB held before), launches {launches}")
    pipe.disable_vae_tiling()
    untiled, tiled = out["untiled"].pop("video"), out["tiled"].pop("video")
    if tiled.shape != (nf, height, width, 3) or not np.isfinite(tiled).all():
        raise RuntimeError(f"tiled decode gave {tiled.shape}, finite {np.isfinite(tiled).all()}")
    diff = float(np.abs(tiled - untiled).max())
    tile_sig = (1, 1, 4096, 4096, 512, "torch.bfloat16", False)
    n_tile = out["tiled"]["shapes"]["flash_attention"].get(tile_sig, 0)
    log(f"tiled vs untiled decode: max |diff| {diff:.4g} of pixel values in [0, 1] (each tile's "
        f"GroupNorm statistics are its own, as in the JAX package and the reference); K1 at "
        f"{list(tile_sig[:5])}: {n_tile} launches ({n_tile / nf:.0f} a frame); peaks "
        f"{out['tiled']['peak_gib']:.2f} GiB tiled, {out['untiled']['peak_gib']:.2f} GiB untiled")
    if n_tile <= 0:
        raise RuntimeError("the tiled decode never launched K1 at the 64 x 64 tile")
    return dict(diff=diff, tile_launches=n_tile, shapes=out["tiled"]["shapes"],
                untiled={k: v for k, v in out["untiled"].items() if k != "shapes"},
                tiled_run={k: v for k, v in out["tiled"].items() if k != "shapes"})


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 9: the (job, seq, model) mesh, MESH_WORLD ranks sharing the one card
# ---------------------------------------------------------------------------


def ring_inputs(seed: int, frames: int, lat: int, d_ctx: int, device) -> list:
    """A seeded UNet input of `frames` frames at lat x lat latents (fp32)."""
    import torch

    g = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(g.standard_normal(s).astype(np.float32), device=device)
    return [mk(1, frames, lat, lat, 4), torch.tensor([501], device=device),
            torch.tensor([8], device=device), mk(1, frames, lat, lat, 4),
            mk(1, frames, lat, lat, 4), mk(1, frames, d_ctx), mk(1, 77, d_ctx)]


def windowed_unet(unet, window: int):
    """The same weights in a UNet whose temporal attention is banded."""
    import torch

    from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet

    with torch.device("meta"):
        out = I2VGenXLUNet(dataclasses.replace(unet.config, temporal_window=window,
                                               attn_mesh=None, temporal_cp=None))
    out.load_state_dict(unet.state_dict(), strict=True, assign=True)
    return out.eval()


def mesh_refs(pipe, videos, masks, stores, steps: int, seed: int) -> dict:
    """Phase 9's single-process references on phase 2's bf16 pipeline and
    stores: the fused composite, the fused composite with the objects'
    masks exchanged (the J = 2 batch's second entry), and the 32-frame
    windowed UNet forward that the ring runs on the mesh."""
    import torch

    nf, size = len(videos[0]), videos[0][0].size[0]
    kw = dict(height=size, width=size, num_frames=nf, num_inference_steps=steps,
              guidance_scale=9.0, seed=seed, decode=False)

    def comp(two_pass, m):
        return pipe.sample_composite(PROMPT, videos[0][0], videos[0], videos[0], videos[1:], m,
                                     m, stores[0], stores[1:], two_pass=two_pass, **kw)

    with torch.inference_mode():
        fused = comp(False, masks).float().cpu()
        swapped = comp(False, masks[::-1].copy()).float().cpu()
        unet_w = windowed_unet(pipe.unet, MESH_RING_WINDOW)
        ring = unet_w(*ring_inputs(seed + 9, MESH_RING_FRAMES, size // pipe.vae_scale_factor,
                                   pipe.unet.config.cross_attention_dim,
                                   pipe.device)).float().cpu()
    return dict(fused=fused, swapped=swapped, ring=ring)


def _mesh_stage(out: dict, name: str, fn):
    """Run fn with every launch and collective count at 0 and the peak reset;
    record its wall time, launches, launch shapes, collectives and peak."""
    import torch

    from mvoc_tpu_torch.parallel import collectives as coll

    reset_counts()
    coll.reset_call_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        res = fn()
    torch.cuda.synchronize()
    launches, shapes = read_counts()
    from mvoc_tpu_torch.ops import norm as N

    out["stages"][name] = dict(
        s=time.perf_counter() - t0, launches=launches, collectives=dict(coll.CALLS),
        plain_calls=dict(N.PLAIN_CALLS), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["shapes"][name] = shapes
    return res


def _mesh_rank_body(rank: int, world: int, cfg: dict) -> dict:
    import torch

    from mvoc_tpu_torch.io.trajectory import TrajectoryStore
    from mvoc_tpu_torch.ops import ring_attention as tring
    from mvoc_tpu_torch.parallel import collectives as coll
    from mvoc_tpu_torch.parallel import mesh as pm
    from mvoc_tpu_torch.pipeline import core
    from mvoc_tpu_torch.utils import testing as tt
    from mvoc_tpu_torch.utils.flops import FlopCounter

    dev, seed, steps, nf, size = "cuda", cfg["seed"], cfg["steps"], cfg["nf"], cfg["size"]
    out = {"rank": rank, "stages": {}, "shapes": {}, "arrays": {}}
    rng = np.random.default_rng(seed)
    videos = [tt.synthetic_video(rng, nf, size) for _ in range(3)]
    masks = cfg["masks"]
    t0 = time.perf_counter()
    pipe = tt.build_full_pipeline(seed=seed)
    pipe.enable_mesh(world, seq=2)
    mesh = pipe.mesh
    out["build_s"] = time.perf_counter() - t0
    out["mesh"] = repr(mesh)
    coords = {a: mesh.rank_of(a) for a in mesh.axis_names}
    out["coords"] = coords
    dirs = [os.path.join(cfg["tmp"], n) for n in ("bg", "obj0", "obj1")]
    kw = dict(height=size, width=size, num_frames=nf, num_inference_steps=steps, seed=seed)
    trajs = _mesh_stage(out, "invert", lambda: [
        pipe.invert(f, output_dir=d, **kw)[1] for d, f in zip(dirs, videos)])
    stores = [TrajectoryStore(d) for d in dirs]

    def comp(two_pass, m=masks):
        return pipe.sample_composite(PROMPT, videos[0][0], videos[0], videos[0], videos[1:], m,
                                     m, stores[0], stores[1:], two_pass=two_pass,
                                     guidance_scale=9.0, decode=False, **kw)

    stream = _mesh_stage(out, "stream", lambda: comp("stream"))
    fused = _mesh_stage(out, "fused", lambda: comp(False))
    video = _mesh_stage(out, "decode", lambda: pipe.decode_latents(stream, decode_chunk_size=1))
    out["arrays"].update(trajs=np.stack(trajs), stream=stream.float().cpu().numpy(),
                         fused=fused.float().cpu().numpy(), video=video)

    # fp32: the full-width UNet forward of phase 4 on the mesh; then the same
    # forward with a planted fault, the all-reduce after each row-split
    # projection dropped (each rank keeps its own partial product)
    pipe.disable_mesh()
    unet32 = copy.deepcopy(pipe.unet).float()
    pm.shard_params(unet32, mesh)
    unet32.set_parallel(mesh)
    inp = [torch.as_tensor(x, device=dev) for x in cfg["ref_input"]]
    out["arrays"]["fp32"] = _mesh_stage(out, "fp32", lambda: unet32(*inp)).float().cpu().numpy()
    from mvoc_tpu_torch.models import layers

    row_parallel = layers.row_parallel

    def dropped(layer, x, tp):
        if tp is None:
            return layer(x)
        y = torch.nn.functional.linear(x, layer.weight)
        return y if layer.bias is None else y + layer.bias.to(x.dtype)

    layers.row_parallel = dropped
    try:
        out["arrays"]["fault"] = _mesh_stage(out, "fault", lambda: unet32(*inp)).float().cpu(
            ).numpy()
    finally:
        layers.row_parallel = row_parallel
    del unet32

    # ring: the 32-frame windowed forward, frames over seq = 2, heads over model = 2
    unet_w = windowed_unet(pipe.unet, MESH_RING_WINDOW)
    pm.shard_params(unet_w, mesh)
    unet_w.set_parallel(mesh, "ring")
    rin = ring_inputs(seed + 9, MESH_RING_FRAMES, size // pipe.vae_scale_factor,
                      pipe.unet.config.cross_attention_dim, dev)
    out["arrays"]["ring"] = _mesh_stage(out, "ring", lambda: unet_w(*rin)).float().cpu().numpy()
    del unet_w
    # Ulysses: one 1280-channel temporal attention call (20 heads) over seq = 2
    # and seq = 4, against ring_sdpa's unsharded result
    g = torch.Generator(device=dev).manual_seed(seed)
    heads = 20
    qkv = [torch.randn((MESH_ULYSSES_PIXELS, nf, heads * 64), generator=g, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]
    whole = tring.ring_sdpa(*qkv, heads, pm.Mesh(), "seq", "ulysses")
    for seq in (2, 4):
        m = mesh if seq == 2 else pm.make_mesh(world, seq=4)
        r = m.rank_of("seq")
        loc = [t.chunk(seq, dim=1)[r] for t in qkv]
        got = _mesh_stage(out, f"ulysses_seq{seq}", lambda: coll.all_gather(
            tring.ring_sdpa(*loc, heads, m, "seq", "ulysses"), m, "seq", 1))
        out[f"ulysses_seq{seq}_err"] = (got.float() - whole.float()).abs().max().item()
        out[f"ulysses_scale"] = whole.float().abs().max().item()

    # the job axis: (job 2, seq 2, model 1)
    pipe.enable_mesh(world, seq=2, job=2)
    out["job_mesh"] = repr(pipe.mesh)
    _, traj_b = _mesh_stage(out, "invert_batch", lambda: pipe.invert_batch(videos, **kw))
    entries = [dict(prompt=PROMPT, main_first_image=videos[0][0], main_image_list=videos[0],
                    background_image_list=videos[0], objs_image_list=videos[1:],
                    masks_soft=m, masks_binary=m, bg_store=stores[0], obj_stores=stores[1:],
                    seed=seed) for m in (masks, masks[::-1].copy())]
    lat_b = _mesh_stage(out, "composite_batch", lambda: pipe.sample_composite_batch(
        entries, two_pass=False, guidance_scale=9.0, decode=False,
        **{k: v for k, v in kw.items() if k != "seed"}))
    out["arrays"].update(invert_batch=traj_b, composite_batch=lat_b.float().cpu().numpy())

    # int8: enable_int8 before enable_mesh, then one fused composite step
    pipe.disable_mesh()
    pipe.enable_int8(mode="mixed")
    pipe.enable_mesh(world, seq=2)
    init, cond, one, ms, pb, ps, _ = one_step_inputs(pipe, videos, masks, stores, steps,
                                                     seed, False)
    with FlopCounter() as counter:
        q = _mesh_stage(out, "int8_step", lambda: core.pnp_composite_core(
            pipe.unet, pipe.ddim, init, cond, one, ms, pb, ps, num_inference_steps=steps,
            guidance_scale=9.0, two_pass=False))
    out["int8_step_flops"] = counter.by_class()
    out["int8_finite"] = bool(torch.isfinite(q).all())
    pipe.disable_mesh()
    return out


def _mesh_rank(rank: int, world: int, port: int, cfg: dict) -> None:
    """One rank of phase 9: a gloo process group over the ranks sharing the
    card (NCCL refuses two ranks on one device), the body, its results."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as in the main process
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // world))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(minutes=5))
    try:
        out = _mesh_rank_body(rank, world, cfg)
        with open(os.path.join(cfg["tmp"], f"rank{rank}.pkl"), "wb") as f:
            import pickle

            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_phase(cfg: dict, refs: dict) -> dict:
    """Phase 9: spawn MESH_WORLD ranks on the card, each running the mesh
    paths (_mesh_rank_body), and hold their results against the
    single-process runs (refs)."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log(f"mesh: {MESH_WORLD} ranks on one card, process group backend gloo (NCCL refuses two "
        f"ranks on one device): collectives move CUDA tensors through host memory, so these "
        f"are times of ranks sharing one card, not multi-GPU times")
    t0 = time.perf_counter()
    mp.spawn(_mesh_rank, args=(MESH_WORLD, port, cfg), nprocs=MESH_WORLD)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(MESH_WORLD):
        with open(os.path.join(cfg["tmp"], f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    a0 = ranks[0]["arrays"]
    # every rank returns the full result (the planted fault's ranks differ)
    for rk in ranks[1:]:
        for key, arr in a0.items():
            if key == "fault":
                continue
            diff = float(np.abs(np.asarray(rk["arrays"][key], np.float64)
                                - np.asarray(arr, np.float64)).max())
            if diff > 0:
                raise RuntimeError(f"mesh: rank {rk['rank']}'s {key} differs from rank 0's "
                                   f"by {diff:.3g}")
    checks, failed = {}, []

    def gate(name, got, want, tol, beyond=False):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise RuntimeError(f"mesh {name}: shape {got.shape} vs {want.shape} or non-finite")
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        checks[name] = rel
        ok = rel > tol if beyond else rel <= tol
        log(f"mesh {name}: {rel:.4g} of max |x| {np.abs(want).max():.4g} (tolerance {tol}, "
            f"{'over' if beyond else 'under'} it to pass)")
        if not ok:
            failed.append(f"mesh {name}: {rel:.4g} of max |x| against tolerance {tol}")

    for j, t in enumerate(refs["trajs"]):
        gate(f"inversion {j} vs one process", a0["trajs"][j], t, TOL_MESH)
    gate("stream composite vs one process", a0["stream"], refs["stream"], TOL_MESH)
    gate("fused composite vs one process", a0["fused"], refs["fused"], TOL_MESH)
    gate("decode vs one process", a0["video"], refs["video"], TOL_MESH)
    gate("fp32 UNet forward vs one process on the card", a0["fp32"], refs["fp32"], TOL_REF)
    gate("planted fault (the row-parallel all-reduce dropped) in the fp32 forward",
         a0["fault"], refs["fp32"], TOL_MESH, beyond=True)
    gate("ring (32 frames, window 16) vs one process", a0["ring"], refs["ring"], TOL_MESH)
    for j, t in enumerate(refs["trajs"]):
        gate(f"invert_batch video {j} vs one process", a0["invert_batch"][:, j], t, TOL_BATCH)
    gate("composite_batch entry 0 vs one process", a0["composite_batch"][0], refs["fused"],
         TOL_BATCH)
    gate("composite_batch entry 1 (masks exchanged) vs one process",
         a0["composite_batch"][1], refs["swapped"], TOL_BATCH)
    for seq in (2, 4):
        err, scale = ranks[0][f"ulysses_seq{seq}_err"], ranks[0]["ulysses_scale"]
        checks[f"ulysses seq {seq}"] = err / scale
        log(f"mesh Ulysses, 20 heads, seq = {seq}: max |diff| {err:.4g} of max |x| "
            f"{scale:.4g} against ring_sdpa unsharded (tolerance {TOL_REF} relative)")
        if not err <= TOL_REF * scale:
            failed.append(f"mesh Ulysses seq = {seq} disagrees with ring_sdpa")
    for rk in ranks:
        if not rk["int8_finite"]:
            raise RuntimeError(f"mesh: rank {rk['rank']}'s int8 step gave non-finite values")
        st = rk["stages"]
        norms = ("group_norm", "layer_norm")
        for stage, need in (("invert", ("flash_attention", "frame_attention") + norms),
                            ("stream", ("flash_attention", "frame_attention") + norms),
                            ("fused", ("flash_attention", "frame_attention") + norms),
                            ("int8_step", ("flash_attention", "frame_attention", "s8_matmul")
                             + norms)):
            for name in need:
                if st[stage]["launches"][name] <= 0:
                    failed.append(f"mesh rank {rk['rank']}: {name} never launched in {stage}")
        for stage, v in st.items():  # the sharded-frame GroupNorm too takes the kernels
            if any(v["plain_calls"].values()):
                failed.append(f"mesh rank {rk['rank']}: norms took the plain version on the "
                              f"card in {stage}: {v['plain_calls']}")
        steps = max(cfg["steps"] - 1, 1)
        rk["local_shapes"] = {name: sorted({str(sig) for by_kernel in rk["shapes"].values()
                                            for sig in by_kernel.get(name, {})})
                              for name in KERNELS}
        log(f"mesh rank {rk['rank']} local launch shapes: "
            + "; ".join(f"{name} {len(v)}: {', '.join(v[:4])}{' ...' if len(v) > 4 else ''}"
                        for name, v in rk["local_shapes"].items()))
        log(f"mesh rank {rk['rank']} {rk['coords']} ({rk['mesh']}; build {rk['build_s']:.1f} s): "
            + "; ".join(f"{k} {v['s']:.2f} s, peak {v['peak_gib']:.2f} GiB, launches "
                        f"{v['launches']}, collectives {v['collectives']}"
                        for k, v in st.items()))
        log(f"mesh rank {rk['rank']}: s per composite step stream "
            f"{st['stream']['s'] / steps:.3f}, fused {st['fused']['s'] / steps:.3f}; "
            f"s per inversion step {st['invert']['s'] / (3 * cfg['steps']):.3f}")
    # each rank's operations on the int8 fused step beside the one-process
    # count over the world: the excess is work repeated on several ranks
    one = refs["int8_step_flops"]
    flops = {}
    for rk in ranks:
        got = rk["int8_step_flops"]
        flops[rk["rank"]] = dict(tf=got, excess={c: got[c] - one[c] / MESH_WORLD for c in got})
        log(f"mesh rank {rk['rank']} {rk['coords']}: one int8-mixed fused step, TF by class "
            f"{ {c: round(v / 1e12, 4) for c, v in got.items()} }; one process / {MESH_WORLD} "
            f"{ {c: round(v / MESH_WORLD / 1e12, 4) for c, v in one.items()} }; the rank's "
            f"excess { {c: round(v / 1e12, 4) for c, v in flops[rk['rank']]['excess'].items()} } "
            f"({got['total'] / (one['total'] / MESH_WORLD):.3f}x its share)")
    shapes: dict = {}
    for rk in ranks:
        for stage, by_kernel in rk["shapes"].items():
            for name, sigs in by_kernel.items():
                for sig, n in sigs.items():
                    shapes.setdefault(name, {})
                    shapes[name][sig] = shapes[name].get(sig, 0) + n
    launches = {name: sum(rk["stages"][st]["launches"][name] for rk in ranks
                          for st in rk["stages"]) for name in KERNELS}
    log(f"mesh: {wall:.1f} s for the phase (spawn to join); launches over every rank and stage "
        f"{launches}; local shard shapes {sum(len(v) for v in shapes.values())}")
    if failed:
        raise RuntimeError("; ".join(failed))
    return dict(wall_s=wall, checks=checks, launches=launches, shapes=shapes, flops=flops,
                one_process_flops=one,
                ranks=[{k: v for k, v in rk.items() if k not in ("arrays", "shapes")}
                       for rk in ranks])


def gloo_cuda_probe() -> dict:
    """Which collectives a gloo process group (world 1, this process) takes
    on CUDA tensors directly; parallel/collectives.py hands gloo CUDA
    tensors for these and stages the point-to-point exchange through host
    memory itself."""
    import socket

    import torch
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    x = torch.ones(4, device="cuda")
    out = {}
    try:
        for name, fn in (("all_reduce", lambda: dist.all_reduce(x)),
                         ("all_gather", lambda: dist.all_gather([torch.empty_like(x)], x)),
                         ("all_to_all_single",
                          lambda: dist.all_to_all_single(torch.empty_like(x), x))):
            try:
                fn()
                torch.cuda.synchronize()
                out[name] = True
            except (RuntimeError, ValueError) as e:
                out[name] = f"refused: {e}"[:160]
    finally:
        dist.destroy_process_group()
    log(f"gloo on CUDA tensors (torch {torch.__version__}): {out}")
    if not all(v is True for v in out.values()):
        raise RuntimeError("gloo refuses a collective on CUDA tensors that "
                           "parallel/collectives.py hands it")
    return out


def nccl_phase(pipe, inp) -> dict:
    """A one-rank NCCL process group through enable_mesh (the launcher's
    environment, the default backend on CUDA): the 1x1x1 mesh, whose UNet
    forward is bitwise the unmeshed one."""
    import torch
    import torch.distributed as dist

    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with torch.inference_mode():
            before = pipe.unet(*inp)
            pipe.enable_mesh()
            backend = dist.get_backend()
            after = pipe.unet(*inp)
            t = torch.ones(1, device="cuda")
            dist.all_reduce(t)
        pipe.disable_mesh()
        diff = (after.float() - before.float()).abs().max().item()
        log(f"nccl: process group backend {backend}, world 1, mesh {pipe.mesh!r} after "
            f"disable; the 1x1x1 mesh's UNet forward vs unmeshed max |diff| {diff}")
        if backend != "nccl" or diff != 0.0 or t.item() != 1.0:
            raise RuntimeError("the NCCL one-rank mesh is not the unmeshed run")
        return dict(backend=backend, diff=diff)
    finally:
        dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _chunked(fn, n: int, chunk: int, *args):
    import torch

    if n <= chunk:
        return fn(*args)
    return torch.cat([fn(*(a[i:i + chunk] for a in args)) for i in range(0, n, chunk)])


def launched_variant(mod, name: str, fn):
    """fn's result and the design(s) its launches of kernel `name` took, as
    counted by the wrapper."""
    before = dict(mod.LAUNCH_VARIANTS[name])
    out = fn()
    took = sorted(v for v, n in mod.LAUNCH_VARIANTS[name].items() if n > before.get(v, 0))
    return out, "+".join(took)


def band(f: int, window: int):
    """The temporal window's [F, F] band on the card (True = attend)."""
    import torch

    idx = torch.arange(f, device="cuda")
    return (idx[:, None] - idx[None, :]).abs() <= window // 2


def _by_dtype(dtype):
    """(tolerance relative to max|plain|, peak operation rate, bytes per
    element) of a kernel launched on `dtype` (bf16 or fp32) tensors."""
    import torch

    if dtype == torch.float32:
        return TOL_FP32, PEAK_FP32_FLOPS, 4
    return TOL_BF16, PEAK_BF16_FLOPS, 2


def _flash_measure(q, k, v, bias, mask, needed_pairs: float):
    """K1 on [B, H, S, D] views (bias: its fp32 [Sq, Sk] or None; mask: the
    same as SDPA's boolean mask): error against the plain version in fp32
    from the same inputs, times of the kernel, its call, the plain version,
    the SIMT design and one SDPA call; operations counted over the (query,
    key) pairs the function needs."""
    import torch.nn.functional as F

    from mvoc_tpu_torch.ops import attention as A
    from mvoc_tpu_torch.utils import flops as FL

    b, h, sq, d = q.shape
    sk = k.shape[2]
    out, design = launched_variant(A, "flash_attention", lambda: A.flash_attention(
        q, k, v, bias=bias))
    # plain version in fp32 from the same bf16 inputs, over (batch x head)
    # slices in chunks that keep their [Sq, Sk] fp32 logits under ~4 GB (one
    # slice at 14400 tokens holds 0.83 GB of them)
    chunk = max(1, int(4e9 // (sq * sk * 4)))

    def plain(q, k, v):
        flat = [t.reshape(b * h, 1, t.shape[2], d) for t in (q, k, v)]
        return _chunked(lambda *a: A.flash_attention_plain(*a, bias=bias), b * h, chunk,
                        *flat).reshape(b, h, sq, d)

    ref = plain(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    rel, peak, elt = _by_dtype(q.dtype)
    tol = rel * ref.abs().max().item()
    ms = graph_ms(lambda: A.flash_attention(q, k, v, bias=bias), reps=TIMED_REPS)
    old = A._flash_cuda(q, k, v, "simt", bias=bias)  # the old design, for comparison
    old_err = (old.float() - ref).abs().max().item()
    call_ms = cuda_ms(lambda: A.flash_attention(q, k, v, bias=bias), reps=TIMED_REPS)
    # warm from the launch above; one launch where it takes seconds (the
    # 14400-token batches)
    old_ms = cuda_ms(lambda: A._flash_cuda(q, k, v, "simt", bias=bias),
                     reps=3 if ms < 10 else 1, warmup=0)
    plain_ms = cuda_ms(lambda: plain(q, k, v), reps=1)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                      reps=TIMED_REPS)
    # the kernel's count (every pair, utils.flops) and the bound's (the pairs needed)
    flops = FL.kernel_flops("flash_attention", (b, h, sq, sk, d))
    nbytes = elt * (2.0 * b * h * sq * d + 2.0 * b * h * sk * d) + (
        0.0 if bias is None else 4.0 * sq * sk)
    return dict(err=err, old_err=old_err, tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, flops=flops, bound_flops=flops * needed_pairs / (sq * sk),
                bytes=nbytes, peak=peak, old_ms=old_ms, design=design, out=out)


def flash_phase(sig, gen):
    """K1 at a launched signature (B, H, Sq, Sk, D, dtype, biased), or at a
    BAND_CASES entry (band_phase)."""
    import torch

    from mvoc_tpu_torch.ops import attention as A

    if sig[0] in ("sf", "natural"):
        return band_phase(sig, gen)
    b, h, sq, sk, d, dt, biased = sig
    dev = torch.device("cuda")
    dtype = getattr(torch, dt.split(".")[-1])  # bf16 on the main paths, fp32 in phase 9's
    # the main path's layout: [B, S, H, D] projections viewed as [B, H, S, D]
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev, dtype=dtype)
               .transpose(1, 2) for s in (sq, sk, sk))
    mask = band(sq, 16) if biased else None
    pairs = float(mask.sum().item()) if biased else float(sq) * sk
    ph = _flash_measure(q, k, v, A.band_bias(mask), mask, pairs)
    ph.pop("out")
    return ph


def band_phase(case, gen):
    """K1 with the temporal window's band as its bias over F > 64 frames, on
    the [S, H, F, D] view layers.sdpa (layout "sf": [S, F, H*D]) or
    A.frame_axis_attention (layout "natural": [1, F, S, H*D]) hands it; the
    layer's own output must be the kernel's, bit for bit."""
    import torch

    from mvoc_tpu_torch.models import layers
    from mvoc_tpu_torch.ops import attention as A

    layout, s, heads, f, window = case
    d = 64
    shape = (s, f, heads * d) if layout == "sf" else (1, f, s, heads * d)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))

    def view(t):
        if layout == "sf":
            return t.view(s, f, heads, d).transpose(1, 2)
        return t[0].unflatten(-1, (heads, d)).permute(1, 2, 0, 3)

    mask = band(f, window)
    ph = _flash_measure(view(q), view(k), view(v), A.band_bias(mask), mask,
                        float(mask.sum().item()))
    out = ph.pop("out")
    if layout == "sf":
        layer = layers.sdpa(q, k, v, heads, mask=mask)
        same = torch.equal(layer, out.transpose(1, 2).reshape(s, f, heads * d))
    else:
        layer = A.frame_axis_attention(q, k, v, heads, mask=mask, layout="natural")
        same = torch.equal(layer, out.permute(2, 0, 1, 3).reshape(1, f, s, heads * d))
    if not same:
        raise RuntimeError(f"K1 band case {case}: the layer's output is not the kernel's")
    return ph


def sass_counts(stem: str) -> dict:
    """Tensor-core instructions (HGMMA / IGMMA: wgmma with fp / integer
    inputs, HMMA / IMMA: mma.sync with fp / integer inputs) in each kernel's
    SASS of the library
    built from csrc/<stem>.cu, from cuobjdump -sass; {} when the toolkit has
    no cuobjdump."""
    from mvoc_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
        if tool is None:
            return {}
    out = subprocess.run([tool, "-sass", _build.library_path(stem)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "IGMMA": 0, "HMMA": 0, "IMMA": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += bool(re.search(rf"\b{op}\.", line))
    return counts


def frame_phase(sig, gen):
    """K2 at a launched signature: error against the plain version in fp32,
    times of the kernel, its call, the plain version, the SIMT design and
    one SDPA call."""
    import torch
    import torch.nn.functional as F

    from mvoc_tpu_torch.ops import attention as A
    from mvoc_tpu_torch.utils import flops as FL

    layout, b, f, s, heads, d, dt, masked = sig
    dev = torch.device("cuda")
    dtype = getattr(torch, dt.split(".")[-1])  # bf16 on the main paths, fp32 in phase 9's
    shape = (b, f, s, heads * d) if layout == "natural" else (s, f, heads * d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
               for _ in range(3))
    mask = None
    if masked:
        idx = torch.arange(f, device=dev)
        mask = (idx[:, None] - idx[None, :]).abs() <= 4
    out, design = launched_variant(A, "frame_attention", lambda: A.frame_attention(
        q, k, v, heads, mask=mask, layout=layout))
    ref = A.frame_attention_plain(q.float(), k.float(), v.float(), heads, mask=mask,
                                  layout=layout)
    err = (out.float() - ref).abs().max().item()
    rel, peak, elt = _by_dtype(dtype)
    tol = rel * ref.abs().max().item()
    ms = graph_ms(lambda: A.frame_attention(q, k, v, heads, mask=mask, layout=layout),
                  reps=TIMED_REPS)
    n = b * s * heads
    flops = FL.kernel_flops("frame_attention", sig)
    nbytes = 4.0 * n * f * d * elt
    old = A._frame_cuda(q, k, v, heads, mask, layout, "simt")  # the PR 1 design
    old_err = (old.float() - ref).abs().max().item()
    call_ms = cuda_ms(lambda: A.frame_attention(q, k, v, heads, mask=mask, layout=layout),
                      reps=TIMED_REPS)
    old_ms = graph_ms(lambda: A._frame_cuda(q, k, v, heads, mask, layout, "simt"), reps=5)
    plain_ms = cuda_ms(lambda: A.frame_attention_plain(q, k, v, heads, mask=mask,
                                                       layout=layout), reps=2)

    def relaid(t):  # [B*S, H, F, D], laid out once, outside the timed call
        n = A._as_natural(t, layout)
        return n.reshape(n.shape[0], f, s, heads, d).permute(0, 2, 3, 1, 4).reshape(
            -1, heads, f, d).contiguous()

    qr, kr, vr = relaid(q), relaid(k), relaid(v)
    lib_ms = None
    try:  # some of its kernels put batch x heads on one grid axis, which stops at 65535
        F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
        torch.cuda.synchronize()
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask),
                          reps=TIMED_REPS)
    except RuntimeError as exc:  # a launch the library refuses (not the port's path)
        log(f"  library call refused at {sig} (batch x heads {qr.shape[0] * heads}): "
            f"{str(exc).splitlines()[0]}")
    return dict(err=err, tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                flops=flops, bytes=nbytes, peak=peak, old_ms=old_ms,
                old_err=old_err, design=design)


def s8_phase(sig, gen):
    """K3 at a launched signature, bitwise against its plain version; times
    of the kernel, its call, the plain version, the mma.sync design and
    torch._int_mm plus the dequantise."""
    import torch

    from mvoc_tpu_torch.ops import s8gemm as S8
    from mvoc_tpu_torch.utils import flops as FL

    m, k, n, dt = sig
    out_dtype = getattr(torch, dt.split(".")[-1])
    dev = torch.device("cuda")
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    # the main path's weight: the [K, N] view of [N, K] storage
    wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8).t()
    sx = torch.rand(m, generator=gen, device=dev) * 0.1 + 1e-3
    sw = torch.rand(n, generator=gen, device=dev) * 0.1 + 1e-3
    out, design = launched_variant(S8, "s8_matmul", lambda: S8.s8_matmul(
        xq, wq, sx, sw, out_dtype=out_dtype))
    # plain version (exact float64 product), row-chunked to keep its float64
    # copy of x under ~2 GB
    chunk = max(1, int(2e9 // (8 * k)))

    def plain():
        return _chunked(lambda x, s: S8.s8_matmul_plain(x, wq, s, sw, out_dtype=out_dtype),
                        m, chunk, xq, sx)

    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    ms = graph_ms(lambda: S8.s8_matmul(xq, wq, sx, sw, out_dtype=out_dtype), reps=TIMED_REPS)
    out_bytes = torch.finfo(out_dtype).bits // 8
    flops = FL.kernel_flops("s8_matmul", sig)
    nbytes = float(m * k + k * n + 4 * (m + n) + m * n * out_bytes)
    old = S8._s8_cuda(xq, wq, sx, sw, out_dtype, "mma")  # the PR 2 design
    exact = torch.equal(out, ref) and torch.equal(old, ref)
    old_err = (old.float() - ref.float()).abs().max().item()
    call_ms = cuda_ms(lambda: S8.s8_matmul(xq, wq, sx, sw, out_dtype=out_dtype),
                      reps=TIMED_REPS)
    old_ms = graph_ms(lambda: S8._s8_cuda(xq, wq, sx, sw, out_dtype, "mma"), reps=TIMED_REPS)
    plain_ms = cuda_ms(plain, reps=2)
    lib_ms = None
    # torch._int_mm (cuBLASLt) plus the dequantise: M > 16, K and N multiples of 8
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        def library():
            acc = torch._int_mm(xq, wq)
            return (acc.float() * (sx[:, None] * sw[None, :])).to(out_dtype)
        try:
            lib = library()
            if not torch.equal(lib, ref):
                log(f"  note: library call differs from plain at {sig}")
            lib_ms = graph_ms(library, reps=TIMED_REPS)
        except RuntimeError as exc:  # a layout cuBLASLt refuses
            log(f"  library call refused at {sig}: {str(exc).splitlines()[0]}")
    return dict(err=err, tol=TOL_S8, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, flops=flops,
                bytes=nbytes, peak=PEAK_INT8_OPS, exact=exact, old_ms=old_ms, old_err=old_err,
                design=design)


def k3_host_costs(gen) -> dict:
    """Host microseconds per K3 launch at the int8 path's most launched
    shape: the wgmma design's two tensor-map encodings alone (C timer in
    csrc/s8_gemm.cu), and a whole wrapper call."""
    import ctypes

    import torch

    from mvoc_tpu_torch.ops import _build
    from mvoc_tpu_torch.ops import s8gemm as S8

    m, k, n = 4096, 1280, 1280
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8).t()
    sx, sw = torch.ones(m, device="cuda"), torch.ones(n, device="cuda")
    fn = _build.load("s8_gemm").mvoc_s8_encode_us
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int]
    encode_us = fn(xq.data_ptr(), wq.data_ptr(), m, n, k, xq.stride(0), wq.stride(1), 10000)
    if encode_us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused the K3 operands")
    S8.s8_matmul(xq, wq, sx, sw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        S8.s8_matmul(xq, wq, sx, sw)
    call_us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
    torch.cuda.synchronize()
    return dict(encode_us=encode_us, call_us=call_us)


def norm_phase(name: str, sig, gen) -> dict:
    """A fused norm (ops/norm.py) at a launched signature: its error against
    the plain version from the same inputs (in chunks of samples or rows of
    ~256 MB, whose fp32 temporaries stay under a few GB), whether a second
    launch gives the same bits, the kernel's device time (kernel_ms: NORM_REPS
    launches in one CUDA graph; call_ms: the same back to back from Python),
    the plain version's over the whole input, and the
    byte floor at 3.35 TB/s: GroupNorm reads x twice (statistics, then the
    apply pass) and writes it once, LayerNorm reads and writes it once.
    Beside them, one PyTorch library call of the same function (library_ms,
    its error against the plain version: library_err): F.layer_norm, or
    F.group_norm on x's channels-first view (then F.silu)."""
    import torch
    import torch.nn.functional as F

    from mvoc_tpu_torch.ops import norm as N

    shape, dt = sig[0], sig[-1]
    dtype = getattr(torch, dt.split(".")[-1])
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    w = (1 + 0.3 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    b = (0.2 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    if name == "group_norm":
        _, groups, eps, silu, _ = sig
        rows = x
        first = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))  # channels-last -> first
        back = tuple(first.index(i) for i in range(x.ndim))

        def run():
            return N.group_norm(x, w, b, groups, eps, silu=silu)

        def plain(t):
            return N.group_norm_plain(t, w, b, groups, eps, silu=silu)

        def library():
            y = F.group_norm(x.permute(first), groups, w, b, eps)
            return F.silu(y) if silu else y

        def library_nhwc():
            return library().permute(back)
        reads = 2
    else:
        _, eps, _ = sig
        rows = x.reshape(-1, c)

        def run():
            return N.layer_norm(x, w, b, eps)

        def plain(t):
            return N.layer_norm_plain(t, w, b, eps)

        def library():
            return F.layer_norm(x, (c,), w, b, eps)
        library_nhwc = library
        reads = 1
    out = run()
    same = torch.equal(out, run())
    n = rows.shape[0]
    chunk = max(1, int(2.56e8 // (rows[0].numel() * x.element_size())))

    def plain_all():
        return torch.cat([plain(rows[i:i + chunk]) for i in range(0, n, chunk)])

    ref = plain_all().reshape(shape)
    err = (out.float() - ref.float()).abs().max().item()
    library_err = (library_nhwc().float() - ref.float()).abs().max().item()
    rel = TOL_FP32 if dtype == torch.float32 else TOL_BF16
    tol = rel * ref.abs().max().item()
    del ref
    ms = graph_ms(run, reps=NORM_REPS)
    call_ms = cuda_ms(run, reps=NORM_REPS)
    library_ms = graph_ms(library, reps=NORM_REPS)
    plain_ms = cuda_ms(plain_all, reps=1, warmup=0)
    nbytes = float((reads + 1) * x.numel() * x.element_size())
    return dict(err=err, tol=tol, same=same, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_err=library_err, bytes=nbytes,
                bound_ms=1e3 * nbytes / PEAK_BYTES)


def bound(ph):
    t_ops = ph.get("bound_flops", ph["flops"]) / ph["peak"]
    t_bytes = ph["bytes"] / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fmt_ms(x):
    return "null" if x is None else f"{x:.4f}"


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
    t_start = time.perf_counter()
    phase_s: dict = {}

    def mark(done: str) -> None:
        """Seconds since the start when the phase(s) `done` ended."""
        phase_s[done] = time.perf_counter() - t_start
        log(f"[{phase_s[done]:.1f} s] phase {done} done")

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    import importlib.util

    log("packages the port does without, present here: " + ", ".join(
        f"{name} {importlib.util.find_spec(name) is not None}" for name in FOREIGN_PACKAGES))

    from mvoc_tpu_torch.ops import _build
    from mvoc_tpu_torch.ops import quantize as Q
    from mvoc_tpu_torch.pipeline import core
    from mvoc_tpu_torch.utils import flops as FL
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
        # per kernel; shared memory is dynamic in the tensor-core kernels
        for fn, body in re.findall(r"Compiling entry function '(\S+)'(.*?)Compile time",
                                   text, re.S):
            n_regs = re.search(r"Used (\d+) registers", body).group(1)
            n_spill = re.search(r"(\d+) bytes spill stores", body).group(1)
            log(f"    {fn}: {n_regs} registers, {n_spill} bytes spill stores")
        for line in text.splitlines():
            if "C7515" in line or "serialized" in line:
                log(f"    {line.strip()}")
    sass = {}  # tensor-core instructions in each kernel's SASS
    for meta in KERNELS.values():
        stem = os.path.splitext(os.path.basename(meta["source"]))[0]
        _build.load(stem)
        sass[stem] = sass_counts(stem)
        if not sass[stem]:
            log(f"{stem} SASS tensor-core instructions: not measured (no cuobjdump)")
        for fn, c in sorted(sass[stem].items()):
            log(f"{stem} SASS {fn}: " + " ".join(f"{op} {n}" for op, n in c.items()))
    for stem, needle, op in SASS_REQUIRED:
        if sass[stem] and not any(c[op] for fn, c in sass[stem].items() if needle in fn):
            raise RuntimeError(f"{stem}: kernel {needle} has no {op} in its SASS")

    mark("build")
    # 2. the bf16 slice at full width
    rng = np.random.default_rng(args.seed)
    size, nf, steps = 512, 16, args.steps  # the main path: 16 frames at 512 px
    pipe, t_build = sync_time(lambda: tt.build_full_pipeline(seed=args.seed))
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder,
                                       pipe.image_encoder) for p in m.parameters())
    log(f"pipeline: full I2VGen-XL geometry, bf16, random weights (seed {args.seed}), "
        f"built in {t_build:.1f} s; {n_params / 1e9:.3f} B parameters")
    videos = [tt.synthetic_video(rng, nf, size) for _ in range(3)]
    lat = size // pipe.vae_scale_factor
    masks = np.zeros((2, nf, lat, lat), np.float32)
    masks[0, :, lat // 8: lat // 2, lat // 8: lat // 2] = 1.0
    masks[1, :, lat // 2: 7 * lat // 8, 3 * lat // 8: 7 * lat // 8] = 1.0

    bf16 = run_slice(pipe, videos, masks, steps, args.seed, "bf16")
    for name in ("flash_attention", "frame_attention"):
        if bf16["launches"][name] <= 0:
            raise RuntimeError(f"{name} was never launched on the main path")
        if bf16["comp_launch"][name] <= 0:
            raise RuntimeError(f"{name} was never launched in the composite steps")
    if bf16["launches"]["s8_matmul"] != 0:
        raise RuntimeError("s8_matmul launched on the bf16 path")

    mark("2")
    # 3. one fused step against one stream step, same inputs
    init, cond, one, ms, pb, ps, cw = one_step_inputs(pipe, videos, masks, bf16["stores"],
                                                      steps, args.seed, "stream")
    outs, step_stats = {}, {}
    for tp_mode in ("stream", False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        outs[tp_mode], secs = sync_time(lambda: core.pnp_composite_core(
            pipe.unet, pipe.ddim, init, cond, one, ms, pb, ps, num_inference_steps=steps,
            guidance_scale=9.0, two_pass=tp_mode,
            capture_weights=cw if tp_mode == "stream" else None))
        step_peak = torch.cuda.max_memory_allocated() / 2**30
        step_stats[repr(tp_mode)] = dict(s=secs, peak_gib=step_peak)
        log(f"one composite step, two_pass={tp_mode!r}: {secs:.2f} s, peak memory "
            f"{step_peak:.2f} GiB")
    # planted faults through the two_pass=True path: the injection dropped
    # (every gate off) and misplaced (the two objects' masks swapped); each
    # must land beyond the tolerance, so that the gate can see such a fault
    off = np.zeros_like(one.gate_spatial)
    faults = {
        "injection dropped": (dataclasses.replace(one, gate_spatial=off, gate_temporal=off,
                                                  gate_conv=off), pb, ps),
        "masks swapped": (one, {r: m.flip(0) for r, m in pb.items()},
                          {r: m.flip(0) for r, m in ps.items()}),
    }
    for name, (one_f, pb_f, ps_f) in faults.items():
        outs[name] = core.pnp_composite_core(
            pipe.unet, pipe.ddim, init, cond, one_f, ms, pb_f, ps_f, num_inference_steps=steps,
            guidance_scale=9.0, two_pass=True)
    scale = outs[False].abs().max().item()
    step_stats["scale"] = scale
    for mode in ("stream", True, "injection dropped", "masks swapped"):
        diff = (outs[mode] - outs[False]).abs().max().item()
        step_stats[f"{mode} vs fused"] = diff
        fault = isinstance(mode, str) and mode != "stream"
        log(f"{'planted fault, ' + mode if fault else f'two_pass={mode!r}'} vs fused, one "
            f"step (bf16): max |diff| {diff:.4g} ({diff / scale:.4g} of max |x| {scale:.4g}; "
            f"tolerance {TOL_TWO_PASS}, {'over' if fault else 'under'} it to pass)")
        if not math.isfinite(diff):
            raise RuntimeError(f"{mode} step gave non-finite values")
        if fault and not diff > TOL_TWO_PASS * scale:
            raise RuntimeError(f"planted fault ({mode}) is within the tolerance of the fused "
                               f"step: the gate cannot see it")
        if not fault and not diff <= TOL_TWO_PASS * scale:
            raise RuntimeError(f"two_pass={mode!r} step is {diff:.4g} from the fused step")
    profiles = {"bf16": profile_step(lambda: core.pnp_composite_core(
        pipe.unet, pipe.ddim, init, cond, one, ms, pb, ps, num_inference_steps=steps,
        guidance_scale=9.0, two_pass="stream", capture_weights=cw), "bf16")}
    route = route_check(pipe, init, cond, int(one.timesteps[0]))
    route["paths"] = path_flops(pipe, init, cond, one, ms, pb, ps, steps)
    # phase 9's single-process references, on this pipeline and these stores
    mesh_ref = mesh_refs(pipe, videos, masks, bf16["stores"], steps, args.seed)
    mesh_ref.update(trajs=bf16["trajs"], stream=bf16["final"].float().cpu(), video=bf16["video"])
    shutil.rmtree(bf16["root"])
    if read_counts()[0]["s8_matmul"] != 0:
        raise RuntimeError("s8_matmul launched on the bf16 path")

    mark("3")
    # 4. reference on a small input: fp32 UNet on the card vs on the CPU, and
    # the same UNet quantized ("full" selection) on the card vs on the CPU
    unet32 = copy.deepcopy(pipe.unet).float()
    torch.cuda.empty_cache()
    g = np.random.default_rng(args.seed + 1)
    rf, rl = 4, 16
    d_ctx = unet32.config.cross_attention_dim
    inp = [g.standard_normal(s).astype(np.float32) for s in
           ((1, rf, rl, rl, 4),)] + [np.array([501]), np.array([8])] + [
        g.standard_normal(s).astype(np.float32) for s in
        ((1, rf, rl, rl, 4), (1, rf, rl, rl, 4), (1, rf, d_ctx), (1, 77, d_ctx))]
    with torch.inference_mode():
        q32 = copy.deepcopy(unet32)
        Q.quantize_unet_(q32, Q.default_unet_predicate)  # on the card, once
        out_gpu = unet32(*(torch.as_tensor(x, device="cuda") for x in inp)).float().cpu()
        outq_free = q32(*(torch.as_tensor(x, device="cuda") for x in inp)).float().cpu()
        unet_cpu = unet32.cpu()
        out_cpu = unet_cpu(*(torch.as_tensor(x) for x in inp))
        del unet32, unet_cpu
        q32.cpu()
        tape = tt.ActivationTape()
        with tape.active():
            outq_cpu = q32(*(torch.as_tensor(x) for x in inp))
        q32.cuda()
        replay = tt.ActivationTape(tape.records)
        reset_counts()
        with replay.active():
            outq_gpu = q32(*(torch.as_tensor(x, device="cuda") for x in inp)).float().cpu()
        if read_counts()[0]["s8_matmul"] <= 0:
            raise RuntimeError("the int8 reference forward launched no s8_matmul")
        del q32, tape
    mesh_ref["fp32"] = out_gpu
    ref_err = (out_gpu - out_cpu).abs().max().item()
    ref_scale = out_cpu.abs().max().item()
    log(f"reference: full-width UNet fp32, {rf} frames at {rl}x{rl} latents, card (kernels) "
        f"vs CPU (plain): max |diff| {ref_err:.3g} of max |out| {ref_scale:.3g} "
        f"(tolerance {TOL_REF} relative)")
    if not (ref_err <= TOL_REF * ref_scale):
        raise RuntimeError("full-width UNet on the card disagrees with the CPU reference")
    # int8 is discontinuous: the card's and the CPU's fp32 roundings flip a
    # few activations by one step, and the flips grow downstream.  So the
    # card replays the CPU run's int8 activations (checking its own against
    # them), and the outputs are compared under the goldens' rule
    q_err = (outq_gpu - outq_cpu).abs().max().item()
    q_free = (outq_free - outq_cpu).abs().max().item()
    q_drift = (outq_cpu - out_cpu).abs().max().item()
    log(f"reference, int8 (full selection, fp32 activations): card replaying the CPU's int8 "
        f"activations vs CPU max |diff| {q_err:.3g}; int8 vs fp32 on the CPU {q_drift:.3g}; "
        f"ratio {q_err / max(q_drift, 1e-30):.3g} (limit {TOL_INT8_SHARE}). The card's own "
        f"quantization: {replay.calls} calls, {replay.flips} of {replay.elements} elements one "
        f"step from the CPU's (max {replay.max_step}), scales within "
        f"{replay.max_scale_rel:.3g}; without the replay the card is {q_free:.3g} from the CPU")
    if not (math.isfinite(q_drift) and q_drift > 0 and q_err <= TOL_INT8_SHARE * q_drift):
        raise RuntimeError("full-width int8 UNet on the card disagrees with the CPU reference")
    if not (replay.calls == len(replay.records) and replay.max_step <= 1
            and replay.flips <= TOL_FLIP_SHARE * replay.elements):
        raise RuntimeError("the card's int8 activations disagree with the CPU's")
    torch.cuda.empty_cache()

    mark("4")
    # 6b. the reuse and broadcast modes at 512 px, on phase 2's bf16 pipeline
    # (before phase 5 quantizes it)
    reuse = reuse_phase(pipe, videos, masks, args.seed)
    torch.cuda.empty_cache()

    mark("6b")
    # 5. the int8 slice (mixed selection) on the same weights
    _, q_secs = sync_time(lambda: pipe.enable_int8(mode="mixed"))
    n_q = sum(isinstance(m, (Q.QuantLinear, Q.QuantConv)) for m in pipe.unet.modules())
    log(f"enable_int8(mode='mixed'): {n_q} layers quantized in {q_secs:.2f} s")
    int8 = run_slice(pipe, videos, masks, steps, args.seed, "int8-mixed")
    if int8["inv_launch"]["s8_matmul"] <= 0:
        raise RuntimeError("s8_matmul was never launched in the int8 inversions")
    if int8["comp_launch"]["s8_matmul"] <= 0:
        raise RuntimeError("s8_matmul was never launched in the int8 composite steps")
    drift = (int8["final"] - bf16["final"]).abs().max().item()
    log(f"int8-mixed vs bf16 composite latents: max |diff| {drift:.4g} of max |x| "
        f"{bf16['final'].abs().max().item():.4g}")
    init, cond, one, ms, pb, ps, cw = one_step_inputs(pipe, videos, masks, int8["stores"],
                                                      steps, args.seed, "stream")
    profiles["int8-mixed"] = profile_step(lambda: core.pnp_composite_core(
        pipe.unet, pipe.ddim, init, cond, one, ms, pb, ps, num_inference_steps=steps,
        guidance_scale=9.0, two_pass="stream", capture_weights=cw), "int8-mixed")
    # one int8-mixed fused step counted shape-only: phase 9's one-process count
    init, cond, one, ms, pb, ps, _ = one_step_inputs(pipe, videos, masks, int8["stores"],
                                                     steps, args.seed, False)
    with torch.inference_mode():
        fused_flops = FL.forward_flops(core.pnp_composite_core, pipe.unet, pipe.ddim, init, cond,
                                       one, ms, pb, ps, num_inference_steps=steps,
                                       guidance_scale=9.0, two_pass=False)
    log(f"int8-mixed: one fused composite step, shape-only count (TF) "
        f"{ {c: round(v / 1e12, 4) for c, v in fused_flops.items()} }")
    mesh_ref["int8_step_flops"] = fused_flops

    mark("5")
    # 6. one stream composite step in int8 "full", on the same seeded weights
    del pipe
    torch.cuda.empty_cache()
    pipe = tt.build_full_pipeline(seed=args.seed)
    pipe.enable_int8(mode="full")
    init, cond, one, ms, pb, ps, cw = one_step_inputs(pipe, videos, masks, int8["stores"],
                                                      steps, args.seed, "stream")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    full_out, full_secs = sync_time(lambda: core.pnp_composite_core(
        pipe.unet, pipe.ddim, init, cond, one, ms, pb, ps, num_inference_steps=steps,
        guidance_scale=9.0, two_pass="stream", capture_weights=cw))
    full_launch, full_shapes = read_counts()
    full_peak = torch.cuda.max_memory_allocated() / 2**30
    shutil.rmtree(int8["root"])
    if not torch.isfinite(full_out).all():
        raise RuntimeError("the int8 'full' composite step gave non-finite values")
    if full_launch["s8_matmul"] <= 0:
        raise RuntimeError("s8_matmul was never launched in the int8 'full' step")
    log(f"int8-full: one stream composite step in {full_secs:.2f} s, launches {full_launch}, "
        f"peak memory {full_peak:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()

    mark("6")
    # 7a. a full-width diffusers checkpoint: written, loaded, verified; then
    # 7. both CLIs at the templates' 1280 x 720 from that checkpoint, and a
    # tiled decode of their composite (both directories removed on any exit)
    with tempfile.TemporaryDirectory(prefix="mvoc_smoke_ckpt_") as ckpt_root, \
            tempfile.TemporaryDirectory(prefix="mvoc_smoke_cli_") as cli_root:
        ckpt = checkpoint_phase(args.seed, os.path.join(ckpt_root, "i2vgen-xl"))
        cli = cli_phase(args.steps, args.seed, ckpt["dir"], cli_root)
        # 7b. both CLIs batched, on the same pipeline and demo tree
        cli_b = batch_cli_phase(cli, args.steps, cli_root)
        # 7c. both CLIs with the reuse modes, on the same pipeline and demo tree
        cli_r = cli_reuse_phase(cli, cli_root)
        # 9 (NCCL): a one-rank NCCL process group through enable_mesh, on
        # the CLI phase's pipeline and phase 4's small input
        nccl = nccl_phase(cli["pipe"], [torch.as_tensor(x, device="cuda") for x in inp])
        for key in ("pipe", "final", "templates", "paths", "inv_cfgs", "comp_cfgs"):
            cli.pop(key)
        torch.cuda.empty_cache()

    mark("7a-7c")
    # 9. the mesh: MESH_WORLD ranks on the card, phase 2's weights and inputs
    gloo_cuda = gloo_cuda_probe()
    with tempfile.TemporaryDirectory(prefix="mvoc_smoke_mesh_") as mesh_root:
        mesh = mesh_phase(dict(seed=args.seed, steps=steps, nf=nf,
                               size=size, masks=masks, ref_input=inp, tmp=mesh_root), mesh_ref)
    mesh.update(nccl=nccl, gloo_cuda=gloo_cuda)
    torch.cuda.empty_cache()

    mark("9")
    # 8. kernel phases at every shape the paths launched (+ ragged cases)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    s8_shapes = dict(int8["shapes"]["s8_matmul"])
    for sig in full_shapes["s8_matmul"]:
        s8_shapes.setdefault(sig, 0)
    attn_shapes = {}
    for name in ("flash_attention", "frame_attention"):
        attn_shapes[name] = dict(bf16["shapes"][name])
        for sig in (list(cli["shapes"][name]) + list(cli["tiled"]["shapes"][name])
                    + list(cli_b["shapes"][name]) + list(reuse["shapes"][name])
                    + list(cli_r["shapes"][name])):
            attn_shapes[name].setdefault(sig, 0)
    for name, shapes in (("flash_attention", attn_shapes["flash_attention"]),
                         ("frame_attention", attn_shapes["frame_attention"]),
                         ("s8_matmul", s8_shapes)):
        for sig in mesh["shapes"].get(name, {}):
            shapes.setdefault(sig, 0)
    plans = (
        ("flash_attention", flash_phase, attn_shapes["flash_attention"],
         [(1, 5, 14400, 14400, 64, "torch.bfloat16", False)] + list(BAND_CASES)),
        ("frame_attention", frame_phase, attn_shapes["frame_attention"], []),
        ("s8_matmul", s8_phase, s8_shapes,
         [(17, 36, 9, "torch.bfloat16"), (17, 36, 9, "torch.float32")]),
    )
    table = []
    for name, run, launched, extra in plans:
        for sig in sorted(launched) + [e for e in extra if e not in launched]:
            t_row = time.perf_counter()
            ph = run(sig, gen)
            b_ms, basis = bound(ph)
            row = dict(kernel=name, shape=list(sig), wall_s=time.perf_counter() - t_row,
                       launches=launched.get(sig, 0),
                       full_step_launches=full_shapes.get(name, {}).get(sig, 0),
                       cli_launches=cli["shapes"].get(name, {}).get(sig, 0),
                       cli_batch_launches=cli_b["shapes"].get(name, {}).get(sig, 0),
                       reuse_launches=reuse["shapes"].get(name, {}).get(sig, 0),
                       cli_reuse_launches=cli_r["shapes"].get(name, {}).get(sig, 0),
                       tiled_launches=cli["tiled"]["shapes"].get(name, {}).get(sig, 0),
                       mesh_launches=mesh["shapes"].get(name, {}).get(sig, 0),
                       max_abs_err=ph["err"], tol=ph["tol"], ms=ph["ms"], call_ms=ph["call_ms"],
                       plain_ms=ph["plain_ms"], library_ms=ph["library_ms"], bound_ms=b_ms,
                       bound_by=basis, flops=ph["flops"],
                       bound_flops=ph.get("bound_flops", ph["flops"]))
            # the design launched, rate, share of the bound, ratio to the
            # library call, and the old design's time and error
            rate, unit = RATE[name](ph)
            row.update(design=ph["design"], rate=rate, rate_unit=unit,
                       bound_share=b_ms / ph["ms"], old_ms=ph["old_ms"], old_err=ph["old_err"],
                       vs_library=None if ph["library_ms"] is None
                       else ph["ms"] / ph["library_ms"])
            lib_txt = ("no library call" if row["vs_library"] is None
                       else f"{row['vs_library']:.2f}x the library call")
            old_txt = (f"{OLD_DESIGN[name]} design {ph['old_ms']:.4f} ms, "
                       f"err {ph['old_err']:.3g}")
            ops_txt = f"; operations {ph['flops']:.6g}"
            if row["bound_flops"] != ph["flops"]:
                ops_txt += (f" (utils.flops, every pair), the bound's {row['bound_flops']:.6g} "
                            f"(the pairs the function needs)")
            extra = (f" [{ph['design']}: {rate:.1f} {unit}, {100 * row['bound_share']:.1f}% "
                     f"of the bound, {lib_txt}; {old_txt}{ops_txt}]")
            table.append(row)
            peak_txt = {PEAK_BF16_FLOPS: "989 TF/s bf16", PEAK_FP32_FLOPS: "67 TF/s fp32",
                        PEAK_INT8_OPS: "1979 TOP/s int8"}[ph["peak"]]
            log(f"phase {name} {sig}: max_abs_err {ph['err']:.3g} (tol {ph['tol']:.3g}) "
                f"kernel_ms {ph['ms']:.4f} (call_ms {fmt_ms(ph['call_ms'])}) "
                f"plain_ms {fmt_ms(ph['plain_ms'])} "
                f"library_ms {fmt_ms(ph['library_ms'])} bound_ms {b_ms:.4f} ({basis}: "
                f"{'ops at ' + peak_txt if basis == 'operations' else 'bytes at 3.35 TB/s'}) "
                f"main-path launches {row['launches']}, CLI launches {row['cli_launches']}, "
                f"batched-CLI launches {row['cli_batch_launches']}, "
                f"reuse launches {row['reuse_launches']}, "
                f"reuse-CLI launches {row['cli_reuse_launches']}, "
                f"tiled-decode launches {row['tiled_launches']}, "
                f"mesh launches (all ranks) {row['mesh_launches']}{extra}")
            if not ph["err"] <= ph["tol"] or not ph.get("exact", True):
                raise RuntimeError(f"{name} {sig}: error {ph['err']} over {ph['tol']}")
            if not ph["old_err"] <= ph["tol"]:
                raise RuntimeError(f"{name} {sig}: old design's error {ph['old_err']} over "
                                   f"{ph['tol']}")
            torch.cuda.empty_cache()

    # the fused norms at every shape any path launched
    from mvoc_tpu_torch.ops import norm as N

    norm_paths = {"bf16": bf16["shapes"], "int8-mixed": int8["shapes"],
                  "int8-full-step": full_shapes, "cli": cli["shapes"],
                  "cli-tiled-decode": cli["tiled"]["shapes"], "cli-batched": cli_b["shapes"],
                  "reuse": reuse["shapes"], "cli-reuse": cli_r["shapes"], "mesh": mesh["shapes"]}
    norm_rows = []
    for name in N.LAUNCHES:
        launched: dict = {}
        for path, shapes in norm_paths.items():
            for sig, n in shapes.get(name, {}).items():
                launched.setdefault(sig, {})[path] = n
        if not launched:
            raise RuntimeError(f"{name} was never launched")
        for sig in sorted(launched):
            t_row = time.perf_counter()
            ph = norm_phase(name, sig, gen)
            row = dict(kernel=name, shape=[list(sig[0])] + list(sig[1:]),
                       wall_s=time.perf_counter() - t_row, launches_by_path=launched[sig],
                       max_abs_err=ph["err"], tol=ph["tol"], repeat_equal=ph["same"], ms=ph["ms"],
                       call_ms=ph["call_ms"], plain_ms=ph["plain_ms"],
                       library_ms=ph["library_ms"], library_err=ph["library_err"],
                       vs_library=ph["ms"] / ph["library_ms"], bound_ms=ph["bound_ms"],
                       bound_by="bytes", bytes=ph["bytes"], bound_share=ph["bound_ms"] / ph["ms"])
            norm_rows.append(row)
            log(f"phase {name} {sig}: max_abs_err {ph['err']:.3g} (tol {ph['tol']:.3g}) "
                f"repeat bitwise {ph['same']} kernel_ms {ph['ms']:.4f} (call_ms "
                f"{ph['call_ms']:.4f}) plain_ms {ph['plain_ms']:.4f} library_ms "
                f"{ph['library_ms']:.4f} ({row['vs_library']:.2f}x; library err "
                f"{ph['library_err']:.3g}) bound_ms {ph['bound_ms']:.4f} (bytes at 3.35 TB/s) "
                f"[{ph['bytes'] / ph['ms'] / 1e6:.1f} GB/s, {100 * row['bound_share']:.1f}% of "
                f"the bound] launches {launched[sig]}")
            if not ph["err"] <= ph["tol"]:
                raise RuntimeError(f"{name} {sig}: error {ph['err']} over {ph['tol']}")
            if not ph["same"]:
                raise RuntimeError(f"{name} {sig}: two launches gave different bits")
            torch.cuda.empty_cache()
    table.extend(norm_rows)

    # each kernel's device time in one composite step of the path that ran
    # it: composite-only launches at each shape times that shape's kernel time
    per_step_ms = {}
    for name, path in (("bf16", bf16), ("int8-mixed", int8)):
        per_step_ms[name] = {}
        for kname in KERNELS:
            ms_of = {tuple(r["shape"]): r["ms"] for r in table if r["kernel"] == kname}
            per_step_ms[name][kname] = sum(
                n * ms_of[sig] for sig, n in path["comp_shapes"][kname].items()
                if n and sig in ms_of) / max(
                path["steps"], 1)
        wall_ms = 1e3 * sum(path["step_s"]) / max(path["steps"], 1)
        steady_ms = 1e3 * path["step_s"][-1]  # the last step: past the first step's warm-up
        rest = steady_ms - sum(per_step_ms[name].values())
        log(f"{name}: kernel device time per composite step (launches x phase kernel_ms): "
            f"{ {k: round(v, 2) for k, v in per_step_ms[name].items()} } ms; mean step "
            f"{wall_ms:.1f} ms wall, steady (last) step {steady_ms:.1f} ms wall; shares of the "
            f"steady step: { {k: round(v / steady_ms, 4) for k, v in per_step_ms[name].items()} }"
            f", the rest {rest:.1f} ms ({rest / steady_ms:.4f})")

    # and in the whole CLI run: its launches at each shape times that shape's kernel time
    cli_kernel_s = {}
    for kname in ("flash_attention", "frame_attention"):
        ms_of = {tuple(r["shape"]): r["ms"] for r in table if r["kernel"] == kname}
        cli_kernel_s[kname] = sum(n * ms_of[sig] for sig, n in cli["shapes"][kname].items()
                                  if sig in ms_of) / 1e3
    cli["kernel_s"] = cli_kernel_s
    log(f"cli: kernel device time over both CLIs (launches x phase kernel_ms): "
        f"{ {k: round(v, 3) for k, v in cli_kernel_s.items()} } s of {cli['total_s']:.1f} s "
        f"wall ({ {k: round(v / cli['total_s'], 4) for k, v in cli_kernel_s.items()} })")

    mark("8")
    host = k3_host_costs(gen)
    log(f"K3 host cost per launch at [4096, 1280, 1280] -> bf16: encoding the two TMA tensor "
        f"maps {host['encode_us']:.2f} us (mean of 10000); the whole s8_matmul call "
        f"{host['call_us']:.1f} us on the host clock ({HOST_CALLS} calls back to back)")

    os.makedirs("chiprun_out", exist_ok=True)
    summary = {tag: {k: v for k, v in path.items() if k not in (
        "final", "root", "stores", "shapes", "comp_shapes", "trajs", "video")}
               for tag, path in (("bf16", bf16), ("int8_mixed", int8))}
    with open(os.path.join("chiprun_out", "chip_smoke_phases.json"), "w") as f:
        json.dump(dict(card=card, sass=sass, paths=summary, int8_full_step=dict(
            s=full_secs, launches=full_launch, peak_gib=full_peak),
            kernel_ms_per_step=per_step_ms, reference=dict(
                fp32_err=ref_err, fp32_scale=ref_scale, int8_err=q_err, int8_drift=q_drift),
            int8_vs_bf16_drift=drift, k3_host=host, profiles=profiles, composite_step=step_stats,
            route_check=route, int8_fused_step_flops=mesh_ref["int8_step_flops"],
            checkpoint={k: v for k, v in ckpt.items() if k not in ("root", "dir")},
            cli=dict({k: v for k, v in cli.items() if k not in ("shapes", "tiled")},
                     tiled={k: v for k, v in cli["tiled"].items() if k != "shapes"}),
            cli_batched={k: v for k, v in cli_b.items() if k != "shapes"},
            reuse={k: v for k, v in reuse.items() if k != "shapes"},
            cli_reuse={k: v for k, v in cli_r.items() if k != "shapes"},
            mesh={k: v for k, v in mesh.items() if k != "shapes"}, phase_end_s=phase_s,
            phases=table), f, indent=1, default=str)

    # one row per kernel, from this slice's path that launched it (K1, K2:
    # the CLIs at 1280 x 720; K3: the int8-mixed path), with the launches of
    # every path; the row's times at the shape that path spends most on
    by_path = {"bf16": bf16["launches"], "int8-mixed": int8["launches"],
               "int8-full-step": full_launch, "cli": cli["launches"],
               "cli-batched": cli_b["launches"], "cli-reuse": cli_r["launches"],
               "mesh": mesh["launches"]}
    count_key = {"flash_attention": "cli_launches", "frame_attention": "cli_launches",
                 "s8_matmul": "launches"}
    kernels = []
    for name, meta in KERNELS.items():
        key = count_key[name]
        rows = [r for r in table if r["kernel"] == name and r[key] > 0]
        head = max(rows, key=lambda r: r["bound_ms"] * r[key])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=cli["launches"][name] if key == "cli_launches" else int8["launches"][name],
            launches_by_path={p: n[name] for p, n in by_path.items()},
            max_abs_err=max(r["max_abs_err"] for r in table if r["kernel"] == name),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"], shape=head["shape"]))
    for name in N.LAUNCHES:
        rows = [r for r in norm_rows if r["kernel"] == name]
        head = max(rows, key=lambda r: r["ms"] * sum(r["launches_by_path"].values()))
        kernels.append(dict(
            name=name, route="cuda", source="mvoc_tpu_torch/csrc/norm.cu",
            replaces="none (XLA fuses the JAX package's jnp norms)",
            launches=sum(sum(r["launches_by_path"].values()) for r in rows),
            launches_by_path={p: sum(r["launches_by_path"].get(p, 0) for r in rows)
                              for p in norm_paths},
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by="bytes",
            library_ms=head["library_ms"], shape=head["shape"]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
