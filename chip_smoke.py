"""On-card smoke run of mvoc_tpu_torch: builds the CUDA kernels, drives the
main paths (invert -> stream composite -> decode in bf16, then the same in
int8, then a full-width diffusers checkpoint written, loaded and verified,
then both CLIs from that checkpoint at the templates' 1280 x 720 and a tiled
decode of their composite) at full I2VGen-XL width on one CUDA card, and
holds every kernel against its plain PyTorch version at every shape those
runs launched it with.

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
     wall times and peak memory are printed.  K3 must not launch here;
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
     and idle share, and device time by kernel group);
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
  8. kernel phases: K1 and K2 at every distinct shape the bf16 slice and
     the CLI phase and the tiled decode launched, plus a ragged 14400-token
     K1 case and K1 with the temporal-window band as its bias (F = 96 in
     both frame layouts, F = 160), each against its plain
     version computed in fp32 from the same bf16 inputs; K3 at every
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
     PR 2's mma.sync kernel); after the build, per-kernel registers
     (-Xptxas -v) and the HGMMA / IGMMA / HMMA / IMMA counts in each
     kernel's SASS (cuobjdump); K3's host cost per launch.  Last, the bf16
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
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# bf16 kernel vs fp32 plain on unit-variance inputs: |err| <= TOL_BF16 * max|plain|.
# Tied to the output's own scale (which falls as 1/sqrt(Sk) for K1): the
# bf16 roundings of the pre-scaled q, of p and of the output each cost up to
# 2^-9 of what they round, so the kernel's error stays a few 1e-3 of max|plain|
TOL_BF16 = 2e-2
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
HOST_CALLS = 200  # K3 wrapper calls timed on the host clock, back to back

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
RATE = {"flash_attention": lambda ph: (ph["flops"] / ph["ms"] / 1e9, "TF/s"),
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
    from mvoc_tpu_torch.ops import s8gemm as S8

    return A, S8


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
        out.update({k: dict(v) for k, v in mod.LAUNCH_VARIANTS.items()})
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
    inv_secs = []
    for d, frames in zip(dirs, videos):
        (_, traj), secs = sync_time(lambda: pipe.invert(
            frames, height=size, width=size, num_frames=nf, num_inference_steps=steps,
            seed=seed, output_dir=d))
        if not np.isfinite(traj).all():
            raise RuntimeError(f"{tag}: inversion of {d} gave non-finite latents")
        inv_secs.append(secs)
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
                variants=variants,
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


# kernel-name fragments -> the group a steady step's device time is booked
# under (first match wins; lower-cased names)
KERNEL_GROUPS = (("flash_", "K1 flash attention"), ("frame_", "K2 frame attention"),
                 ("s8_", "K3 s8 GEMM"), ("conv", "convolution"), ("fprop", "convolution"),
                 ("implicit", "convolution"), ("gemm", "GEMM"), ("cutlass", "GEMM"),
                 ("cublas", "GEMM"), ("nvjet", "GEMM"), ("norm", "normalisation"),
                 ("reduce", "reductions"),
                 ("copy", "copies and layout"), ("cat", "copies and layout"),
                 ("elementwise", "elementwise"), ("vectorized", "elementwise"))


def profile_step(run, tag: str) -> dict:
    """One composite step (`run`, warmed up first) under torch.profiler:
    its wall time, the device's busy time (the union of the kernels'
    intervals) and idle share, and the device time by kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync_time(run)
    _, wall_s = sync_time(run)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = sync_time(run)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"{tag} profile: no device events (CUPTI gave none): not measured")
        return dict(wall_s=wall_s, device_busy_ms=None)
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
        low = e.name.lower()
        group = next((g for frag, g in KERNEL_GROUPS if frag in low), "other")
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
    return out


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


def cli_phase(steps: int, seed: int, ckpt: str, tmp: str) -> dict:
    """The inversion CLI (3 videos, the reconstruction round trip on bg) and
    the composite CLI (fused, N = 2) on a demo tree of 16-frame 1280 x 720
    videos, through the CLIs' own configure / build_pipeline (from the
    checkpoint directory `ckpt`) / apply_unet_options / apply_quantize /
    run, with every launch count set to 0 just before and read just after;
    wall time, launches and peak memory per CLI stage.  Then the
    composite's final latents decoded again, tiled."""
    import contextlib

    import torch
    from PIL import Image

    from mvoc_tpu_torch import config as cfglib
    from mvoc_tpu_torch.cli import common, composite, inverse
    from mvoc_tpu_torch.io import media
    from mvoc_tpu_torch.io.trajectory import NATIVE_NAME, STACK_NAME
    from mvoc_tpu_torch.pipeline import core
    from mvoc_tpu_torch.utils import testing as tt
    from mvoc_tpu_torch.utils.profiling import StepTimer

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

    def on_step(i):  # composite steps, synchronised
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - last[0])
        last[0] = now

    def timed(owner, attr, name):
        """owner.attr as a stage of the timer (sub-stages of the CLI stages:
        the pipeline's entry points, its step loops and the VAE decode)."""
        fn = getattr(owner, attr)

        def wrapped(*a, **kw):
            if attr == "pnp_composite_core":
                kw["step_callback"] = on_step
                torch.cuda.synchronize()
                last[0] = time.perf_counter()
            with timer.stage(name):
                out = fn(*a, **kw)
            if attr == "pnp_composite_core":
                finals.append(out)
            return out

        setattr(owner, attr, wrapped)
        return fn

    for attr in ("invert", "sample", "sample_composite", "decode_latents"):
        timed(pipe, attr, f"pipe.{attr}")
    # the host's share: frame loading and the exports
    originals = [(mod, attr, timed(mod, attr, f"{mod.__name__.split('.')[-1]}.{attr}"))
                 for mod, attr in ((core, "ddim_inversion_core"), (core, "ddim_sampling_core"),
                                   (core, "pnp_composite_core"), (media, "load_video_frames"),
                                   (media, "export_to_video"), (media, "export_to_gif"),
                                   (composite, "_load_frame_dir"), (composite, "load_entry_masks"))]
    inv_cfgs = inverse.configure(templates["inversion"], cfglib.load_json_list(paths["inversion"]))
    comp_cfgs = composite.configure(templates["composite"],
                                    cfglib.load_json_list(paths["composite"]))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    inverse.run(pipe, inv_cfgs, timer=timer)
    composite.run(pipe, comp_cfgs, timer=timer)
    total_s = time.perf_counter() - t0
    launches, shapes = read_counts()
    for mod, attr, fn in originals:
        setattr(mod, attr, fn)
    peak = max(peaks.values()) / 2**30
    times = timer.summary()
    for name, secs in times.items():
        log(f"cli stage {name}: {secs:.2f} s wall over {calls[name]} call(s), peak memory "
            f"{peaks[name] / 2**30:.2f} GiB, launches {stages[name]}")
    log(f"cli: composite steps {[round(t, 3) for t in step_s]} s")
    log(f"cli: both CLIs in {total_s:.1f} s; launches {launches}; peak device memory "
        f"{peak:.2f} GiB; {card_line()}")
    for name, n in stages.items():
        if n["s8_matmul"] != 0:
            raise RuntimeError(f"cli stage {name}: s8_matmul launched on the bf16 path")
        if name.startswith(("invert/", "composite/")) and (
                n["flash_attention"] <= 0 or n["frame_attention"] <= 0):
            raise RuntimeError(f"cli stage {name}: K1 or K2 was never launched ({n})")

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

    want = {"recon": [os.path.join(bg.output_dir, "ddim_reconstruction.gif")],
            "composite": [os.path.join(composite.export_dir(comp_cfgs[0]), "video.gif")]}
    if media.cv2 is not None:
        want["recon"].append(os.path.join(bg.output_dir, "ddim_reconstruction.mp4"))
        want["composite"].append(os.path.join(composite.export_dir(comp_cfgs[0]), "video.mp4"))
    out_dir = composite.export_dir(comp_cfgs[0])
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
    if media.cv2 is not None:
        for p in (want["recon"][1], want["composite"][1]):
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
    tiled = tiled_decode_phase(pipe, finals[-1], nf, height, width)
    del pipe
    torch.cuda.empty_cache()
    return dict(launches=launches, shapes=shapes, stages=stages, stage_s=times,
                stage_calls=calls, stage_peak_gib={k: v / 2**30 for k, v in peaks.items()},
                composite_step_s=step_s, total_s=total_s, peak_gib=peak,
                containers=containers, recon=recon, frames=len(frames),
                mp4=media.cv2 is not None, build_s=build_s, tiled=tiled)


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


def _flash_measure(q, k, v, bias, mask, needed_pairs: float):
    """K1 on [B, H, S, D] views (bias: its fp32 [Sq, Sk] or None; mask: the
    same as SDPA's boolean mask): error against the plain version in fp32
    from the same bf16 inputs, times of the kernel, its call, the plain
    version, the SIMT design and one SDPA call; operations counted
    over the (query, key) pairs the function needs."""
    import torch.nn.functional as F

    from mvoc_tpu_torch.ops import attention as A

    b, h, sq, d = q.shape
    sk = k.shape[2]
    out, design = launched_variant(A, "flash_attention", lambda: A.flash_attention(
        q, k, v, bias=bias))
    old = A._flash_cuda(q, k, v, "simt", bias=bias)  # the old design, kept for comparison
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
    old_err = (old.float() - ref).abs().max().item()
    tol = TOL_BF16 * ref.abs().max().item()
    call_ms = cuda_ms(lambda: A.flash_attention(q, k, v, bias=bias), reps=TIMED_REPS)
    ms = graph_ms(lambda: A.flash_attention(q, k, v, bias=bias), reps=TIMED_REPS)
    old_ms = cuda_ms(lambda: A._flash_cuda(q, k, v, "simt", bias=bias), reps=3)
    plain_ms = cuda_ms(lambda: plain(q, k, v), reps=1)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                      reps=TIMED_REPS)
    flops = 4.0 * b * h * needed_pairs * d
    nbytes = 2.0 * (2 * b * h * sq * d + 2 * b * h * sk * d) + (
        0.0 if bias is None else 4.0 * sq * sk)
    return dict(err=err, old_err=old_err, tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, flops=flops, bytes=nbytes, peak=PEAK_BF16_FLOPS,
                old_ms=old_ms, design=design, out=out)


def flash_phase(sig, gen):
    """K1 at a launched signature (B, H, Sq, Sk, D, dtype, biased), or at a
    BAND_CASES entry (band_phase)."""
    import torch

    from mvoc_tpu_torch.ops import attention as A

    if sig[0] in ("sf", "natural"):
        return band_phase(sig, gen)
    b, h, sq, sk, d, _, biased = sig
    dev = torch.device("cuda")
    # the main path's layout: [B, S, H, D] projections viewed as [B, H, S, D]
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
               .transpose(1, 2) for s in (sq, sk, sk))
    mask = band(sq, 16) if biased else None
    pairs = float(mask.sum().item()) if biased else float(sq) * sk
    ph = _flash_measure(q, k, v, A.band_bias(mask), mask, pairs)
    ph.pop("out")
    return ph


def band_phase(case, gen):
    """K1 with the temporal window's band as its bias over F > 64 frames, on
    the [S, H, F, D] view layers.sdpa (layout "sf": [S, F, H*D]) or
    layers.sdpa_frames (layout "natural": [1, F, S, H*D]) hands it; the
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
        layer = layers.sdpa_frames(q, k, v, heads, mask=mask)
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
    out, design = launched_variant(A, "frame_attention", lambda: A.frame_attention(
        q, k, v, heads, mask=mask, layout=layout))
    old = A._frame_cuda(q, k, v, heads, mask, layout, "simt")  # the PR 1 design
    ref = A.frame_attention_plain(q.float(), k.float(), v.float(), heads, mask=mask,
                                  layout=layout)
    err = (out.float() - ref).abs().max().item()
    old_err = (old.float() - ref).abs().max().item()
    tol = TOL_BF16 * ref.abs().max().item()
    call_ms = cuda_ms(lambda: A.frame_attention(q, k, v, heads, mask=mask, layout=layout),
                      reps=TIMED_REPS)
    ms = graph_ms(lambda: A.frame_attention(q, k, v, heads, mask=mask, layout=layout),
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
    n = b * s * heads
    flops = 4.0 * n * f * f * d
    nbytes = 4.0 * n * f * d * 2
    return dict(err=err, tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                flops=flops, bytes=nbytes, peak=PEAK_BF16_FLOPS, old_ms=old_ms,
                old_err=old_err, design=design)


def s8_phase(sig, gen):
    import torch

    from mvoc_tpu_torch.ops import s8gemm as S8

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
    old = S8._s8_cuda(xq, wq, sx, sw, out_dtype, "mma")  # the PR 2 design
    # plain version (exact float64 product), row-chunked to keep its float64
    # copy of x under ~2 GB
    chunk = max(1, int(2e9 // (8 * k)))

    def plain():
        return _chunked(lambda x, s: S8.s8_matmul_plain(x, wq, s, sw, out_dtype=out_dtype),
                        m, chunk, xq, sx)

    ref = plain()
    exact = torch.equal(out, ref) and torch.equal(old, ref)
    err = (out.float() - ref.float()).abs().max().item()
    old_err = (old.float() - ref.float()).abs().max().item()
    call_ms = cuda_ms(lambda: S8.s8_matmul(xq, wq, sx, sw, out_dtype=out_dtype),
                      reps=TIMED_REPS)
    ms = graph_ms(lambda: S8.s8_matmul(xq, wq, sx, sw, out_dtype=out_dtype), reps=TIMED_REPS)
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
    out_bytes = torch.finfo(out_dtype).bits // 8
    flops = 2.0 * m * k * n
    nbytes = float(m * k + k * n + 4 * (m + n) + m * n * out_bytes)
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


def bound(ph):
    t_ops = ph["flops"] / ph["peak"]
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
    shutil.rmtree(bf16["root"])
    if read_counts()[0]["s8_matmul"] != 0:
        raise RuntimeError("s8_matmul launched on the bf16 path")

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

    # 7a. a full-width diffusers checkpoint: written, loaded, verified; then
    # 7. both CLIs at the templates' 1280 x 720 from that checkpoint, and a
    # tiled decode of their composite (both directories removed on any exit)
    with tempfile.TemporaryDirectory(prefix="mvoc_smoke_ckpt_") as ckpt_root, \
            tempfile.TemporaryDirectory(prefix="mvoc_smoke_cli_") as cli_root:
        ckpt = checkpoint_phase(args.seed, os.path.join(ckpt_root, "i2vgen-xl"))
        cli = cli_phase(args.steps, args.seed, ckpt["dir"], cli_root)

    # 8. kernel phases at every shape the paths launched (+ ragged cases)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    s8_shapes = dict(int8["shapes"]["s8_matmul"])
    for sig in full_shapes["s8_matmul"]:
        s8_shapes.setdefault(sig, 0)
    attn_shapes = {}
    for name in ("flash_attention", "frame_attention"):
        attn_shapes[name] = dict(bf16["shapes"][name])
        for sig in list(cli["shapes"][name]) + list(cli["tiled"]["shapes"][name]):
            attn_shapes[name].setdefault(sig, 0)
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
            ph = run(sig, gen)
            b_ms, basis = bound(ph)
            row = dict(kernel=name, shape=list(sig), launches=launched.get(sig, 0),
                       full_step_launches=full_shapes.get(name, {}).get(sig, 0),
                       cli_launches=cli["shapes"].get(name, {}).get(sig, 0),
                       tiled_launches=cli["tiled"]["shapes"].get(name, {}).get(sig, 0),
                       max_abs_err=ph["err"], tol=ph["tol"], ms=ph["ms"], call_ms=ph["call_ms"],
                       plain_ms=ph["plain_ms"], library_ms=ph["library_ms"], bound_ms=b_ms,
                       bound_by=basis)
            # the design launched, rate, share of the bound, ratio to the
            # library call, and the old design's time and error
            rate, unit = RATE[name](ph)
            row.update(design=ph["design"], rate=rate, rate_unit=unit,
                       bound_share=b_ms / ph["ms"], old_ms=ph["old_ms"], old_err=ph["old_err"],
                       vs_library=None if ph["library_ms"] is None
                       else ph["ms"] / ph["library_ms"])
            lib_txt = ("no library call" if row["vs_library"] is None
                       else f"{row['vs_library']:.2f}x the library call")
            extra = (f" [{ph['design']}: {rate:.1f} {unit}, {100 * row['bound_share']:.1f}% "
                     f"of the bound, {lib_txt}; {OLD_DESIGN[name]} design "
                     f"{ph['old_ms']:.4f} ms, err {ph['old_err']:.3g}]")
            table.append(row)
            peak_txt = "989 TF/s" if ph["peak"] == PEAK_BF16_FLOPS else "1979 TOP/s int8"
            log(f"phase {name} {sig}: max_abs_err {ph['err']:.3g} (tol {ph['tol']:.3g}) "
                f"kernel_ms {ph['ms']:.4f} (call_ms {ph['call_ms']:.4f}) "
                f"plain_ms {ph['plain_ms']:.4f} "
                f"library_ms {fmt_ms(ph['library_ms'])} bound_ms {b_ms:.4f} ({basis}: "
                f"{'ops at ' + peak_txt if basis == 'operations' else 'bytes at 3.35 TB/s'}) "
                f"main-path launches {row['launches']}, CLI launches {row['cli_launches']}, "
                f"tiled-decode launches {row['tiled_launches']}{extra}")
            if not ph["err"] <= ph["tol"] or not ph.get("exact", True):
                raise RuntimeError(f"{name} {sig}: error {ph['err']} over {ph['tol']}")
            if not ph.get("old_err", 0.0) <= ph["tol"]:
                raise RuntimeError(f"{name} {sig}: old design's error {ph['old_err']} over "
                                   f"{ph['tol']}")
            torch.cuda.empty_cache()

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

    host = k3_host_costs(gen)
    log(f"K3 host cost per launch at [4096, 1280, 1280] -> bf16: encoding the two TMA tensor "
        f"maps {host['encode_us']:.2f} us (mean of 10000); the whole s8_matmul call "
        f"{host['call_us']:.1f} us on the host clock ({HOST_CALLS} calls back to back)")

    os.makedirs("chiprun_out", exist_ok=True)
    summary = {tag: {k: v for k, v in path.items() if k not in ("final", "root", "stores",
                                                                "shapes", "comp_shapes")}
               for tag, path in (("bf16", bf16), ("int8_mixed", int8))}
    with open(os.path.join("chiprun_out", "chip_smoke_phases.json"), "w") as f:
        json.dump(dict(card=card, sass=sass, paths=summary, int8_full_step=dict(
            s=full_secs, launches=full_launch, peak_gib=full_peak),
            kernel_ms_per_step=per_step_ms, reference=dict(
                fp32_err=ref_err, fp32_scale=ref_scale, int8_err=q_err, int8_drift=q_drift),
            int8_vs_bf16_drift=drift, k3_host=host, profiles=profiles, composite_step=step_stats,
            checkpoint={k: v for k, v in ckpt.items() if k not in ("root", "dir")},
            cli=dict({k: v for k, v in cli.items() if k not in ("shapes", "tiled")},
                     tiled={k: v for k, v in cli["tiled"].items() if k != "shapes"}),
            phases=table), f, indent=1)

    # one row per kernel, from this slice's path that launched it (K1, K2:
    # the CLIs at 1280 x 720; K3: the int8-mixed path), with the launches of
    # every path; the row's times at the shape that path spends most on
    by_path = {"bf16": bf16["launches"], "int8-mixed": int8["launches"],
               "int8-full-step": full_launch, "cli": cli["launches"]}
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
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
