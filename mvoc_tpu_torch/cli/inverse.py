"""Entry point A: group DDIM inversion CLI (the port's own copy of
mvoc_tpu/cli/inverse.py).

Usage (the reference's surface, reference: inverse.py:230-255):

  python -m mvoc_tpu_torch.cli.inverse \
      --template_config configs/group_inversion/template.yaml \
      --configs_json <group_config.json> [--checkpoint <dir>|tiny]

Per active entry: load (or extract) the frames, DDIM-invert them and save
the trajectory store, then, when recon_config.enable_recon, run the
reconstruction round trip and score it with PSNR / SSIM (reference:
inverse.py:111-227).  With --batch (or the template's batch_inversions)
the uncached entries that share their settings are first inverted together
in one batched step loop (`run_batched`).  `configure` (merge, paths,
ReplaceMe check) and `run` (the work, on a given pipeline) are the two
halves of `main`.
"""

from __future__ import annotations

import logging
import os

import torch

from mvoc_tpu_torch import config as cfglib
from mvoc_tpu_torch.cli import common
from mvoc_tpu_torch.io import media
from mvoc_tpu_torch.io.trajectory import NATIVE_NAME, STACK_NAME, TrajectoryStore
from mvoc_tpu_torch.ops.ddim import sampling_timesteps
from mvoc_tpu_torch.utils.autoreuse import resolve_auto_reuse
from mvoc_tpu_torch.utils.metrics import psnr, ssim
from mvoc_tpu_torch.utils.profiling import StepTimer, trace

logger = logging.getLogger("mvoc_tpu_torch.inverse")


def _load_entry_frames(config):
    """(frames, first_frame) of one entry, with the static-video and
    null-first-image inversion modes."""
    from PIL import Image

    image_size = tuple(config.image_size)
    try:
        logger.info("loading frames from %s", config.video_frames_path)
        _, frames = media.load_video_frames(
            config.video_frames_path, config.n_frames, image_size)
    except (FileNotFoundError, NotADirectoryError):
        logger.info("converting video to frames: %s", config.video_path)
        frames = media.convert_video_to_frames(config.video_path, image_size)
        frames = frames[: config.n_frames]

    first_frame = frames[0]
    inv = config.inverse_config
    if inv.get("inverse_static_video", False):
        logger.info("inverting a static video")
        frames = [frames[0]] * config.n_frames
    if inv.get("null_image_inversion", False):
        logger.info("using a null first image")
        first_frame = Image.new("RGB", image_size, (0, 0, 0))
    return frames, first_frame


def _has_valid_cache(config) -> bool:
    """True when a usable trajectory store exists for this entry (the
    reference's skip-if-cached, inverse.py:181-183, plus a check of the
    stored meta against this entry's settings)."""
    inv = config.inverse_config
    image_size = tuple(config.image_size)
    out_dir = inv.output_dir
    has_cache = any(
        os.path.exists(os.path.join(out_dir, n)) for n in (NATIVE_NAME, STACK_NAME)
    )
    expected_meta = dict(
        n_steps=inv.n_steps, num_frames=config.n_frames,
        height=image_size[1], width=image_size[0], prompt=inv.prompt,
        seed=config.get("seed", 8888),
    )
    if has_cache and not TrajectoryStore(out_dir).matches_meta(expected_meta):
        logger.warning("cached trajectory at %s was produced by a different "
                       "config — recomputing", out_dir)
        has_cache = False
    return has_cache and not config.get("force_recompute_latents", False)


def run_batched(pipe, configs) -> None:
    """Invert the uncached entries that share an inversion signature in one
    batched step loop (pipe.invert_batch, the videos on the UNet batch
    axis); groups of one, and entries with cfg != 1, are left to the
    per-entry pass of run_entry, which then finds the fresh stores."""
    groups: dict[tuple, list] = {}
    for config in configs:
        inv = config.inverse_config
        if _has_valid_cache(config) or float(inv.cfg) != 1.0:
            continue
        key = (
            tuple(config.image_size), config.n_frames, inv.n_steps,
            inv.target_fps, inv.prompt, config.get("seed", 8888),
            inv.get("encoder_reuse_interval", 1),
            inv.get("deep_reuse", False),
        )
        groups.setdefault(key, []).append(config)

    for key, group in groups.items():
        if len(group) < 2:
            continue  # nothing to batch: the per-entry pass inverts it
        image_size, n_frames, n_steps, fps, prompt, seed, reuse, deep = key
        videos, firsts, out_dirs = [], [], []
        for config in group:
            frames, first = _load_entry_frames(config)
            videos.append(frames)
            firsts.append(first)
            out_dirs.append(config.inverse_config.output_dir)
        logger.info("batched inversion of %d videos: %s", len(group),
                    [c.video_name for c in group])
        pipe.invert_batch(
            videos, first_frames=firsts, prompt=prompt,
            height=image_size[1], width=image_size[0], target_fps=fps,
            num_frames=n_frames, num_inference_steps=n_steps, seed=seed,
            output_dirs=out_dirs, encoder_reuse_interval=reuse,
            deep_reuse=deep,
        )
        for config in group:
            # the per-entry pass must now pick up the fresh stores
            config.force_recompute_latents = False


def run_entry(pipe, config) -> None:
    image_size = tuple(config.image_size)
    inv = config.inverse_config
    out_dir = inv.output_dir
    frames, first_frame = _load_entry_frames(config)
    if _has_valid_cache(config):
        logger.info("skipping inversion — %s already exists", out_dir)
    else:
        ts, _ = pipe.invert(
            frames,
            first_frame=first_frame,
            prompt=inv.prompt,
            negative_prompt=inv.get("negative_prompt", ""),
            height=image_size[1],
            width=image_size[0],
            target_fps=inv.target_fps,
            num_frames=config.n_frames,
            num_inference_steps=inv.n_steps,
            guidance_scale=inv.cfg,
            seed=config.get("seed", 8888),
            output_dir=out_dir,
            encoder_reuse_interval=inv.get("encoder_reuse_interval", 1),
            encoder_reuse_depth=inv.get("encoder_reuse_depth", None),
            deep_reuse=inv.get("deep_reuse", False),
        )
        logger.info("inversion done: %d steps -> %s", len(ts), out_dir)

    recon = config.get("recon_config")
    recon_on = recon is not None and recon.get("enable_recon", False)
    if (inv.get("deep_reuse", False)
            or inv.get("encoder_reuse_interval", 1) > 1) and not recon_on \
            and not inv.get("reuse_auto_report"):
        # a cached trajectory may come from an approximate inversion of the
        # JAX package: point at the reconstruction check
        logger.warning(
            "inverse_config enables approximate inversion (deep_reuse=%s, "
            "encoder_reuse_interval=%s) but recon_config.enable_recon is "
            "off — enable it to score reconstruction PSNR/SSIM and verify "
            "the approximation is acceptable for this content",
            inv.get("deep_reuse", False),
            inv.get("encoder_reuse_interval", 1))
    if recon_on:
        t_idx = recon.ddim_init_latents_t_idx
        samp_ts = sampling_timesteps(pipe.scheduler_config, recon.n_steps)
        store = TrajectoryStore(recon.get("ddim_latents_path", inv.output_dir))
        start = store.load_at_t(int(samp_ts[t_idx]))
        video = pipe.sample(
            first_frame,
            prompt=recon.prompt,
            negative_prompt=recon.get("negative_prompt", ""),
            height=image_size[1],
            width=image_size[0],
            target_fps=recon.target_fps,
            num_frames=config.n_frames,
            num_inference_steps=recon.n_steps,
            guidance_scale=recon.cfg,
            ddim_init_latents_t_idx=t_idx,
            latents=torch.from_numpy(start),
            seed=config.get("seed", 8888),
        )
        src = media.pil_to_01(frames)
        score_psnr = psnr(video, src)
        score_ssim = ssim(video, src)
        logger.info("reconstruction PSNR %.2f dB, SSIM %.4f", score_psnr, score_ssim)
        if not common.is_writer(pipe):
            return
        os.makedirs(config.output_dir, exist_ok=True)
        pil = media.video_to_pil(video)
        media.export_to_video(pil, os.path.join(config.output_dir, "ddim_reconstruction.mp4"), fps=10)
        media.export_to_gif(pil, os.path.join(config.output_dir, "ddim_reconstruction.gif"))
        with open(os.path.join(config.output_dir, "recon_metrics.txt"), "w") as f:
            f.write(f"psnr_db={score_psnr:.4f}\nssim={score_ssim:.4f}\n")
        logger.info("saved reconstruction to %s", config.output_dir)


def configure(template, entries) -> list:
    """The active entries merged over the template, with the reference's
    path resolution and the ReplaceMe check."""
    configs = []
    for entry in entries:
        if not entry.get("active", True):
            logger.info("skipping inactive entry %s", entry.get("video_name"))
            continue
        config = cfglib.merge(template, entry)
        config.video_path = os.path.join(config.video_dir, config.video_name + ".mp4")
        config.video_frames_path = os.path.join(config.video_dir, config.video_name)
        common.check_replaceme(config)
        configs.append(config)
    return configs


def run(pipe, configs, profile_dir=None, timer: StepTimer | None = None,
        batch: bool = False) -> StepTimer:
    """Invert (and reconstruct) every configured entry on `pipe`, one stage
    of `timer` per entry; with `batch`, the entries that share an inversion
    signature first go through one batched step loop (stage
    "invert/batched").  Returns the timer."""
    for config in configs:
        # `encoder_reuse_interval: auto`: probe this entry's own video and pick
        # the largest k that clears the reconstruction PSNR bar
        # (utils/autoreuse.py); cached entries skip the probe
        if (config.inverse_config.get("encoder_reuse_interval", 1) == "auto"
                and not _has_valid_cache(config)):
            logger.info("resolving auto reuse interval for %s", config.get("video_name", "?"))
            resolve_auto_reuse(pipe, config)
    timer = timer or StepTimer()
    with trace(profile_dir):
        if batch and len(configs) > 1:
            with timer.stage("invert/batched"):
                run_batched(pipe, configs)
        for config in configs:
            logger.info("processing %s", config.video_name)
            with timer.stage(f"invert/{config.video_name}"):
                run_entry(pipe, config)
            common.save_config(pipe, config)
    logger.info("timings: %s", timer.summary())
    return timer


def main(argv=None) -> None:
    args = common.parse_args("configs/group_inversion/template.yaml", argv)
    template, entries = common.load_configs(args)
    common.setup_logging(template)
    common.init_launcher(template)
    pipe = common.build_pipeline(args, template)
    pipe = common.apply_unet_options(pipe, template)
    pipe = common.apply_mesh(pipe, args, template)
    if common.off_mesh(pipe):
        return
    pipe = common.apply_quantize(pipe, template)
    run(pipe, configure(template, entries), args.profile_dir,
        batch=args.batch or template.get("batch_inversions", False))


if __name__ == "__main__":
    main()
