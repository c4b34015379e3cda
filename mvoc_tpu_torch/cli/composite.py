"""Entry point B: group multi-object composition CLI (the port's own
copy of mvoc_tpu/cli/composite.py).

Usage (the reference's surface, reference: composite.py:227-255):

  python -m mvoc_tpu_torch.cli.composite \
      --template_config configs/group_composite/template.yaml \
      --configs_json <group_config.json> [--checkpoint <dir>|tiny]

Per active entry: resolve the paths, load the edited first frame, the
per-branch control frames, the masks and the inversion trajectories, run the
PnP composite sampler, and export mp4 / gif / frames into a
parameter-encoded directory (reference: composite.py:72-224).  With
--batch (or the template's batch_composites) the entries that share a
batching signature are composited together in one batched step loop
(`run_batched`).  `configure` (merge, paths, ReplaceMe check) and `run`
(the work, on a given pipeline) are the two halves of `main`.
"""

from __future__ import annotations

import logging
import os

import numpy as np
from PIL import Image

from mvoc_tpu_torch import config as cfglib
from mvoc_tpu_torch.cli import common
from mvoc_tpu_torch.io import masks as masklib
from mvoc_tpu_torch.io import media
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.utils.profiling import StepTimer, trace

logger = logging.getLogger("mvoc_tpu_torch.composite")


def _load_frame_dir(path: str, n_frames: int, image_size) -> list:
    frames = []
    for i in range(n_frames):
        img = Image.open(os.path.join(path, f"{i:05d}.png")).convert("RGB")
        if img.size != tuple(image_size):
            img = img.resize(tuple(image_size), resample=Image.Resampling.LANCZOS)
        frames.append(img)
    return frames


def load_entry_masks(config, image_size, n_frames: int, vae_scale: int = 8):
    """Masks with the reference's semantics: downscaled by the VAE scale
    from the MASK FILE's own size (soft bicubic, binary > 10 at the
    downscaled size; reference: utils.py:93-95, 110-125), used directly at
    latent resolution.  The reference therefore requires masks authored at
    the working size, and a mismatch raises here;
    `mask_resize_to_latent: true` opts into resizing straight to latent
    resolution instead (the same at matched sizes).  Returns (masks_soft,
    masks_binary), each [N, F, h_lat, w_lat]."""
    lat_wh = (image_size[0] // vae_scale, image_size[1] // vae_scale)
    softs, bins = [], []
    for m in config.obj_mask_path:
        s, b = masklib.mask_preprocess(m, n_frames, downscale=vae_scale)
        if s.shape[-2:] != (lat_wh[1], lat_wh[0]):
            if config.get("mask_resize_to_latent", False):
                logger.warning(
                    "mask %s: x8 downscale gives %s != latent %s — resizing "
                    "straight to latent resolution (mask_resize_to_latent; "
                    "NOT reference semantics, which require mask size == "
                    "working size)", m, s.shape[-2:], (lat_wh[1], lat_wh[0]))
                s, b = masklib.mask_preprocess(m, n_frames, target_wh=lat_wh)
            else:
                raise ValueError(
                    f"mask {m} downscaled x8 is {s.shape[-2:]} but the "
                    f"latent resolution is {(lat_wh[1], lat_wh[0])}: the "
                    "reference requires masks authored at the working "
                    "resolution (utils.py:93-95). Re-author the mask at "
                    f"{tuple(image_size)}, or set mask_resize_to_latent: "
                    "true to resize it straight to latent resolution "
                    "instead.")
        softs.append(s)
        bins.append(b)
    return np.stack(softs), np.stack(bins)


def _entry_inputs(pipe, config):
    """(per_entry, static, key): the sample_composite arguments of one
    entry, split as the JAX CLI splits them (per-entry inputs; knobs that
    every entry of a batched group shares), and the group's signature, the
    JAX CLI's: the shapes and every static knob but target_fps (so a
    batched group runs at its first entry's fps, as in JAX)."""
    image_size = tuple(config.image_size)
    n_frames = config.n_frames

    main_1st = Image.open(config.edited_first_frame_path).convert("RGB")
    main_1st = main_1st.resize(image_size, resample=Image.Resampling.LANCZOS)
    main_frames = _load_frame_dir(config.edited_contorl_frame_path_main, n_frames, image_size)
    bg_frames = _load_frame_dir(config.edited_contorl_frame_path_background, n_frames, image_size)
    obj_frames = [
        _load_frame_dir(p, n_frames, image_size) for p in config.edited_contorl_frame_path
    ]

    masks_soft, masks_binary = load_entry_masks(
        config, image_size, n_frames, pipe.vae_scale_factor)

    per_entry = dict(
        prompt=config.editing_prompt,
        main_first_image=main_1st,
        main_image_list=main_frames,
        background_image_list=bg_frames,
        objs_image_list=obj_frames,
        masks_soft=masks_soft,
        masks_binary=masks_binary,
        bg_store=TrajectoryStore(config.bg_ddim_latents_path),
        obj_stores=[TrajectoryStore(p) for p in config.obj_ddim_latents_path],
        negative_prompt=config.editing_negative_prompt,
        ddim_inv_prompt=config.ddim_inv_prompt,
        seed=config.get("seed", 6),
    )
    static = dict(
        height=image_size[1],
        width=image_size[0],
        target_fps=config.target_fps,
        num_frames=n_frames,
        num_inference_steps=config.n_steps,
        guidance_scale=config.cfg,
        ddim_init_latents_t_idx=config.ddim_init_latents_t_idx,
        fusion_steps=tuple(config.fusion_step),
        obj_ddim_latents_idx_offset=list(config.obj_ddim_latents_idx_offset),
        obj_random_noise_fusion=config.get("obj_random_noise_fusion", False),
        random_noise_ratio=config.get("random_noise_ratio", 0.0),
        inject_background=config.get("inject_background", True),
        # reference quirk (default on): per-frame CLIP inputs are the
        # UNCROPPED frames resized (pipeline_i2vgen_xl.py:1505-1508)
        strict_reference_crop=config.get("strict_reference_crop", True),
        # training-free encoder reuse (not in the reference); 1 = exact
        encoder_reuse_interval=config.get("encoder_reuse_interval", 1),
        encoder_reuse_depth=config.get("encoder_reuse_depth", None),
        # PAB attention-output broadcast on the fused path (approximate;
        # 1 = off, exact)
        pab_interval=config.get("pab_interval", 1),
        # broadcast the captured PnP source features across steps on
        # two_pass / stream: cached steps skip the N+1 capture forwards
        # (approximate; 1 = off, exact)
        capture_reuse_interval=config.get("capture_reuse_interval", 1),
        # deep variant: cached steps also reuse the edit pair's encoder and
        # up-block attention outputs
        capture_reuse_deep=config.get("capture_reuse_deep", False),
        two_pass=config.get("two_pass", False),
        pnp_f_t=config.pnp_f_t,
        pnp_spatial_attn_t=config.pnp_spatial_attn_t,
        pnp_temp_attn_t=config.pnp_temp_attn_t,
        # per-frame VAE decode by default (reference: decode_chunk_size=1,
        # pipeline_i2vgen_xl.py:771-791); 0/None decodes the full batch
        decode_chunk_size=config.get("decode_chunk_size", 1) or None,
    )
    key = (image_size, n_frames, len(per_entry["obj_stores"])) + tuple(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in sorted(static.items())
        if k not in ("target_fps",))
    return per_entry, static, key


def export_dir(config) -> str:
    """The parameter-encoded output directory (reference: composite.py:195-213)."""
    suffix = (
        f"ddim_init_latents_t_idx_{config.ddim_init_latents_t_idx}"
        f"_nsteps_{config.n_steps}_cfg_{config.cfg}"
        f"_pnpf{config.pnp_f_t}_pnps{config.pnp_spatial_attn_t}"
        f"_pnpt{config.pnp_temp_attn_t}_ratio{config.get('random_noise_ratio', 0.0)}"
        f"noise_fusion_step{config.fusion_step[0]}-{config.fusion_step[1]}"
    )
    return os.path.join(config.output_dir, suffix)


def _export_video(pipe, video, config) -> None:
    if not common.is_writer(pipe):
        return
    image_size = tuple(config.image_size)
    out_dir = export_dir(config)
    os.makedirs(out_dir, exist_ok=True)
    pil = media.video_to_pil(video)
    pil = [f.resize(image_size, resample=Image.LANCZOS) for f in pil]
    media.export_to_video(pil, os.path.join(out_dir, "video.mp4"), fps=config.target_fps)
    media.export_to_gif(pil, os.path.join(out_dir, "video.gif"))
    for i, frame in enumerate(pil):
        frame.save(os.path.join(out_dir, f"video_{i:05d}.png"))
    logger.info("saved composite video to %s", out_dir)


def run_entry(pipe, config) -> None:
    if config.get("enable_vae_tiling", False):
        # reference parity memory knob (pipeline_i2vgen_xl.py:520-550)
        pipe.enable_vae_tiling()
    per_entry, static, _ = _entry_inputs(pipe, config)
    video = pipe.sample_composite(**per_entry, **static)
    _export_video(pipe, video, config)


def run_batched(pipe, configs) -> list:
    """Composite the entries that share a batching signature in one batched
    step loop (pipe.sample_composite_batch, the entries on the UNet batch
    axis; the reference loops entries one by one, composite.py:87), with
    the first entry's static knobs.  Groups of one are left to run_entry.
    Returns the configs handled."""
    groups: dict = {}
    for config in configs:
        per_entry, static, key = _entry_inputs(pipe, config)
        groups.setdefault(key, []).append((config, per_entry, static))

    done = []
    for group in groups.values():
        if len(group) < 2:
            continue  # nothing to batch: run_entry composites it
        if any(c.get("enable_vae_tiling", False) for c, _, _ in group):
            pipe.enable_vae_tiling()
        logger.info("batched composite of %d entries: %s", len(group),
                    [c.get("edited_video_name", c.video_name) for c, _, _ in group])
        videos = pipe.sample_composite_batch([pe for _, pe, _ in group], **group[0][2])
        for (config, _, _), video in zip(group, videos):
            _export_video(pipe, video, config)
            done.append(config)
    return done


def configure(template, entries) -> list:
    """The active entries merged over the template, with the reference's
    absolute-path resolution (composite.py:97-106) and the ReplaceMe check."""
    configs = []
    for entry in entries:
        if not entry.get("active", True):
            logger.info("skipping inactive entry %s", entry.get("video_name"))
            continue
        config = cfglib.merge(template, entry)
        config.video_path = os.path.join(config.video_dir, config.video_name + ".mp4")
        config.video_frames_path = os.path.join(config.video_dir, config.video_name)
        config.edited_first_frame_path = os.path.join(config.data_dir, config.edited_first_frame_path)
        config.obj_mask_path = [os.path.join(config.data_dir, p) for p in config.obj_mask_path]
        config.obj_ddim_latents_path = [
            os.path.join(config.data_dir, p) for p in config.obj_ddim_latents_path
        ]
        config.bg_ddim_latents_path = os.path.join(config.data_dir, config.bg_ddim_latents_path)
        config.edited_contorl_frame_path_main = os.path.join(
            config.data_dir, config.edited_contorl_frame_path_main)
        config.edited_contorl_frame_path_background = os.path.join(
            config.data_dir, config.edited_contorl_frame_path_background)
        config.edited_contorl_frame_path = [
            os.path.join(config.data_dir, p) for p in config.edited_contorl_frame_path
        ]
        common.check_replaceme(config)
        configs.append(config)
    return configs


def run(pipe, configs, profile_dir=None, timer: StepTimer | None = None,
        batch: bool = False) -> StepTimer:
    """Composite every configured entry on `pipe`, one stage of `timer` per
    entry; with `batch`, the entries that share a batching signature go
    through one batched step loop instead (stage "composite/batched").
    Returns the timer."""
    timer = timer or StepTimer()
    handled = []
    with trace(profile_dir):
        if batch and len(configs) > 1:
            with timer.stage("composite/batched"):
                handled = run_batched(pipe, configs)
        for config in configs:
            if any(config is c for c in handled):
                common.save_config(pipe, config)
                continue
            name = config.get("edited_video_name", config.video_name)
            logger.info("processing %s", name)
            with timer.stage(f"composite/{name}"):
                run_entry(pipe, config)
            common.save_config(pipe, config)
    logger.info("timings: %s", timer.summary())
    return timer


def main(argv=None) -> None:
    args = common.parse_args("configs/group_composite/template.yaml", argv)
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
        batch=args.batch or template.get("batch_composites", False))


if __name__ == "__main__":
    main()
