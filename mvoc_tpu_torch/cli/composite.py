"""Entry point B: group multi-object composition CLI (the port's own
copy of mvoc_tpu/cli/composite.py).

Usage (the reference's surface, reference: composite.py:227-255):

  python -m mvoc_tpu_torch.cli.composite \
      --template_config configs/group_composite/template.yaml \
      --configs_json <group_config.json> [--checkpoint <dir>|tiny]

Per active entry: resolve the paths, load the edited first frame, the
per-branch control frames, the masks and the inversion trajectories, run the
PnP composite sampler, and export mp4 / gif / frames into a
parameter-encoded directory (reference: composite.py:72-224).  `configure`
(merge, paths, ReplaceMe check) and `run` (the work, on a given pipeline)
are the two halves of `main`.
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
from mvoc_tpu_torch.utils.profiling import StepTimer, save_run_config, trace

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
    """(per_entry, static): the sample_composite arguments of one entry,
    split as the JAX CLI splits them (per-entry inputs; knobs that shape
    the program)."""
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
        # the JAX package's reuse / broadcast extensions: only their exact
        # defaults run here (the pipeline refuses any other value)
        encoder_reuse_interval=config.get("encoder_reuse_interval", 1),
        encoder_reuse_depth=config.get("encoder_reuse_depth", None),
        pab_interval=config.get("pab_interval", 1),
        capture_reuse_interval=config.get("capture_reuse_interval", 1),
        capture_reuse_deep=config.get("capture_reuse_deep", False),
        two_pass=config.get("two_pass", False),
        pnp_f_t=config.pnp_f_t,
        pnp_spatial_attn_t=config.pnp_spatial_attn_t,
        pnp_temp_attn_t=config.pnp_temp_attn_t,
        # per-frame VAE decode by default (reference: decode_chunk_size=1,
        # pipeline_i2vgen_xl.py:771-791); 0/None decodes the full batch
        decode_chunk_size=config.get("decode_chunk_size", 1) or None,
    )
    return per_entry, static


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


def _export_video(video, config) -> None:
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
    per_entry, static = _entry_inputs(pipe, config)
    video = pipe.sample_composite(**per_entry, **static)
    _export_video(video, config)


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


def run(pipe, configs, profile_dir=None, timer: StepTimer | None = None) -> StepTimer:
    """Composite every configured entry on `pipe`, one stage of `timer` per
    entry.  Returns the timer."""
    timer = timer or StepTimer()
    with trace(profile_dir):
        for config in configs:
            name = config.get("edited_video_name", config.video_name)
            logger.info("processing %s", name)
            with timer.stage(f"composite/{name}"):
                run_entry(pipe, config)
            save_run_config(config, config.output_dir)
    logger.info("timings: %s", timer.summary())
    return timer


def main(argv=None) -> None:
    args = common.parse_args("configs/group_composite/template.yaml", argv)
    template, entries = common.load_configs(args)
    common.setup_logging(template)
    common.check_unported_options(args, template, "batch_composites")
    pipe = common.build_pipeline(args, template)
    pipe = common.apply_unet_options(pipe, template)
    pipe = common.apply_mesh(pipe, args, template)
    pipe = common.apply_quantize(pipe, template)
    run(pipe, configure(template, entries), args.profile_dir)


if __name__ == "__main__":
    main()
