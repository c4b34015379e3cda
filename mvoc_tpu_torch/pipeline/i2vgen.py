"""I2VGen-XL pipeline in PyTorch: host orchestration over the step loops
(counterpart of mvoc_tpu/pipeline/i2vgen.py, cut to the slice
invert -> sample_composite).

The modules hold their own weights.  Every random draw of an entry point
comes from one explicit `torch.Generator` seeded from `seed`, on the
pipeline's device.  The pipeline runs on CUDA unless `device="cpu"` is
passed; it raises when CUDA is asked for and absent.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from mvoc_tpu_torch import pnp as pnp_lib
from mvoc_tpu_torch.io import media
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModelWithProjection, normalize_clip_image
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet
from mvoc_tpu_torch.models.vae import AutoencoderKL, sample_latents
from mvoc_tpu_torch.ops.ddim import DDIM, SchedulerConfig, inversion_timesteps, sampling_timesteps
from mvoc_tpu_torch.pipeline import core
from mvoc_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class I2VGenXLPipeline:
    """The model modules plus the reference's pipeline entry points (batch
    size 1, like the reference's usage)."""

    def __init__(self, unet: I2VGenXLUNet, vae: AutoencoderKL, text_encoder: CLIPTextModel,
                 image_encoder: CLIPVisionModelWithProjection, scheduler_config: SchedulerConfig,
                 tokenizer=None, dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.unet = unet.to(self.device, dtype).eval()
        self.vae = vae.to(self.device, dtype).eval()
        self.text_encoder = text_encoder.to(self.device, dtype).eval()
        self.image_encoder = image_encoder.to(self.device, dtype).eval()
        self.scheduler_config = scheduler_config
        self.ddim = DDIM(scheduler_config)
        self.tokenizer = tokenizer
        self.vae_scale_factor = vae.config.downscale_factor
        self.vae_scaling = vae.config.scaling_factor
        self.clip_image_size = image_encoder.config.image_size

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g

    # -- encoders ------------------------------------------------------------

    def tokenize(self, prompts: Sequence[str]) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError("pipeline has no tokenizer; pass prompt_embeds")
        out = self.tokenizer(list(prompts), padding="max_length",
                             max_length=self.tokenizer.model_max_length, truncation=True,
                             return_tensors="np")
        return out["input_ids"]

    @torch.inference_mode()
    def encode_prompt(self, prompt, negative_prompt=None, do_cfg: bool = True,
                      clip_skip: int = 1, prompt_embeds: Optional[torch.Tensor] = None,
                      negative_prompt_embeds: Optional[torch.Tensor] = None):
        """(prompt_embeds, negative_prompt_embeds) [B, 77, D]; clip_skip=1
        (the penultimate layer) is the reference default."""
        if prompt_embeds is None:
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            ids = torch.as_tensor(self.tokenize(prompts), dtype=torch.long, device=self.device)
            prompt_embeds = self.text_encoder(ids, clip_skip=clip_skip)
        if do_cfg and negative_prompt_embeds is None:
            neg = negative_prompt or ""
            negs = [neg] if isinstance(neg, str) else list(neg)
            ids = torch.as_tensor(self.tokenize(negs), dtype=torch.long, device=self.device)
            negative_prompt_embeds = self.text_encoder(ids, clip_skip=clip_skip)
        return prompt_embeds, negative_prompt_embeds

    def _clip_pixels(self, images: Sequence[Image.Image]) -> torch.Tensor:
        px = torch.as_tensor(media.pil_to_01(images), device=self.device).to(self.dtype)
        return normalize_clip_image(px)

    @torch.inference_mode()
    def encode_image(self, image: Image.Image, width: int) -> torch.Tensor:
        """CLIP embedding of one frame: square centre crop, bilinear to the
        CLIP size -> [1, D_img]."""
        cropped = media.center_crop_wide(image, (width, width))
        resized = media.resize_bilinear(cropped, (self.clip_image_size, self.clip_image_size))
        return self.image_encoder(self._clip_pixels([resized]))

    @torch.inference_mode()
    def encode_frames(self, frames: Sequence[Image.Image], width: int,
                      strict_reference_crop: bool = True) -> torch.Tensor:
        """Per-frame CLIP embeddings [F, D_img].  strict_reference_crop
        reproduces the reference's quirk: the centre crop is computed and
        discarded, the UNCROPPED frame is resized."""
        size = (self.clip_image_size, self.clip_image_size)
        if strict_reference_crop:
            crops = [media.resize_bilinear(f, size) for f in frames]
        else:
            crops = [media.resize_bilinear(media.center_crop_wide(f, (width, width)), size)
                     for f in frames]
        return self.image_encoder(self._clip_pixels(crops))

    # -- VAE -------------------------------------------------------------------

    @torch.inference_mode()
    def encode_vae_video(self, frames: Sequence[Image.Image], height: int, width: int,
                         generator: torch.Generator) -> torch.Tensor:
        """[F, h, w, C] scaled latents, sampled with noise from `generator`."""
        resized = [media.center_crop_wide(f, (width, height)) for f in frames]
        px = torch.as_tensor(media.pil_to_neg1_1(resized), device=self.device).to(self.dtype)
        mean, logvar = self.vae.encode(px)
        noise = torch.randn(mean.shape, generator=generator, device=self.device,
                            dtype=torch.float32)
        return sample_latents(mean, logvar, noise) * self.vae_scaling

    def encode_first_frame_latents(self, image: Image.Image, height: int, width: int,
                                   num_frames: int, generator: torch.Generator) -> torch.Tensor:
        """[F, h, w, C]: frame 0 the latent, frames 1.. the position ramp."""
        z = self.encode_vae_video([image], height, width, generator=generator)[0]
        return core.prepare_image_latents(z, num_frames)

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor, decode_chunk_size: Optional[int] = 1
                       ) -> np.ndarray:
        """[F, h, w, C] scaled latents -> video [F, H, W, 3] in [0, 1]."""
        z = latents.to(self.device) / self.vae_scaling
        step = decode_chunk_size or z.shape[0]
        img = torch.cat([self.vae.decode(z[i:i + step]) for i in range(0, z.shape[0], step)])
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0).cpu().numpy()

    def prepare_latents(self, num_frames: int, height: int, width: int,
                        generator: torch.Generator) -> torch.Tensor:
        shape = (num_frames, height // self.vae_scale_factor, width // self.vae_scale_factor,
                 self.unet.config.in_channels)
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=torch.float32) * self.ddim.init_noise_sigma

    def _stack_cond(self, text_embeds, first_image_latents, image_latents, image_embeddings,
                    fps: int) -> core.UNetConditioning:
        b = text_embeds.shape[0]
        return core.UNetConditioning(
            encoder_hidden_states=text_embeds.to(self.dtype),
            image_latents_first=first_image_latents.to(self.dtype),
            image_latents=image_latents.to(self.dtype),
            image_embeddings=image_embeddings.to(self.dtype),
            fps=torch.full((b,), fps, dtype=torch.long, device=self.device))

    def check_inputs(self, height: int, width: int, num_frames: int, prompt=None,
                     prompt_embeds=None, negative_prompt=None, negative_prompt_embeds=None):
        f = self.vae_scale_factor
        if height % f != 0 or width % f != 0:
            raise ValueError(f"height/width must be divisible by {f}, got {height}x{width}")
        if num_frames < 2:
            raise ValueError("num_frames must be >= 2 (temporal model)")
        if prompt is not None and not isinstance(prompt, (str, list, tuple)):
            raise ValueError(f"prompt must be str or list, got {type(prompt)}")
        if prompt_embeds is not None and prompt not in (None, ""):
            raise ValueError("cannot forward both `prompt` and `prompt_embeds`")
        if negative_prompt_embeds is not None and negative_prompt not in (None, ""):
            raise ValueError("cannot forward both `negative_prompt` and `negative_prompt_embeds`")
        if (prompt_embeds is not None and negative_prompt_embeds is not None
                and prompt_embeds.shape != negative_prompt_embeds.shape):
            raise ValueError(f"`prompt_embeds` {tuple(prompt_embeds.shape)} and "
                             f"`negative_prompt_embeds` {tuple(negative_prompt_embeds.shape)} "
                             "must have the same shape")

    # -- entry point A: DDIM inversion ------------------------------------------

    def invert(self, frames: Sequence[Image.Image], first_frame: Optional[Image.Image] = None,
               prompt: str = "", negative_prompt: str = "", height: int = 720, width: int = 1280,
               target_fps: int = 8, num_frames: int = 16, num_inference_steps: int = 500,
               guidance_scale: float = 1.0, clip_skip: int = 1, seed: int = 8888,
               output_dir: Optional[str] = None, prompt_embeds=None,
               negative_prompt_embeds=None) -> tuple[np.ndarray, np.ndarray]:
        """DDIM-invert a video.  Returns (timesteps ascending, trajectory
        [S, F, h, w, C]) and writes the trajectory store when output_dir."""
        self.check_inputs(height, width, num_frames, prompt=prompt, prompt_embeds=prompt_embeds,
                          negative_prompt=negative_prompt,
                          negative_prompt_embeds=negative_prompt_embeds)
        gen = self._generator(seed)
        first_frame = first_frame or frames[0]
        do_cfg = guidance_scale > 1.0
        latents = self.encode_vae_video(frames, height, width, generator=gen)
        pe, ne = self.encode_prompt(prompt, negative_prompt, do_cfg=do_cfg, clip_skip=clip_skip,
                                    prompt_embeds=prompt_embeds,
                                    negative_prompt_embeds=negative_prompt_embeds)
        text = torch.cat([ne, pe]) if do_cfg else pe
        img_emb = self.encode_image(first_frame, width)
        img_emb = img_emb[:, None].expand(1, num_frames, img_emb.shape[-1])
        if do_cfg:
            img_emb = torch.cat([torch.zeros_like(img_emb), img_emb])
        img_lat = self.encode_first_frame_latents(first_frame, height, width, num_frames,
                                                  generator=gen)
        img_lat = img_lat[None].expand((2 if do_cfg else 1,) + tuple(img_lat.shape))
        cond = self._stack_cond(text, img_lat, img_lat, img_emb, target_fps)
        ts = inversion_timesteps(self.scheduler_config, num_inference_steps)
        traj = core.ddim_inversion_core(self.unet, self.ddim, latents.float(),
                                        cond, ts, num_inference_steps, float(guidance_scale))
        trajectory = traj.float().cpu().numpy()
        if output_dir is not None:
            meta = dict(n_steps=num_inference_steps, guidance_scale=guidance_scale,
                        num_frames=num_frames, height=height, width=width, prompt=prompt,
                        seed=seed, target_fps=target_fps)
            TrajectoryStore(output_dir).save(ts, trajectory, meta=meta)
            logger.info("saved trajectory (%d steps) to %s", len(ts), output_dir)
        return ts, trajectory

    # -- entry point B: PnP composite sampling ----------------------------------

    def _injection_resolutions(self, h_lat: int, w_lat: int) -> list[tuple[int, int]]:
        """Spatial sizes of the injection sites: up_blocks[b] of an L-level
        UNet runs at the latent size ceil-halved L-1-b times; out_conv at
        the full latent size."""
        cfg = self.unet.config
        n_levels = len(cfg.block_out_channels)

        def block_res(b: int) -> tuple[int, int]:
            h, w = h_lat, w_lat
            for _ in range(n_levels - 1 - b):
                h, w = (h + 1) // 2, (w + 1) // 2
            return (h, w)

        res = {block_res(b) for b in cfg.sites.block_indices()}
        if cfg.sites.out_conv:
            res.add((h_lat, w_lat))
        return sorted(res, reverse=True)

    def _prepare_composite(
        self, prompt: str, main_first_image: Image.Image,
        main_image_list: Sequence[Image.Image], background_image_list: Sequence[Image.Image],
        objs_image_list: Sequence[Sequence[Image.Image]], masks_soft: np.ndarray,
        masks_binary: np.ndarray, bg_store: TrajectoryStore,
        obj_stores: Sequence[TrajectoryStore], height: int = 720, width: int = 1280,
        target_fps: int = 8, num_frames: int = 16, num_inference_steps: int = 50,
        guidance_scale: float = 9.0, negative_prompt: str = "", ddim_inv_prompt: str = "",
        clip_skip: int = 1, ddim_init_latents_t_idx: int = 1,
        fusion_steps: tuple[int, int] = (0, 3),
        obj_ddim_latents_idx_offset: Optional[Sequence[int]] = None,
        inject_background: bool = True, strict_reference_crop: bool = True,
        two_pass=False, pnp_f_t: float = 0.8, pnp_spatial_attn_t: float = 0.8,
        pnp_temp_attn_t: float = 0.8, seed: int = 6, prompt_embeds=None,
        negative_prompt_embeds=None, ddim_inv_prompt_embeds=None):
        """Host-side preparation of sample_composite.  Returns (init_latents,
        cond, sched, masks_soft, pyr_bin, pyr_soft, capture_weights)."""
        self.check_inputs(height, width, num_frames, prompt=prompt, prompt_embeds=prompt_embeds,
                          negative_prompt=negative_prompt,
                          negative_prompt_embeds=negative_prompt_embeds)
        n_obj = len(obj_stores)
        if masks_soft.shape[0] != n_obj or masks_binary.shape[0] != n_obj:
            raise ValueError("obj_mask / obj_ddim_latents count mismatch")
        gen = self._generator(seed)
        init_latents = self.prepare_latents(num_frames, height, width, gen)

        # text: [inversion prompt x (N+1), negative, editing prompt]
        pe, ne = self.encode_prompt(prompt, negative_prompt, do_cfg=True, clip_skip=clip_skip,
                                    prompt_embeds=prompt_embeds,
                                    negative_prompt_embeds=negative_prompt_embeds)
        if ddim_inv_prompt_embeds is None:
            ddim_inv_prompt_embeds, _ = self.encode_prompt(ddim_inv_prompt, do_cfg=False,
                                                           clip_skip=clip_skip)
        inv_text = ddim_inv_prompt_embeds.expand((n_obj + 1,) + tuple(ddim_inv_prompt_embeds.shape[1:]))
        text = torch.cat([inv_text, ne, pe])

        # first-frame latents per branch; the context image latents are the
        # same images with the same draws, so they alias these
        def first_lat(img):
            return self.encode_first_frame_latents(img, height, width, num_frames, generator=gen)

        bg_fl = first_lat(background_image_list[0])
        obj_fls = [first_lat(o[0]) for o in objs_image_list]
        main_fl = first_lat(main_first_image)
        first_lats = torch.stack([bg_fl, *obj_fls, main_fl, main_fl])

        sc = strict_reference_crop
        bg_emb = self.encode_frames(background_image_list, width, strict_reference_crop=sc)
        obj_embs = [self.encode_frames(o, width, strict_reference_crop=sc) for o in objs_image_list]
        main_emb = self.encode_frames(main_image_list, width, strict_reference_crop=sc)
        img_embs = torch.stack([bg_emb, *obj_embs, torch.zeros_like(main_emb), main_emb])
        cond = self._stack_cond(text, first_lats, first_lats, img_embs, target_fps)

        full_ts = sampling_timesteps(self.scheduler_config, num_inference_steps)
        run_ts = full_ts[ddim_init_latents_t_idx:]
        gates = pnp_lib.injection_gates(full_ts, run_ts, num_inference_steps, pnp_f_t,
                                        pnp_spatial_attn_t, pnp_temp_attn_t)
        offsets = list(obj_ddim_latents_idx_offset or [0] * n_obj)
        bg_traj = bg_store.gather(run_ts)
        obj_traj = np.stack([s.gather(run_ts) for s in obj_stores], axis=1)
        obj_fusion_lat = np.stack([
            obj_stores[j].load_at_t(int(full_ts[offsets[j]:][fusion_steps[0]]))
            for j in range(n_obj)])
        fusion_mask = np.array([fusion_steps[0] <= i < fusion_steps[1]
                                for i in range(len(run_ts))], dtype=bool)

        h_lat, w_lat = masks_soft.shape[2], masks_soft.shape[3]
        resolutions = self._injection_resolutions(h_lat, w_lat)
        dev = self.device
        pyr_bin = {k: torch.as_tensor(v, device=dev)
                   for k, v in pnp_lib.build_mask_pyramid(masks_binary, resolutions).items()}
        pyr_soft = {k: torch.as_tensor(v, device=dev)
                    for k, v in pnp_lib.build_mask_pyramid(masks_soft, resolutions).items()}
        sched = core.CompositeSchedule(
            bg_traj=torch.as_tensor(bg_traj, dtype=torch.float32, device=dev),
            obj_traj=torch.as_tensor(obj_traj, dtype=torch.float32, device=dev),
            obj_fusion_lat=torch.as_tensor(obj_fusion_lat, dtype=torch.float32, device=dev),
            gate_spatial=gates["spatial"], gate_temporal=gates["temporal"],
            gate_conv=gates["conv"], fusion_mask=fusion_mask, timesteps=np.asarray(run_ts))
        capture_weights = (pnp_lib.build_capture_weights(pyr_bin, pyr_soft, inject_background)
                           if two_pass == "stream" else None)
        return (init_latents, cond, sched,
                torch.as_tensor(masks_soft, dtype=torch.float32, device=dev),
                pyr_bin, pyr_soft, capture_weights)

    def sample_composite(self, *args, decode: bool = True, decode_chunk_size: Optional[int] = 1,
                         random_noise_ratio: float = 0.0, obj_random_noise_fusion: bool = False,
                         step_callback=None, **kwargs):
        """The MVOC composite sampler.  Same argument surface as
        _prepare_composite; two_pass is False (fused) or "stream"."""
        (init_latents, cond, sched, masks_soft, pyr_bin, pyr_soft,
         capture_weights) = self._prepare_composite(*args, **kwargs)
        final = core.pnp_composite_core(
            self.unet, self.ddim, init_latents, cond, sched, masks_soft, pyr_bin, pyr_soft,
            num_inference_steps=kwargs.get("num_inference_steps", 50),
            guidance_scale=float(kwargs.get("guidance_scale", 9.0)),
            random_noise_ratio=float(random_noise_ratio),
            obj_random_noise_fusion=obj_random_noise_fusion,
            inject_background=kwargs.get("inject_background", True),
            two_pass=kwargs.get("two_pass", False), capture_weights=capture_weights,
            step_callback=step_callback)
        if not decode:
            return final
        return self.decode_latents(final, decode_chunk_size=decode_chunk_size)
