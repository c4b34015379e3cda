"""I2VGen-XL pipeline in PyTorch: host orchestration over the step loops
(counterpart of mvoc_tpu/pipeline/i2vgen.py, cut to the slices ported so
far: from_pretrained, invert and invert_batch, sample (the reconstruction
path), generate_background, sample_composite and sample_composite_batch,
the int8 mode (enable_int8), the tiled VAE decode (enable_vae_tiling) and
the device mesh (enable_mesh)).

Every extension keyword of the JAX package runs here at every value it
accepts: the reuse and broadcast modes (encoder_reuse_interval and
encoder_reuse_depth, deep_reuse, pab_interval, capture_reuse_interval and
capture_reuse_deep; approximate, each 1 / None / False = exact) and FreeU
(enable_freeu / disable_freeu, on every path).

The modules hold their own weights.  Every random draw of an entry point
comes from one explicit `torch.Generator` seeded from `seed`, on the
pipeline's device.  The pipeline runs on CUDA unless `device="cpu"` is
passed; it raises when CUDA is asked for and absent.

On a mesh (enable_mesh: one process per rank, parallel/mesh.py) every rank
calls the same entry point with the same arguments and returns the same
full result: the UNet runs each rank on its frames and its tensor-parallel
share, the VAE encode and decode split the frames over "seq", the batch
entry points split their J entries over "job", and every draw is the full
tensor from the entry point's generator, each rank taking its slice.

Spans (utils.profiling.span, recorded only while a torch profiler records):
each call of invert, invert_batch, sample_composite and
sample_composite_batch runs inside `entry/<entry point>`; inside it the
text encode (`entry/encode_prompt`), the CLIP image encodes
(`entry/encode_image`), the VAE encode (`entry/encode_vae`), the source
trajectories' upload to the device (`entry/trajectory_upload`), the mask
pyramids and capture weights (`entry/mask_pyramids`) and the VAE decode
(`entry/decode`), beside the step loop's `step` spans (pipeline/core.py).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from mvoc_tpu_torch import pnp as pnp_lib
from mvoc_tpu_torch.io import media
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModelWithProjection, normalize_clip_image
from mvoc_tpu_torch.models.unet_i2vgen import FreeUConfig, I2VGenXLUNet
from mvoc_tpu_torch.models.vae import AutoencoderKL, sample_latents, tiled_decode
from mvoc_tpu_torch.ops import quantize
from mvoc_tpu_torch.ops.ddim import DDIM, SchedulerConfig, inversion_timesteps, sampling_timesteps
from mvoc_tpu_torch.parallel import mesh as pm
from mvoc_tpu_torch.pipeline import core
from mvoc_tpu_torch.utils.device import resolve_device
from mvoc_tpu_torch.utils.profiling import span, spanned

logger = logging.getLogger(__name__)

def _composite_core_kwargs(kwargs: dict, random_noise_ratio: float,
                           obj_random_noise_fusion: bool, step_callback) -> dict:
    """The composite loop's static knobs, from the entry point's keywords."""
    return dict(num_inference_steps=kwargs.get("num_inference_steps", 50),
                guidance_scale=float(kwargs.get("guidance_scale", 9.0)),
                random_noise_ratio=float(random_noise_ratio),
                obj_random_noise_fusion=obj_random_noise_fusion,
                inject_background=kwargs.get("inject_background", True),
                two_pass=kwargs.get("two_pass", False),
                encoder_reuse_interval=int(kwargs.get("encoder_reuse_interval", 1)),
                pab_interval=int(kwargs.get("pab_interval", 1)),
                capture_reuse_interval=int(kwargs.get("capture_reuse_interval", 1)),
                capture_reuse_deep=bool(kwargs.get("capture_reuse_deep", False)),
                step_callback=step_callback)


def _take_entries(tree, j: slice):
    """Entries j of every leaf (leading axis J) of _prepare_composite_batch's
    output: tensors and arrays, in tuples, dicts and dataclasses."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_take_entries(t, j) for t in tree)
    if isinstance(tree, dict):
        return {k: _take_entries(v, j) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(_take_entries(getattr(tree, f.name), j)
                            for f in dataclasses.fields(tree)))
    return tree[j]


class I2VGenXLPipeline:
    """The model modules plus the reference's pipeline entry points: one
    video or composite a call, like the reference's usage, or J of them in
    one step loop (invert_batch, sample_composite_batch)."""

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
        self.vae_tiling: Optional[tuple[int, int]] = None  # set by enable_vae_tiling
        self.freeu: Optional[FreeUConfig] = None  # set by enable_freeu
        self.mesh: Optional[pm.Mesh] = None  # set by enable_mesh

    @staticmethod
    def from_pretrained(checkpoint_dir: str, dtype: torch.dtype = torch.bfloat16,
                        device=None) -> "I2VGenXLPipeline":
        """Build from a diffusers I2VGen-XL checkpoint directory (the layout
        the reference loads), in `dtype` on `device` (CUDA unless asked
        otherwise): models/convert.py: load_pipeline."""
        from mvoc_tpu_torch.models import convert

        return convert.load_pipeline(checkpoint_dir, dtype=dtype, device=device)

    def enable_int8(self, predicate=None, mode: str = "full") -> "I2VGenXLPipeline":
        """Quantize the UNet's dense and conv weights to int8 (w8a8), in place.

        mode="mixed" takes `ops.quantize.mixed_unet_predicate` (dense layers
        with K >= 1280 and (3,1,1) temporal convs with C_in >= 1280, chosen
        by shape), mode="full" `default_unet_predicate` (everything but the
        time / fps embeddings, conv_in / conv_out and the image-latents
        projections and temporal encoder); `predicate(names)` or
        `predicate(names, leaf)` overrides the selection.  An approximate
        mode: the int8 GEMMs run on K3.  The VAE and CLIP towers keep their
        dtype.  Runs once, before the step loops; quantizing an
        already-quantized layer is a no-op (it is no longer a float layer).
        Call it before enable_mesh, whose tensor parallelism splits the int8
        layers as it splits the float ones; after a mesh of more than one
        rank it raises, as in the JAX package."""
        if self.mesh is not None and self.mesh.size > 1:
            raise NotImplementedError(
                "call enable_int8 BEFORE enable_mesh: parallel.mesh.shard_params splits "
                "QuantLinear layers with their tensor-parallel shares, but re-quantizing "
                "already-sharded params is not supported")
        if mode not in ("full", "mixed"):
            raise ValueError(f"enable_int8 mode {mode!r}: 'full' or 'mixed'")
        pred = predicate if predicate is not None else (
            quantize.mixed_unet_predicate if mode == "mixed" else quantize.default_unet_predicate)
        n = len(quantize.quantize_unet_(self.unet, pred))
        logger.info("UNet quantized to int8 (w8a8, %s selection): %d layers", mode, n)
        return self

    def enable_mesh(self, n_devices: Optional[int] = None, seq: Optional[int] = None,
                    job: int = 1) -> "I2VGenXLPipeline":
        """Run the pipeline over a (job, seq, model) mesh of n_devices ranks
        (the world size by default; one process per rank, every rank making
        the same calls).  Under a launcher (torchrun) the default process
        group is initialised here: NCCL on CUDA, gloo on the CPU; a process
        group already initialised keeps its backend.  The UNet's attention, MLP
        and timestep layers are split over "model" (parallel/mesh.
        shard_params) and its forward runs each rank on its frames of
        "seq".  One rank is the no-op 1x1x1 mesh.  Ranks outside a mesh
        smaller than the world get `mesh.member` False and must not call
        the entry points."""
        if self.mesh is not None:
            self.disable_mesh()
        if pm.launched():
            pm.init_distributed(self.device)
        mesh = pm.make_mesh(n_devices, seq=seq, job=job, device=self.device)
        self.mesh = mesh
        if mesh.size > 1 and mesh.member:
            split = pm.shard_params(self.unet, mesh)
            self.unet.set_parallel(mesh, self.unet.config.temporal_cp)
            logger.info("mesh enabled: %s, %d tensor-parallel units", mesh, len(split))
        return self

    def disable_mesh(self) -> "I2VGenXLPipeline":
        """Back to one device: the split layers gathered whole again."""
        mesh, self.mesh = self.mesh, None
        if mesh is not None and mesh.size > 1 and mesh.member:
            pm.unshard_params(self.unet, mesh)
            self.unet.set_parallel(None, self.unet.config.temporal_cp)
        return self

    def _seq_mesh(self, frames: int) -> Optional[pm.Mesh]:
        """The mesh when `frames` split over its "seq" axis, else None."""
        m = self.mesh
        if m is None or m.size == 1 or m.size_of(pm.SEQ_AXIS) == 1:
            return None
        return m if frames % m.size_of(pm.SEQ_AXIS) == 0 else None

    def _sync(self) -> None:
        """All ranks of the mesh meet here (rank 0 wrote what they read next)."""
        if self.mesh is not None and self.mesh.size > 1:
            from mvoc_tpu_torch.parallel import collectives as coll

            coll.barrier(self.mesh)

    def _job_gather(self, x: torch.Tensor, j: int, dim: int) -> torch.Tensor:
        """The J entries back from this job slice's share along dim."""
        if x.shape[dim] == j:
            return x
        from mvoc_tpu_torch.parallel import collectives as coll

        return coll.all_gather(x, self.mesh, pm.JOB_AXIS, dim)

    def enable_freeu(self, s1: float, s2: float, b1: float, b2: float) -> None:
        """FreeU up-block re-weighting on every UNet call of every entry point
        (the reference's passthrough, pipeline_i2vgen_xl.py:950-976)."""
        self.freeu = FreeUConfig(s1=s1, s2=s2, b1=b1, b2=b2)

    def disable_freeu(self) -> None:
        self.freeu = None

    def _unet_apply(self, encoder_reuse_depth: Optional[int] = None):
        """The UNet as the step loops call it: FreeU bound when enabled, and
        the partial-depth encoder reuse when a depth is given (it acts only on
        the cache paths)."""
        kw = {}
        if self.freeu is not None:
            kw["freeu"] = self.freeu
        if encoder_reuse_depth:
            kw["encoder_reuse_depth"] = int(encoder_reuse_depth)
        return functools.partial(self.unet, **kw) if kw else self.unet

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
    @spanned("entry/encode_prompt")
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
    @spanned("entry/encode_image")
    def encode_image(self, image: Image.Image, width: int) -> torch.Tensor:
        """CLIP embedding of one frame: square centre crop, bilinear to the
        CLIP size -> [1, D_img]."""
        cropped = media.center_crop_wide(image, (width, width))
        resized = media.resize_bilinear(cropped, (self.clip_image_size, self.clip_image_size))
        return self.image_encoder(self._clip_pixels([resized]))

    @torch.inference_mode()
    @spanned("entry/encode_image")
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
    @spanned("entry/encode_vae")
    def encode_vae_video(self, frames: Sequence[Image.Image], height: int, width: int,
                         generator: torch.Generator) -> torch.Tensor:
        """[F, h, w, C] scaled latents, sampled with noise from `generator`."""
        resized = [media.center_crop_wide(f, (width, height)) for f in frames]
        px = torch.as_tensor(media.pil_to_neg1_1(resized), device=self.device).to(self.dtype)
        mesh = self._seq_mesh(px.shape[0])
        if mesh is not None:  # frame-parallel: this rank's frames, then all-gathered
            px = pm.shard_video(px, mesh, frame_axis=0)
        mean, logvar = self.vae.encode(px)
        shape = (len(frames),) + tuple(mean.shape[1:])
        noise = torch.randn(shape, generator=generator, device=self.device, dtype=torch.float32)
        if mesh is not None:
            noise = pm.shard_video(noise, mesh, frame_axis=0)
        z = sample_latents(mean, logvar, noise) * self.vae_scaling
        return z if mesh is None else pm.gather_video(z, mesh, len(frames), frame_axis=0)

    def encode_first_frame_latents(self, image: Image.Image, height: int, width: int,
                                   num_frames: int, generator: torch.Generator) -> torch.Tensor:
        """[F, h, w, C]: frame 0 the latent, frames 1.. the position ramp."""
        z = self.encode_vae_video([image], height, width, generator=generator)[0]
        return core.prepare_image_latents(z, num_frames)

    @torch.inference_mode()
    @spanned("entry/decode")
    def decode_latents(self, latents: torch.Tensor, decode_chunk_size: Optional[int] = 1
                       ) -> np.ndarray:
        """[F, h, w, C] scaled latents -> video [F, H, W, 3] in [0, 1].

        decode_chunk_size bounds the frames per VAE call (the reference
        decodes one at a time); enable_vae_tiling also bounds the spatial
        footprint of each call (tiled_decode inside each chunk)."""
        z = latents.to(self.device) / self.vae_scaling
        frames = z.shape[0]
        mesh = self._seq_mesh(frames)
        if mesh is not None:  # frame-parallel: this rank's frames, then all-gathered
            z = pm.shard_video(z, mesh, frame_axis=0)
        step = decode_chunk_size or z.shape[0]

        def dec(zz):
            if self.vae_tiling is None:
                return self.vae.decode(zz)
            return tiled_decode(self.vae.decode, zz, *self.vae_tiling)

        img = torch.cat([dec(z[i:i + step]) for i in range(0, z.shape[0], step)])
        if mesh is not None:
            img = pm.gather_video(img, mesh, frames, frame_axis=0)
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0).cpu().numpy()

    def enable_vae_tiling(self, tile_latent: int = 64, overlap_latent: int = 8) -> None:
        """Route decode through spatially tiled decoding with seam blending
        (reference parity: enable_vae_tiling, pipeline_i2vgen_xl.py:520-550)."""
        self.vae_tiling = (tile_latent, overlap_latent)

    def disable_vae_tiling(self) -> None:
        self.vae_tiling = None

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

    @spanned("entry/invert")
    def invert(self, frames: Sequence[Image.Image], first_frame: Optional[Image.Image] = None,
               prompt: str = "", negative_prompt: str = "", height: int = 720, width: int = 1280,
               target_fps: int = 8, num_frames: int = 16, num_inference_steps: int = 500,
               guidance_scale: float = 1.0, clip_skip: int = 1, seed: int = 8888,
               output_dir: Optional[str] = None, prompt_embeds=None,
               negative_prompt_embeds=None, latents=None, encoder_reuse_interval: int = 1,
               encoder_reuse_depth: Optional[int] = None, deep_reuse: bool = False,
               step_callback=None) -> tuple[np.ndarray, np.ndarray]:
        """DDIM-invert a video.  Returns (timesteps ascending, trajectory
        [S, F, h, w, C]) and writes the trajectory store when output_dir.
        `latents` ([F, h, w, C] scaled) skip the VAE encode (its draws are
        still taken, so the first frame's latents stay those of the same
        seed).  encoder_reuse_interval > 1 runs encoder reuse;
        encoder_reuse_depth = k caches only down blocks k.. and the mid
        block; deep_reuse also broadcasts the up blocks' attention outputs
        (PAB) on cached steps.  step_callback(i) runs after each step."""
        self.check_inputs(height, width, num_frames, prompt=prompt, prompt_embeds=prompt_embeds,
                          negative_prompt=negative_prompt,
                          negative_prompt_embeds=negative_prompt_embeds)
        gen = self._generator(seed)
        first_frame = first_frame or frames[0]
        do_cfg = guidance_scale > 1.0
        if latents is None:
            latents = self.encode_vae_video(frames, height, width, generator=gen)
        else:  # the encode's draw, so that the first frame's draw is the same
            latents = torch.as_tensor(latents, device=self.device)
            torch.randn(latents.shape, generator=gen, device=self.device, dtype=torch.float32)
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
        traj = core.ddim_inversion_core(
            self._unet_apply(encoder_reuse_depth if encoder_reuse_interval > 1 else None),
            self.ddim, latents.float(), cond, ts, num_inference_steps, float(guidance_scale),
            encoder_reuse_interval=int(encoder_reuse_interval), deep_reuse=bool(deep_reuse),
            step_callback=step_callback)
        trajectory = traj.float().cpu().numpy()
        if output_dir is not None:
            meta = dict(n_steps=num_inference_steps, guidance_scale=guidance_scale,
                        num_frames=num_frames, height=height, width=width, prompt=prompt,
                        seed=seed, target_fps=target_fps,
                        encoder_reuse_interval=encoder_reuse_interval)
            if pm.is_writer(self.mesh):
                TrajectoryStore(output_dir).save(ts, trajectory, meta=meta)
                logger.info("saved trajectory (%d steps) to %s", len(ts), output_dir)
            self._sync()
        return ts, trajectory

    @spanned("entry/invert_batch")
    def invert_batch(self, videos: Sequence[Sequence[Image.Image]],
                     first_frames: Optional[Sequence[Optional[Image.Image]]] = None,
                     prompt: str = "", height: int = 720, width: int = 1280, target_fps: int = 8,
                     num_frames: int = 16, num_inference_steps: int = 500, clip_skip: int = 1,
                     seed: int = 8888, output_dirs: Optional[Sequence[Optional[str]]] = None,
                     encoder_reuse_interval: int = 1, deep_reuse: bool = False,
                     step_callback=None) -> tuple[np.ndarray, np.ndarray]:
        """DDIM-invert J independent videos in one step loop, the videos on
        the UNet batch axis (ddim_inversion_batch_core), at cfg 1 (the
        inversion template's), so each video is one branch.  Returns
        (timesteps ascending, trajectory [S, J, F, h, w, C]) and writes one
        trajectory store per video where output_dirs names a directory.

        Draws: video j's VAE encode noise, then its first frame's, come from
        its own generator seeded from `seed`, so every video gets the draws
        invert(videos[j], seed=seed) takes and a batch inverts what the
        sequential calls invert.  (The JAX package splits one key into 2J
        keys, which torch cannot reproduce.)  encoder_reuse_interval and
        deep_reuse as in invert, one cache over the J videos (the JAX
        package's invert_batch has no encoder_reuse_depth)."""
        self.check_inputs(height, width, num_frames)
        first_frames = list(first_frames or [None] * len(videos))
        x0s, img_embs, img_lats = [], [], []
        for frames, first in zip(videos, first_frames):
            gen = self._generator(seed)
            first = first or frames[0]
            x0s.append(self.encode_vae_video(frames, height, width, generator=gen))
            img_embs.append(self.encode_image(first, width).expand(num_frames, -1))
            img_lats.append(self.encode_first_frame_latents(first, height, width, num_frames,
                                                            generator=gen))
        pe, _ = self.encode_prompt(prompt, do_cfg=False, clip_skip=clip_skip)
        img_lat = torch.stack(img_lats)
        cond = self._stack_cond(pe.expand((len(videos),) + tuple(pe.shape[1:])), img_lat,
                                img_lat, torch.stack(img_embs), target_fps)
        ts = inversion_timesteps(self.scheduler_config, num_inference_steps)
        j = pm.job_slice(len(videos), self.mesh)  # this job slice's videos
        traj = core.ddim_inversion_batch_core(
            self._unet_apply(), self.ddim, torch.stack(x0s)[j].float(), cond.slice(j.start, j.stop),
            ts, num_inference_steps, encoder_reuse_interval=int(encoder_reuse_interval),
            deep_reuse=bool(deep_reuse), step_callback=step_callback)
        trajectory = self._job_gather(traj.float(), len(videos), dim=1).cpu().numpy()
        for j, out_dir in enumerate(output_dirs or []):
            if out_dir is None or not pm.is_writer(self.mesh):
                continue
            meta = dict(n_steps=num_inference_steps, guidance_scale=1.0, num_frames=num_frames,
                        height=height, width=width, prompt=prompt, seed=seed,
                        target_fps=target_fps, encoder_reuse_interval=encoder_reuse_interval)
            TrajectoryStore(out_dir).save(ts, trajectory[:, j], meta=meta)
            logger.info("saved trajectory (%d steps) to %s", len(ts), out_dir)
        if output_dirs:
            self._sync()
        return ts, trajectory

    # -- entry point D: plain sampling / reconstruction -------------------------

    def sample(self, image: Image.Image, prompt: str = "", negative_prompt: str = "",
               height: int = 720, width: int = 1280, target_fps: int = 8, num_frames: int = 16,
               num_inference_steps: int = 50, guidance_scale: float = 9.0, clip_skip: int = 1,
               ddim_init_latents_t_idx: int = 0, latents=None, seed: int = 6,
               decode: bool = True, decode_chunk_size: Optional[int] = 1, prompt_embeds=None,
               negative_prompt_embeds=None):
        """Image-to-video sampling; with `latents` ([F, h, w, C], the
        inverted latents at the schedule's step ddim_init_latents_t_idx) it
        is the reference's DDIM reconstruction path (inverse.py:79-108).
        Draws (the start latents when not given, then the first frame's VAE
        sample) come from one generator seeded from `seed`.  Returns the
        video [F, H, W, 3] in [0, 1], or the final latents if not decode."""
        self.check_inputs(height, width, num_frames, prompt=prompt, prompt_embeds=prompt_embeds,
                          negative_prompt=negative_prompt,
                          negative_prompt_embeds=negative_prompt_embeds)
        gen = self._generator(seed)
        do_cfg = guidance_scale > 1.0
        if latents is None:
            latents = self.prepare_latents(num_frames, height, width, gen)
        latents = torch.as_tensor(latents, device=self.device).float()
        pe, ne = self.encode_prompt(prompt, negative_prompt, do_cfg=do_cfg, clip_skip=clip_skip,
                                    prompt_embeds=prompt_embeds,
                                    negative_prompt_embeds=negative_prompt_embeds)
        text = torch.cat([ne, pe]) if do_cfg else pe
        img_emb = self.encode_image(image, width)
        img_emb = img_emb[:, None].expand(1, num_frames, img_emb.shape[-1])
        if do_cfg:
            img_emb = torch.cat([torch.zeros_like(img_emb), img_emb])
        img_lat = self.encode_first_frame_latents(image, height, width, num_frames, generator=gen)
        img_lat = img_lat[None].expand((2 if do_cfg else 1,) + tuple(img_lat.shape))
        cond = self._stack_cond(text, img_lat, img_lat, img_emb, target_fps)
        run_ts = sampling_timesteps(self.scheduler_config,
                                    num_inference_steps)[ddim_init_latents_t_idx:]
        final = core.ddim_sampling_core(self._unet_apply(), self.ddim, latents, cond, run_ts,
                                        num_inference_steps, float(guidance_scale))
        if not decode:
            return final
        return self.decode_latents(final, decode_chunk_size=decode_chunk_size)

    def generate_background(self, prompt: str, negative_prompt: str = "", height: int = 720,
                            width: int = 1280, num_frames: int = 16,
                            num_inference_steps: int = 50, guidance_scale: float = 9.0,
                            target_fps: int = 8, seed: int = 6):
        """Text-to-video background: image-to-video sampling conditioned on a
        null (black) first frame (the reference's dormant
        `generated_bacground*` config block, group_composite/template.yaml)."""
        black = Image.new("RGB", (width, height), (0, 0, 0))
        return self.sample(black, prompt=prompt, negative_prompt=negative_prompt, height=height,
                           width=width, target_fps=target_fps, num_frames=num_frames,
                           num_inference_steps=num_inference_steps,
                           guidance_scale=guidance_scale, seed=seed)

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
        negative_prompt_embeds=None, ddim_inv_prompt_embeds=None,
        encoder_reuse_interval: int = 1, encoder_reuse_depth: Optional[int] = None,
        pab_interval: int = 1, capture_reuse_interval: int = 1,
        capture_reuse_deep: bool = False):
        """Host-side preparation of sample_composite.  Returns (init_latents,
        cond, sched, masks_soft, pyr_bin, pyr_soft, capture_weights).  The
        reuse and broadcast keywords act in the step loop (sample_composite)."""
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
        with span("entry/trajectory_upload"):
            bg_traj = bg_store.gather(run_ts)
            obj_traj = np.stack([s.gather(run_ts) for s in obj_stores], axis=1)
            obj_fusion_lat = np.stack([
                obj_stores[j].load_at_t(int(full_ts[offsets[j]:][fusion_steps[0]]))
                for j in range(n_obj)])
        fusion_mask = np.array([fusion_steps[0] <= i < fusion_steps[1]
                                for i in range(len(run_ts))], dtype=bool)

        with span("entry/mask_pyramids"):
            h_lat, w_lat = masks_soft.shape[2], masks_soft.shape[3]
            resolutions = self._injection_resolutions(h_lat, w_lat)
            dev = self.device
            pyr_bin = {k: torch.as_tensor(v, device=dev)
                       for k, v in pnp_lib.build_mask_pyramid(masks_binary, resolutions).items()}
            pyr_soft = {k: torch.as_tensor(v, device=dev)
                        for k, v in pnp_lib.build_mask_pyramid(masks_soft, resolutions).items()}
        with span("entry/trajectory_upload"):
            sched = core.CompositeSchedule(
                bg_traj=torch.as_tensor(bg_traj, dtype=torch.float32, device=dev),
                obj_traj=torch.as_tensor(obj_traj, dtype=torch.float32, device=dev),
                obj_fusion_lat=torch.as_tensor(obj_fusion_lat, dtype=torch.float32, device=dev),
                gate_spatial=gates["spatial"], gate_temporal=gates["temporal"],
                gate_conv=gates["conv"], fusion_mask=fusion_mask, timesteps=np.asarray(run_ts))
        with span("entry/mask_pyramids"):
            capture_weights = (pnp_lib.build_capture_weights(pyr_bin, pyr_soft,
                                                             inject_background)
                               if two_pass == "stream" else None)
        return (init_latents, cond, sched,
                torch.as_tensor(masks_soft, dtype=torch.float32, device=dev),
                pyr_bin, pyr_soft, capture_weights)

    @spanned("entry/sample_composite")
    def sample_composite(self, *args, decode: bool = True, decode_chunk_size: Optional[int] = 1,
                         random_noise_ratio: float = 0.0, obj_random_noise_fusion: bool = False,
                         step_callback=None, **kwargs):
        """The MVOC composite sampler.  Same argument surface as
        _prepare_composite; two_pass is False (fused), True (batched
        capture, then consume) or "stream" (capture one branch at a time).
        The reuse and broadcast modes as in core.pnp_composite_core, with
        encoder_reuse_depth bound into the UNet when encoder reuse is on."""
        static = _composite_core_kwargs(kwargs, random_noise_ratio, obj_random_noise_fusion,
                                        step_callback)
        (init_latents, cond, sched, masks_soft, pyr_bin, pyr_soft,
         capture_weights) = self._prepare_composite(*args, **kwargs)
        final = core.pnp_composite_core(
            self._composite_unet(static, kwargs), self.ddim, init_latents, cond, sched,
            masks_soft, pyr_bin, pyr_soft, capture_weights=capture_weights, **static)
        if not decode:
            return final
        return self.decode_latents(final, decode_chunk_size=decode_chunk_size)

    def _composite_unet(self, static: dict, kwargs: dict):
        """The UNet of a composite loop: encoder_reuse_depth bound only when
        encoder reuse is on (the JAX package's _reuse_unet_apply)."""
        return self._unet_apply(kwargs.get("encoder_reuse_depth")
                                if static["encoder_reuse_interval"] > 1 else None)

    def _prepare_composite_batch(self, entries: Sequence[dict], **shared_kwargs):
        """_prepare_composite of every entry (its own kwargs and the shared
        ones), stacked on a leading entry axis J: (init_latents [J, ...],
        cond [J, N+3, ...], sched, masks_soft, pyr_bin, pyr_soft,
        capture_weights), as pnp_composite_batch_core takes them."""
        if not entries:
            raise ValueError("sample_composite_batch needs at least one entry")
        prepared = [self._prepare_composite(**shared_kwargs, **e) for e in entries]

        def stack(items):
            first = items[0]
            if first is None:
                return None
            if isinstance(first, dict):
                return {k: stack([it[k] for it in items]) for k in first}
            if isinstance(first, np.ndarray):
                return np.stack(items)
            if dataclasses.is_dataclass(first):
                return type(first)(*(stack([getattr(it, f.name) for it in items])
                                     for f in dataclasses.fields(first)))
            return torch.stack(items)

        return tuple(stack([p[i] for p in prepared]) for i in range(len(prepared[0])))

    @spanned("entry/sample_composite_batch")
    def sample_composite_batch(self, entries: Sequence[dict], decode: bool = True,
                               decode_chunk_size: Optional[int] = 1,
                               random_noise_ratio: float = 0.0,
                               obj_random_noise_fusion: bool = False, step_callback=None,
                               **shared_kwargs):
        """J independent composites in one step loop, the entries on the
        UNet batch axis (pnp_composite_batch_core; the reference loops group
        entries one by one, composite.py:87).

        entries: per-entry kwargs of _prepare_composite (prompt, images,
        masks, stores, seed, ...); shared_kwargs: the knobs every entry
        shares (steps, guidance, two_pass, ...; the CLI groups entries by
        them), and every entry is prepared with them, target_fps included,
        as in the JAX package.  Each entry draws from its own generator
        seeded from its seed, as sample_composite does.  Returns one decoded
        video [F, H, W, 3] per entry, or the final latents [J, F, h, w, C]
        if not decode."""
        static = _composite_core_kwargs(shared_kwargs, random_noise_ratio,
                                        obj_random_noise_fusion, step_callback)
        prepared = self._prepare_composite_batch(entries, **shared_kwargs)
        j = pm.job_slice(len(entries), self.mesh)  # this job slice's entries
        (init_latents, cond, sched, masks_soft, pyr_bin, pyr_soft,
         capture_weights) = _take_entries(prepared, j)
        final = core.pnp_composite_batch_core(
            self._composite_unet(static, shared_kwargs), self.ddim, init_latents, cond, sched,
            masks_soft, pyr_bin, pyr_soft, capture_weights=capture_weights, **static)
        final = self._job_gather(final, len(entries), dim=0)
        if not decode:
            return final
        return [self.decode_latents(f, decode_chunk_size=decode_chunk_size) for f in final]
