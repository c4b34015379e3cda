"""The system under test, seen from the benchmark: the one module here that
imports the PyTorch port `mvoc_tpu_torch`.  It builds the port's pipeline
around the benchmark's weights and hands each call the benchmark's inputs
through the public entry points, as a user's script does.

`StateTap` reads what the comparison needs from the program's own run,
through a forward pre-hook on its UNet: the latents a step's last UNet call
takes for the edit branches (the state after the previous step's update
and this step's noise fusion).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel, CLIPVisionConfig,
                                        CLIPVisionModelWithProjection)
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from mvoc_tpu_torch.ops.ddim import SchedulerConfig
from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline

PARTS = ("unet", "vae", "text_encoder", "image_encoder")


def _conf(cls, d: dict, **extra):
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in fields}
    return cls(**kw, **extra)


def meta_modules(cfg: dict) -> dict:
    """The program's modules of configuration `cfg`, on the meta device."""
    opts = cfg.get("program", {})
    with torch.device("meta"):
        return {
            "unet": I2VGenXLUNet(_conf(UNetConfig, cfg["unet"], **opts)),
            "vae": AutoencoderKL(_conf(VAEConfig, cfg["vae"])),
            "text_encoder": CLIPTextModel(_conf(CLIPTextConfig, cfg["text_encoder"])),
            "image_encoder": CLIPVisionModelWithProjection(
                _conf(CLIPVisionConfig, cfg["image_encoder"])),
        }


def build(cfg: dict, modules: dict, weights: dict, tokenizer, device) -> I2VGenXLPipeline:
    """The pipeline of `modules` (meta) holding `weights` ({part: {name:
    tensor}}), in the configuration's dtype and int8 mode."""
    for part in PARTS:
        modules[part].load_state_dict(weights[part], assign=True)
        modules[part].requires_grad_(False)
    dtype = getattr(torch, cfg["dtype"])
    pipe = I2VGenXLPipeline(*(modules[p] for p in PARTS),
                            scheduler_config=_conf(SchedulerConfig, cfg["scheduler"]),
                            tokenizer=tokenizer, dtype=dtype, device=device)
    int8 = cfg.get("int8")
    if int8 is not None:
        min_k = int(int8.get("min_k", 1280))
        if min_k == 1280:
            pipe.enable_int8(mode=int8["mode"])
        else:  # the same selection at another threshold (tiny test geometries)
            pipe.enable_int8(predicate=lambda names, leaf: _mixed(names, leaf, min_k))
    return pipe


def _mixed(names, leaf, min_k: int) -> bool:
    from mvoc_tpu_torch.ops.quantize import default_unet_predicate

    if not default_unet_predicate(names):
        return False
    if leaf.ndim == 2:
        return leaf.shape[0] >= min_k
    return leaf.ndim == 5 and tuple(leaf.shape[:3]) == (3, 1, 1) and leaf.shape[3] >= min_k


def write_stores(root: str, entry) -> tuple:
    """The entry's source trajectories as the program's trajectory stores
    under root: (bg, [objects])."""
    stores = []
    for i, traj in enumerate([entry.bg_traj] + list(entry.obj_traj)):
        path = os.path.join(root, f"source{i}")
        TrajectoryStore(path).save(entry.full_ts, traj)
        stores.append(path)
    return stores[0], stores[1:]


def composite_kwargs(entry, stores, call: dict) -> dict:
    """One entry's keywords of sample_composite (fresh stores, as a caller
    opens them per entry)."""
    bg, objs = stores
    return dict(prompt=entry.prompts["prompt"], negative_prompt=entry.prompts["negative"],
                ddim_inv_prompt=entry.prompts["inversion"], main_first_image=entry.main_first,
                main_image_list=entry.main_frames, background_image_list=entry.bg_frames,
                objs_image_list=entry.obj_frames, masks_soft=entry.masks_soft,
                masks_binary=entry.masks_binary, bg_store=TrajectoryStore(bg),
                obj_stores=[TrajectoryStore(p) for p in objs], seed=entry.seed)


def shared_kwargs(call: dict) -> dict:
    return dict(height=call["height"], width=call["width"], num_frames=call["frames"],
                target_fps=call["fps"], num_inference_steps=call["n_steps"],
                guidance_scale=call["guidance"],
                ddim_init_latents_t_idx=call["ddim_init_latents_t_idx"],
                fusion_steps=tuple(call["fusion_steps"]), two_pass=call["two_pass"],
                pnp_f_t=call["pnp_f_t"], pnp_spatial_attn_t=call["pnp_spatial_attn_t"],
                pnp_temp_attn_t=call["pnp_temp_attn_t"],
                inject_background=call["inject_background"])


def run_call(pipe: I2VGenXLPipeline, entry_point: str, call: dict, inputs: list,
             step_callback) -> torch.Tensor:
    """One call of the entry point; returns its final latents (composites,
    [J, F, h, w, C]) or its trajectory ([S, J, F, h, w, C], inversions)."""
    if entry_point in ("sample_composite", "sample_composite_batch"):
        entries = [composite_kwargs(e, s, call) for e, s in inputs]
        static = dict(decode=False, random_noise_ratio=call["random_noise_ratio"],
                      obj_random_noise_fusion=call["obj_random_noise_fusion"],
                      step_callback=step_callback)
        if entry_point == "sample_composite":
            return pipe.sample_composite(**entries[0], **shared_kwargs(call), **static)[None]
        return pipe.sample_composite_batch(entries, **shared_kwargs(call), **static)
    if entry_point in ("invert", "invert_batch"):
        videos, prompt, seed = inputs
        kw = dict(prompt=prompt, height=call["height"], width=call["width"],
                  target_fps=call["fps"], num_frames=call["frames"],
                  num_inference_steps=call["n_steps"], seed=seed, step_callback=step_callback)
        if entry_point == "invert":
            _, traj = pipe.invert(videos[0], **kw)
            return torch.as_tensor(traj)[:, None]
        _, traj = pipe.invert_batch(videos, **kw)
        return torch.as_tensor(traj)
    raise ValueError(f"entry point {entry_point!r}")


class StateTap:
    """The edit branches' input latents of chosen steps of one call, [J, F,
    h, w, C] float32 copies, read at each UNet call: rows nb-1 of every
    entry of a fused composite batch of nb = N+3 branches, the cond row of
    the edit pair of a two-pass or streamed step (its PnP state in mode
    "consume_pre"), every row of an inversion at cfg 1."""

    def __init__(self, pipe: I2VGenXLPipeline, entry_point: str, n_branches: int):
        self.kind = "inversion" if entry_point.startswith("invert") else "composite"
        self.nb = n_branches
        self.want: set = set()
        self.step = 0
        self.active = False
        self.states: dict = {}
        self._handle = pipe.unet.register_forward_pre_hook(self._hook, with_kwargs=True)

    def arm(self, steps) -> None:
        self.want, self.step, self.active, self.states = set(steps), 0, True, {}

    def stepped(self, i: int) -> None:
        self.step = i + 1

    def _hook(self, _module, args, kwargs):
        if not self.active or self.step not in self.want:
            return None
        sample = args[0] if args else kwargs["sample"]
        if self.kind == "inversion":
            rows = sample
        else:
            pnp = kwargs.get("pnp")
            if kwargs.get("pnp_capture"):
                return None
            rows = sample[1::2] if pnp is not None and pnp.mode == "consume_pre" \
                else sample[self.nb - 1::self.nb]
        self.states[self.step] = rows.float().clone()
        return None

    def close(self) -> None:
        self._handle.remove()
        self.active = False
