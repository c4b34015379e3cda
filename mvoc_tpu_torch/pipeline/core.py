"""Inversion and PnP composite loops (counterpart of mvoc_tpu/pipeline/core.py).

The JAX package compiles each loop into one `lax.scan`; here each is a
Python step loop over an eager UNet, under `torch.inference_mode()`.
Schedules (timesteps, gates, the fusion mask) are host arrays, so each
step's branching is plain Python.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mvoc_tpu_torch import pnp as pnp_lib
from mvoc_tpu_torch.ops.ddim import DDIM


@dataclasses.dataclass(frozen=True)
class UNetConditioning:
    """Per-branch UNet conditioning, leading axis = branch batch B.

    encoder_hidden_states [B, 77, D]; image_latents_first / image_latents
    [B, F, h, w, C]; image_embeddings [B, F, D_img]; fps [B]."""

    encoder_hidden_states: torch.Tensor
    image_latents_first: torch.Tensor
    image_latents: torch.Tensor
    image_embeddings: torch.Tensor
    fps: torch.Tensor

    def slice(self, lo: int, hi: int) -> "UNetConditioning":
        return UNetConditioning(*(getattr(self, f.name)[lo:hi] for f in dataclasses.fields(self)))

    def unet_kwargs(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def prepare_image_latents(first_frame_latents: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[h, w, C] scaled first-frame latents -> [F, h, w, C]: frame 0 is the
    latent, frame k > 0 the constant plane k/(F-1)."""
    h, w, c = first_frame_latents.shape
    ramp = torch.arange(1, num_frames, dtype=first_frame_latents.dtype,
                        device=first_frame_latents.device) / (num_frames - 1)
    planes = ramp[:, None, None, None].expand(num_frames - 1, h, w, c)
    return torch.cat([first_frame_latents[None], planes], dim=0)


@torch.inference_mode()
def ddim_inversion_core(unet, ddim: DDIM, x0_latents: torch.Tensor, cond: UNetConditioning,
                        timesteps, num_inference_steps: int,
                        guidance_scale: float = 1.0) -> torch.Tensor:
    """DDIM inversion.  Returns the trajectory [S, F, h, w, C]: entry i is
    the latents at timesteps[i] (ascending)."""
    do_cfg = guidance_scale > 1.0
    n_branches = 2 if do_cfg else 1
    latents = x0_latents
    traj = []
    for t in np.asarray(timesteps):
        inp = latents[None].expand((n_branches,) + tuple(latents.shape))
        eps = unet(inp, int(t), **cond.unet_kwargs())
        eps = eps[0] + guidance_scale * (eps[1] - eps[0]) if do_cfg else eps[0]
        latents = ddim.inverse_step(eps, int(t), latents, num_inference_steps)
        traj.append(latents)
    return torch.stack(traj)


@dataclasses.dataclass(frozen=True)
class CompositeSchedule:
    """Per-step inputs of the composite loop, all of length S' (run steps).

    bg_traj [S', F, h, w, C] and obj_traj [S', N, F, h, w, C]: the inverted
    latents at each run t.  obj_fusion_lat [N, F, h, w, C]: the object
    latents pasted during fusion — the reference indexes its fusion list
    with a counter that is set to 0 and never incremented, so the SAME
    latent is pasted at every fusion step (reproduced).  gate_* and
    fusion_mask: [S'] booleans; timesteps: [S'] descending."""

    bg_traj: torch.Tensor
    obj_traj: torch.Tensor
    obj_fusion_lat: torch.Tensor
    gate_spatial: np.ndarray
    gate_temporal: np.ndarray
    gate_conv: np.ndarray
    fusion_mask: np.ndarray
    timesteps: np.ndarray


def _accumulate(acc: Optional[dict], feats: dict) -> dict:
    """acc += feats site by site, in place (tensors or (q, k) pairs)."""
    if acc is None:
        return feats
    for key, val in feats.items():
        if isinstance(val, tuple):
            for a, v in zip(acc[key], val):
                a.add_(v)
        else:
            acc[key].add_(val)
    return acc


@torch.inference_mode()
def pnp_composite_core(unet, ddim: DDIM, init_latents: torch.Tensor, cond: UNetConditioning,
                       sched: CompositeSchedule, masks_soft: torch.Tensor,
                       masks_binary_pyramid: Dict[Tuple[int, int], torch.Tensor],
                       masks_soft_pyramid: Dict[Tuple[int, int], torch.Tensor],
                       num_inference_steps: int, guidance_scale: float,
                       random_noise_ratio: float = 0.0, obj_random_noise_fusion: bool = False,
                       inject_background: bool = True, two_pass=False,
                       capture_weights=None, step_callback=None) -> torch.Tensor:
    """The MVOC composite sampler.  Branch layout [bg, obj_1..obj_N, uncond,
    cond]; source branches take their inverted latents at the current t.

    two_pass=False runs all N+3 branches as one batch (fused).
    two_pass="stream" runs the capture one source branch at a time (batch
    1): each branch's site terms x_b * M_b (weights from
    pnp.build_capture_weights) are summed in place into the pre-composited
    S, then the uncond/cond pair runs as a batch of 2 consuming S.  Same
    function as the fused path; peak activation memory of one branch.
    step_callback(i), when given, runs after each step (timing hooks)."""
    if two_pass not in (False, "stream"):
        raise NotImplementedError(f"two_pass={two_pass!r}: only False and 'stream' are ported")
    stream = two_pass == "stream"
    if stream and capture_weights is None:
        raise ValueError("stream capture needs capture_weights")
    n_obj = masks_soft.shape[0]
    mask_b = masks_soft[..., None]
    latents = init_latents
    for i, t in enumerate(np.asarray(sched.timesteps)):
        t = int(t)
        bg_lat, obj_lat = sched.bg_traj[i], sched.obj_traj[i]
        fuse = bool(sched.fusion_mask[i])
        if fuse:  # noise fusion
            latents = random_noise_ratio * latents + (1.0 - random_noise_ratio) * bg_lat
            for j in range(n_obj):
                m = mask_b[j]
                paste = sched.obj_fusion_lat[j] * m
                if obj_random_noise_fusion:
                    fg = latents * m * random_noise_ratio + (1.0 - random_noise_ratio) * paste
                else:
                    fg = paste
                latents = latents * (1.0 - m) + fg
            # during fusion steps the object branches also take the fusion latents
            obj_lat = sched.obj_fusion_lat
        state = pnp_lib.PnPState(
            masks=masks_binary_pyramid, masks_soft=masks_soft_pyramid,
            gate_spatial=bool(sched.gate_spatial[i]), gate_temporal=bool(sched.gate_temporal[i]),
            gate_conv=bool(sched.gate_conv[i]), inject_background=inject_background)

        if stream:
            src_inp = torch.cat([bg_lat[None], obj_lat], dim=0)
            feats = None
            for b in range(n_obj + 1):
                wgt = {kind: {res: w[b] for res, w in pyr.items()}
                       for kind, pyr in capture_weights.items()}
                _, f_b = unet(src_inp[b:b + 1], t, **cond.slice(b, b + 1).unet_kwargs(),
                              pnp=dataclasses.replace(state, capture_weight=wgt),
                              pnp_capture=True)
                feats = _accumulate(feats, f_b)
            consume = dataclasses.replace(state, mode="consume_pre", features=feats)
            eps = unet(torch.stack([latents, latents]), t,
                       **cond.slice(n_obj + 1, n_obj + 3).unet_kwargs(), pnp=consume)
            eps_neg, eps_pos = eps[0], eps[1]
        else:
            inp = torch.cat([bg_lat[None], obj_lat, latents[None], latents[None]], dim=0)
            eps = unet(inp, t, **cond.unet_kwargs(), pnp=state)
            eps_neg, eps_pos = eps[n_obj + 1], eps[n_obj + 2]
        eps_g = eps_neg + guidance_scale * (eps_pos - eps_neg)
        latents = ddim.step(eps_g, t, latents, num_inference_steps)
        if step_callback is not None:
            step_callback(i)
    return latents
