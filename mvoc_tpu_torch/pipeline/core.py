"""Inversion, plain sampling and PnP composite loops (counterpart of
mvoc_tpu/pipeline/core.py).

The JAX package compiles each loop into one `lax.scan`; here each is a
Python step loop over an eager UNet, under `torch.inference_mode()`.
Schedules (timesteps, gates, the fusion mask) are host arrays, so each
step's branching is plain Python.

The batch cores run J independent videos (inversion) or group entries
(composite) in one step loop, the entries riding the UNet's batch axis
entry-major: one UNet call per step covers all J entries (the JAX package
vmaps its single-entry scans instead).

The reuse and broadcast modes (encoder reuse, PAB, capture reuse) follow
the JAX package's blockwise schedule as a plain loop: run step i is fresh
iff i % k == 0 (fresh_steps); a fresh step computes the cache, the next
k - 1 steps read it, and it stays on the device until the next fresh step.

Spans (utils.profiling.span, recorded only while a torch profiler records):
each step's body runs inside `step`, closed before the step callback, so
that a profiler started or stopped there records whole steps; inside it
`step/fusion` (noise fusion), `step/capture` (each source UNet call of the
two-pass and stream paths, with its `_accumulate`), `step/edit` (the UNet
call that yields the guided pair's noise: the edit pair's, or the fused
batch's) and `step/guidance_ddim` (guidance and the DDIM update).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mvoc_tpu_torch import pnp as pnp_lib
from mvoc_tpu_torch.ops.ddim import DDIM
from mvoc_tpu_torch.utils.profiling import span


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

    def branches(self, lo: int, hi: int, per_entry: int) -> "UNetConditioning":
        """Branches lo..hi-1 of every entry of an entry-major batch of
        `per_entry` branches an entry, entry-major again."""
        return UNetConditioning(*(
            getattr(self, f.name).unflatten(0, (-1, per_entry))[:, lo:hi].flatten(0, 1)
            for f in dataclasses.fields(self)))

    def flatten_entries(self) -> "UNetConditioning":
        """[J, B, ...] fields -> the entry-major batch [J*B, ...]."""
        return UNetConditioning(*(getattr(self, f.name).flatten(0, 1)
                                  for f in dataclasses.fields(self)))

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


def fresh_steps(n_steps: int, k: int) -> list[bool]:
    """The reuse schedule of the JAX package's blockwise scan: run step i is
    fresh (computes its cache) iff i % k == 0, so every block of k steps,
    and the remainder block, starts fresh; k <= 1 makes every step fresh."""
    return [k <= 1 or i % k == 0 for i in range(n_steps)]


def _inversion_loop(unet, ddim: DDIM, latents: torch.Tensor, cond: UNetConditioning,
                    timesteps, num_inference_steps: int, branches,
                    encoder_reuse_interval: int, deep_reuse: bool, step_callback):
    """The inversion step loop shared by both inversion cores: `branches(lat)`
    builds the UNet batch and `eps = branches.guide(eps)` the guided noise.
    With encoder_reuse_interval = k > 1 a fresh step caches the encoder
    (deep_reuse: and the up blocks' attention outputs) and the next k - 1
    steps reuse it; the cache stays on the device and dies at the next
    fresh step."""
    k = int(encoder_reuse_interval)
    ts = np.asarray(timesteps)
    schedule = fresh_steps(len(ts), k)
    kw = cond.unet_kwargs()
    cache = None
    traj = []
    for i, t in enumerate(ts):
        with span("step"):
            t = int(t)
            inp = branches(latents)
            if k <= 1:
                eps = unet(inp, t, **kw)
            elif schedule[i]:
                cache = None
                if deep_reuse:
                    eps, enc, attn = unet(inp, t, **kw, return_encoder=True, pab_capture=True)
                    cache = (enc, attn)
                else:
                    eps, cache = unet(inp, t, **kw, return_encoder=True)
            elif deep_reuse:
                eps = unet(inp, t, **kw, cached_encoder=cache[0], pab_cache=cache[1])
            else:
                eps = unet(inp, t, **kw, cached_encoder=cache)
            with span("step/guidance_ddim"):
                latents = ddim.inverse_step(branches.guide(eps), t, latents,
                                            num_inference_steps)
            traj.append(latents)
        if step_callback is not None:
            step_callback(i)
    return torch.stack(traj)


class _Branches:
    """The inversion's UNet batch: the latents broadcast over n branches
    ([uncond, cond] under CFG), or, for the batch core, the J videos as
    they are (n = None); guide() applies the guidance."""

    def __init__(self, n: Optional[int], guidance_scale: float = 1.0):
        self.n, self.scale = n, guidance_scale

    def __call__(self, lat):
        return lat if self.n is None else lat[None].expand((self.n,) + tuple(lat.shape))

    def guide(self, eps):
        if self.n is None:
            return eps
        return eps[0] + self.scale * (eps[1] - eps[0]) if self.n == 2 else eps[0]


@torch.inference_mode()
def ddim_inversion_core(unet, ddim: DDIM, x0_latents: torch.Tensor, cond: UNetConditioning,
                        timesteps, num_inference_steps: int, guidance_scale: float = 1.0,
                        encoder_reuse_interval: int = 1, deep_reuse: bool = False,
                        step_callback=None) -> torch.Tensor:
    """DDIM inversion.  Returns the trajectory [S, F, h, w, C]: entry i is
    the latents at timesteps[i] (ascending).

    encoder_reuse_interval = k > 1: training-free encoder reuse, the UNet's
    down and mid features computed on every k-th step and reused in
    between; deep_reuse also broadcasts the up blocks' attention outputs
    (PAB), so a cached step computes only the up blocks' convs and FFs and
    the inverse update.  Bind encoder_reuse_depth into `unet` for the
    partial-depth cache (as the pipeline does).  step_callback(i), when
    given, runs after each step."""
    do_cfg = guidance_scale > 1.0
    return _inversion_loop(unet, ddim, x0_latents, cond, timesteps, num_inference_steps,
                           _Branches(2 if do_cfg else 1, guidance_scale),
                           encoder_reuse_interval, deep_reuse, step_callback)


@torch.inference_mode()
def ddim_inversion_batch_core(unet, ddim: DDIM, x0_latents: torch.Tensor,
                              cond: UNetConditioning, timesteps,
                              num_inference_steps: int, encoder_reuse_interval: int = 1,
                              deep_reuse: bool = False, step_callback=None) -> torch.Tensor:
    """DDIM inversion of J independent videos in one step loop: x0_latents
    [J, F, h, w, C] ride the UNet batch axis with one conditioning row per
    video (cond's leading axis J), at cfg 1 (the inversion template's), so
    each video is one branch.  The reuse keywords as in
    ddim_inversion_core, the cache over all J videos.  Returns [S, J, F, h,
    w, C]."""
    return _inversion_loop(unet, ddim, x0_latents, cond, timesteps, num_inference_steps,
                           _Branches(None), encoder_reuse_interval, deep_reuse, step_callback)


@torch.inference_mode()
def ddim_sampling_core(unet, ddim: DDIM, latents: torch.Tensor, cond: UNetConditioning,
                       timesteps, num_inference_steps: int, guidance_scale: float,
                       eta: float = 0.0, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain DDIM sampling from `latents` [F, h, w, C] over `timesteps`
    (descending, possibly a truncated schedule: the reconstruction path
    starts at ddim_init_latents_t_idx).  cond has batch 2 ([uncond, cond])
    when guidance_scale > 1, else 1.  eta > 0 takes `noise` [S', F, h, w, C],
    one slice per step."""
    do_cfg = guidance_scale > 1.0
    n_branches = 2 if do_cfg else 1
    if eta > 0.0 and noise is None:
        raise ValueError("eta > 0 requires noise")
    for i, t in enumerate(np.asarray(timesteps)):
        with span("step"):
            inp = latents[None].expand((n_branches,) + tuple(latents.shape))
            eps = unet(inp, int(t), **cond.unet_kwargs())
            with span("step/guidance_ddim"):
                eps = eps[0] + guidance_scale * (eps[1] - eps[0]) if do_cfg else eps[0]
                latents = ddim.step(eps, int(t), latents, num_inference_steps, eta=eta,
                                    noise=noise[i] if eta > 0.0 else None)
    return latents


@dataclasses.dataclass(frozen=True)
class CompositeSchedule:
    """Per-step inputs of the composite loop, all of length S' (run steps).

    bg_traj [S', F, h, w, C] and obj_traj [S', N, F, h, w, C]: the inverted
    latents at each run t.  obj_fusion_lat [N, F, h, w, C]: the object
    latents pasted during fusion — the reference indexes its fusion list
    with a counter that is set to 0 and never incremented, so the SAME
    latent is pasted at every fusion step (reproduced).  gate_* and
    fusion_mask: [S'] booleans; timesteps: [S'] descending.
    pnp_composite_batch_core takes every field with a leading entry axis J."""

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
                       capture_weights=None, encoder_reuse_interval: int = 1,
                       pab_interval: int = 1, capture_reuse_interval: int = 1,
                       capture_reuse_deep: bool = False, step_callback=None) -> torch.Tensor:
    """The MVOC composite sampler.  Branch layout [bg, obj_1..obj_N, uncond,
    cond]; source branches take their inverted latents at the current t.

    two_pass=False runs all N+3 branches as one batch (fused).
    two_pass=True captures the pre-composited site features S over the N+1
    source branches as one batch, then the uncond/cond pair runs as a batch
    of 2 consuming S: peak activation memory of max(N+1, 2) branches.
    two_pass="stream" runs the capture one source branch at a time (batch
    1): each branch's site terms x_b * M_b (weights from
    pnp.build_capture_weights) are summed in place into S, then the pair
    consumes it: peak activation memory of one branch.  All three are the
    same function.  step_callback(i), when given, runs after each step
    (timing hooks).  The loop is pnp_composite_batch_core's at one entry.

    The approximate modes, each with an interval k > 1 (1 = off, exact);
    run step i is fresh iff i % k == 0 (fresh_steps), a fresh step computes
    the cache and the next k - 1 steps reuse it:
    - encoder_reuse_interval: the UNet's down and mid features, on all
      three paths (two_pass=True: one cache for the N+1 source branches and
      one for the edit pair; stream: one per source branch and the edit
      pair's).  Bind encoder_reuse_depth into `unet` for the partial cache;
    - pab_interval (fused path only): the up blocks' attention outputs
      (PAB), the rest of each step fresh;
    - capture_reuse_interval (two_pass=True and stream only): the
      pre-composited source features S, so cached steps skip the N+1
      source forwards while noise fusion, the edit pair, CFG and DDIM stay
      fresh;
    - capture_reuse_deep (stream, with capture_reuse_interval): the edit
      pair's encoder and attention outputs too, so a cached step runs only
      the edit pair's up-block convs and FFs, CFG and DDIM.
    Other combinations raise ValueError, as the JAX package asserts."""
    def one(pyr):
        return {res: m[None] for res, m in pyr.items()}

    entry = dataclasses.replace(sched, bg_traj=sched.bg_traj[None], obj_traj=sched.obj_traj[None],
                                obj_fusion_lat=sched.obj_fusion_lat[None])
    weights = None if capture_weights is None else {
        kind: one(pyr) for kind, pyr in capture_weights.items()}
    return _composite_loop(
        unet, ddim, init_latents[None], cond, entry, masks_soft[None], one(masks_binary_pyramid),
        one(masks_soft_pyramid), num_inference_steps, guidance_scale, random_noise_ratio,
        obj_random_noise_fusion, inject_background, two_pass, weights,
        encoder_reuse_interval, pab_interval, capture_reuse_interval, capture_reuse_deep,
        step_callback)[0]


SHARED_SCHEDULE = ("timesteps", "gate_spatial", "gate_temporal", "gate_conv", "fusion_mask")


@torch.inference_mode()
def pnp_composite_batch_core(unet, ddim: DDIM, init_latents: torch.Tensor,
                             cond: UNetConditioning, sched: CompositeSchedule,
                             masks_soft: torch.Tensor,
                             masks_binary_pyramid: Dict[Tuple[int, int], torch.Tensor],
                             masks_soft_pyramid: Dict[Tuple[int, int], torch.Tensor],
                             capture_weights=None, **kwargs) -> torch.Tensor:
    """J independent composites in one step loop (the counterpart of the
    JAX package's vmap of pnp_composite_core): every argument carries a
    leading entry axis J, as there — init_latents [J, F, h, w, C], cond's
    fields [J, N+3, ...], every field of sched, masks_soft [J, N, F, h, w],
    the pyramids [J, N, F, h', w'] and the capture weights [J, N+1, ...].
    The UNet runs once per step over all J entries (fused: J*(N+3)
    branches; two_pass=True: a capture of J*(N+1), a consume of J*2;
    stream: N+1 captures of J, a consume of J*2), each site compositing
    every entry with its own masks, and noise fusion pastes each entry's
    own fusion latents under its own masks.  The schedule (timesteps,
    gates, fusion mask) must be the same for every entry: a ValueError
    otherwise (the CLI groups entries by exactly these).  kwargs: the
    static knobs of pnp_composite_core.  Returns [J, F, h, w, C]."""
    j = init_latents.shape[0]
    shared = {}
    for name in SHARED_SCHEDULE:
        v = np.asarray(getattr(sched, name))
        if v.shape[0] != j or not (v == v[:1]).all():
            raise ValueError(f"sched.{name} differs across the {j} entries: a batch of "
                             "composites shares its timesteps, gates and fusion mask")
        shared[name] = v[0]
    return _composite_loop(unet, ddim, init_latents, cond.flatten_entries(),
                           dataclasses.replace(sched, **shared), masks_soft,
                           masks_binary_pyramid, masks_soft_pyramid,
                           capture_weights=capture_weights, **kwargs)


def check_composite_modes(two_pass, encoder_reuse_interval: int = 1, pab_interval: int = 1,
                          capture_reuse_interval: int = 1,
                          capture_reuse_deep: bool = False) -> None:
    """The combinations of the composite's approximate modes that the JAX
    package asserts against, refused with a ValueError naming the rule."""
    if two_pass not in (False, True, "stream"):
        raise ValueError(f"two_pass={two_pass!r}: False (fused), True or 'stream'")
    reuse, pab = encoder_reuse_interval > 1, pab_interval > 1
    cap_reuse = capture_reuse_interval > 1
    if pab and (two_pass or reuse):
        raise ValueError("pab_interval composes with the fused path only (two_pass=False, "
                         "encoder_reuse_interval=1)")
    if cap_reuse and (not two_pass or reuse or pab):
        raise ValueError("capture_reuse_interval composes with two_pass/stream only (and "
                         "neither encoder_reuse_interval nor pab_interval)")
    if capture_reuse_deep and not (cap_reuse and two_pass == "stream"):
        raise ValueError("capture_reuse_deep extends capture reuse on the stream path "
                         "(two_pass='stream', capture_reuse_interval > 1)")


def _composite_loop(unet, ddim: DDIM, latents: torch.Tensor, cond: UNetConditioning,
                    sched: CompositeSchedule, masks_soft: torch.Tensor, pyr_bin, pyr_soft,
                    num_inference_steps: int, guidance_scale: float,
                    random_noise_ratio: float = 0.0, obj_random_noise_fusion: bool = False,
                    inject_background: bool = True, two_pass=False, capture_weights=None,
                    encoder_reuse_interval: int = 1, pab_interval: int = 1,
                    capture_reuse_interval: int = 1, capture_reuse_deep: bool = False,
                    step_callback=None) -> torch.Tensor:
    """The composite step loop over J entries: latents [J, F, h, w, C]; cond
    the entry-major batch of J*(N+3) branches; sched's trajectories with a
    leading J and its timesteps, gates and fusion mask shared ([S']);
    masks_soft [J, N, F, h, w]; pyramids and capture weights with a leading
    J.  The reuse modes as in pnp_composite_core, every cache over the J
    entries' batch."""
    check_composite_modes(two_pass, encoder_reuse_interval, pab_interval,
                          capture_reuse_interval, capture_reuse_deep)
    stream = two_pass == "stream"
    if stream and capture_weights is None:
        raise ValueError("stream capture needs capture_weights")
    reuse, pab = encoder_reuse_interval > 1, pab_interval > 1
    cap_reuse = capture_reuse_interval > 1
    k = (encoder_reuse_interval if reuse else pab_interval if pab
         else capture_reuse_interval if cap_reuse else 1)
    n_entries, n_obj = masks_soft.shape[:2]
    nb = n_obj + 3
    mask_b = masks_soft[..., None]
    if two_pass:
        src_cond = cond.branches(0, n_obj + 1, nb)
        edit_cond = cond.branches(n_obj + 1, nb, nb)
        branch_cond = [cond.branches(b, b + 1, nb) for b in range(n_obj + 1)] if stream else None
    ts = np.asarray(sched.timesteps)
    schedule = fresh_steps(len(ts), k)
    cache = None
    for i, t in enumerate(ts):
        with span("step"):
            t = int(t)
            # the step's static mode (JAX's): plain, or fresh / cached under
            # encoder reuse and PAB, cap_fresh / cap_cached under capture reuse
            mode = "plain" if k <= 1 else ("cap_" if cap_reuse else "") + (
                "fresh" if schedule[i] else "cached")
            if schedule[i]:
                cache = None  # the last block's cache dies before this step makes a new one
            bg_lat, obj_lat = sched.bg_traj[:, i], sched.obj_traj[:, i]
            if bool(sched.fusion_mask[i]):  # noise fusion, each entry with its own masks
                with span("step/fusion"):
                    latents = random_noise_ratio * latents + (1.0 - random_noise_ratio) * bg_lat
                    for j in range(n_obj):
                        m = mask_b[:, j]
                        paste = sched.obj_fusion_lat[:, j] * m
                        if obj_random_noise_fusion:
                            fg = latents * m * random_noise_ratio + (
                                1.0 - random_noise_ratio) * paste
                        else:
                            fg = paste
                        latents = latents * (1.0 - m) + fg
                # during fusion steps the object branches also take the fusion latents
                obj_lat = sched.obj_fusion_lat
            state = pnp_lib.PnPState(
                masks=pyr_bin, masks_soft=pyr_soft, gate_spatial=bool(sched.gate_spatial[i]),
                gate_temporal=bool(sched.gate_temporal[i]), gate_conv=bool(sched.gate_conv[i]),
                inject_background=inject_background)

            if two_pass:
                src = torch.cat([bg_lat[:, None], obj_lat], dim=1)  # [J, N+1, F, h, w, C]
                src_caches = None
                if mode == "cap_cached":  # broadcast the cached source features
                    feats = cache[0] if capture_reuse_deep else cache
                elif stream:
                    feats = None
                    src_caches = [] if mode == "fresh" else None
                    for b in range(n_obj + 1):
                        with span("step/capture"):
                            wgt = {kind: {res: w[:, b] for res, w in pyr.items()}
                                   for kind, pyr in capture_weights.items()}
                            kw = dict(branch_cond[b].unet_kwargs(), pnp_capture=True,
                                      pnp=dataclasses.replace(state, capture_weight=wgt))
                            if mode == "fresh":
                                _, f_b, enc = unet(src[:, b], t, **kw, return_encoder=True)
                                src_caches.append(enc)
                            elif mode == "cached":
                                _, f_b = unet(src[:, b], t, **kw, cached_encoder=cache[0][b])
                            else:
                                _, f_b = unet(src[:, b], t, **kw)
                            feats = _accumulate(feats, f_b)
                else:
                    kw = dict(src_cond.unet_kwargs(), pnp=state, pnp_capture=True)
                    with span("step/capture"):
                        if mode == "fresh":
                            _, feats, src_caches = unet(src.flatten(0, 1), t, **kw,
                                                        return_encoder=True)
                        elif mode == "cached":
                            _, feats = unet(src.flatten(0, 1), t, **kw, cached_encoder=cache[0])
                        else:
                            _, feats = unet(src.flatten(0, 1), t, **kw)
                consume = dataclasses.replace(state, mode="consume_pre", features=feats)
                edit = torch.stack([latents, latents], dim=1).flatten(0, 1)
                kw = dict(edit_cond.unet_kwargs(), pnp=consume)
                with span("step/edit"):
                    if mode == "fresh":
                        eps, edit_cache = unet(edit, t, **kw, return_encoder=True)
                        cache = (src_caches, edit_cache)
                    elif mode == "cached":
                        eps = unet(edit, t, **kw, cached_encoder=cache[1])
                    elif mode == "cap_fresh" and capture_reuse_deep:
                        eps, edit_enc, attn = unet(edit, t, **kw, return_encoder=True,
                                                   pab_capture=True)
                        cache = (feats, edit_enc, attn)
                    elif mode == "cap_cached" and capture_reuse_deep:
                        eps = unet(edit, t, **kw, cached_encoder=cache[1], pab_cache=cache[2])
                    else:
                        eps = unet(edit, t, **kw)
                        if mode == "cap_fresh":
                            cache = feats
                eps = eps.unflatten(0, (n_entries, 2))
                eps_neg, eps_pos = eps[:, 0], eps[:, 1]
            else:
                inp = torch.cat([bg_lat[:, None], obj_lat, latents[:, None], latents[:, None]],
                                dim=1).flatten(0, 1)
                kw = dict(cond.unet_kwargs(), pnp=state)
                with span("step/edit"):
                    if mode == "fresh" and reuse:
                        eps, cache = unet(inp, t, **kw, return_encoder=True)
                    elif mode == "cached" and reuse:
                        eps = unet(inp, t, **kw, cached_encoder=cache)
                    elif mode == "fresh":  # PAB
                        eps, cache = unet(inp, t, **kw, pab_capture=True)
                    elif mode == "cached":
                        eps = unet(inp, t, **kw, pab_cache=cache)
                    else:
                        eps = unet(inp, t, **kw)
                eps = eps.unflatten(0, (n_entries, nb))
                eps_neg, eps_pos = eps[:, n_obj + 1], eps[:, n_obj + 2]
            with span("step/guidance_ddim"):
                eps_g = eps_neg + guidance_scale * (eps_pos - eps_neg)
                latents = ddim.step(eps_g, t, latents, num_inference_steps)
        if step_callback is not None:
            step_callback(i)
    return latents
