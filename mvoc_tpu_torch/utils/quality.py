"""Exact-vs-approximate drift of the acceleration modes (the port's copy of
mvoc_tpu/utils/quality.py).

The reference computes every step exactly; the reuse and broadcast modes
(encoder reuse, partial-depth reuse, PAB, capture reuse and its deep form,
deep-reuse inversion) and int8 trade exactness for speed.  This module runs
the exact and the approximate samplers on the same tiny inputs on the CPU
(random weights: the metric is the algorithmic drift of the cache wiring,
not visual quality, which needs real weights) and reports, per mode, the
latent-space error against the exact run of the same path:

  rel_l2   ||approx - exact|| / ||exact||
  psnr_db  10 log10(range(exact)^2 / mse)

A wrong cache wiring (the wrong tensor broadcast, a stale index, swapped
branches) lands near rel_l2 ~ 1, far outside the bounds the tests pin,
while a correct k = 2 reuse drifts mildly.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

# the modes evaluated by default: (name, keywords of run_composite / run_inversion)
COMPOSITE_MODES = (
    ("encoder_reuse_k2", dict(encoder_reuse_interval=2)),
    ("encoder_reuse_k2_depth1", dict(encoder_reuse_interval=2, reuse_depth=1)),
    ("pab_k2", dict(pab_interval=2)),
    ("capture_reuse_k2", dict(capture_reuse_interval=2)),
    ("capture_reuse_k2_deep", dict(capture_reuse_interval=2, capture_reuse_deep=True)),
    ("capture_reuse_k3_deep", dict(capture_reuse_interval=3, capture_reuse_deep=True)),
    ("capture_reuse_k5_deep", dict(capture_reuse_interval=5, capture_reuse_deep=True)),
    ("int8", dict(int8=True)),  # w8a8: every step approximated
)
INVERSION_MODES = (
    ("inv_encoder_reuse_k2", dict(encoder_reuse_interval=2)),
    ("inv_deep_reuse_k2", dict(encoder_reuse_interval=2, deep_reuse=True)),
    ("inv_deep_reuse_k3", dict(encoder_reuse_interval=3, deep_reuse=True)),
    ("inv_deep_reuse_k5", dict(encoder_reuse_interval=5, deep_reuse=True)),
    ("inv_int8", dict(int8=True)),
)


def latent_metrics(approx, exact) -> Dict[str, float]:
    """Scale-free drift metrics between two latent tensors."""
    a = np.asarray(approx, np.float64)
    b = np.asarray(exact, np.float64)
    diff = a - b
    rel = float(np.linalg.norm(diff) / max(np.linalg.norm(b), 1e-12))
    mse = float(np.mean(diff * diff))
    rng = float(b.max() - b.min())
    psnr = float(10.0 * math.log10(max(rng, 1e-12) ** 2 / max(mse, 1e-300)))
    return {"rel_l2": round(rel, 6), "psnr_db": round(psnr, 2)}


class _TinyHarness:
    """One tiny UNet and one set of composite inputs, in fp32 on the CPU.

    The inputs are drawn from numpy's default_rng(seed) in the JAX
    harness's order, so they are that harness's bitwise.  The weights are
    `unet_state` (a state dict, e.g. the JAX harness's parameters through
    models/convert.py), else torch's own init under torch.manual_seed(seed)."""

    def __init__(self, seed: int = 0, natural: bool = True,
                 unet_state: Optional[dict] = None):
        from mvoc_tpu_torch import pnp as pnp_lib
        from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
        from mvoc_tpu_torch.ops.ddim import (DDIM, SchedulerConfig, inversion_timesteps,
                                             sampling_timesteps)
        from mvoc_tpu_torch.pipeline import core

        self.core, self.pnp = core, pnp_lib
        cfg = dataclasses.replace(UNetConfig.tiny(), temporal_natural_layout=natural)
        self.cfg = cfg
        F, H, W = 8, 8, 8
        self.F, self.H, self.W = F, H, W
        self.n_obj = 2
        # the composite's grid (spacing 125) is a subset of the inversion's
        # (spacing 25), as 50 within 500 at full scale
        self.invert_steps, self.compose_steps = 40, 8
        torch.manual_seed(seed)
        self.model = I2VGenXLUNet(cfg).eval()
        if unet_state is not None:
            self.model.load_state_dict(unet_state, strict=True)
        rng = np.random.default_rng(seed)

        def mk(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

        self.mk = mk
        # the JAX harness's init inputs: drawn, so the later draws line up
        for shape in ((1, F, H, W, 4), (1, F, H, W, 4), (1, F, H, W, 4),
                      (1, F, cfg.cross_attention_dim), (1, 7, cfg.cross_attention_dim)):
            mk(*shape)
        self.ddim = DDIM(SchedulerConfig())
        self.inv_ts = np.asarray(inversion_timesteps(SchedulerConfig(), self.invert_steps))
        full_ts = sampling_timesteps(SchedulerConfig(), self.compose_steps)
        self.run_ts = np.asarray(full_ts[1:])
        self.full_ts = full_ts

        masks = np.zeros((self.n_obj, F, H, W), np.float32)
        masks[0, :, : H // 2] = 1.0
        masks[1, :, :, : W // 2] = 1.0
        self.masks = masks
        res = [(H, W), ((H + 1) // 2, (W + 1) // 2), ((H + 3) // 4, (W + 3) // 4)]
        self.pyr = {k: torch.as_tensor(v) for k, v in
                    pnp_lib.build_mask_pyramid(masks, res).items()}
        self.cw = pnp_lib.build_capture_weights(self.pyr, self.pyr, True)
        self.x0 = mk(F, H, W, 4)
        self.xT = mk(F, H, W, 4)
        self.cond1 = self._cond(1)
        self.condN = self._cond(self.n_obj + 3)
        self._sched = None
        self._memo: dict = {}

    def _cond(self, b):
        mk, d, F = self.mk, self.cfg.cross_attention_dim, self.F
        return self.core.UNetConditioning(
            encoder_hidden_states=mk(b, 7, d), image_latents_first=mk(b, F, self.H, self.W, 4),
            image_latents=mk(b, F, self.H, self.W, 4), image_embeddings=mk(b, F, d),
            fps=torch.full((b,), 8, dtype=torch.long))

    def unet(self, reuse_depth: Optional[int] = None, int8: bool = False):
        """The UNet (int8: a copy quantized with enable_int8's "full"
        selection, made once), with the partial-depth reuse bound."""
        model = self.model
        if int8:
            if not hasattr(self, "_q_model"):
                from mvoc_tpu_torch.ops import quantize

                self._q_model = copy.deepcopy(self.model)
                quantize.quantize_unet_(self._q_model, quantize.default_unet_predicate)
            model = self._q_model
        if reuse_depth:
            return functools.partial(model, encoder_reuse_depth=int(reuse_depth))
        return model

    def run_inversion(self, x0=None, **kw) -> np.ndarray:
        """The [S, F, h, w, C] trajectory; memoized per knob set on the
        default x0 (the exact baseline is shared across modes)."""
        key = ("inv",) + tuple(sorted(kw.items())) if x0 is None else None
        if key is not None and key in self._memo:
            return self._memo[key]
        kw = dict(kw)
        unet = self.unet(kw.pop("reuse_depth", None), kw.pop("int8", False))
        out = self.core.ddim_inversion_core(
            unet, self.ddim, self.x0 if x0 is None else x0, self.cond1, self.inv_ts,
            self.invert_steps, 1.0, **kw).numpy()
        if key is not None:
            self._memo[key] = out
        return out

    def sched(self):
        """The composite schedule from exact inversions of three sources
        (computed once)."""
        if self._sched is None:
            # three sources: x0 (the memoized exact inversion) and x0 -+ 0.1
            traj = [self.run_inversion()] + [self.run_inversion(x0=x)
                                             for x in (self.x0 + 0.1, self.x0 - 0.1)]
            idx_of = {int(t): i for i, t in enumerate(self.inv_ts)}
            sel = [idx_of[int(t)] for t in self.run_ts if int(t) in idx_of]
            if len(sel) != len(self.run_ts):
                raise ValueError("the composite's timesteps must be a subset of the inversion's")
            n_run = len(self.run_ts)
            bg = traj[0][sel]
            obj = np.stack([traj[1][sel], traj[2][sel]], axis=1)
            gates = self.pnp.injection_gates(self.full_ts, self.run_ts, self.compose_steps,
                                             0.8, 0.8, 0.8)
            self._sched = self.core.CompositeSchedule(
                bg_traj=torch.from_numpy(bg), obj_traj=torch.from_numpy(obj),
                obj_fusion_lat=torch.from_numpy(obj[0]),
                gate_spatial=np.asarray(gates["spatial"]),
                gate_temporal=np.asarray(gates["temporal"]),
                gate_conv=np.asarray(gates["conv"]),
                fusion_mask=np.array([i < 3 for i in range(n_run)]),
                timesteps=self.run_ts)
        return self._sched

    def run_composite(self, two_pass="stream", **kw) -> np.ndarray:
        """The final composite latents [F, h, w, C]; memoized per knob set."""
        key = ("comp", two_pass) + tuple(sorted(kw.items()))
        if key in self._memo:
            return self._memo[key]
        kw = dict(kw)
        unet = self.unet(kw.pop("reuse_depth", None), kw.pop("int8", False))
        out = self.core.pnp_composite_core(
            unet, self.ddim, self.xT, self.condN, self.sched(), torch.from_numpy(self.masks),
            self.pyr, self.pyr, num_inference_steps=self.compose_steps, guidance_scale=9.0,
            random_noise_ratio=0.5, two_pass=two_pass,
            capture_weights=self.cw if two_pass == "stream" else None, **kw).numpy()
        self._memo[key] = out
        return out


def approx_quality_report(composite_modes: Iterable = COMPOSITE_MODES,
                          inversion_modes: Iterable = INVERSION_MODES, seed: int = 0,
                          harness: Optional[_TinyHarness] = None) -> Dict[str, Dict[str, float]]:
    """Latent drift of every approximate mode against its exact baseline:
    PAB runs on the fused path (baseline: the exact fused composite), every
    other composite mode on the stream path (baseline: the exact stream
    composite); the inversion modes compare whole trajectories, and their
    last entries (x_T, which every later stage consumes) as xT_*."""
    h = harness if harness is not None else _TinyHarness(seed=seed)
    report: Dict[str, Dict[str, float]] = {}
    exact_stream = h.run_composite()
    for name, kw in composite_modes:
        kw = dict(kw)
        if kw.get("pab_interval", 1) > 1:
            report[name] = latent_metrics(h.run_composite(two_pass=False, **kw),
                                          h.run_composite(two_pass=False))
        else:
            report[name] = latent_metrics(h.run_composite(**kw), exact_stream)
    if inversion_modes:
        exact_traj = h.run_inversion()
        for name, kw in inversion_modes:
            traj = h.run_inversion(**dict(kw))
            m = latent_metrics(traj, exact_traj)
            m.update({("xT_" + k): v for k, v in latent_metrics(traj[-1], exact_traj[-1]).items()})
            report[name] = m
    return report
