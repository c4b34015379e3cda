"""DDIM / DDIM-inverse schedulers (PyTorch counterpart of mvoc_tpu/ops/ddim.py).

The tables are host-side numpy; the step functions take a host timestep
(the sampling loops are plain Python loops, so `t` is always known on the
host) and do their tensor math in float32 whatever the model dtype, since
hundreds of inversion steps amplify rounding.

Timestep-spacing parity anchors: with 50 steps, `sampling_timesteps[0, 3,
9, 20] == [981, 921, 801, 581]` ("leading" spacing, steps_offset=1).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from mvoc_tpu_torch.config import dataclass_from_json


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    prediction_type: str = "epsilon"  # epsilon | sample | v_prediction
    timestep_spacing: str = "leading"  # leading | trailing | linspace
    rescale_betas_zero_snr: bool = False

    @staticmethod
    def from_json(path: str) -> "SchedulerConfig":
        """A diffusers scheduler_config.json; keys that are not fields are dropped."""
        return dataclass_from_json(SchedulerConfig, path)

    @staticmethod
    def from_pretrained(checkpoint_dir: str) -> "SchedulerConfig":
        return SchedulerConfig.from_json(
            os.path.join(checkpoint_dir, "scheduler", "scheduler_config.json"))


def _betas(cfg: SchedulerConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array(
            [min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999) for i in range(n)],
            dtype=np.float64)
    raise ValueError(f"unknown beta_schedule: {cfg.beta_schedule}")


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """diffusers.rescale_zero_terminal_snr operating on sqrt(alpha-bar)."""
    ab_sqrt = np.sqrt(alphas_cumprod)
    ab_sqrt_0, ab_sqrt_t = ab_sqrt[0], ab_sqrt[-1]
    ab_sqrt = ab_sqrt - ab_sqrt_t
    ab_sqrt = ab_sqrt * ab_sqrt_0 / (ab_sqrt_0 - ab_sqrt_t)
    return ab_sqrt**2


def alphas_cumprod_table(cfg: SchedulerConfig) -> np.ndarray:
    """float64 table of alpha-bar_t, t in [0, num_train_timesteps)."""
    acp = np.cumprod(1.0 - _betas(cfg), axis=0)
    if cfg.rescale_betas_zero_snr:
        acp = _rescale_zero_terminal_snr(acp)
    return acp


def sampling_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending timesteps for DDIM sampling (diffusers DDIMScheduler.set_timesteps)."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return ts + cfg.steps_offset
    if cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        return np.round(np.arange(n, 0, -step_ratio)).astype(np.int64) - 1
    if cfg.timestep_spacing == "linspace":
        return np.linspace(0, n - 1, num_inference_steps).round()[::-1].astype(np.int64)
    raise ValueError(f"unknown timestep_spacing: {cfg.timestep_spacing}")


def inversion_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Ascending timesteps for DDIM inversion (diffusers DDIMInverseScheduler)."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
        return ts + cfg.steps_offset
    if cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        return np.round(np.arange(n, 0, -step_ratio))[::-1].astype(np.int64) - 1
    if cfg.timestep_spacing == "linspace":
        return np.linspace(0, n - 1, num_inference_steps).round().astype(np.int64)
    raise ValueError(f"unknown timestep_spacing: {cfg.timestep_spacing}")


class DDIM:
    """alpha-bar table plus the sampling / inversion / noising updates.

    Alphas are looked up on the host as float32 scalars; a timestep below 0
    takes the boundary value (`final_alpha_cumprod` for sampling,
    `initial_alpha_cumprod` = 1 for inversion, as diffusers >= 0.26)."""

    def __init__(self, cfg: SchedulerConfig):
        self.config = cfg
        self.alphas_cumprod = alphas_cumprod_table(cfg).astype(np.float32)
        self.final_alpha_cumprod = np.float32(
            1.0 if cfg.set_alpha_to_one else self.alphas_cumprod[0])
        self.initial_alpha_cumprod = np.float32(1.0)
        self.init_noise_sigma = 1.0

    def _alpha_at(self, t: int, boundary: np.float32) -> np.float32:
        t = int(t)
        if t < 0:
            return boundary
        return self.alphas_cumprod[min(t, self.config.num_train_timesteps - 1)]

    def _predict_x0_eps(self, sample, model_output, alpha_prod_t):
        sample = sample.float()
        model_output = model_output.float()
        a = np.float32(alpha_prod_t)
        sa, sb = float(np.sqrt(a)), float(np.sqrt(np.float32(1.0) - a))
        p = self.config.prediction_type
        if p == "epsilon":
            x0 = (sample - sb * model_output) / sa
            eps = model_output
        elif p == "sample":
            x0 = model_output
            eps = (sample - sa * x0) / sb
        elif p == "v_prediction":
            x0 = sa * sample - sb * model_output
            eps = sa * model_output + sb * sample
        else:
            raise ValueError(f"unknown prediction_type: {p}")
        if self.config.clip_sample:
            # diffusers clips x0 after deriving eps and does not recompute eps
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
        return x0, eps

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             num_inference_steps: int, eta: float = 0.0,
             noise: torch.Tensor | None = None) -> torch.Tensor:
        """diffusers DDIMScheduler.step(...).prev_sample.  eta > 0 adds
        `noise` (drawn by the caller) scaled by eta times the DDIM sigma."""
        t = int(timestep)
        prev_t = t - self.config.num_train_timesteps // num_inference_steps
        a_t = self._alpha_at(t, self.final_alpha_cumprod)
        a_prev = self._alpha_at(prev_t, self.final_alpha_cumprod)
        x0, eps = self._predict_x0_eps(sample, model_output, a_t)
        std = np.float32(0.0)
        if eta > 0.0:
            variance = (np.float32(1.0) - a_prev) / (np.float32(1.0) - a_t) * (
                np.float32(1.0) - a_t / a_prev)
            std = np.float32(eta) * np.sqrt(variance)
        direction = float(np.sqrt(np.float32(1.0) - a_prev - std**2))
        prev = float(np.sqrt(a_prev)) * x0 + direction * eps
        if eta > 0.0:
            if noise is None:
                raise ValueError("eta > 0 requires noise")
            prev = prev + float(std) * noise.float()
        return prev.to(sample.dtype)

    def inverse_step(self, model_output: torch.Tensor, timestep: int,
                     sample: torch.Tensor, num_inference_steps: int) -> torch.Tensor:
        """diffusers DDIMInverseScheduler.step(...).prev_sample: `timestep`
        is the target (noisier) t; the sample sits N//steps below it."""
        t_to = int(timestep)
        t_from = min(t_to - self.config.num_train_timesteps // num_inference_steps,
                     self.config.num_train_timesteps - 1)
        a_from = self._alpha_at(t_from, self.initial_alpha_cumprod)
        a_to = self._alpha_at(t_to, self.initial_alpha_cumprod)
        x0, eps = self._predict_x0_eps(sample, model_output, a_from)
        nxt = float(np.sqrt(a_to)) * x0 + float(np.sqrt(np.float32(1.0) - a_to)) * eps
        return nxt.to(sample.dtype)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timestep: int) -> torch.Tensor:
        a = self._alpha_at(timestep, self.final_alpha_cumprod)
        out = (float(np.sqrt(a)) * original.float()
               + float(np.sqrt(np.float32(1.0) - a)) * noise.float())
        return out.to(original.dtype)
