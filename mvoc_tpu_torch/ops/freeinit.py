"""FreeInit-style frequency-domain noise re-initialisation (the port's copy
of mvoc_tpu/ops/freeinit.py).

The reference ships a dormant `frameinit_kwargs` config block (a gaussian
spatio-temporal low-pass with cutoffs d_s / d_t and a noise_level): the
FreeInit technique, which keeps the low-frequency band of a diffused latent
and refills the high frequencies with fresh noise.  Pure functions over
[F, H, W, C] latents on torch.fft.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch


def _freq_grid(f: int, h: int, w: int, device=None):
    """Normalised centred frequency coordinates per axis, [F, H, W] each."""
    def axis(n):
        return (torch.arange(n, device=device, dtype=torch.float32) - (n - 1) / 2) / max(n / 2, 1e-8)

    return torch.meshgrid(axis(f), axis(h), axis(w), indexing="ij")


def lowpass_mask(f: int, h: int, w: int, d_s: float = 0.25, d_t: float = 0.25,
                 method: Literal["gaussian", "ideal", "butterworth"] = "gaussian",
                 order: int = 4, device=None) -> torch.Tensor:
    """The spatio-temporal low-pass mask, fftshift-centred, [F, H, W]."""
    t, y, x = _freq_grid(f, h, w, device)
    if d_s <= 0 or d_t <= 0:
        return torch.zeros((f, h, w), device=device)
    r2 = (x / d_s) ** 2 + (y / d_s) ** 2 + (t / d_t) ** 2
    if method == "gaussian":
        return torch.exp(-0.5 * r2)
    if method == "ideal":
        return (r2 <= 1.0).float()
    if method == "butterworth":
        return 1.0 / (1.0 + r2 ** order)
    raise ValueError(f"unknown filter method {method}")


def freq_mix(latents: torch.Tensor, noise: torch.Tensor, lp_mask: torch.Tensor) -> torch.Tensor:
    """low-frequency(latents) + high-frequency(noise) over the (F, H, W)
    axes; latents, noise [F, H, W, C], lp_mask [F, H, W]."""
    m = lp_mask[..., None]
    dims = (0, 1, 2)
    lf = torch.fft.fftshift(torch.fft.fftn(latents.float().to(torch.complex64), dim=dims), dim=dims)
    hf = torch.fft.fftshift(torch.fft.fftn(noise.float().to(torch.complex64), dim=dims), dim=dims)
    mixed = lf * m + hf * (1.0 - m)
    out = torch.fft.ifftn(torch.fft.ifftshift(mixed, dim=dims), dim=dims)
    return out.real.to(latents.dtype)


def frameinit(latents: torch.Tensor, alphas_cumprod, noise_level: int = 850,
              d_s: float = 0.25, d_t: float = 0.25, method: str = "gaussian",
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference config's entry: diffuse `latents` to `noise_level`, keep
    their low-frequency band and refill the high frequencies with the same
    noise.  The noise is `noise` when given (the JAX package draws it from
    a jax.random key, which torch cannot reproduce), else drawn from
    `generator`."""
    f, h, w, _ = latents.shape
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                            dtype=torch.float32)
    noise = noise.float()
    a = torch.as_tensor(alphas_cumprod, device=latents.device, dtype=torch.float32)[noise_level]
    diffused = torch.sqrt(a) * latents.float() + torch.sqrt(1 - a) * noise
    mask = lowpass_mask(f, h, w, d_s=d_s, d_t=d_t, method=method, device=latents.device)
    return freq_mix(diffused, noise, mask).to(latents.dtype)
