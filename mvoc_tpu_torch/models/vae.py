"""AutoencoderKL (the SD-2.x VAE of the I2VGen-XL checkpoint) in PyTorch,
channels-last (counterpart of mvoc_tpu/models/vae.py).  Module names are
the diffusers keys.

encode returns the Gaussian moments; `sample_latents` takes its noise as
an argument (draw it from an explicit torch.Generator)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvoc_tpu_torch.models.layers import Conv2d, GroupNorm, sdpa


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def from_diffusers_config(cfg: dict[str, Any]) -> "VAEConfig":
        return VAEConfig(
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=cfg.get("layers_per_block", 2),
            latent_channels=cfg.get("latent_channels", 4),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            scaling_factor=cfg.get("scaling_factor", 0.18215),
        )

    @staticmethod
    def from_pretrained(checkpoint_dir: str) -> "VAEConfig":
        with open(os.path.join(checkpoint_dir, "vae", "config.json")) as f:
            return VAEConfig.from_diffusers_config(json.load(f))

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)


class VAEResnetBlock(nn.Module):
    """ResnetBlock2D without time embedding, GroupNorm eps 1e-6."""

    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over the spatial tokens, biased q/k/v,
    GroupNorm in front, residual.  The head dim is the channel count (512
    at full width), which K1 takes in its D = 512 instantiation."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        t = sdpa(self.to_q(t), self.to_k(t), self.to_v(t), heads=1)
        return self.to_out[0](t).reshape(b, h, w, c) + x


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=stride, padding=0 if stride == 2 else 1)


class _EncoderBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, n: int, groups: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(in_ch if j == 0 else ch, ch, groups)
                                      for j in range(n)])
        self.downsamplers = nn.ModuleList([_Sampler(ch, 2)]) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            # asymmetric right/bottom pad + stride-2 valid conv
            x = self.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        return x


class _DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, n: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(in_ch if j == 0 else ch, ch, groups)
                                      for j in range(n)])
        self.upsamplers = nn.ModuleList([_Sampler(ch, 1)]) if upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # nearest x2
            x = self.upsamplers[0].conv(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _EncoderBlock(chans[max(i - 1, 0)], ch, cfg.layers_per_block, g, i < len(chans) - 1)
            for i, ch in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _DecoderBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g, i < len(rev) - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """encode(x [B, H, W, 3]) -> (mean, logvar); decode(z) -> rgb."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = Conv2d(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))


def sample_latents(mean: torch.Tensor, logvar: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample with the noise passed in."""
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)


def tiled_decode(decode_fn, z: torch.Tensor, tile_latent: int = 64,
                 overlap_latent: int = 8) -> torch.Tensor:
    """Spatially tiled VAE decode with linear seam blending (counterpart of
    mvoc_tpu/models/vae.py: tiled_decode, the reference's enable_vae_tiling,
    pipeline_i2vgen_xl.py:520-550).  `decode_fn(z_tile) -> rgb_tile` on
    [B, h, w, C] latents.  Tiles of tile_latent start every tile_latent -
    overlap_latent latents, the last clamped to the edge; each is weighted
    by a linear ramp (+ 0.5 / k) over its overlapping borders, summed in
    fp32 and divided by the summed weight (at least 1e-8).  The JAX
    function decodes the first tile once more to learn the scale; here
    that decode is the first tile itself."""
    b, h, w, _ = z.shape
    if h <= tile_latent and w <= tile_latent:
        return decode_fn(z)
    stride = tile_latent - overlap_latent
    ys = sorted({min(y, max(h - tile_latent, 0))
                 for y in range(0, max(h - overlap_latent, 1), stride)})
    xs = sorted({min(x, max(w - tile_latent, 0))
                 for x in range(0, max(w - overlap_latent, 1), stride)})
    first = decode_fn(z[:, :min(tile_latent, h), :min(tile_latent, w)])
    scale = first.shape[1] // min(tile_latent, h)
    out = torch.zeros((b, h * scale, w * scale, first.shape[-1]), dtype=torch.float32,
                      device=first.device)
    weight = torch.zeros((1, h * scale, w * scale, 1), dtype=torch.float32, device=first.device)

    def ramp(n, lo_blend, hi_blend):
        wgt = np.ones(n, np.float32)
        k = overlap_latent * scale
        if lo_blend and k > 0:
            wgt[:k] = np.linspace(0.0, 1.0, k, endpoint=False) + 0.5 / k
        if hi_blend and k > 0:
            wgt[-k:] = wgt[-k:] * (np.linspace(1.0, 0.0, k, endpoint=False) + 0.5 / k)
        return wgt

    for y in ys:
        for x in xs:
            th, tw = min(tile_latent, h - y), min(tile_latent, w - x)
            tile = first if y == 0 and x == 0 else decode_fn(z[:, y:y + th, x:x + tw])
            wy = ramp(th * scale, y > 0, y + th < h)
            wx = ramp(tw * scale, x > 0, x + tw < w)
            wgt = torch.as_tensor(np.outer(wy, wx), device=first.device)[None, :, :, None]
            ys_, xs_ = slice(y * scale, (y + th) * scale), slice(x * scale, (x + tw) * scale)
            out[:, ys_, xs_] += tile.float() * wgt
            weight[:, ys_, xs_] += wgt
    return (out / weight.clamp_min(1e-8)).to(first.dtype)
