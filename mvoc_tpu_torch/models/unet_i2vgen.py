"""I2VGen-XL 3D UNet in PyTorch (counterpart of mvoc_tpu/models/unet_i2vgen.py).

Channels-last public tensors; module names are the diffusers I2VGenXLUNet
keys.  Covers the per-frame 145-token context (77 text + 64 image-latent +
4 CLIP-image tokens), the image-latents temporal encoder, time + fps
embeddings, all down / mid / up blocks, and the PnP injection and capture
sites of the up blocks.

PnP capture: with `pnp_capture=True` and a PnPState (carrying the branch's
capture weights on the stream path; without them, over the N+1 source
branches as one batch) the forward returns `(eps, features)`, `features`
being a plain dict site_id -> tensor or (q, k) of the pre-composited S or
one branch's term of it (the flax package sows the same values into a
mutable collection).

Device mesh (parallel/mesh.py; `I2VGenXLPipeline.enable_mesh` sets it): with
`config.attn_mesh` larger than one rank, the forward takes whole (replicated)
inputs on every rank, runs this rank's frames of the "seq" axis when the
frame count divides it (else every frame, on every rank), and all-gathers
the predicted noise, so every rank returns the full result.  The frame-0
context, the temporal layers and the PnP masks see global frames; what the
forward returns besides the noise (PnP features, the encoder cache, the PAB
dict) stays this rank's block, and only a forward on the same mesh and frame
count reads it back.  `config.temporal_cp` ("ring" / "ulysses") runs the
temporal attention as context parallelism over "seq".

Profiling (`utils.profiling.span`: recorded only while a torch profiler
records): the forward runs inside the span `I2VGenXLUNet`, each top-level
child inside `I2VGenXLUNet/<child>` (`conv_in`, `down_blocks.0`,
`mid_block`, `up_blocks.3`, ...), which an active `utils.flops.FlopCounter`
books its operations to, and each sub-block of a down, mid or up block
inside `I2VGenXLUNet/<child>/<sub>` (`resnets.i`, `temp_convs.i`,
`attentions.i`, `temp_attentions.i`, `downsamplers.0`, `upsamplers.0`).
`utils.profiling.device_op_breakdown` books device time under all of them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from mvoc_tpu_torch import pnp as pnp_lib
from mvoc_tpu_torch.parallel import mesh as pm
from mvoc_tpu_torch.utils import flops
from mvoc_tpu_torch.utils.profiling import UNET_SCOPE, span
from mvoc_tpu_torch.models.layers import (
    Attention,
    Conv2d,
    Downsample2D,
    FeedForward,
    GroupNorm,
    LayerNorm,
    ResnetBlock2D,
    TemporalConvLayer,
    TimestepEmbedding,
    Transformer2DModel,
    TransformerTemporalModel,
    Upsample2D,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64  # heads = block_channels // this
    transformer_in_heads: int = 8
    transformer_in_head_dim: Optional[int] = None  # None = attention_head_dim
    img_temporal_encoder_heads: int = 2
    img_temporal_encoder_head_dim: Optional[int] = None  # None = in_channels
    norm_eps: float = 1e-5
    temporal_window: Optional[int] = None
    ff_chunk_rows: int = 32768
    temporal_natural_layout: bool = False
    site_map: Optional[Any] = None  # pnp.SiteMap; None = I2VGEN_SITES
    # context parallelism of the temporal attention over the mesh's "seq"
    # axis: "ring" or "ulysses" (ops/ring_attention); it overrides the
    # natural layout (layers.effective_natural_layout)
    temporal_cp: Optional[str] = None
    # the active device mesh (parallel/mesh.Mesh; pipeline.enable_mesh sets
    # it): the forward then runs each rank on its frames of "seq"
    attn_mesh: Optional[Any] = None

    @property
    def sites(self) -> pnp_lib.SiteMap:
        return self.site_map if self.site_map is not None else pnp_lib.I2VGEN_SITES

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_for(self, channels: int) -> int:
        # the diffusers quirk: heads = channels // attention_head_dim, so the
        # per-head dim is attention_head_dim at every block width
        assert channels % self.attention_head_dim == 0
        return channels // self.attention_head_dim

    @staticmethod
    def from_diffusers_config(cfg: dict[str, Any]) -> "UNetConfig":
        """The seven keys of a diffusers I2VGenXLUNet config.json that shape the
        modules; the rest stay at their defaults (the transformer_in and
        temporal-encoder head counts are diffusers constants, not config keys:
        models/convert.py: infer_unet_geometry derives their head dims)."""
        return UNetConfig(
            in_channels=cfg.get("in_channels", 4),
            out_channels=cfg.get("out_channels", 4),
            block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
            layers_per_block=cfg.get("layers_per_block", 2),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            cross_attention_dim=cfg.get("cross_attention_dim", 1024),
            attention_head_dim=cfg.get("attention_head_dim", 64),
        )

    @staticmethod
    def from_pretrained(checkpoint_dir: str) -> "UNetConfig":
        with open(os.path.join(checkpoint_dir, "unet", "config.json")) as f:
            return UNetConfig.from_diffusers_config(json.load(f))

    @staticmethod
    def tiny() -> "UNetConfig":
        """Small config for tests."""
        return UNetConfig(block_out_channels=(8, 16, 32, 32), norm_num_groups=4,
                          cross_attention_dim=16, attention_head_dim=4, transformer_in_heads=2)


@dataclasses.dataclass(frozen=True)
class FreeUConfig:
    """FreeU up-block re-weighting (the reference's enable_freeu passthrough):
    b1 / b2 amplify the backbone features, s1 / s2 scale the Fourier low band
    of the skip features, in up blocks 0 and 1."""

    s1: float = 0.9
    s2: float = 0.2
    b1: float = 1.1
    b2: float = 1.2


def _fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred low-frequency box of the spatial FFT of x [BF, H, W,
    C] (channels-last) by `scale`: FreeU's skip filter."""
    _, h, w, _ = x.shape
    xf = torch.fft.fftshift(torch.fft.fft2(x.float().to(torch.complex64), dim=(1, 2)), dim=(1, 2))
    yy = (torch.arange(h, device=x.device) - h // 2).abs() < threshold
    xx = (torch.arange(w, device=x.device) - w // 2).abs() < threshold
    mask = torch.where(yy[:, None] & xx[None, :], scale, 1.0)
    xf = xf * mask[None, :, :, None]
    out = torch.fft.ifft2(torch.fft.ifftshift(xf, dim=(1, 2)), dim=(1, 2))
    return out.real.to(x.dtype)


def apply_freeu(block_index: int, hidden: torch.Tensor, skip: torch.Tensor,
                freeu: Optional[FreeUConfig]):
    """(hidden, skip) re-weighted at the start of each layer of up blocks 0
    and 1; unchanged elsewhere and without a config."""
    if freeu is None or block_index > 1:
        return hidden, skip
    b = freeu.b1 if block_index == 0 else freeu.b2
    s = freeu.s1 if block_index == 0 else freeu.s2
    c = hidden.shape[-1]
    scale = torch.cat([torch.full((c // 2,), b, dtype=hidden.dtype, device=hidden.device),
                       torch.ones((c - c // 2,), dtype=hidden.dtype, device=hidden.device)])
    return hidden * scale, _fourier_filter(skip, threshold=1, scale=s)


# ---------------------------------------------------------------------------
# PnP edit / capture hooks
# ---------------------------------------------------------------------------
#
# Four uses of an injection site: the fused path injects (pnp, no capture);
# the two-pass paths capture on the source branches and their edit pass
# consumes the summed, pre-composited S (pnp.mode == "consume_pre").
# two_pass=True captures S over the N+1 source branches as one batch
# (pnp.capture_weight None: precomposite_*); the stream path captures one
# branch at a time, its weighted term x * M_b (pnp.capture_weight set),
# summed over the branches by the caller.


def _need_pnp(pnp):
    if pnp is None:
        raise ValueError("capture needs a PnPState: two_pass=True captures the pre-composited "
                         "S, the stream path (capture_weight set) one branch's term of it")


def _streamed(pnp) -> bool:
    _need_pnp(pnp)
    return pnp.capture_weight is not None


def _spatial_qk_edit(pnp, h, w, site_id, rec):
    if rec is not None:
        stream = _streamed(pnp)

        def cap(q, k):
            rec[site_id] = (pnp_lib.stream_capture_spatial(q, k, pnp, h, w) if stream
                            else pnp_lib.precomposite_spatial(q, k, pnp, h, w))
            return q, k
        return cap
    if pnp is None:
        return None
    if pnp.mode == "consume_pre":
        sq, sk = pnp.features[site_id]
        return lambda q, k: pnp_lib.consume_spatial_precomposited(q, k, sq, sk, pnp, h, w)
    return lambda q, k: pnp_lib.inject_spatial_qk(q, k, pnp, h, w)


def _temporal_qk_edit(pnp, h, w, site_id, rec, natural: bool):
    if natural:
        return _temporal_qk_edit_natural(pnp, h, w, site_id, rec)
    if rec is not None:
        stream = _streamed(pnp)

        def cap(q, k):
            rec[site_id] = (pnp_lib.stream_capture_temporal(q, k, pnp, h, w) if stream
                            else pnp_lib.precomposite_temporal(q, k, pnp, h, w))
            return q, k
        return cap
    if pnp is None:
        return None
    if pnp.mode == "consume_pre":
        sq, sk = pnp.features[site_id]
        return lambda q, k: pnp_lib.consume_temporal_precomposited(q, k, sq, sk, pnp, h, w)
    return lambda q, k: pnp_lib.inject_temporal_qk(q, k, pnp, h, w)


def _temporal_qk_edit_natural(pnp, h, w, site_id, rec):
    """Temporal edit for frame-major tokens [B, F, hw, C]: flattening (B, F)
    gives exactly the spatial layout, so the spatial functions apply with
    the soft masks and the temporal gate."""

    def flat(fn):
        def wrapped(q, k):
            B, f, hw, c = q.shape
            q2, k2 = fn(q.reshape(B * f, hw, c), k.reshape(B * f, hw, c))
            return q2.reshape(B, f, hw, c), k2.reshape(B, f, hw, c)
        return wrapped

    if rec is not None:
        stream = _streamed(pnp)

        def cap(q, k):
            B, f, hw, c = q.shape
            q2, k2 = q.reshape(B * f, hw, c), k.reshape(B * f, hw, c)
            rec[site_id] = (pnp_lib.stream_capture_temporal_natural(q2, k2, pnp, h, w) if stream
                            else pnp_lib.precomposite_spatial(q2, k2, pnp, h, w, soft=True))
            return q, k
        return cap
    if pnp is None:
        return None
    gate = pnp.gate_temporal
    if pnp.mode == "consume_pre":
        sq, sk = pnp.features[site_id]
        return flat(lambda q2, k2: pnp_lib.consume_spatial_precomposited(
            q2, k2, sq, sk, pnp, h, w, soft=True, gate=gate))
    return flat(lambda q2, k2: pnp_lib.inject_spatial_qk(q2, k2, pnp, h, w, soft=True, gate=gate))


def _conv_edit(pnp, h, w, site_id, rec):
    if rec is not None:
        stream = _streamed(pnp)

        def cap(x):
            rec[site_id] = (pnp_lib.stream_capture_conv(x, pnp, h, w) if stream
                            else pnp_lib.precomposite_conv(x, pnp, h, w))
            return x
        return cap
    if pnp is None:
        return None
    if pnp.mode == "consume_pre":
        return lambda x: pnp_lib.consume_conv_precomposited(x, pnp.features[site_id], pnp, h, w)
    return lambda x: pnp_lib.inject_conv_features(x, pnp, h, w)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class _Sub:
    """Runs a block's sub-blocks inside their spans, named
    `I2VGenXLUNet/<child>/<sub>` from the block's child name."""

    def _sub(self, sub: str, module, *args, **kwargs):
        with span(f"{UNET_SCOPE}{self.child}/{sub}"):
            return module(*args, **kwargs)


class _Block3D(_Sub, nn.Module):
    """resnets + temp_convs (+ attentions + temp_attentions with cross_attn)
    per layer; the shared body of the down and up blocks."""

    def __init__(self, cfg: UNetConfig, in_channels: list[int], out_channels: int,
                 cross_attn: bool, child: str):
        super().__init__()
        self.child = child
        temb = cfg.time_embed_dim
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList([
            ResnetBlock2D(c, out_channels, temb, eps=eps, groups=g) for c in in_channels])
        self.temp_convs = nn.ModuleList([
            TemporalConvLayer(out_channels, out_channels, groups=g) for _ in in_channels])
        if cross_attn:
            heads = cfg.heads_for(out_channels)
            self.attentions = nn.ModuleList([
                Transformer2DModel(out_channels, heads, cfg.attention_head_dim,
                                   cfg.cross_attention_dim, norm_num_groups=g,
                                   ff_chunk_rows=cfg.ff_chunk_rows)
                for _ in in_channels])
            self.temp_attentions = nn.ModuleList([
                TransformerTemporalModel(out_channels, heads, cfg.attention_head_dim,
                                         norm_num_groups=g, window=cfg.temporal_window,
                                         ff_chunk_rows=cfg.ff_chunk_rows,
                                         natural_layout=cfg.temporal_natural_layout)
                for _ in in_channels])
        else:
            self.attentions = None


class DownBlock3D(_Block3D):
    def __init__(self, cfg, in_channels: int, out_channels: int, add_downsample: bool,
                 cross_attn: bool, child: str = "down_blocks"):
        ins = [in_channels] + [out_channels] * (cfg.layers_per_block - 1)
        super().__init__(cfg, ins, out_channels, cross_attn, child)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context, num_frames):
        res = []
        for i in range(len(self.resnets)):
            x = self._sub(f"resnets.{i}", self.resnets[i], x, temb)
            x = self._sub(f"temp_convs.{i}", self.temp_convs[i], x, num_frames)
            if self.attentions is not None:
                x = self._sub(f"attentions.{i}", self.attentions[i], x, context)
                x = self._sub(f"temp_attentions.{i}", self.temp_attentions[i], x, num_frames)
            res.append(x)
        if self.downsamplers is not None:
            x = self._sub("downsamplers.0", self.downsamplers[0], x)
            res.append(x)
        return x, res


class UNetMidBlock3DCrossAttn(_Sub, nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        self.child = "mid_block"
        heads = cfg.heads_for(channels)
        g, eps, temb = cfg.norm_num_groups, cfg.norm_eps, cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb, eps=eps, groups=g) for _ in range(2)])
        self.temp_convs = nn.ModuleList([
            TemporalConvLayer(channels, channels, groups=g) for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(channels, heads, cfg.attention_head_dim, cfg.cross_attention_dim,
                               norm_num_groups=g, ff_chunk_rows=cfg.ff_chunk_rows)])
        self.temp_attentions = nn.ModuleList([
            TransformerTemporalModel(channels, heads, cfg.attention_head_dim, norm_num_groups=g,
                                     window=cfg.temporal_window,
                                     ff_chunk_rows=cfg.ff_chunk_rows,
                                     natural_layout=cfg.temporal_natural_layout)])

    def forward(self, x, temb, context, num_frames):
        x = self._sub("resnets.0", self.resnets[0], x, temb)
        x = self._sub("temp_convs.0", self.temp_convs[0], x, num_frames)
        x = self._sub("attentions.0", self.attentions[0], x, context)
        x = self._sub("temp_attentions.0", self.temp_attentions[0], x, num_frames)
        x = self._sub("resnets.1", self.resnets[1], x, temb)
        return self._sub("temp_convs.1", self.temp_convs[1], x, num_frames)


class UpBlock3D(_Block3D):
    def __init__(self, cfg, prev_channels: int, skip_channels: list[int], out_channels: int,
                 add_upsample: bool, cross_attn: bool, block_index: int):
        ins = [(prev_channels if j == 0 else out_channels) + s for j, s in enumerate(skip_channels)]
        super().__init__(cfg, ins, out_channels, cross_attn, f"up_blocks.{block_index}")
        self.block_index = block_index
        self.natural = cfg.temporal_natural_layout
        self.sites = cfg.sites
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_samples, temb, context, num_frames, upsample_size=None,
                pnp=None, capture=None, freeu=None, pab_cache=None, pab_rec=None):
        """pab_cache / pab_rec: the PAB cache to read and the dict to record
        into (attention sublayers keyed sp{block}_{layer} / tm{block}_{layer});
        only the cross-attention up blocks have attention to broadcast."""
        bi, sites = self.block_index, self.sites
        pab_on = pab_cache is not None or pab_rec is not None
        for i in range(len(self.resnets)):
            x, skip = apply_freeu(bi, x, res_samples[-1 - i], freeu)
            x = torch.cat([x, skip], dim=-1)
            hc, wc = x.shape[1], x.shape[2]
            x = self._sub(f"resnets.{i}", self.resnets[i], x, temb, pnp_edit=_conv_edit(
                pnp, hc, wc, f"resnet_{bi}_{i}", capture) if i in sites.resnet_at(bi) else None)
            x = self._sub(f"temp_convs.{i}", self.temp_convs[i], x, num_frames,
                          pnp_edit=_conv_edit(pnp, hc, wc, f"tconv_{bi}_{i}", capture)
                          if i in sites.temp_conv_at(bi) else None)
            if self.attentions is not None:
                x = self._sub(f"attentions.{i}", self.attentions[i], x, context,
                              attn1_qk_edit=_spatial_qk_edit(
                                  pnp, hc, wc, f"spatial_{bi}_{i}", capture)
                              if i in sites.spatial_at(bi) else None,
                              pab=(pab_cache, pab_rec, f"sp{bi}_{i}") if pab_on else None)
                x = self._sub(f"temp_attentions.{i}", self.temp_attentions[i], x, num_frames,
                              attn1_qk_edit=_temporal_qk_edit(
                                  pnp, hc, wc, f"temporal_{bi}_{i}", capture, self.natural)
                              if i in sites.temporal_at(bi) else None,
                              pab=(pab_cache, pab_rec, f"tm{bi}_{i}") if pab_on else None)
        if self.upsamplers is not None:
            x = self._sub("upsamplers.0", self.upsamplers[0], x, upsample_size)
        return x


class ImageLatentsTemporalEncoder(nn.Module):
    """LN -> self-attention -> + residual -> FF(gelu) -> + residual, over
    [B*H*W, F, C=in_channels] tokens."""

    def __init__(self, dim: int, heads: int, head_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim or dim, temporal=True)
        self.ff = FeedForward(dim, inner_dim=dim * 4, activation="gelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        return self.ff(x) + x


def _scope(child: str):
    """The span of one top-level child of the UNet forward (and the module an
    active operation counter books to)."""
    if flops.COUNTER is None:
        return span(f"{UNET_SCOPE}{child}")
    return flops.COUNTER.scope(child, span(f"{UNET_SCOPE}{child}"))


class I2VGenXLUNet(nn.Module):
    """forward(sample [B, F, H, W, C_in], timestep, fps, image_latents_first
    [B, F, H, W, C_in], image_latents [B, F, H, W, C_in], image_embeddings
    [B, F, D_img], encoder_hidden_states [B, 77, D_ctx], pnp=None)
    -> predicted noise [B, F, H, W, C_out]."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        c_in, ch0, temb = cfg.in_channels, cfg.block_out_channels[0], cfg.time_embed_dim
        d_ctx = cfg.cross_attention_dim
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.fps_embedding = TimestepEmbedding(ch0, temb)
        # nn.Sequential layouts of the diffusers modules, activations and the
        # pool as placeholders so the parameter indices match
        self.image_latents_context_embedding = nn.ModuleList([
            Conv2d(c_in, c_in * 8, 3, padding=1), nn.SiLU(), nn.Identity(),
            Conv2d(c_in * 8, c_in * 16, 3, stride=2, padding=1), nn.SiLU(),
            Conv2d(c_in * 16, d_ctx, 3, stride=2, padding=1)])
        self.context_embedding = nn.ModuleList([
            nn.Linear(d_ctx, temb), nn.SiLU(), nn.Linear(temb, d_ctx * c_in)])
        self.image_latents_proj_in = nn.ModuleList([
            Conv2d(c_in, c_in * 4, 1), nn.SiLU(), Conv2d(c_in * 4, c_in * 4, 3, padding=1),
            nn.SiLU(), Conv2d(c_in * 4, c_in, 3, padding=1)])
        self.image_latents_temporal_encoder = ImageLatentsTemporalEncoder(
            c_in, cfg.img_temporal_encoder_heads, cfg.img_temporal_encoder_head_dim)
        self.conv_in = Conv2d(c_in * 2, ch0, 3, padding=1)
        self.transformer_in = TransformerTemporalModel(
            ch0, cfg.transformer_in_heads, cfg.transformer_in_head_dim or cfg.attention_head_dim,
            norm_num_groups=cfg.norm_num_groups, window=cfg.temporal_window,
            ff_chunk_rows=cfg.ff_chunk_rows, natural_layout=cfg.temporal_natural_layout)

        chans = cfg.block_out_channels
        n = len(chans)
        self.down_blocks = nn.ModuleList()
        prev = ch0
        for i, out_ch in enumerate(chans):
            final = i == n - 1
            self.down_blocks.append(DownBlock3D(cfg, prev, out_ch, add_downsample=not final,
                                                cross_attn=not final, child=f"down_blocks.{i}"))
            prev = out_ch
        self.mid_block = UNetMidBlock3DCrossAttn(cfg, chans[-1])
        rev = tuple(reversed(chans))
        n_up = cfg.layers_per_block + 1
        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(rev):
            prev_out = rev[max(i - 1, 0)]
            in_ch = rev[min(i + 1, n - 1)]
            skips = [out_ch] * (n_up - 1) + [in_ch]
            self.up_blocks.append(UpBlock3D(cfg, prev_out, skips, out_ch,
                                            add_upsample=i < n - 1, cross_attn=i > 0,
                                            block_index=i))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch0, eps=cfg.norm_eps, silu=True)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)
        if cfg.temporal_cp is not None:
            self.set_parallel(cfg.attn_mesh, cfg.temporal_cp)

    def set_parallel(self, mesh, temporal_cp: Optional[str] = None) -> None:
        """Thread a mesh (None: none) and the temporal context parallelism
        into the config and every temporal block, in place (the JAX package
        rebuilds its stateless modules from the new config)."""
        if temporal_cp not in (None, "ring", "ulysses"):
            raise ValueError(f"context_parallel {temporal_cp!r}: 'ring' or 'ulysses'")
        self.config = dataclasses.replace(self.config, attn_mesh=mesh, temporal_cp=temporal_cp)
        natural = None
        for m in self.modules():
            if isinstance(m, TransformerTemporalModel):
                m.set_context_parallel(temporal_cp)
                natural = m.natural_layout
        for blk in self.up_blocks:
            blk.natural = natural if natural is not None else blk.natural

    @property
    def dtype(self) -> torch.dtype:
        # a norm's weight: it keeps the model dtype when convs quantize to int8
        return self.conv_norm_out.weight.dtype

    def _context(self, b, f, h, w, image_latents, image_embeddings, encoder_hidden_states,
                 multi_frame_guidance: bool = False):
        """Per-frame context [B*F, 77 + 64 + C_in, D]: from frame 0's image
        embedding and image latents (the reference's default), or with
        multi_frame_guidance from every frame's."""
        c_in, d_ctx = self.config.in_channels, self.config.cross_attention_dim
        if not multi_frame_guidance:
            image_embeddings = image_embeddings[:, 0:1].expand(b, f, image_embeddings.shape[-1])
        n_ctx = f if multi_frame_guidance else 1
        ce = self.image_latents_context_embedding
        with _scope("image_latents_context_embedding"):
            il = image_latents[:, :n_ctx].reshape(b * n_ctx, h, w, c_in)
            il = F.silu(ce[0](il))
            il = F.adaptive_avg_pool2d(il.permute(0, 3, 1, 2).float(), (32, 32))
            il = il.permute(0, 2, 3, 1).to(self.dtype)
            il = ce[5](F.silu(ce[3](il)))
        n_tok = il.shape[1] * il.shape[2]
        il_tokens = il.reshape(b, n_ctx, n_tok, d_ctx).expand(b, f, n_tok, d_ctx)
        with _scope("context_embedding"):
            ie = self.context_embedding[2](F.silu(self.context_embedding[0](image_embeddings)))
        ie_tokens = ie.reshape(b, f, c_in, d_ctx)
        text = encoder_hidden_states[:, None].expand((b, f) + encoder_hidden_states.shape[1:])
        ctx = torch.cat([text, il_tokens, ie_tokens], dim=2)
        return ctx.reshape(b * f, -1, d_ctx)

    def _entries_before_block(self, k: int) -> int:
        """Skip-stack entries made before down block k: the conv_in /
        transformer_in entry, then layers_per_block per block (+1 for each
        downsampler)."""
        cfg = self.config
        n_blocks = len(cfg.block_out_channels)
        return 1 + sum(cfg.layers_per_block + (1 if i < n_blocks - 1 else 0) for i in range(k))

    def forward(self, sample, timestep, fps, image_latents_first, image_latents,
                image_embeddings, encoder_hidden_states,
                pnp: Optional[pnp_lib.PnPState] = None, pnp_capture: bool = False,
                multi_frame_guidance: bool = False, freeu: Optional[FreeUConfig] = None,
                cached_encoder: Optional[tuple] = None, return_encoder: bool = False,
                encoder_reuse_depth: Optional[int] = None, pab_cache: Optional[dict] = None,
                pab_capture: bool = False):
        """See _forward; on a mesh, this rank's frames in and all frames out."""
        kw = dict(pnp=pnp, pnp_capture=pnp_capture, multi_frame_guidance=multi_frame_guidance,
                  freeu=freeu, cached_encoder=cached_encoder, return_encoder=return_encoder,
                  encoder_reuse_depth=encoder_reuse_depth, pab_cache=pab_cache,
                  pab_capture=pab_capture)
        mesh = self.config.attn_mesh
        with span("I2VGenXLUNet"):
            if mesh is None or mesh.size == 1:
                return self._forward(sample, timestep, fps, image_latents_first, image_latents,
                                     image_embeddings, encoder_hidden_states, **kw)
            f, seq = sample.shape[1], mesh.size_of(pm.SEQ_AXIS)
            fs = pm.FrameShard(mesh, f, seq > 1 and f % seq == 0)
            if fs.sharded:
                lo, hi = fs.offset, fs.offset + fs.local
                sample, image_latents_first = sample[:, lo:hi], image_latents_first[:, lo:hi]
                if multi_frame_guidance:  # every frame's context, else frame 0's (global)
                    image_latents = image_latents[:, lo:hi]
                    image_embeddings = image_embeddings[:, lo:hi]
                if pnp is not None:
                    kw["pnp"] = pnp_lib.frame_slice(pnp, lo, hi)
            with pm.frame_shard(fs):
                res = self._forward(sample, timestep, fps, image_latents_first, image_latents,
                                    image_embeddings, encoder_hidden_states, **kw)
            out = res[0] if isinstance(res, tuple) else res
            out = pm.gather_video(out, mesh, f, frame_axis=1)
        return (out,) + res[1:] if isinstance(res, tuple) else out

    def _forward(self, sample, timestep, fps, image_latents_first, image_latents,
                 image_embeddings, encoder_hidden_states,
                 pnp: Optional[pnp_lib.PnPState] = None, pnp_capture: bool = False,
                 multi_frame_guidance: bool = False, freeu: Optional[FreeUConfig] = None,
                 cached_encoder: Optional[tuple] = None, return_encoder: bool = False,
                 encoder_reuse_depth: Optional[int] = None, pab_cache: Optional[dict] = None,
                 pab_capture: bool = False):
        """The predicted noise [B, F, H, W, C_out]; with pnp_capture,
        return_encoder or pab_capture a tuple (noise, then in this order the
        captured PnP features, the encoder cache, the PAB dict).

        Encoder reuse: return_encoder returns the encoder cache
        (mid_features, skip_stack); a later forward given it as
        cached_encoder skips the stem, the down blocks and the mid block and
        runs only the up blocks on it.  With encoder_reuse_depth = k only the
        skips of down blocks k.. and the mid features are cached; a cached
        forward recomputes the stem and down blocks 0..k-1 and splices the
        cached deep part in.  PAB: pab_capture records every up-block
        attention sublayer's output; a forward given that dict as pab_cache
        skips those sublayers (q/k/v, the kernel, the out-projection and any
        PnP Q/K edit) and reuses the outputs, while the residual stream, the
        convs and the FFs stay fresh.  Both are approximate when a cache is
        reused on a later step."""
        cfg = self.config
        dt, dev = self.dtype, self.conv_norm_out.weight.device
        b, f, h, w, c_in = sample.shape
        ch0 = cfg.block_out_channels[0]
        sample = sample.to(dt)
        image_latents_first = image_latents_first.to(dt)
        image_latents = image_latents.to(dt)
        image_embeddings = image_embeddings.to(dt)
        encoder_hidden_states = encoder_hidden_states.to(dt)

        timestep = torch.as_tensor(timestep, device=dev).reshape(-1).expand(b)
        fps = torch.as_tensor(fps, device=dev).reshape(-1).expand(b)
        with _scope("time_embedding"):
            emb = self.time_embedding(timestep_embedding(timestep, ch0).to(dt))
        with _scope("fps_embedding"):
            emb = emb + self.fps_embedding(timestep_embedding(fps, ch0).to(dt))
        emb = emb.repeat_interleave(f, dim=0)  # [B*F, temb]

        depth = encoder_reuse_depth
        n_down = len(self.down_blocks)
        # the down blocks this forward runs; the context feeds their attention
        # and the up blocks' unless every up-block attention is broadcast
        n_run = n_down if cached_encoder is None else (0 if depth is None else depth)
        context = None
        if n_run > 0 or pab_cache is None:
            context = self._context(b, f, h, w, image_latents, image_embeddings,
                                    encoder_hidden_states, multi_frame_guidance)

        res_stack: list = []
        if cached_encoder is None or depth is not None:
            pi = self.image_latents_proj_in
            with _scope("image_latents_proj_in"):
                ilf = image_latents_first.reshape(b * f, h, w, c_in)
                ilf = pi[4](F.silu(pi[2](F.silu(pi[0](ilf)))))
            with _scope("image_latents_temporal_encoder"):
                ilf = ilf.reshape(b, f, h, w, c_in).permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c_in)
                ilf = self.image_latents_temporal_encoder(ilf)
                ilf = ilf.reshape(b, h, w, f, c_in).permute(0, 3, 1, 2, 4).reshape(b * f, h, w, c_in)
            with _scope("conv_in"):
                x = self.conv_in(torch.cat([sample.reshape(b * f, h, w, c_in), ilf], dim=-1))
            with _scope("transformer_in"):
                x = self.transformer_in(x, f)
            res_stack = [x]
            for i, blk in enumerate(self.down_blocks[:n_run]):
                with _scope(f"down_blocks.{i}"):
                    x, res = blk(x, emb, context, f)
                res_stack.extend(res)
        if cached_encoder is None:
            with _scope("mid_block"):
                x = self.mid_block(x, emb, context, f)
            cut = 0 if depth is None else self._entries_before_block(depth)
            encoder_features = (x, tuple(res_stack[cut:]))
        else:
            x, deep_skips = cached_encoder
            res_stack = res_stack + list(deep_skips)
            encoder_features = cached_encoder

        capture: Optional[dict] = {} if pnp_capture else None
        pab_rec: Optional[dict] = {} if pab_capture else None
        n_up = cfg.layers_per_block + 1
        for i, blk in enumerate(self.up_blocks):
            res = res_stack[-n_up:]
            res_stack = res_stack[:-n_up]
            final = i == len(self.up_blocks) - 1
            upsample_size = tuple(res_stack[-1].shape[1:3]) if (not final and res_stack) else None
            with _scope(f"up_blocks.{i}"):
                x = blk(x, res, emb, context, f, upsample_size, pnp, capture, freeu,
                        pab_cache, pab_rec)

        with _scope("conv_norm_out"):
            x = self.conv_norm_out(x)
        with _scope("conv_out"):  # with the out_conv injection site
            x = self.conv_out(x)
            if cfg.sites.out_conv:
                hh, ww = x.shape[1], x.shape[2]
                if capture is not None:
                    _conv_edit(pnp, hh, ww, "out_conv", capture)(x)
                elif pnp is not None:
                    x = _conv_edit(pnp, hh, ww, "out_conv", None)(x)
        out = x.reshape(b, f, h, w, cfg.out_channels)
        extra = ((capture,) if pnp_capture else ()) + (
            (encoder_features,) if return_encoder else ()) + ((pab_rec,) if pab_capture else ())
        return (out,) + extra if extra else out
