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


class _Block3D(nn.Module):
    """resnets + temp_convs (+ attentions + temp_attentions with cross_attn)
    per layer; the shared body of the down and up blocks."""

    def __init__(self, cfg: UNetConfig, in_channels: list[int], out_channels: int,
                 cross_attn: bool):
        super().__init__()
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
                 cross_attn: bool):
        ins = [in_channels] + [out_channels] * (cfg.layers_per_block - 1)
        super().__init__(cfg, ins, out_channels, cross_attn)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context, num_frames):
        res = []
        for i in range(len(self.resnets)):
            x = self.resnets[i](x, temb)
            x = self.temp_convs[i](x, num_frames)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
                x = self.temp_attentions[i](x, num_frames)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
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
        x = self.temp_convs[0](self.resnets[0](x, temb), num_frames)
        x = self.attentions[0](x, context)
        x = self.temp_attentions[0](x, num_frames)
        return self.temp_convs[1](self.resnets[1](x, temb), num_frames)


class UpBlock3D(_Block3D):
    def __init__(self, cfg, prev_channels: int, skip_channels: list[int], out_channels: int,
                 add_upsample: bool, cross_attn: bool, block_index: int):
        ins = [(prev_channels if j == 0 else out_channels) + s for j, s in enumerate(skip_channels)]
        super().__init__(cfg, ins, out_channels, cross_attn)
        self.block_index = block_index
        self.natural = cfg.temporal_natural_layout
        self.sites = cfg.sites
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels, out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_samples, temb, context, num_frames, upsample_size=None,
                pnp=None, capture=None):
        bi, sites = self.block_index, self.sites
        for i in range(len(self.resnets)):
            x = torch.cat([x, res_samples[-1 - i]], dim=-1)
            hc, wc = x.shape[1], x.shape[2]
            x = self.resnets[i](x, temb, pnp_edit=_conv_edit(
                pnp, hc, wc, f"resnet_{bi}_{i}", capture) if i in sites.resnet_at(bi) else None)
            x = self.temp_convs[i](x, num_frames, pnp_edit=_conv_edit(
                pnp, hc, wc, f"tconv_{bi}_{i}", capture) if i in sites.temp_conv_at(bi) else None)
            if self.attentions is not None:
                x = self.attentions[i](x, context, attn1_qk_edit=_spatial_qk_edit(
                    pnp, hc, wc, f"spatial_{bi}_{i}", capture)
                    if i in sites.spatial_at(bi) else None)
                x = self.temp_attentions[i](x, num_frames, attn1_qk_edit=_temporal_qk_edit(
                    pnp, hc, wc, f"temporal_{bi}_{i}", capture, self.natural)
                    if i in sites.temporal_at(bi) else None)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_size)
        return x


class ImageLatentsTemporalEncoder(nn.Module):
    """LN -> self-attention -> + residual -> FF(gelu) -> + residual, over
    [B*H*W, F, C=in_channels] tokens."""

    def __init__(self, dim: int, heads: int, head_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim or dim)
        self.ff = FeedForward(dim, inner_dim=dim * 4, activation="gelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        return self.ff(x) + x


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
                                                cross_attn=not final))
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
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch0, eps=cfg.norm_eps)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        # a norm's weight: it keeps the model dtype when convs quantize to int8
        return self.conv_norm_out.weight.dtype

    def _context(self, b, f, h, w, image_latents, image_embeddings, encoder_hidden_states):
        """Per-frame context [B*F, 77 + 64 + C_in, D] from frame 0's image
        embedding and image latents (the reference's default; its
        multi_frame_guidance option is not ported)."""
        c_in, d_ctx = self.config.in_channels, self.config.cross_attention_dim
        image_embeddings = image_embeddings[:, 0:1].expand(b, f, image_embeddings.shape[-1])
        ce = self.image_latents_context_embedding
        il = image_latents[:, :1].reshape(b, h, w, c_in)
        il = F.silu(ce[0](il))
        il = F.adaptive_avg_pool2d(il.permute(0, 3, 1, 2).float(), (32, 32))
        il = il.permute(0, 2, 3, 1).to(self.dtype)
        il = ce[5](F.silu(ce[3](il)))
        n_tok = il.shape[1] * il.shape[2]
        il_tokens = il.reshape(b, 1, n_tok, d_ctx).expand(b, f, n_tok, d_ctx)
        ie = self.context_embedding[2](F.silu(self.context_embedding[0](image_embeddings)))
        ie_tokens = ie.reshape(b, f, c_in, d_ctx)
        text = encoder_hidden_states[:, None].expand((b, f) + encoder_hidden_states.shape[1:])
        ctx = torch.cat([text, il_tokens, ie_tokens], dim=2)
        return ctx.reshape(b * f, -1, d_ctx)

    def forward(self, sample, timestep, fps, image_latents_first, image_latents,
                image_embeddings, encoder_hidden_states,
                pnp: Optional[pnp_lib.PnPState] = None, pnp_capture: bool = False):
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
        emb = self.time_embedding(timestep_embedding(timestep, ch0).to(dt))
        emb = emb + self.fps_embedding(timestep_embedding(fps, ch0).to(dt))
        emb = emb.repeat_interleave(f, dim=0)  # [B*F, temb]

        context = self._context(b, f, h, w, image_latents, image_embeddings,
                                encoder_hidden_states)

        pi = self.image_latents_proj_in
        ilf = image_latents_first.reshape(b * f, h, w, c_in)
        ilf = pi[4](F.silu(pi[2](F.silu(pi[0](ilf)))))
        ilf = ilf.reshape(b, f, h, w, c_in).permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c_in)
        ilf = self.image_latents_temporal_encoder(ilf)
        ilf = ilf.reshape(b, h, w, f, c_in).permute(0, 3, 1, 2, 4).reshape(b * f, h, w, c_in)

        x = torch.cat([sample.reshape(b * f, h, w, c_in), ilf], dim=-1)
        x = self.transformer_in(self.conv_in(x), f)
        res_stack = [x]
        for blk in self.down_blocks:
            x, res = blk(x, emb, context, f)
            res_stack.extend(res)
        x = self.mid_block(x, emb, context, f)

        capture: Optional[dict] = {} if pnp_capture else None
        n_up = cfg.layers_per_block + 1
        for i, blk in enumerate(self.up_blocks):
            res = res_stack[-n_up:]
            res_stack = res_stack[:-n_up]
            final = i == len(self.up_blocks) - 1
            upsample_size = tuple(res_stack[-1].shape[1:3]) if (not final and res_stack) else None
            x = blk(x, res, emb, context, f, upsample_size, pnp, capture)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        if cfg.sites.out_conv:
            hh, ww = x.shape[1], x.shape[2]
            if capture is not None:
                _conv_edit(pnp, hh, ww, "out_conv", capture)(x)
            elif pnp is not None:
                x = _conv_edit(pnp, hh, ww, "out_conv", None)(x)
        out = x.reshape(b, f, h, w, cfg.out_channels)
        if capture is not None:
            return out, capture
        return out
