"""Network layers of the I2VGen-XL stack in PyTorch (counterpart of
mvoc_tpu/models/layers.py).

Public tensors stay channels-last, as in the JAX package:
  * per-frame ("2D") tensors:  [B*F, H, W, C]
  * temporal ("3D") tensors:   [B, F, H, W, C]
  * token tensors:             [B, S, C]
Convolutions view a channels-last tensor as NCHW with channels-last strides
(a permute, no copy), which cuDNN and the CPU backend take as they are.

Module and parameter names are the diffusers keys, so a diffusers state
dict loads with no key map (models/convert.py bridges the JAX params).
Norm statistics and softmax run in fp32; the affine parts run in the
activation dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mvoc_tpu_torch.ops import attention as attn_ops

# A QKEdit receives (q, k) right after the q/k projections (before the head
# split) and returns the edited (q, k): the PnP injection hook.
QKEdit = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding (diffusers `Timesteps`), fp32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class GroupNorm(nn.Module):
    """torch nn.GroupNorm semantics on channels-last input with one leading
    batch dim (4-D [B, H, W, C] or 5-D [B, F, H, W, C] with joint (F, H, W)
    statistics).  Two-pass centred variance in fp32; the affine is folded
    into per-channel coefficients applied in the activation dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        assert num_channels % num_groups == 0, (num_channels, num_groups)
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        dims = tuple(range(1, x.ndim - 1))
        bshape = (b,) + (1,) * len(dims) + (c,)
        xf = x.float()
        mean_c = xf.mean(dim=dims)                                   # [B, C]
        mean_ch = mean_c.view(b, g, c // g).mean(-1).repeat_interleave(c // g, -1)
        cen2_c = (xf - mean_ch.view(bshape)).square().mean(dim=dims)
        del xf
        var_g = cen2_c.view(b, g, c // g).mean(-1)
        inv_ch = torch.rsqrt(var_g + self.eps).repeat_interleave(c // g, -1)
        w = self.weight.float()[None]
        a_ch = (inv_ch * w).view(bshape).to(x.dtype)
        b_ch = (self.bias.float()[None] - mean_ch * inv_ch * w).view(bshape).to(x.dtype)
        return x * a_ch + b_ch


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        xn = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return xn * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last [B, H, W, C] tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """nn.Conv3d on channels-last [B, F, H, W, C] tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, S, H*D] projections.

    A frame-axis call (sq == sk <= 64 at head dim 4 or 64: temporal tokens
    [B*H*W, F, C], the image-latents temporal encoder, and the spatial
    self-attention of the 8x8 level) goes to K2 in its pixel-major layout;
    every other call to K1, whatever its length (the VAE's D = 512 over at
    most 64 tokens included), a frame-axis call over more than 64 frames
    with its band mask (if any) as K1's bias.  The kernels' wrappers launch
    on CUDA tensors and take their plain versions on CPU tensors.  A mask
    (the temporal window's [F, F] band) exists only on frame-axis calls.

    The JAX package masks with finfo(float32).min, the kernels with the
    finite -1e30 (band_bias): a band always keeps its diagonal, so every
    row has a kept key, and both give the masked keys probability 0."""
    b, sq, inner = q.shape
    sk = k.shape[1]
    d = inner // heads
    if mask is not None and mask.shape != (sq, sk):
        raise ValueError(f"mask {tuple(mask.shape)} for attention over {sq}x{sk} tokens")
    if sq == sk and sq <= attn_ops.FRAME_MAX_FRAMES and d in attn_ops.FRAME_HEAD_DIMS:
        return attn_ops.frame_attention(q, k, v, heads, mask=mask, layout="sf")
    qh = q.view(b, sq, heads, d).transpose(1, 2)
    kh = k.view(b, sk, heads, d).transpose(1, 2)
    vh = v.view(b, sk, heads, d).transpose(1, 2)
    bias = None if mask is None else attn_ops.band_bias(mask).to(q.device)
    out = attn_ops.flash_attention(qh, kh, vh, bias=bias)  # [B, H, Sq, D]
    return out.transpose(1, 2).reshape(b, sq, inner)


def sdpa_frames(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention across the FRAME axis of frame-major [B, F, S, H*D] tokens,
    with no re-layout of q, k and v: K2 (natural layout) up to 64 frames.

    Beyond 64 frames K1 takes the call, with the band mask (if any) as its
    bias.  K1 reads [batch, head, seq, D] through one stride each, and the
    natural layout's batch is two axes (B with stride F*S*H*D, the pixel S
    with stride H*D), so each of the B entries launches K1 once on its
    [S, H, F, D] view, read in place; only the output is laid back, by one
    copy.  That spends B launches (B <= N+3 branches) instead of a re-layout
    of all four tensors, and keeps K1's C interface at one batch stride."""
    b, f, s, inner = q.shape
    if f <= attn_ops.FRAME_MAX_FRAMES:
        return attn_ops.frame_attention(q, k, v, heads, mask=mask, layout="natural")
    d = inner // heads
    bias = None if mask is None else attn_ops.band_bias(mask).to(q.device)

    def view(t, i):  # entry i as [S, H, F, D]
        return t[i].unflatten(-1, (heads, d)).permute(1, 2, 0, 3)

    outs = [attn_ops.flash_attention(view(q, i), view(k, i), view(v, i), bias=bias)
            for i in range(b)]
    return torch.stack([o.permute(2, 0, 1, 3) for o in outs]).reshape(b, f, s, inner)


class Attention(nn.Module):
    """diffusers `Attention`: to_q/to_k/to_v without bias, to_out.0 with
    bias; optional cross-attention context; optional Q/K edit after the
    projections and before the head split."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, out_bias: bool = True,
                 frame_axis: bool = False):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.frame_axis = frame_axis
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                qk_edit: Optional[QKEdit] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        q = self.to_q(hidden_states)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        if qk_edit is not None:
            q, k = qk_edit(q, k)
        if self.frame_axis:
            out = sdpa_frames(q, k, v, self.heads, mask=attn_mask)
        else:
            out = sdpa(q, k, v, self.heads, mask=attn_mask)
        return self.to_out[0](out)


class _GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class _GELU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x))


class FeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU or GELU projection, net.2 =
    Linear.  Rows are processed in chunks of `chunk_rows` only when the
    whole intermediate would exceed CHUNK_BYTE_THRESHOLD (exact: the FF is
    pointwise over tokens)."""

    CHUNK_BYTE_THRESHOLD = 2 << 30

    def __init__(self, dim: int, inner_dim: Optional[int] = None, activation: str = "geglu",
                 chunk_rows: int = 0):
        super().__init__()
        inner = inner_dim or dim * 4
        if activation == "geglu":
            act = _GEGLU(dim, inner)
        elif activation == "gelu":
            act = _GELU(dim, inner)
        else:
            raise ValueError(f"unknown activation {activation}")
        self.inner_cols = inner * 2 if activation == "geglu" else inner
        self.chunk_rows = chunk_rows
        self.dim = dim
        self.net = nn.ModuleList([act, nn.Dropout(0.0), nn.Linear(inner, dim)])

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        rows = math.prod(lead)
        inter_bytes = rows * self.inner_cols * x.element_size()
        if (not self.chunk_rows or rows <= self.chunk_rows
                or inter_bytes <= self.CHUNK_BYTE_THRESHOLD):
            return self._ff(x)
        x2 = x.reshape(rows, x.shape[-1])
        outs = [self._ff(x2[i:i + self.chunk_rows]) for i in range(0, rows, self.chunk_rows)]
        return torch.cat(outs, dim=0).reshape(*lead, self.dim)


class BasicTransformerBlock(nn.Module):
    """norm1 -> attn1 (self) ; norm2 -> attn2 (cross, or a second self-
    attention when double_self_attention) ; norm3 -> ff, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None,
                 double_self_attention: bool = False, activation: str = "geglu",
                 ff_chunk_rows: int = 0, frame_axis: bool = False):
        super().__init__()
        self.double_self_attention = double_self_attention
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, frame_axis=frame_axis)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(
            dim, heads, dim_head,
            cross_attention_dim=None if double_self_attention else cross_attention_dim,
            frame_axis=frame_axis)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, activation=activation, chunk_rows=ff_chunk_rows)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                attn1_qk_edit: Optional[QKEdit] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.attn1(self.norm1(hidden_states), qk_edit=attn1_qk_edit,
                                   attn_mask=attn_mask) + hidden_states
        h2 = self.norm2(hidden_states)
        if self.double_self_attention:
            h = self.attn2(h2, attn_mask=attn_mask)
        else:
            h = self.attn2(h2, encoder_hidden_states=encoder_hidden_states)
        hidden_states = h + hidden_states
        return self.ff(self.norm3(hidden_states)) + hidden_states


class Transformer2DModel(nn.Module):
    """Spatial transformer over per-frame tokens: [B*F, H, W, C] -> GroupNorm
    -> proj_in -> blocks over h*w tokens (cross-attending to the context)
    -> proj_out -> + residual."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, cross_attention_dim: int,
                 num_layers: int = 1, norm_num_groups: int = 32, ff_chunk_rows: int = 0):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim=cross_attention_dim,
                                  ff_chunk_rows=ff_chunk_rows)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                attn1_qk_edit: Optional[QKEdit] = None) -> torch.Tensor:
        bf, h, w, c = hidden_states.shape
        x = self.norm(hidden_states).reshape(bf, h * w, c)
        x = self.proj_in(x)
        for i, block in enumerate(self.transformer_blocks):
            x = block(x, encoder_hidden_states,
                      attn1_qk_edit=attn1_qk_edit if i == 0 else None)
        return self.proj_out(x).reshape(bf, h, w, c) + hidden_states


class TransformerTemporalModel(nn.Module):
    """Temporal transformer: attention across the frame axis per pixel.

    [B*F, H, W, C] -> GroupNorm with joint (F, H, W) statistics -> tokens
    -> proj_in -> blocks (double self-attention) -> proj_out -> + residual.
    natural_layout keeps the tokens frame-major [B, F, H*W, C] and attends
    across F directly (sdpa_frames); otherwise tokens are [B*H*W, F, C].
    Both compute the same function.  window: frames attend within
    +-window/2 (band mask) when set and smaller than the frame count."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, num_layers: int = 1,
                 norm_num_groups: int = 32, window: Optional[int] = None,
                 ff_chunk_rows: int = 0, natural_layout: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.window = window
        self.natural_layout = natural_layout
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, double_self_attention=True,
                                  ff_chunk_rows=ff_chunk_rows, frame_axis=natural_layout)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states: torch.Tensor, num_frames: int,
                attn1_qk_edit: Optional[QKEdit] = None) -> torch.Tensor:
        bf, h, w, c = hidden_states.shape
        b = bf // num_frames
        x = self.norm(hidden_states.reshape(b, num_frames, h, w, c))
        if self.natural_layout:
            x = x.reshape(b, num_frames, h * w, c)
        else:
            x = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, num_frames, c)
        x = self.proj_in(x)
        attn_mask = None
        if self.window is not None and self.window < num_frames:
            idx = torch.arange(num_frames, device=x.device)
            attn_mask = (idx[:, None] - idx[None, :]).abs() <= self.window // 2
        for i, block in enumerate(self.transformer_blocks):
            x = block(x, attn1_qk_edit=attn1_qk_edit if i == 0 else None, attn_mask=attn_mask)
        x = self.proj_out(x)
        if self.natural_layout:
            x = x.reshape(bf, h, w, c)
        else:
            x = x.reshape(b, h, w, num_frames, c).permute(0, 3, 1, 2, 4).reshape(bf, h, w, c)
        return x + hidden_states


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D (per frame): norm1 -> silu -> conv1 (+ the
    time embedding through time_emb_proj) -> norm2 -> silu -> conv2; a 1x1
    conv_shortcut when the channels change.  pnp_edit acts on the residual
    branch before the shortcut add."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                pnp_edit: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if pnp_edit is not None:
            h = pnp_edit(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _tconv_stage(in_dim: int, out_dim: int, groups: int) -> nn.Sequential:
    return nn.Sequential(GroupNorm(groups, in_dim, eps=1e-5), nn.SiLU(),
                         Conv3d(in_dim, out_dim, (3, 1, 1), padding=(1, 0, 0)))


class TemporalConvLayer(nn.Module):
    """diffusers TemporalConvLayer: four (GroupNorm -> silu -> Conv3d
    (3,1,1)) stages and a residual; conv4 starts at zero, so a fresh layer
    is the identity.  Keys convN.0 (norm) and convN.2 (conv), the layout
    the JAX package's key map expects.  pnp_edit acts after the residual."""

    def __init__(self, in_dim: int, out_dim: Optional[int] = None, groups: int = 32):
        super().__init__()
        out_dim = out_dim or in_dim
        self.conv1 = _tconv_stage(in_dim, out_dim, groups)
        self.conv2 = _tconv_stage(out_dim, in_dim, groups)
        self.conv3 = _tconv_stage(in_dim, in_dim, groups)
        self.conv4 = _tconv_stage(in_dim, in_dim, groups)

    def forward(self, x: torch.Tensor, num_frames: int,
                pnp_edit: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        x5 = x.reshape(bf // num_frames, num_frames, hh, ww, c)
        h = self.conv4(self.conv3(self.conv2(self.conv1(x5))))
        h = (x5 + h).reshape(bf, hh, ww, c)
        if pnp_edit is not None:
            h = pnp_edit(h)
        return h


class Downsample2D(nn.Module):
    """Strided 3x3 conv, padding 1."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 (or to an explicit output size) + 3x3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, output_size: Optional[tuple[int, int]] = None) -> torch.Tensor:
        bf, h, w, c = x.shape
        th, tw = output_size or (h * 2, w * 2)
        # torch F.interpolate(nearest): out[i] = in[floor(i * h / H_out)]
        ys = (torch.arange(th, device=x.device, dtype=torch.float32) * (h / th)).long()
        xs = (torch.arange(tw, device=x.device, dtype=torch.float32) * (w / tw)).long()
        return self.conv(x[:, ys][:, :, xs])
