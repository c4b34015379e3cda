"""Plain PyTorch equations of the I2VGen-XL stack: the benchmark's own
reference, frozen here so that no later change to the program can move it.

It imports nothing of the program.  Module and parameter names are the
diffusers keys (the ones the program uses), so one state dict loads into
both.  Everything runs in the weights' dtype (float32 when it is the
reference); attention is softmax(q k^T / sqrt(d)) v written as two matmuls,
cut into blocks of (batch x head) so that its logits fit; the feed-forward
runs in blocks of rows for the same reason.  Tensors are channels-last:
per-frame [B*F, H, W, C], temporal [B, F, H, W, C], tokens [B, S, C].

Departures from the published I2VGen-XL equations are none; the PnP sites
(`Injection`) are the MVOC composite's: inside the up blocks the edit
branches' Q/K and conv features are overwritten with the masked composite
of the source branches, as the program's fused path does.

`Precision` carries what the configuration states below float: the w8a8
layers of the int8 configuration, fake-quantised (quantise, dequantise,
then the float product: the same function as an integer product with its
dequantising epilogue, to float32 rounding).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# attention logits of one block are at most this many elements (float32: 1 GiB)
ATTN_BLOCK_ELEMS = 1 << 28
# feed-forward rows per block when the whole inner activation would be larger
FF_BLOCK_ELEMS = 1 << 28


# ---------------------------------------------------------------------------
# precision below float: the w8a8 layers
# ---------------------------------------------------------------------------

# the temporal (3,1,1) conv's per-token scales apply where a call holds at
# most this many rows B*F*H*W and frames (else one scale per sample)
TCONV_TOKEN_MAX_ROWS = 4096
TCONV_TOKEN_MAX_FRAMES = 16

QUANT_SKIP = ("time_embedding", "fps_embedding", "conv_out", "conv_in",
              "image_latents_proj_in", "image_latents_temporal_encoder")


def mixed_selection(name: str, module: nn.Module, min_k: int = 1280) -> bool:
    """The int8-mixed selection: dense layers with K >= min_k (1280) and
    (3,1,1) temporal convs with C_in >= min_k, none on the skip list (by
    each dotted component of the module's name)."""
    parts = name.split(".") + ["weight"]
    if any(any(s in p for s in QUANT_SKIP) for p in parts):
        return False
    if isinstance(module, nn.Linear):
        return module.in_features >= min_k
    if isinstance(module, nn.Conv3d):
        return tuple(module.kernel_size) == (3, 1, 1) and module.in_channels >= min_k
    return False


def fake_quant(x: torch.Tensor, reduce_dims, qmax: float) -> torch.Tensor:
    """Symmetric quantise-dequantise: scale = amax * float32(1 / qmax) over
    `reduce_dims` (1 where amax is 0), round half to even, clip to +-qmax."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(reduce_dims), keepdim=True)
    inv = float(torch.tensor(1.0 / qmax, dtype=torch.float32))
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    return torch.clamp(torch.round(xf / scale), -qmax, qmax) * scale


@dataclasses.dataclass
class Precision:
    """qmax: 127 for w8a8, 7 for w4a4 (the control of an int8 configuration).
    call_batch_of: for each sample of a forward's batch, the batch of the
    program's UNet call that computes it (the (3,1,1) conv's activation
    scales are per token or per sample by the rows of that call); None: the
    forward is one call.  min_k: the selection's contraction threshold."""

    qmax: float = 127.0
    call_batch_of: Optional[list] = None
    min_k: int = 1280


class QLinear(nn.Module):
    """A selected dense layer: per-row activation scales, per-output weights."""

    def __init__(self, inner: nn.Linear, precision: Precision):
        super().__init__()
        self.inner, self.precision = inner, precision

    def forward(self, x):
        q = self.precision.qmax
        w = fake_quant(self.inner.weight, (1,), q)
        y = F.linear(fake_quant(x, (x.ndim - 1,), q), w)
        return y if self.inner.bias is None else y + self.inner.bias


class QConv3d(nn.Module):
    """A selected (3,1,1) temporal conv on [B, F, H, W, C]: per-token
    activation scales for the samples of a call of at most
    TCONV_TOKEN_MAX_ROWS rows, else one scale per sample."""

    def __init__(self, inner: "Conv3d", precision: Precision):
        super().__init__()
        self.inner, self.precision = inner, precision

    def forward(self, x):
        qmax = self.precision.qmax
        b, f, h, w, _ = x.shape
        sizes = self.precision.call_batch_of or [b] * b
        if len(sizes) != b:
            raise ValueError(f"{len(sizes)} call batches for a batch of {b}")
        token = torch.tensor([n * f * h * w <= TCONV_TOKEN_MAX_ROWS and f <= TCONV_TOKEN_MAX_FRAMES
                              for n in sizes], device=x.device)
        xq = torch.where(token[:, None, None, None, None], fake_quant(x, (4,), qmax),
                         fake_quant(x, (1, 2, 3, 4), qmax))
        wq = fake_quant(self.inner.weight, (1, 2, 3, 4), qmax)
        y = F.conv3d(xq.permute(0, 4, 1, 2, 3), wq, None, self.inner.stride, self.inner.padding)
        y = y.permute(0, 2, 3, 4, 1)
        return y if self.inner.bias is None else y + self.inner.bias


@contextlib.contextmanager
def rounded_products(module: nn.Module, dtype: torch.dtype):
    """Inside the block, every dense and conv layer's output is rounded to
    `dtype` (and back): the reference's own estimate of what rounding to the
    configuration's dtype moves."""
    def hook(_mod, _args, out):
        return out.to(dtype).to(out.dtype)
    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def quantize_(unet: nn.Module, precision: Precision) -> int:
    """Wrap the selected layers of a UNet in place; returns their count."""
    picked = [(n, m) for n, m in unet.named_modules()
              if mixed_selection(n, m, precision.min_k)]
    for name, module in picked:
        parent, _, child = name.rpartition(".")
        wrap = QLinear if isinstance(module, nn.Linear) else QConv3d
        setattr(unet.get_submodule(parent), child, wrap(module, precision))
    return len(picked)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.Module):
    """torch GroupNorm on channels-last input; a 5-D input takes joint
    statistics over (F, H, W)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        xg = x.reshape(b, -1, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class AttentionLog:
    """Where a forward's attention calls go, for the benchmark's counts:
    (kind, batch*heads, Sq, Sk, D) per call; kind "frame" for attention
    across the frame axis, "token" for every other (spatial, cross, VAE)."""

    def __init__(self):
        self.calls: list = []


ATTENTION_LOG: Optional[AttentionLog] = None


def attention(q, k, v, heads: int, kind: str = "token"):
    """softmax(q k^T / sqrt(d)) v over [B, S, H*D] projections, in blocks
    of (batch x head)."""
    b, sq, inner = q.shape
    sk, d = k.shape[1], inner // heads
    if ATTENTION_LOG is not None:
        ATTENTION_LOG.calls.append((kind, b * heads, sq, sk, d))
    qh = q.reshape(b, sq, heads, d).transpose(1, 2).reshape(b * heads, sq, d)
    kh = k.reshape(b, sk, heads, d).transpose(1, 2).reshape(b * heads, sk, d)
    vh = v.reshape(b, sk, heads, d).transpose(1, 2).reshape(b * heads, sk, d)
    step = max(1, ATTN_BLOCK_ELEMS // (sq * sk))
    outs = []
    for i in range(0, b * heads, step):
        logits = torch.matmul(qh[i:i + step], kh[i:i + step].transpose(1, 2)) / math.sqrt(d)
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), vh[i:i + step]))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out.reshape(b, heads, sq, d).transpose(1, 2).reshape(b, sq, inner)


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, out_bias: bool = True,
                 kind: str = "token"):
        super().__init__()
        inner = heads * dim_head
        kv = cross_attention_dim or query_dim
        self.heads, self.kind = heads, kind
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv, inner, bias=False)
        self.to_v = nn.Linear(kv, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, x, context=None, qk_edit=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if qk_edit is not None:
            q, k = qk_edit(q, k)
        return self.to_out[0](attention(q, k, v, self.heads, self.kind))


class _GEGLU(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.proj = nn.Linear(din, dout * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class _GELU(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.proj = nn.Linear(din, dout)

    def forward(self, x):
        return F.gelu(self.proj(x))


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner_dim: Optional[int] = None, activation: str = "geglu"):
        super().__init__()
        inner = inner_dim or dim * 4
        act = _GEGLU(dim, inner) if activation == "geglu" else _GELU(dim, inner)
        self.cols = inner * (2 if activation == "geglu" else 1)
        self.net = nn.ModuleList([act, nn.Dropout(0.0), nn.Linear(inner, dim)])

    def forward(self, x):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        step = max(1, FF_BLOCK_ELEMS // self.cols)
        outs = [self.net[2](self.net[0](x2[i:i + step])) for i in range(0, x2.shape[0], step)]
        return (torch.cat(outs) if len(outs) > 1 else outs[0]).reshape(*lead, -1)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: Optional[int] = None,
                 double_self: bool = False, activation: str = "geglu", kind: str = "token"):
        super().__init__()
        self.double_self = double_self
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, kind=kind)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head,
                               cross_attention_dim=None if double_self else cross_dim, kind=kind)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, activation=activation)

    def forward(self, x, context=None, qk_edit=None):
        x = self.attn1(self.norm1(x), qk_edit=qk_edit) + x
        ctx = None if self.double_self else context
        x = self.attn2(self.norm2(x), context=ctx) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, cross_dim: int, groups: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_dim=cross_dim)])
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context, qk_edit=None):
        bf, h, w, c = x.shape
        t = self.proj_in(self.norm(x).reshape(bf, h * w, c))
        t = self.transformer_blocks[0](t, context, qk_edit=qk_edit)
        return self.proj_out(t).reshape(bf, h, w, c) + x


class TransformerTemporalModel(nn.Module):
    """Attention across frames for each pixel; tokens [B*H*W, F, C]."""

    def __init__(self, channels: int, heads: int, dim_head: int, groups: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, double_self=True, kind="frame")])
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, frames: int, qk_edit=None):
        bf, h, w, c = x.shape
        b = bf // frames
        t = self.norm(x.reshape(b, frames, h, w, c)).permute(0, 2, 3, 1, 4)
        t = self.proj_in(t.reshape(b * h * w, frames, c))
        t = self.transformer_blocks[0](t, qk_edit=qk_edit)
        t = self.proj_out(t).reshape(b, h, w, frames, c).permute(0, 3, 1, 2, 4)
        return t.reshape(bf, h, w, c) + x


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None, edit=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if edit is not None:
            h = edit(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _tconv_stage(cin: int, cout: int, groups: int) -> nn.Sequential:
    return nn.Sequential(GroupNorm(groups, cin, eps=1e-5), nn.SiLU(),
                         Conv3d(cin, cout, (3, 1, 1), padding=(1, 0, 0)))


class TemporalConvLayer(nn.Module):
    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.conv1 = _tconv_stage(dim, dim, groups)
        self.conv2 = _tconv_stage(dim, dim, groups)
        self.conv3 = _tconv_stage(dim, dim, groups)
        self.conv4 = _tconv_stage(dim, dim, groups)

    def forward(self, x, frames: int, edit=None):
        bf, h, w, c = x.shape
        x5 = x.reshape(bf // frames, frames, h, w, c)
        y = (x5 + self.conv4(self.conv3(self.conv2(self.conv1(x5))))).reshape(bf, h, w, c)
        return y if edit is None else edit(y)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, size=None):
        h, w = x.shape[1], x.shape[2]
        th, tw = size or (h * 2, w * 2)
        # nearest: out[i] = in[floor(i * h / th)], in float32 as torch computes it
        ys = (torch.arange(th, device=x.device, dtype=torch.float32) * (h / th)).long()
        xs = (torch.arange(tw, device=x.device, dtype=torch.float32) * (w / tw)).long()
        return self.conv(x[:, ys][:, :, xs])


# ---------------------------------------------------------------------------
# PnP injection (the fused path's semantics)
# ---------------------------------------------------------------------------

# the reference MVOC's sites in the I2VGen-XL up blocks: {block: layers}
SPATIAL_SITES = {1: (1, 2), 2: (0, 1, 2), 3: (0, 1, 2)}
TEMPORAL_SITES = {1: (1, 2), 2: (0, 1, 2), 3: (0, 1, 2)}
RESNET_SITES = {3: (0, 1, 2)}
TCONV_SITES = {3: (0, 1, 2)}


@dataclasses.dataclass
class Injection:
    """One step's injection.  The batch holds J entries of N+3 branches,
    [bg, obj_1..obj_N, uncond, cond], entry-major.  masks / masks_soft:
    (h, w) -> [J, N, F, h, w]; gates as the schedule gives them."""

    masks: dict
    masks_soft: dict
    gate_spatial: bool
    gate_temporal: bool
    gate_conv: bool
    inject_background: bool

    def _edit(self, x, mask, base_bg: bool):
        """x [J*B, F, P, C] (P positions), mask [J, N, F, P]: the edit chunks
        take the composite of the source branches, later objects winning."""
        j, n = mask.shape[:2]
        b = n + 3
        xb = x.reshape(j, b, *x.shape[1:])
        m = mask[..., None].to(x.dtype)
        base = xb[:, 0] if base_bg else xb[:, b - 1]
        for o in range(n):
            base = base * (1.0 - m[:, o]) + xb[:, 1 + o] * m[:, o]
        return torch.cat([xb[:, :n + 1], base[:, None], base[:, None]], dim=1).reshape(x.shape)

    def qk(self, h: int, w: int, temporal: bool):
        """The Q/K edit of attention sites at (h, w): spatial tokens
        [J*B*F, h*w, C]; temporal tokens [J*B*h*w, F, C] (pixel-major)."""
        gate = self.gate_temporal if temporal else self.gate_spatial
        if not gate:
            return None
        mask = (self.masks_soft if temporal else self.masks)[(h, w)]
        j, n, f = mask.shape[:3]
        flat = mask.reshape(j, n, f, h * w)

        def edit(q, k):
            def one(x):
                c = x.shape[-1]
                if temporal:  # [J*B*hw, F, C] -> [J*B, F, hw, C]
                    xs = x.reshape(-1, h * w, f, c).transpose(1, 2)
                    out = self._edit(xs, flat, self.inject_background)
                    return out.transpose(1, 2).reshape(x.shape)
                xs = x.reshape(-1, f, h * w, c)
                return self._edit(xs, flat, self.inject_background).reshape(x.shape)
            return one(q), one(k)
        return edit

    def conv(self, h: int, w: int):
        if not self.gate_conv:
            return None
        mask = self.masks[(h, w)]
        j, n, f = mask.shape[:3]
        flat = mask.reshape(j, n, f, h * w)

        def edit(x):
            xs = x.reshape(-1, f, h * w, x.shape[-1])
            return self._edit(xs, flat, True).reshape(x.shape)
        return edit


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    transformer_in_heads: int = 8
    img_temporal_encoder_heads: int = 2
    norm_eps: float = 1e-5


class _Block(nn.Module):
    def __init__(self, cfg: UNetConfig, ins: list, cout: int, cross: bool):
        super().__init__()
        temb, g, eps = cfg.block_out_channels[0] * 4, cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList([ResnetBlock2D(c, cout, temb, eps, g) for c in ins])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(cout, g) for _ in ins])
        self.attentions = self.temp_attentions = None
        if cross:
            heads = cout // cfg.attention_head_dim
            self.attentions = nn.ModuleList([
                Transformer2DModel(cout, heads, cfg.attention_head_dim, cfg.cross_attention_dim, g)
                for _ in ins])
            self.temp_attentions = nn.ModuleList([
                TransformerTemporalModel(cout, heads, cfg.attention_head_dim, g) for _ in ins])


class DownBlock3D(_Block):
    def __init__(self, cfg, cin: int, cout: int, down: bool, cross: bool):
        super().__init__(cfg, [cin] + [cout] * (cfg.layers_per_block - 1), cout, cross)
        self.downsamplers = nn.ModuleList([Downsample2D(cout)]) if down else None

    def forward(self, x, temb, context, frames):
        res = []
        for i in range(len(self.resnets)):
            x = self.temp_convs[i](self.resnets[i](x, temb), frames)
            if self.attentions is not None:
                x = self.temp_attentions[i](self.attentions[i](x, context), frames)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class MidBlock3D(nn.Module):
    def __init__(self, cfg: UNetConfig, ch: int):
        super().__init__()
        heads, g = ch // cfg.attention_head_dim, cfg.norm_num_groups
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, temb, cfg.norm_eps, g)
                                      for _ in range(2)])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(ch, g) for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(ch, heads, cfg.attention_head_dim, cfg.cross_attention_dim, g)])
        self.temp_attentions = nn.ModuleList([
            TransformerTemporalModel(ch, heads, cfg.attention_head_dim, g)])

    def forward(self, x, temb, context, frames):
        x = self.temp_convs[0](self.resnets[0](x, temb), frames)
        x = self.temp_attentions[0](self.attentions[0](x, context), frames)
        return self.temp_convs[1](self.resnets[1](x, temb), frames)


class UpBlock3D(_Block):
    def __init__(self, cfg, prev: int, skips: list, cout: int, up: bool, cross: bool,
                 index: int):
        ins = [(prev if j == 0 else cout) + s for j, s in enumerate(skips)]
        super().__init__(cfg, ins, cout, cross)
        self.index = index
        self.upsamplers = nn.ModuleList([Upsample2D(cout)]) if up else None

    def forward(self, x, res, temb, context, frames, size, inj: Optional[Injection]):
        bi = self.index
        for i in range(len(self.resnets)):
            x = torch.cat([x, res[-1 - i]], dim=-1)
            h, w = x.shape[1], x.shape[2]

            def site(table, make):
                return make() if inj is not None and i in table.get(bi, ()) else None
            x = self.resnets[i](x, temb, edit=site(RESNET_SITES, lambda: inj.conv(h, w)))
            x = self.temp_convs[i](x, frames, edit=site(TCONV_SITES, lambda: inj.conv(h, w)))
            if self.attentions is not None:
                x = self.attentions[i](x, context, qk_edit=site(
                    SPATIAL_SITES, lambda: inj.qk(h, w, temporal=False)))
                x = self.temp_attentions[i](x, frames, qk_edit=site(
                    TEMPORAL_SITES, lambda: inj.qk(h, w, temporal=True)))
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, size)
        return x


class ImageLatentsTemporalEncoder(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim, kind="frame")
        self.ff = FeedForward(dim, inner_dim=dim * 4, activation="gelu")

    def forward(self, x):
        x = self.attn1(self.norm1(x)) + x
        return self.ff(x) + x


class UNet(nn.Module):
    """forward(sample [B, F, h, w, C], t, fps [B], image_latents [B, F, h, w,
    C], image_embeddings [B, F, D], text [B, 77, D], inj) -> eps."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        c_in, ch0, d = cfg.in_channels, cfg.block_out_channels[0], cfg.cross_attention_dim
        temb = ch0 * 4
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.fps_embedding = TimestepEmbedding(ch0, temb)
        self.image_latents_context_embedding = nn.ModuleList([
            Conv2d(c_in, c_in * 8, 3, padding=1), nn.SiLU(), nn.Identity(),
            Conv2d(c_in * 8, c_in * 16, 3, stride=2, padding=1), nn.SiLU(),
            Conv2d(c_in * 16, d, 3, stride=2, padding=1)])
        self.context_embedding = nn.ModuleList([
            nn.Linear(d, temb), nn.SiLU(), nn.Linear(temb, d * c_in)])
        self.image_latents_proj_in = nn.ModuleList([
            Conv2d(c_in, c_in * 4, 1), nn.SiLU(), Conv2d(c_in * 4, c_in * 4, 3, padding=1),
            nn.SiLU(), Conv2d(c_in * 4, c_in, 3, padding=1)])
        self.image_latents_temporal_encoder = ImageLatentsTemporalEncoder(
            c_in, cfg.img_temporal_encoder_heads)
        self.conv_in = Conv2d(c_in * 2, ch0, 3, padding=1)
        self.transformer_in = TransformerTemporalModel(
            ch0, cfg.transformer_in_heads, cfg.attention_head_dim, cfg.norm_num_groups)
        chans = cfg.block_out_channels
        n = len(chans)
        self.down_blocks = nn.ModuleList()
        prev = ch0
        for i, ch in enumerate(chans):
            self.down_blocks.append(DownBlock3D(cfg, prev, ch, i < n - 1, i < n - 1))
            prev = ch
        self.mid_block = MidBlock3D(cfg, chans[-1])
        rev = tuple(reversed(chans))
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(rev):
            skips = [ch] * cfg.layers_per_block + [rev[min(i + 1, n - 1)]]
            self.up_blocks.append(UpBlock3D(cfg, rev[max(i - 1, 0)], skips, ch, i < n - 1, i > 0, i))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch0, eps=cfg.norm_eps)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def _context(self, b, f, h, w, image_latents, image_embeddings, text):
        c_in, d = self.config.in_channels, self.config.cross_attention_dim
        ce = self.image_latents_context_embedding
        il = F.silu(ce[0](image_latents[:, 0]))
        il = F.adaptive_avg_pool2d(il.permute(0, 3, 1, 2), (32, 32)).permute(0, 2, 3, 1)
        il = ce[5](F.silu(ce[3](il)))
        n_tok = il.shape[1] * il.shape[2]
        il_tokens = il.reshape(b, 1, n_tok, d).expand(b, f, n_tok, d)
        # frame 0's embedding on every frame, as the published pipeline feeds it
        ie = image_embeddings[:, 0:1].expand(b, f, image_embeddings.shape[-1])
        ie = self.context_embedding[2](F.silu(self.context_embedding[0](ie)))
        ie_tokens = ie.reshape(b, f, c_in, d)
        txt = text[:, None].expand((b, f) + text.shape[1:])
        return torch.cat([txt, il_tokens, ie_tokens], dim=2).reshape(b * f, -1, d)

    def forward(self, sample, t: int, fps, image_latents, image_embeddings, text,
                inj: Optional[Injection] = None):
        cfg = self.config
        b, f, h, w, c_in = sample.shape
        ch0 = cfg.block_out_channels[0]
        dev, dt = sample.device, self.conv_in.weight.dtype
        tt = torch.full((b,), int(t), device=dev, dtype=torch.long)
        emb = self.time_embedding(timestep_embedding(tt, ch0).to(dt))
        emb = emb + self.fps_embedding(timestep_embedding(fps.to(dev), ch0).to(dt))
        emb = emb.repeat_interleave(f, dim=0)
        context = self._context(b, f, h, w, image_latents, image_embeddings, text)

        pi = self.image_latents_proj_in
        ilf = pi[4](F.silu(pi[2](F.silu(pi[0](image_latents.reshape(b * f, h, w, c_in))))))
        ilf = ilf.reshape(b, f, h, w, c_in).permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c_in)
        ilf = self.image_latents_temporal_encoder(ilf)
        ilf = ilf.reshape(b, h, w, f, c_in).permute(0, 3, 1, 2, 4).reshape(b * f, h, w, c_in)
        x = self.conv_in(torch.cat([sample.reshape(b * f, h, w, c_in), ilf], dim=-1))
        x = self.transformer_in(x, f)
        stack = [x]
        for blk in self.down_blocks:
            x, res = blk(x, emb, context, f)
            stack.extend(res)
        x = self.mid_block(x, emb, context, f)
        n_up = cfg.layers_per_block + 1
        for i, blk in enumerate(self.up_blocks):
            res, stack = stack[-n_up:], stack[:-n_up]
            size = tuple(stack[-1].shape[1:3]) if (i < len(self.up_blocks) - 1 and stack) else None
            x = blk(x, res, emb, context, f, size, inj)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        if inj is not None:
            edit = inj.conv(x.shape[1], x.shape[2])
            if edit is not None:
                x = edit(x)
        return x.reshape(b, f, h, w, cfg.out_channels)


# ---------------------------------------------------------------------------
# VAE encoder (the SD-2.x AutoencoderKL's encode half)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttention(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        t = attention(self.to_q(t), self.to_k(t), self.to_v(t), 1)
        return self.to_out[0](t).reshape(b, h, w, c) + x


class _VAEMid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0)


class _EncBlock(nn.Module):
    def __init__(self, cin: int, ch: int, n: int, groups: int, down: bool):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(cin if j == 0 else ch, ch, groups)
                                      for j in range(n)])
        self.downsamplers = nn.ModuleList([_Sampler(ch)]) if down else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _EncBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block, g, i < len(ch) - 1)
            for i, c in enumerate(ch)])
        self.mid_block = _VAEMid(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class VAEEncoder(nn.Module):
    """encode(x [B, H, W, 3] in [-1, 1]) -> (mean, logvar); the decoder's
    parameters are not held (nothing the benchmark compares decodes)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)


# ---------------------------------------------------------------------------
# CLIP towers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, causal: bool):
        b, s, c = x.shape
        d = c // self.heads

        def heads(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2)
        logits = torch.matmul(heads(self.q_proj(x)), heads(self.k_proj(x)).transpose(-1, -2))
        logits = logits / math.sqrt(d)
        if causal:
            keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
        out = torch.matmul(torch.softmax(logits, dim=-1), heads(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class _MLP(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, inner: int, heads: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm1 = LayerNorm(dim, eps)
        self.mlp = _MLP(dim, inner)
        self.layer_norm2 = LayerNorm(dim, eps)

    def forward(self, x, causal: bool = False):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _Layers(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads,
                             cfg.layer_norm_eps) for _ in range(cfg.num_hidden_layers)])


class _TextEmb(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _TextEmb(cfg)
        self.encoder = _Layers(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPText(nn.Module):
    """ids [B, S] -> the penultimate layer's states after the final LN
    (clip_skip 1, as the pipeline encodes prompts)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.text_model = _TextModel(cfg)

    def forward(self, ids):
        tm = self.text_model
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[
            None, :ids.shape[1]]
        for layer in tm.encoder.layers[:-1]:
            x = layer(x, causal=True)
        return tm.final_layer_norm(x)


class _VisionEmb(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size,
                                      bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1,
                                               cfg.hidden_size)


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmb(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = _Layers(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPVision(nn.Module):
    """pixels [B, H, W, 3] (CLIP-normalised) -> image embeddings [B, P]."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, px):
        vm, c = self.vision_model, self.config.hidden_size
        emb = vm.embeddings
        b = px.shape[0]
        patches = emb.patch_embedding(px).reshape(b, -1, c)
        x = torch.cat([emb.class_embedding[None, None].expand(b, 1, c), patches], dim=1)
        x = vm.pre_layrnorm(x + emb.position_embedding.weight[None])
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
