"""Int8 weight + activation (w8a8) matmuls and convolutions (counterpart of
mvoc_tpu/ops/quantize.py).

The symmetric-int8 recipe of the JAX package, operation for operation:

  * weights:      per-output-channel scales amax / 127 (1 for an all-zero
                  channel), round half to even, clip to +-127; quantized
                  ONCE by `quantize_unet_`, a pass over the module tree that
                  swaps the selected nn.Linear / Conv2d / Conv3d for
                  QuantLinear / QuantConv;
  * activations:  dynamic scales, per row (token) for matmuls and the stacked
                  temporal conv, per sample (axis 0) for `int8_conv`;
  * accumulation: int32, through K3 (ops/s8gemm.py): on the card every
                  s8 x s8 -> s32 product of this module is the hand-written
                  kernel, on the CPU its plain version;
  * epilogue:     float32(acc) * (x_scale * w_scale), one rounding to the
                  output dtype, then the bias in that dtype.

`int8_conv` is an im2col convolution: the zero-padded int8 input is cut into
kh*kw (or kf*kh*kw) strided slices concatenated on the channel axis, in the
(taps..., C) order of the flax kernel, so the patches times the kernel
reshaped to [taps*C, O] gives exactly the int32 accumulator of XLA's int8
convolution.  (`F.unfold` does not take int8 tensors.)

The public functions keep the JAX package's layouts: channels-last
activations, dense kernels [K, N] and conv kernels [*taps, C, O] with
per-output scales.  The Quant modules store their int8 weight as [N, K]
(K contiguous, as K3 reads it) and pass these functions the flax-layout
views of it, which need no copy.

Spans (utils.profiling.span, recorded only while a torch profiler records):
each Quant module's forward runs inside `int8/linear` or `int8/conv`; in
it the activation's quantize passes inside `int8/quantize`, the patches of
`int8_conv` inside `int8/im2col`, and K3 (its host work and launch) inside
`int8/s8_matmul` (ops/s8gemm.py).

Not carried over: the MVOC_S8_IMPL switch (XLA's int8 dot or the Pallas
kernel; here K3 is the s8 GEMM on the card) and the MVOC_TCONV_ROWS
override of the stacked-conv row limit.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvoc_tpu_torch.models import layers
from mvoc_tpu_torch.ops import s8gemm
from mvoc_tpu_torch.utils.profiling import span

# int8 symmetric range: clip to +-127 (not -128) so the scale maps max|x|
# exactly and the quantizer is symmetric around 0
_QMAX = 127.0
_INV_QMAX = float(np.float32(1.0 / _QMAX))
# the stacked (3,1,1) temporal conv's envelope (mvoc_tpu/ops/conv.py:184,
# :226): at most this many GEMM rows B*F*H*W and frames; outside it int8_conv
TCONV_STACK3_MAX_ROWS = 4096
TCONV_STACK3_MAX_FRAMES = 16


@dataclasses.dataclass
class QuantizedTensor:
    """An int8 tensor and its fp32 dequantisation scale, broadcastable to it."""

    data: torch.Tensor   # int8
    scale: torch.Tensor  # fp32


def _symmetric(x: torch.Tensor, reduce_axes: Sequence[int], amax_hook=None):
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    if amax_hook is not None:  # a row split over ranks: the max over all of them
        amax = amax_hook(amax)
    # amax / 127 as XLA compiles it inside jit (every JAX caller runs jitted):
    # a multiply by the fp32 reciprocal, which differs from the division in
    # the last bit for some amax.  x / scale stays a true division there too.
    scale = torch.where(amax > 0, amax * _INV_QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def quantize_tensor(w: torch.Tensor, channel_axes: Sequence[int]) -> QuantizedTensor:
    """Symmetric per-channel int8 quantization: one scale per index along
    `channel_axes`, all other axes share it (kept as size-1 dims)."""
    reduce_axes = [a for a in range(w.ndim) if a not in tuple(channel_axes)]
    return QuantizedTensor(*_symmetric(w, reduce_axes))


def _quantize_activation(x: torch.Tensor, reduce_axes: Sequence[int], amax_hook=None):
    """Dynamic symmetric int8 quantization; `reduce_axes` share one scale
    (the contraction axis for per-row scales, all but axis 0 per sample;
    amax_hook(amax) gives the amax over a contraction axis split across
    ranks).  Returns (int8 tensor, fp32 scale with keepdims)."""
    with span("int8/quantize"):
        return _symmetric(x, reduce_axes, amax_hook)


def _s8_gemm(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
             w_scale: torch.Tensor, *, out_dtype) -> torch.Tensor:
    """One s8 x s8 -> s32 GEMM with the dequantise epilogue: K3 on CUDA
    tensors, its plain version on CPU tensors."""
    return s8gemm.s8_matmul(xq, wq, x_scale, w_scale, out_dtype=out_dtype)


def int8_matmul(x: torch.Tensor, kernel: QuantizedTensor, *,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """w8a8 dense: x [..., K] with per-row scales, kernel [K, N] with
    per-N scales -> [..., N]."""
    xq, x_scale = _quantize_activation(x, (x.ndim - 1,))
    o_scale = kernel.scale.reshape(kernel.scale.shape[-1])
    m = math.prod(x.shape[:-1])
    out = _s8_gemm(xq.reshape(m, x.shape[-1]), kernel.data, x_scale.reshape(m), o_scale,
                   out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], kernel.data.shape[-1])


def int8_tconv_stack3(x5: torch.Tensor, kernel: QuantizedTensor, *,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """w8a8 (3,1,1) temporal conv, padding 1 on frames, as one GEMM
    [B*F*H*W, C] x [C, 3*O] with per-row activation scales (columns ordered
    (tap, o); the column scale of (tap, o) is scale[o]), an fp32 output, then
    the frame-shifted sum of the three taps and one cast."""
    b, f, h, w, c = x5.shape
    o = kernel.data.shape[-1]
    xq, x_scale = _quantize_activation(x5, (x5.ndim - 1,))
    m = b * f * h * w
    # [3, 1, 1, C, O] -> [3*O, C] rows (tap, o), then its [C, 3*O] view
    wstack = kernel.data[:, 0, 0].permute(0, 2, 1).reshape(3 * o, c).t()
    col_scale = kernel.scale.reshape(1, o).expand(3, o).reshape(3 * o)
    y = _s8_gemm(xq.reshape(m, c), wstack, x_scale.reshape(m), col_scale,
                 out_dtype=torch.float32).reshape(b, f, h, w, 3, o)
    # out[f] = (y0[f-1] + y1[f]) + y2[f+1], zero beyond either end
    out = y[..., 1, :].clone()
    out[:, 1:] += y[:, :-1, ..., 0, :]
    out[:, :-1] += y[:, 1:, ..., 2, :]
    return out.to(out_dtype)


def _im2col(xq: torch.Tensor, taps: Sequence[int], strides: Sequence[int],
            padding: Sequence[tuple[int, int]]) -> torch.Tensor:
    """[N, *spatial, C] int8 -> [N, *out_spatial, prod(taps)*C] patches,
    channels ordered (taps..., C)."""
    nd = len(taps)
    pad = [0, 0]  # F.pad lists the last dim first: C, then spatial dims reversed
    for lo, hi in reversed(padding):
        pad += [lo, hi]
    xp = F.pad(xq, pad) if any(pad) else xq
    out_sizes = [(xp.shape[1 + i] - taps[i]) // strides[i] + 1 for i in range(nd)]
    cols = []
    for offs in itertools.product(*(range(t) for t in taps)):
        idx = tuple(slice(d, d + s * (n - 1) + 1, s) for d, s, n in zip(offs, strides, out_sizes))
        cols.append(xp[(slice(None),) + idx])
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)


def int8_conv(x: torch.Tensor, kernel: QuantizedTensor, *, strides: Sequence[int],
              padding: Sequence[tuple[int, int]], out_dtype=torch.bfloat16) -> torch.Tensor:
    """w8a8 conv on channels-last x [N, *spatial, C] with an HWIO / DHWIO
    kernel and per-O scales; one activation scale per sample (axis 0)."""
    xq, x_scale = _quantize_activation(x, range(1, x.ndim))
    nd = kernel.data.ndim - 2
    taps = tuple(kernel.data.shape[:nd])
    o = kernel.data.shape[-1]
    with span("int8/im2col"):
        patches = _im2col(xq, taps, tuple(strides), [tuple(p) for p in padding])
    n, out_sizes = patches.shape[0], patches.shape[1:-1]
    rows_per_sample = math.prod(out_sizes)
    k = patches.shape[-1]
    o_scale = kernel.scale.reshape(o)
    out = _s8_gemm(patches.reshape(n * rows_per_sample, k), kernel.data.reshape(k, o),
                   x_scale.reshape(n).repeat_interleave(rows_per_sample), o_scale,
                   out_dtype=out_dtype)
    return out.reshape(n, *out_sizes, o)


# ---------------------------------------------------------------------------
# Quantized modules
# ---------------------------------------------------------------------------


class _Quantized(nn.Module):
    """int8 weight [N, K] (K contiguous) and fp32 per-N scale as buffers,
    an optional bias; the output dtype is the activation's (the UNet runs
    its activations in its own dtype, the JAX modules' `dtype`)."""

    def _init_quant(self, qweight: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> None:
        self.register_buffer("weight", qweight.contiguous())
        self.register_buffer("weight_scale", scale.reshape(-1).to(torch.float32).contiguous())
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(),
                                                           requires_grad=False)

    def _apply(self, fn, recurse=True):
        # .to(dtype) / .half() convert every floating buffer: pass the scales
        # through as their int32 bit pattern so that they stay fp32
        self.weight_scale = self.weight_scale.view(torch.int32)
        try:
            return super()._apply(fn, recurse)
        finally:
            self.weight_scale = self.weight_scale.view(torch.float32)

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QuantLinear(_Quantized):
    """nn.Linear with an int8 weight: w8a8 through `int8_matmul`."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        q = quantize_tensor(weight.detach(), (0,))
        self._init_quant(q.data, q.scale, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = QuantizedTensor(self.weight.t(), self.weight_scale)  # [K, N] view
        with span("int8/linear"):
            return self._add_bias(int8_matmul(x, kernel, out_dtype=x.dtype))

    def partial_product(self, x: torch.Tensor, tp) -> torch.Tensor:
        """This rank's fp32 term of a row-split layer (parallel/mesh.
        shard_params kept columns K_r of the weight; x holds the same K_r):
        each row's activation scale from its amax over ALL of K (one max
        all-reduce over "model"), so every rank quantizes its slice as the
        single-rank layer does, then K3 on the slice, dequantised in fp32,
        no bias.  Summed over the ranks this is the single-rank product up
        to fp32 rounding of the sum (layers.row_parallel)."""
        from mvoc_tpu_torch.parallel import collectives as coll

        with span("int8/linear"):
            xq, x_scale = _quantize_activation(
                x, (x.ndim - 1,), amax_hook=lambda a: coll.all_reduce(a, tp, "model", op="max"))
            m = math.prod(x.shape[:-1])
            out = _s8_gemm(xq.reshape(m, x.shape[-1]), self.weight.t(), x_scale.reshape(m),
                           self.weight_scale, out_dtype=torch.float32)
            return out.reshape(*x.shape[:-1], self.weight.shape[0])


class QuantConv(_Quantized):
    """layers.Conv2d / Conv3d (channels-last) with an int8 weight stored as
    [O, taps*C] in (taps..., C) order.  The dispatch of the JAX QuantConv
    (mvoc_tpu/ops/quantize.py:264-282): a (3,1,1) kernel, stride 1, frame
    padding 1, at most TCONV_STACK3_MAX_ROWS rows B*F*H*W (counted per
    call) and TCONV_STACK3_MAX_FRAMES frames takes `int8_tconv_stack3`;
    every other conv `int8_conv`."""

    def __init__(self, conv: nn.Conv2d | nn.Conv3d):
        super().__init__()
        if conv.groups != 1 or any(d != 1 for d in conv.dilation) or isinstance(
                conv.padding, str) or conv.padding_mode != "zeros":
            raise ValueError(f"QuantConv takes ungrouped, undilated, zero-padded convs: {conv}")
        w = conv.weight.detach()
        nd = w.ndim - 2
        self.kernel_size = tuple(conv.kernel_size)
        self.stride = tuple(conv.stride)
        self.padding = tuple(conv.padding)
        self.in_channels = conv.in_channels
        q = quantize_tensor(w.permute(0, *range(2, nd + 2), 1).reshape(w.shape[0], -1), (0,))
        self._init_quant(q.data, q.scale, conv.bias)

    def kernel(self) -> QuantizedTensor:
        """The flax-layout [*taps, C, O] view of the weight and its scales."""
        o, nd = self.weight.shape[0], len(self.kernel_size)
        data = self.weight.view(o, *self.kernel_size, self.in_channels)
        return QuantizedTensor(data.permute(*range(1, nd + 2), 0), self.weight_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("int8/conv"):
            rows = math.prod(x.shape[:-1])
            if (self.kernel_size == (3, 1, 1) and self.stride == (1, 1, 1)
                    and self.padding == (1, 0, 0) and rows <= TCONV_STACK3_MAX_ROWS
                    and x.shape[1] <= TCONV_STACK3_MAX_FRAMES):
                y = int8_tconv_stack3(x, self.kernel(), out_dtype=x.dtype)
            else:
                y = int8_conv(x, self.kernel(), strides=self.stride,
                              padding=[(p, p) for p in self.padding], out_dtype=x.dtype)
            return self._add_bias(y)


# ---------------------------------------------------------------------------
# Selection and the module pass
# ---------------------------------------------------------------------------


def default_unet_predicate(names: Sequence[str]) -> bool:
    """Quantize everything except the layers that anchor the eps-prediction
    (time / fps embedding MLPs, conv_out) and the boundary convs with tiny
    contractions (conv_in, the image-latents projections and temporal
    encoder)."""
    skip = ("time_embedding", "fps_embedding", "conv_out", "conv_in",
            "image_latents_proj_in", "image_latents_temporal_encoder")
    return not any(any(s in n for s in skip) for n in names)


def mixed_unet_predicate(names: Sequence[str], leaf) -> bool:
    """The JAX package's shipped int8 selection, by the leaf's flax-layout
    shape: dense kernels [K, N] with K >= 1280, and (3,1,1) temporal conv
    kernels [3, 1, 1, C, O] with C >= 1280; nothing on the default skip
    list.  By shape alone, so it also takes the FF output projections of
    the 320 / 640 tiers (K = 1280, 2560), every resnet's time_emb_proj and
    context_embedding.2 (K = 1280)."""
    if not default_unet_predicate(names):
        return False
    if leaf.ndim == 2:
        return leaf.shape[0] >= 1280
    if leaf.ndim == 5:
        return tuple(leaf.shape[:3]) == (3, 1, 1) and leaf.shape[3] >= 1280
    return False


def _flax_leaf(module: nn.Module) -> Optional[torch.Tensor]:
    """The flax-layout view of a quantizable module's weight: dense [K, N],
    conv [*taps, C, O]; None for any other module."""
    if isinstance(module, nn.Linear):
        return module.weight.t()
    if isinstance(module, (layers.Conv2d, layers.Conv3d)):
        w = module.weight
        return w.permute(*range(2, w.ndim), 1, 0)
    return None


def quantize_unet_(model: nn.Module, predicate: Optional[Callable] = None) -> list[str]:
    """Swap the model's nn.Linear / layers.Conv2d / layers.Conv3d for
    QuantLinear / QuantConv, in place, where `predicate` selects them
    (all when None).  The predicate takes (names) or (names, leaf): names are
    the module's dotted name split on dots plus "weight", leaf the weight in
    the flax layout.  Runs once, outside any step loop.  Returns the
    quantized modules' names."""
    takes_leaf = predicate is not None and len(inspect.signature(predicate).parameters) >= 2
    done = []
    for name, module in list(model.named_modules()):
        leaf = _flax_leaf(module)
        if leaf is None:
            continue
        if predicate is not None:
            names = tuple(name.split(".")) + ("weight",)
            if not (predicate(names, leaf) if takes_leaf else predicate(names)):
                continue
        if isinstance(module, nn.Linear):
            quant = QuantLinear(module.weight, module.bias)
        else:
            quant = QuantConv(module)
        parent_name, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent_name), child, quant)
        done.append(name)
    return done
