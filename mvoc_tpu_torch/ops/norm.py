"""Fused GroupNorm (+SiLU) and LayerNorm for the models layer, with their
plain versions.

No TPU kernel stands behind these: the JAX package writes its norms as jnp
expressions (mvoc_tpu/models/layers.py) that XLA fuses.  Eager PyTorch runs
the same expression as ~21 passes over fp32 temporaries a GroupNorm and
~11 a LayerNorm, so the port fuses them by hand (`csrc/norm.cu`):

  * `group_norm(x, weight, bias, groups, eps, silu)`: channels-last x, 4-D
    [B, H, W, C] (statistics per sample) or 5-D [B, F, H, W, C] (joint
    (F, H, W) statistics), bf16 or fp32, contiguous; fp32 centred
    statistics, the affine folded into per-channel coefficients rounded to
    x's dtype, then y = x * a + b and optionally SiLU, one rounding.  Three
    launches: the tiles' partial moments, their merge into the
    coefficients, and the apply pass.  Where a 5-D x holds one rank's
    share of each sample's frames (the mesh's "seq" axis), `gather`
    all-gathers the partial moments between the first launch and the
    second, and the merge runs over every rank's tiles in rank order.
  * `layer_norm(x, weight, bias, eps)`: over the last dim of contiguous x,
    bf16 or fp32; one launch, the row held in registers for a two-pass mean
    and centred variance.

CUDA tensors launch the kernels; CPU (and meta) tensors take the plain
versions, which are the models layer's code as it was before the kernels.
On a CUDA tensor the wrapper launches or raises: nothing falls back.
`LAUNCHES` / `LAUNCH_SHAPES` count the launches (a GroupNorm's three
kernels count as one); `PLAIN_CALLS` counts CUDA tensors that took a plain
version (only chip_smoke.py's comparisons call them on the card): 0 on
every main path.  The tiling adapts to the shape it is given
(`group_norm_plan`, `layer_norm_plan`), so one kernel family serves the
UNet, the VAE and the CLIP towers.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mvoc_tpu_torch.ops import _build

LAUNCHES = {"group_norm": 0, "layer_norm": 0}
# launches per (x shape, groups, eps, silu, dtype) / (x shape, eps, dtype)
LAUNCH_SHAPES: dict = {"group_norm": Counter(), "layer_norm": Counter()}
# CUDA tensors that took the plain version
PLAIN_CALLS = {"group_norm": 0, "layer_norm": 0}
# the __global__ functions of csrc/norm.cu: the profiler books each to the
# "normalisation" kernel group by the "norm" in its name
KERNEL_NAMES = ("group_norm_stats", "group_norm_finalize", "group_norm_apply",
                "layer_norm_rows")
# rows a thread of the GroupNorm stats / apply kernels owns (csrc/norm.cu
# kRowsPerThread): a tile is by * GN_ROWS_PER_THREAD rows
GN_ROWS_PER_THREAD = 8
GN_MAX_THREADS = 512
GN_VEC = 8  # channels a thread loads at once when C and the base allow
# vectors a LayerNorm lane can hold in registers (csrc/norm.cu's instantiations)
LN_VECTORS = (1, 2, 3, 4, 5, 8, 10, 16)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# all-gathers a rank's partial moments [B, T, G, 2] over the ranks that split
# a sample's frames, in rank order: -> [R, B, T, G, 2]
Gather = Callable[[torch.Tensor], torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k].clear()
        PLAIN_CALLS[k] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm in plain PyTorch: two-pass centred variance in fp32; the
    affine folded into per-channel coefficients applied in x's dtype; SiLU
    after it when asked."""
    if x.is_cuda:
        PLAIN_CALLS["group_norm"] += 1
    b, c = x.shape[0], x.shape[-1]
    g = groups
    dims = tuple(range(1, x.ndim - 1))
    bshape = (b,) + (1,) * len(dims) + (c,)
    xf = x.float()
    mean_c = xf.mean(dim=dims)                                   # [B, C]
    mean_g = mean_c.view(b, g, c // g).mean(-1)
    cen2_c = (xf - mean_g.repeat_interleave(c // g, -1).view(bshape)).square().mean(dim=dims)
    del xf
    var_g = cen2_c.view(b, g, c // g).mean(-1)
    return _group_norm_apply_plain(x, weight, bias, mean_g, var_g, eps, silu)


def _group_norm_apply_plain(x, weight, bias, mean_g, var_g, eps: float, silu: bool):
    """y = x * a_c + b_c (then SiLU) from the groups' mean and variance
    [B, G], the coefficients rounded to x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    cpg = c // mean_g.shape[-1]
    bshape = (b,) + (1,) * (x.ndim - 2) + (c,)
    mean_ch = mean_g.repeat_interleave(cpg, -1)
    inv_ch = torch.rsqrt(var_g + eps).repeat_interleave(cpg, -1)
    w = weight.float()[None]
    a_ch = (inv_ch * w).view(bshape).to(x.dtype)
    b_ch = (bias.float()[None] - mean_ch * inv_ch * w).view(bshape).to(x.dtype)
    y = x * a_ch + b_ch
    return F.silu(y) if silu else y


def _group_norm_gathered_plain(x, weight, bias, groups: int, eps: float, silu: bool,
                               gather: Gather) -> torch.Tensor:
    """The plain version of group_norm(..., gather=gather): this rank's
    (mean, M2) per group as one tile [B, 1, G, 2], all-gathered, merged as
    the finalize kernel merges them (every rank holds as many rows)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3))                                   # [B, G]
    m2 = (xg - mean[:, None, :, None]).square().sum(dim=(1, 3))
    n = xg.shape[1] * xg.shape[3]
    del xg
    parts = _gathered(gather, torch.stack([mean, m2], -1)[:, None])
    p = parts.movedim(0, 1).reshape(b, -1, groups, 2)            # [B, R, G, 2], rank order
    m = p[..., 0]
    m0 = m[:, :1]
    mean_g = m0[:, 0] + (m - m0).sum(1) / p.shape[1]
    var_g = (p[..., 1].sum(1) + n * (m - mean_g[:, None]).square().sum(1)) / (n * p.shape[1])
    return _group_norm_apply_plain(x, weight, bias, mean_g, var_g, eps, silu)


def _gathered(gather: Gather, part: torch.Tensor) -> torch.Tensor:
    parts = gather(part)
    if (parts.ndim != part.ndim + 1 or tuple(parts.shape[1:]) != tuple(part.shape)
            or parts.dtype != torch.float32 or parts.device != part.device
            or not parts.is_contiguous()):
        raise ValueError(f"group_norm: gather must return contiguous fp32 [R, "
                         f"{', '.join(map(str, part.shape))}] on {part.device}, not {parts.dtype} "
                         f"{tuple(parts.shape)} on {parts.device}")
    return parts


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in plain PyTorch, fp32 statistics; the
    affine in x's dtype."""
    if x.is_cuda:
        PLAIN_CALLS["layer_norm"] += 1
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return xn * weight.to(x.dtype) + bias.to(x.dtype)


# ---------------------------------------------------------------------------
# tiling plans (from the shape alone)
# ---------------------------------------------------------------------------


def group_norm_plan(c: int, aligned: bool) -> tuple[int, int]:
    """(vec, by) of the GroupNorm kernels for C channels: vec channels a
    thread loads at once (GN_VEC: one 16-byte bf16 or two fp32 vectors, when
    C and a 16-byte aligned base allow, else 1), blocks of C / vec x by
    threads (by rows of threads, at most GN_MAX_THREADS a block).  Raises on
    C the kernels cannot take."""
    vec = GN_VEC if c % GN_VEC == 0 and aligned else 1
    v = c // vec
    _require(v <= GN_MAX_THREADS,
             f"group_norm: C = {c} needs {v} threads a row (at most {GN_MAX_THREADS})")
    return vec, GN_MAX_THREADS // v


def gn_tiles(s: int, by: int) -> int:
    return -(-s // (by * GN_ROWS_PER_THREAD))


def layer_norm_plan(d: int, itemsize: int, align: int) -> tuple[int, int, int]:
    """(vec, tpr, nv) of the LayerNorm kernel for rows of width d: vec
    elements a lane loads at once (16 or 8 bytes' worth, or 1, as d and
    `align`, the common alignment of every base and row stride in bytes,
    allow); tpr lanes a row, the largest power of two up to 32 that divides
    the row's d / vec vectors while a lane needs at most the largest of
    LN_VECTORS of them (else 32 lanes); nv vectors a lane, the smallest of
    LN_VECTORS that holds its share (the rest masked).  Raises on d the
    kernel cannot take."""
    vec = 1
    for nbytes in (16, 8):
        n = nbytes // itemsize
        if n > 1 and d % n == 0 and align % nbytes == 0:
            vec = n
            break
    nvec = d // vec
    tpr = 32
    while tpr > 1 and nvec % tpr:
        tpr //= 2
    if nvec // tpr > LN_VECTORS[-1]:
        tpr = 32
    need = -(-nvec // tpr)
    nv = next((n for n in LN_VECTORS if n >= need), None)
    _require(nv is not None,
             f"layer_norm: width {d} needs {need} vectors of {vec} a lane "
             f"(at most {LN_VECTORS[-1]})")
    return vec, tpr, nv


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _affine_ok(x: torch.Tensor, t: torch.Tensor, n: int) -> bool:
    return (t.shape == (n,) and t.device == x.device and t.dtype in _DTYPE_CODE
            and t.is_contiguous())


def _affine_error(name: str, x: torch.Tensor, t: torch.Tensor, n: int) -> ValueError:
    return ValueError(f"{name}: weight and bias must be contiguous fp32 or bf16 [{n}] on "
                      f"{x.device}, not {t.dtype} {tuple(t.shape)} on {t.device}")


# The checks below raise with a message built only on failure: the wrappers
# run once a norm, hundreds of times a UNet forward, on the host's clock.


_GN_SHAPE_ARGS = [ctypes.c_int] * 7       # B, S, C, G, vec, by, n_tiles


def _group_norm_cuda(x, weight, bias, groups: int, eps: float, silu: bool,
                     gather: Optional[Gather] = None) -> torch.Tensor:
    if x.ndim not in (4, 5):
        raise ValueError(f"group_norm: x must be 4-D [B, H, W, C] or 5-D [B, F, H, W, C], "
                         f"not {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group_norm: x must be fp32 or bf16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"group_norm: x must be contiguous (strides {x.stride()})")
    shape = tuple(x.shape)
    b, c = shape[0], shape[-1]
    s = math.prod(shape[1:-1])
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm: {groups} groups of {c} channels")
    if b * s == 0:
        raise ValueError(f"group_norm: empty x {shape}")
    for t in (weight, bias):
        if not _affine_ok(x, t, c):
            raise _affine_error("group_norm", x, t, c)
    if weight.dtype != bias.dtype:
        raise ValueError("group_norm: weight and bias dtypes differ")
    if gather is not None and x.ndim != 5:
        raise ValueError("group_norm: gather takes a 5-D x (a sample's frames split over ranks)")
    vec, by = group_norm_plan(c, x.data_ptr() % 16 == 0)
    n_tiles = gn_tiles(s, by)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dims = (b, s, c, groups, vec, by, n_tiles)
    if gather is None:
        # one C call for all three launches (the host runs this hundreds of
        # times a forward) and one fp32 workspace: the tiles' (mean, M2) per
        # group, then the coefficients a_c, b_c in x's dtype from a 16-byte
        # boundary
        n_part = -(-b * n_tiles * groups * 2 // 4) * 4
        ws = torch.empty(n_part + -(-2 * b * c * x.element_size() // 4), dtype=torch.float32,
                         device=x.device)
        fn = _build.function("norm", "mvoc_group_norm", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                             + _GN_SHAPE_ARGS + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(),
                 ws.data_ptr() + 4 * n_part, _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype],
                 *dims, eps, int(silu), stream)
        _build.check("norm", err, "group_norm launch")
    else:
        part = torch.empty((b, n_tiles, groups, 2), dtype=torch.float32, device=x.device)
        fn = _build.function("norm", "mvoc_group_norm_stats", [ctypes.c_void_p] * 2 + [
            ctypes.c_int] + _GN_SHAPE_ARGS + [ctypes.c_void_p])
        _build.check("norm", fn(x.data_ptr(), part.data_ptr(), _DTYPE_CODE[x.dtype], *dims,
                                stream), "group_norm stats launch")
        parts = _gathered(gather, part)
        coef = torch.empty(2 * b * c, dtype=x.dtype, device=x.device)
        fn = _build.function("norm", "mvoc_group_norm_finish", [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 2 + _GN_SHAPE_ARGS + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p])
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 parts.data_ptr(), coef.data_ptr(), _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[weight.dtype], *dims, parts.shape[0], eps, int(silu), stream)
        _build.check("norm", err, "group_norm finish launch")
    LAUNCHES["group_norm"] += 1
    LAUNCH_SHAPES["group_norm"][(shape, groups, eps, silu, str(x.dtype))] += 1
    return y


def _layer_norm_cuda(x, weight, bias, eps: float) -> torch.Tensor:
    if x.ndim < 1 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm: x must be fp32 or bf16 with a last dim, not {x.dtype} "
                         f"{tuple(x.shape)}")
    shape = tuple(x.shape)
    d = shape[-1]
    rows = x.numel() // max(d, 1)
    if rows == 0 or d == 0:
        raise ValueError(f"layer_norm: empty x {shape}")
    if not x.is_contiguous():
        raise ValueError(f"layer_norm: x must be contiguous (strides {x.stride()})")
    for t in (weight, bias):
        if not _affine_ok(x, t, d):
            raise _affine_error("layer_norm", x, t, d)
    # the plain version applies the affine in x's dtype
    if weight.dtype != x.dtype:
        weight = weight.to(x.dtype)
    if bias.dtype != x.dtype:
        bias = bias.to(x.dtype)
    elt = x.element_size()
    align = math.gcd(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), 16)
    vec, tpr, nv = layer_norm_plan(d, elt, align)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = _build.function("norm", "mvoc_layer_norm", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p])
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
             _DTYPE_CODE[x.dtype], rows, d, vec, nv, tpr, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("norm", err, "layer_norm launch")
    LAUNCHES["layer_norm"] += 1
    LAUNCH_SHAPES["layer_norm"][(shape, eps, str(x.dtype))] += 1
    return y


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, silu: bool = False, gather: Optional[Gather] = None) -> torch.Tensor:
    """GroupNorm of channels-last x (4-D: per-sample statistics; 5-D: joint
    (F, H, W) statistics) with `groups` groups, the affine, then SiLU when
    asked.  gather: where a 5-D x holds this rank's share of each sample's
    frames (as many on every rank), the all-gather of the partial moments
    over those ranks (`Gather`); the statistics then span every rank's
    frames.  CUDA tensors launch the kernels; others take the plain
    versions."""
    if x.is_cuda:
        return _group_norm_cuda(x, weight, bias, groups, eps, silu, gather)
    if gather is not None:
        return _group_norm_gathered_plain(x, weight, bias, groups, eps, silu, gather)
    return group_norm_plain(x, weight, bias, groups, eps, silu)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dim of x with the affine in x's dtype.  CUDA
    tensors launch the kernel; others take the plain version."""
    if x.is_cuda:
        return _layer_norm_cuda(x, weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)
