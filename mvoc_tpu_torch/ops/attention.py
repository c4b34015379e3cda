"""Attention kernels K1 (flash) and K2 (frame) with their plain versions.

PyTorch counterpart of mvoc_tpu/ops/attention.py.  Each function here has:

  * a hand-written CUDA kernel for Hopper (`csrc/flash_attention.cu`,
    `csrc/frame_attention.cu`), launched for CUDA tensors;
  * a plain PyTorch version of the same function (`*_plain`), taken for CPU
    tensors only (the tests), and used by chip_smoke.py as the yardstick
    of correctness on the card;
  * a launch counter, `LAUNCHES[name]`, incremented exactly where the kernel
    is launched.

On a CUDA tensor the wrapper launches the kernel or raises: there is no
fallback to the plain version, and nothing here calls
`scaled_dot_product_attention` or cuDNN attention.

Dropped from the TPU kernels (TPU-only tuning, nothing to carry over):
`FLASH_MIN_SEQ` (the TPU left sequences under 1024 to XLA; here every
unmasked call takes K1 and every frame-axis call K2, so the plain versions
stay off the card's path; a frame-axis call over more than 64 frames, which
the TPU also left to XLA, takes K1 with the band as its bias),
`_pick_block`'s MXU-aligned divisors and the `MVOC_FLASH_BLOCK_Q/K`
overrides (the CUDA kernel masks any ragged tail, its tiles are fixed per
head dim), the 96 MB VMEM limits, and the head merge with a block-diagonal
bias (`_head_group_size`, `_block_diag_bias`):
that merge filled the 128x128 MXU; on the card each head is computed on
its own.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from collections import Counter
from typing import Optional

import torch

from mvoc_tpu_torch.ops import _build

NEG_BIG = -1e30  # finite mask value, never -inf (see csrc/common.cuh)

LAUNCHES = {"flash_attention": 0, "frame_attention": 0}
# launches per call signature, counted beside LAUNCHES: K1 (B, H, Sq, Sk, D,
# dtype, biased), K2 (layout, B, F, S, heads, D, dtype, masked)
LAUNCH_SHAPES: dict = {"flash_attention": Counter(), "frame_attention": Counter()}
# launches per design (flash_variant / frame_variant names), counted beside LAUNCHES
LAUNCH_VARIANTS: dict = {"flash_attention": Counter(), "frame_attention": Counter()}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
FLASH_HEAD_DIMS = (4, 64, 512)  # 4: the image-latents encoder over > 64 frames
FRAME_HEAD_DIMS = (4, 64)
FRAME_MAX_FRAMES = 64


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k].clear()
        LAUNCH_VARIANTS[k].clear()


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K1: flash attention
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v over [B, H, S, D], in the kernel's
    order: q scaled once and rounded to its dtype, fp32 logits and
    statistics, the optional fp32 bias [Sq, Sk] added to the scaled logits
    and floored at -2e30 (below the kernel's initial running max, see
    csrc/flash_attention.cu), p rounded to the input dtype before the P.V
    product, divided by l last."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if bias is not None:
        s = (s + bias.to(s.device, torch.float32)).clamp_min(2 * NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype)


# K1's designs on the card (csrc/flash_attention.cu), by the code its C entry
# takes.  The wrapper picks one from (dtype, head dim) alone; "simt" on bf16
# serves side-by-side timing only (chip_smoke.py).
FLASH_VARIANTS = {"simt": 0, "wgmma": 1}
_TC_ALIGN = 16  # bytes: the tensor-core variants of K1 and K2 copy rows in 16-byte pieces


def flash_variant(dtype: torch.dtype, d: int) -> str:
    """The K1 design a (dtype, head dim) takes on the card, the same every
    time: bf16 runs on the tensor cores (wgmma, D = 64 and 512); fp32 keeps
    the SIMT kernel's exact fp32 FMAs (tensor cores would take it to TF32),
    and D = 4 (the image-latents encoder) the SIMT kernel too."""
    _require(dtype in _DTYPE_CODE, f"flash_attention: dtype {dtype} not supported on CUDA")
    _require(d in FLASH_HEAD_DIMS, f"flash_attention: head dim {d} not in {FLASH_HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 and d != 4 else "simt"


def flash_layout_error(name: str, shape, strides, ptr: int, itemsize: int,
                       kernel: str = "flash_attention",
                       axes=("batch", "head", "seq")) -> Optional[str]:
    """Why a tensor-core variant cannot copy an operand of this shape with
    these element strides from this address, or None.  Every row it copies
    must start on a 16-byte boundary: the pointer, and each stride of an
    outer axis longer than 1 (K1: [B, H, S, D]'s batch, head and seq; K2:
    [B, F, S, H*D]'s batch, frame and pixel), times the item size."""
    if ptr % _TC_ALIGN:
        return f"{kernel}: {name} data pointer {ptr:#x} is not {_TC_ALIGN}-byte aligned"
    for axis, n, st in zip(axes, shape[:3], strides[:3]):
        if n > 1 and (st * itemsize) % _TC_ALIGN:
            return (f"{kernel}: {name} {axis} stride {st} is not a multiple of "
                    f"{_TC_ALIGN // itemsize} elements")
    return None


def _flash_cuda(q, k, v, variant: Optional[str] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, h, sq, d = q.shape
    sk = k.shape[2]
    default = flash_variant(q.dtype, d)  # also refuses an unsupported dtype or head dim
    variant = variant or default
    _require(variant in FLASH_VARIANTS, f"flash_attention: unknown variant {variant!r}")
    _require(variant == "simt" or (q.dtype == torch.bfloat16 and d != 4),
             f"flash_attention: variant {variant} takes bf16 at D = 64 or 512, not {q.dtype} "
             f"at {d}")
    _require(k.dtype == q.dtype and v.dtype == q.dtype, "flash_attention: q/k/v dtypes differ")
    _require(k.shape == (b, h, sk, d) and v.shape == (b, h, sk, d),
             f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} vs q {tuple(q.shape)}")
    _require(q.device == k.device == v.device, "flash_attention: tensors on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.stride(-1) == 1, f"flash_attention: {name} head dim must be contiguous")
        problem = None if variant == "simt" else flash_layout_error(
            name, t.shape, t.stride(), t.data_ptr(), t.element_size())
        if problem:
            raise ValueError(problem)
    if bias is not None:
        _require(bias.dtype == torch.float32 and tuple(bias.shape) == (sq, sk)
                 and bias.is_contiguous() and bias.device == q.device,
                 f"flash_attention: bias must be a contiguous fp32 [{sq}, {sk}] on {q.device}, "
                 f"not {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    # same [B, S, H, D] storage as the projections, viewed as [B, H, S, D]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _build.function("flash_attention", "mvoc_flash_attention", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if bias is None else bias.data_ptr(), FLASH_VARIANTS[variant],
             _DTYPE_CODE[q.dtype], b, h, sq, sk, d, strides, 1.0 / math.sqrt(d), _stream_ptr(q))
    _build.check("flash_attention", err, f"flash_attention launch ({variant})")
    LAUNCHES["flash_attention"] += 1
    LAUNCH_SHAPES["flash_attention"][(b, h, sq, sk, d, str(q.dtype), bias is not None)] += 1
    LAUNCH_VARIANTS["flash_attention"][variant] += 1
    return out


# a weak reference to the last bias that passed _check_bias_rows
_bias_checked: Optional[weakref.ref] = None


def _check_bias_rows(bias: torch.Tensor) -> None:
    """Refuse a bias with a row that keeps no key (every entry <= -1e30 / 2):
    the designs differ there (the wgmma ones divide by l = 0, the SIMT one
    and the plain version give the mean of v).  One reduction and one sync
    per bias tensor: a bias passed again (sdpa_frames' B launches, a timing
    loop) is not checked again, so a caller must not edit one in place."""
    global _bias_checked
    if _bias_checked is not None and _bias_checked() is bias:
        return
    _require(bool((bias.amax(dim=-1) > NEG_BIG / 2).all()),
             "flash_attention: every bias row must keep a key (an entry above -5e29)")
    _bias_checked = weakref.ref(bias)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1.  q [B, H, Sq, D], k/v [B, H, Sk, D] (any strides with a contiguous
    head dim) -> [B, H, Sq, D]; bias: optional fp32 [Sq, Sk] added to the
    scaled logits of every (batch, head), -1e30 where masked (band_bias),
    each row keeping at least one key (refused otherwise).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if bias is not None:
        _check_bias_rows(bias)
    if q.is_cuda:
        return _flash_cuda(q, k, v, bias=bias)
    return flash_attention_plain(q, k, v, bias)


# ---------------------------------------------------------------------------
# K2: frame attention
# ---------------------------------------------------------------------------


def band_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[F, F] boolean band -> fp32 additive bias (0 allowed, -1e30 not)."""
    if mask is None:
        return None
    return torch.where(mask, 0.0, NEG_BIG).to(torch.float32).contiguous()


def _as_natural(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A [B, F, S, H*D] view of either layout (sf [S, F, HD] -> [1, F, S, HD])."""
    if layout == "natural":
        return t
    if layout == "sf":
        return t.transpose(0, 1).unsqueeze(0)
    raise ValueError(f"unknown frame layout {layout!r}")


def frame_attention_plain(q, k, v, heads: int, mask: Optional[torch.Tensor] = None,
                          layout: str = "natural") -> torch.Tensor:
    """Attention across the frame axis for every pixel and head: fp32 logits,
    max-subtracted softmax, p normalised then rounded to the input dtype."""
    qn, kn, vn = (_as_natural(t, layout) for t in (q, k, v))
    b, f, s, inner = qn.shape
    d = inner // heads
    qh = qn.reshape(b, f, s, heads, d).float()
    kh = kn.reshape(b, f, s, heads, d).float()
    vh = vn.reshape(b, f, s, heads, d).float()
    logits = torch.einsum("bfshd,bgshd->bshfg", qh, kh) * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = logits + band_bias(mask).to(logits.device)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype).float()
    out = torch.einsum("bshfg,bgshd->bfshd", p, vh).reshape(b, f, s, inner).to(q.dtype)
    if layout == "sf":
        return out[0].transpose(0, 1)
    return out


# K2's designs on the card (csrc/frame_attention.cu), by the code its C entry
# takes.  The wrapper picks one from (dtype, head dim) alone; "simt" on bf16
# at D = 64 serves side-by-side timing only (chip_smoke.py).
FRAME_VARIANTS = {"simt": 0, "mma": 1}


def frame_variant(dtype: torch.dtype, d: int) -> str:
    """The K2 design a (dtype, head dim) takes on the card, the same every
    time: bf16 at D = 64 runs on the tensor cores (mma.sync); fp32 keeps the
    SIMT kernel's exact fp32 FMAs, and D = 4 (the image-latents temporal
    encoder) the SIMT kernel too."""
    _require(dtype in _DTYPE_CODE, f"frame_attention: dtype {dtype} not supported on CUDA")
    _require(d in FRAME_HEAD_DIMS, f"frame_attention: head dim {d} not in {FRAME_HEAD_DIMS}")
    return "mma" if dtype == torch.bfloat16 and d == 64 else "simt"


def _frame_cuda(q, k, v, heads, mask, layout, variant: Optional[str] = None) -> torch.Tensor:
    qn, kn, vn = (_as_natural(t, layout) for t in (q, k, v))
    b, f, s, inner = qn.shape
    _require(q.dtype in _DTYPE_CODE, f"frame_attention: dtype {q.dtype} not supported on CUDA")
    _require(k.dtype == q.dtype and v.dtype == q.dtype, "frame_attention: q/k/v dtypes differ")
    _require(inner % heads == 0, f"frame_attention: {inner} channels, {heads} heads")
    d = inner // heads
    default = frame_variant(q.dtype, d)  # also refuses an unsupported head dim
    variant = variant or default
    _require(variant in FRAME_VARIANTS, f"frame_attention: unknown variant {variant!r}")
    _require(variant == "simt" or (q.dtype == torch.bfloat16 and d == 64),
             f"frame_attention: variant {variant} takes bf16 at head dim 64, not {q.dtype} "
             f"at {d}")
    _require(f <= FRAME_MAX_FRAMES, f"frame_attention: {f} frames > {FRAME_MAX_FRAMES}")
    _require(q.device == k.device == v.device, "frame_attention: tensors on different devices")
    for name, t in (("k", kn), ("v", vn)):
        _require(t.shape == qn.shape and t.stride() == qn.stride(),
                 f"frame_attention: {name} must match q in shape and strides")
    _require(qn.stride(-1) == 1, "frame_attention: channel axis must be contiguous")
    # q's strides when q is dense (a permuted layout), else contiguous: a
    # strided projection (one slice of a fused q/k/v output) gets a dense out
    out = torch.empty_like(q, memory_format=torch.preserve_format)
    on = _as_natural(out, layout)
    _require(on.stride(-1) == 1, "frame_attention: output channel axis must be contiguous")
    if variant == "mma":
        for name, t in (("q", qn), ("k", kn), ("v", vn), ("out", on)):
            problem = flash_layout_error(name, t.shape, t.stride(), t.data_ptr(),
                                         t.element_size(), "frame_attention",
                                         ("batch", "frame", "pixel"))
            if problem:
                raise ValueError(problem)
    bias = band_bias(mask)
    if bias is not None:
        _require(bias.shape == (f, f), f"frame_attention: mask {tuple(bias.shape)} vs F={f}")
        bias = bias.to(q.device)
    strides = (ctypes.c_longlong * 6)(*qn.stride()[:3], *on.stride()[:3])
    fn = _build.function("frame_attention", "mvoc_frame_attention", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    err = fn(qn.data_ptr(), kn.data_ptr(), vn.data_ptr(), on.data_ptr(),
             None if bias is None else bias.data_ptr(), FRAME_VARIANTS[variant],
             _DTYPE_CODE[q.dtype], b, f, s, heads, d, strides,
             1.0 / math.sqrt(d), _stream_ptr(q))
    _build.check("frame_attention", err, f"frame_attention launch ({variant})")
    LAUNCHES["frame_attention"] += 1
    LAUNCH_SHAPES["frame_attention"][
        (layout, b, f, s, heads, d, str(q.dtype), mask is not None)] += 1
    LAUNCH_VARIANTS["frame_attention"][variant] += 1
    return out


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    mask: Optional[torch.Tensor] = None, layout: str = "natural") -> torch.Tensor:
    """K2.  Self-attention across the frame axis, per pixel and head.

    layout "natural": q/k/v [B, F, S, H*D] (frame-major, sdpa_frames);
    layout "sf":      q/k/v [S, F, H*D]    (pixel-major tokens, sdpa).
    mask: optional [F, F] boolean band (windowed temporal attention)."""
    if q.is_cuda:
        return _frame_cuda(q, k, v, heads, mask, layout)
    return frame_attention_plain(q, k, v, heads, mask, layout)
