"""K3: the s8 x s8 -> s32 GEMM with a fused dequantise epilogue, and its
plain version (counterpart of mvoc_tpu/ops/s8gemm.py).

    out[m, n] = float32(sum_k xq[m, k] * wq[k, n]) * (x_scale[m] * w_scale[n])

rounded once to `out_dtype` (fp32 or bf16).  `s8_matmul` launches the
hand-written CUDA kernel `csrc/s8_gemm.cu` for CUDA tensors and takes the
plain version for CPU tensors only; on a CUDA tensor the kernel cannot take
it raises, there is no fallback (and nothing here calls `torch._int_mm` or
cuBLAS).  `LAUNCHES` / `LAUNCH_SHAPES` count the kernel's launches.  Each
call runs inside the span `int8/s8_matmul` (utils.profiling.span): the
kernel launches through ctypes, which the profiler sees as a bare runtime
call with no aten op around it.

The plain version computes the product in float64: every partial sum is an
integer below K * 127^2 < 2^53, so float64 holds it exactly in any order,
and the fp32 epilogue then matches the kernel bit for bit.  (CUDA has no
integer matmul in PyTorch, so float64 also lets the plain version run on
the card, where chip_smoke.py compares the two.)

Dropped from the TPU kernel: the BLOCK_M/N/K tiling and its `bm/bn/bk`
arguments (the MXU's (32, 128) s8 tiling; the CUDA kernel fixes its own
tiles and masks ragged tails in shared memory, so nothing is padded in
HBM), and the MVOC_PALLAS_INTERPRET / MVOC_S8_INTERPRET knobs (the CPU
takes the plain version by the tensor's device).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from mvoc_tpu_torch.ops import _build
from mvoc_tpu_torch.utils import flops as _flops
from mvoc_tpu_torch.utils.profiling import span

LAUNCHES = {"s8_matmul": 0}
# launches per (M, K, N, out dtype), counted beside LAUNCHES
LAUNCH_SHAPES: dict = {"s8_matmul": Counter()}
# launches per design (s8_variant names), counted beside LAUNCHES
LAUNCH_VARIANTS: dict = {"s8_matmul": Counter()}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# |acc| <= K * 127^2 must fit int32
MAX_K = (2**31 - 1) // (127 * 127)


def reset_launch_counts() -> None:
    LAUNCHES["s8_matmul"] = 0
    LAUNCH_SHAPES["s8_matmul"].clear()
    LAUNCH_VARIANTS["s8_matmul"].clear()


def _scales(xq, wq, x_scale, w_scale):
    m, n = xq.shape[0], wq.shape[1]
    return (x_scale.reshape(m).to(torch.float32).contiguous(),
            w_scale.reshape(n).to(torch.float32).contiguous())


def _flat_f32(t: torch.Tensor, n: int) -> bool:
    return t.dtype == torch.float32 and t.numel() == n and t.is_contiguous()


def s8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the integer product exactly in
    float64, then the same fp32 epilogue and one rounding to out_dtype."""
    sx, sw = _scales(xq, wq, x_scale, w_scale)
    acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(torch.float32)
    return (acc * (sx[:, None] * sw[None, :])).to(out_dtype)


# K3's designs on the card (csrc/s8_gemm.cu), by the code its C entry takes:
# "wgmma" reads both operands by TMA and needs 16-byte rows; "mma" (PR 2's
# mma.sync kernel) takes any layout.  The wrapper picks one from the
# operands' layout alone (s8_variant); "mma" on a layout "wgmma" takes
# serves side-by-side timing only (chip_smoke.py).
S8_VARIANTS = {"mma": 0, "wgmma": 1}
_TMA_ALIGN = 16  # bytes: TMA wants 16-byte aligned bases and row strides


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"s8_matmul: {msg}")


def _k_contiguous(xq: torch.Tensor, wq: torch.Tensor):
    """Both operands K-contiguous: x [M, K] row-major; w the [K, N] view of
    [N, K] storage (the Quant modules' weights), else re-laid once here."""
    if xq.stride(1) != 1:
        xq = xq.contiguous()
    if wq.stride(0) != 1:
        wq = wq.t().contiguous().t()
    return xq, wq


def s8_variant(xq: torch.Tensor, wq: torch.Tensor, out_dtype) -> str:
    """The K3 design the operands take on the card, from their layout alone,
    the same every time; raises on what no design takes.  "wgmma" when TMA
    can read both operands in place: K-contiguous (x [M, K] row-major, w
    the [K, N] view of [N, K] storage), K and both row strides multiples of
    16 bytes, 16-byte aligned bases.  Else "mma", which re-lays an operand
    that is not K-contiguous (a row-major [K, N] weight) and reads any K
    (K = 36: the first image-latents conv)."""
    m, k = xq.shape
    k2, n = wq.shape
    _require(k == k2, f"x {tuple(xq.shape)} and w {tuple(wq.shape)} do not chain")
    _require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
             f"operands must be int8, got {xq.dtype} and {wq.dtype}")
    _require(out_dtype in _DTYPE_CODE, f"out dtype {out_dtype} not supported on CUDA")
    _require(k <= MAX_K, f"K = {k} > {MAX_K} would overflow the int32 accumulator")
    _require(m > 0 and n > 0 and k > 0, f"empty product {m}x{k}x{n}")
    (ldx, xk), (wk, ldw) = xq.stride(), wq.stride()
    tma = (xk == 1 and wk == 1 and k % _TMA_ALIGN == 0 and ldx % _TMA_ALIGN == 0
           and ldw % _TMA_ALIGN == 0 and ldx >= k and ldw >= k
           and xq.data_ptr() % _TMA_ALIGN == 0 and wq.data_ptr() % _TMA_ALIGN == 0)
    return "wgmma" if tma else "mma"


def _s8_cuda(xq, wq, x_scale, w_scale, out_dtype, variant=None) -> torch.Tensor:
    m, k = xq.shape
    n = wq.shape[1]
    default = s8_variant(xq, wq, out_dtype)  # also refuses what no design takes
    variant = variant or default
    _require(variant in S8_VARIANTS, f"unknown variant {variant!r}")
    _require(variant == "mma" or default != "mma",
             f"variant {variant} cannot take this layout (an operand not K-contiguous, or "
             f"K, a row stride or a base not a multiple of {_TMA_ALIGN} bytes)")
    if variant == "mma":
        xq, wq = _k_contiguous(xq, wq)
    _require(xq.device == wq.device == x_scale.device == w_scale.device,
             "tensors on different devices")
    # the kernel reads each scale vector as a flat fp32 run of m (n) values
    sx, sw = x_scale, w_scale
    if not (_flat_f32(sx, m) and _flat_f32(sw, n)):
        sx, sw = _scales(xq, wq, x_scale, w_scale)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    fn = _build.function("s8_gemm", "mvoc_s8_gemm", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    err = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
             S8_VARIANTS[variant], _DTYPE_CODE[out_dtype], m, n, k, xq.stride(0), wq.stride(1),
             out.stride(0), torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check("s8_gemm", err, f"s8_matmul launch ({variant})")
    LAUNCHES["s8_matmul"] += 1
    LAUNCH_SHAPES["s8_matmul"][(m, k, n, str(out_dtype))] += 1
    LAUNCH_VARIANTS["s8_matmul"][variant] += 1
    return out


def s8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
              w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K3.  xq int8 [M, K], wq int8 [K, N] (any strides; the [K, N] view of
    [N, K] storage needs no copy), x_scale [M] or [M, 1], w_scale [N] or
    [1, N] -> [M, N] in out_dtype.  CUDA tensors launch the kernel; CPU
    tensors take the plain version.  An active utils.flops counter books the
    call (meta tensors: shape only)."""
    with span("int8/s8_matmul"):
        if _flops.COUNTER is not None:
            return _s8_counted(xq, wq, x_scale, w_scale, out_dtype)
        if xq.is_cuda:
            return _s8_cuda(xq, wq, x_scale, w_scale, out_dtype)
        return s8_matmul_plain(xq, wq, x_scale, w_scale, out_dtype)


def _s8_counted(xq, wq, x_scale, w_scale, out_dtype):
    """s8_matmul booked by the active utils.flops counter."""
    (m, k), n = xq.shape, wq.shape[1]
    return _flops.COUNTER.kernel(
        "s8_matmul", (m, k, n, str(out_dtype)), xq.device,
        lambda: (_s8_cuda if xq.is_cuda else s8_matmul_plain)(xq, wq, x_scale, w_scale,
                                                              out_dtype),
        lambda: torch.empty((m, n), dtype=out_dtype, device=xq.device))
