"""K3: the s8 x s8 -> s32 GEMM with a fused dequantise epilogue, and its
plain version (counterpart of mvoc_tpu/ops/s8gemm.py).

    out[m, n] = float32(sum_k xq[m, k] * wq[k, n]) * (x_scale[m] * w_scale[n])

rounded once to `out_dtype` (fp32 or bf16).  `s8_matmul` launches the
hand-written CUDA kernel `csrc/s8_gemm.cu` for CUDA tensors and takes the
plain version for CPU tensors only; on a CUDA tensor the kernel cannot take
it raises, there is no fallback (and nothing here calls `torch._int_mm` or
cuBLAS).  `LAUNCHES` / `LAUNCH_SHAPES` count the kernel's launches.

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

LAUNCHES = {"s8_matmul": 0}
# launches per (M, K, N, out dtype), counted beside LAUNCHES
LAUNCH_SHAPES: dict = {"s8_matmul": Counter()}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# |acc| <= K * 127^2 must fit int32
MAX_K = (2**31 - 1) // (127 * 127)


def reset_launch_counts() -> None:
    LAUNCHES["s8_matmul"] = 0
    LAUNCH_SHAPES["s8_matmul"].clear()


def _scales(xq, wq, x_scale, w_scale):
    m, n = xq.shape[0], wq.shape[1]
    return (x_scale.reshape(m).to(torch.float32).contiguous(),
            w_scale.reshape(n).to(torch.float32).contiguous())


def s8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the integer product exactly in
    float64, then the same fp32 epilogue and one rounding to out_dtype."""
    sx, sw = _scales(xq, wq, x_scale, w_scale)
    acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(torch.float32)
    return (acc * (sx[:, None] * sw[None, :])).to(out_dtype)


def _s8_cuda(xq, wq, x_scale, w_scale, out_dtype) -> torch.Tensor:
    m, k = xq.shape
    k2, n = wq.shape

    def require(cond, msg):
        if not cond:
            raise ValueError(f"s8_matmul: {msg}")

    require(k == k2, f"x {tuple(xq.shape)} and w {tuple(wq.shape)} do not chain")
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"operands must be int8, got {xq.dtype} and {wq.dtype}")
    require(out_dtype in _DTYPE_CODE, f"out dtype {out_dtype} not supported on CUDA")
    require(k <= MAX_K, f"K = {k} > {MAX_K} would overflow the int32 accumulator")
    require(xq.device == wq.device == x_scale.device == w_scale.device,
            "tensors on different devices")
    require(m > 0 and n > 0 and k > 0, f"empty product {m}x{k}x{n}")
    # both operands K-contiguous: x [M, K] row-major; w the [K, N] view of
    # [N, K] storage (the Quant modules' weights), else re-laid once here
    if xq.stride(1) != 1:
        xq = xq.contiguous()
    if wq.stride(0) != 1:
        wq = wq.t().contiguous().t()
    sx, sw = _scales(xq, wq, x_scale, w_scale)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    lib = _build.load("s8_gemm")
    fn = lib.mvoc_s8_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p]
    err = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[out_dtype], m, n, k, xq.stride(0), wq.stride(1), out.stride(0),
             torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(lib, err, "s8_matmul launch")
    LAUNCHES["s8_matmul"] += 1
    LAUNCH_SHAPES["s8_matmul"][(m, k, n, str(out_dtype))] += 1
    return out


def s8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
              w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K3.  xq int8 [M, K], wq int8 [K, N] (any strides; the [K, N] view of
    [N, K] storage needs no copy), x_scale [M] or [M, 1], w_scale [N] or
    [1, N] -> [M, N] in out_dtype.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if xq.is_cuda:
        return _s8_cuda(xq, wq, x_scale, w_scale, out_dtype)
    return s8_matmul_plain(xq, wq, x_scale, w_scale, out_dtype)
