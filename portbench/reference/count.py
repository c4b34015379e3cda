"""Operations and launch shapes of one step, counted on the meta device
from the reference's UNet: the benchmark's own yardstick for `mfu` and the
kernels' rooflines, which no change to the program can move.

`torch.utils.flop_counter.FlopCounterMode` books every convolution and
matmul at 2 * prod(out) * contraction, so the two matmuls of an attention
come to 4 * B * H * Sq * Sk * D.  The count walks the program's calls of
one step: one UNet forward per call, at that call's batch (the fused path
one call of J*(N+3) branches; the streamed path N+1 calls of J and one of
2J; an inversion step one call of J), so that a kernel launched once per
call is counted per call.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model as M


@dataclasses.dataclass
class StepCount:
    """One step: `flops` in all; `attention`: (kind, batch*heads, Sq, Sk, D)
    per call; `s8`: (M, K, N, out_bytes) per w8a8 GEMM launch."""

    flops: float
    attention: list
    s8: list


class _S8Log:
    def __init__(self):
        self.gemms: list = []


def _log_s8(log: _S8Log, precision: M.Precision):
    """Record the GEMM each selected layer launches, as the program runs
    it: a dense layer [rows, K] x [K, N] with a bf16 result; a temporal conv
    per token as one GEMM [rows, C] x [C, 3*O] with a float32 result, else
    im2col [rows, 3*C] x [3*C, O] with a bf16 result."""
    def linear_hook(mod, args, _out):
        x = args[0]
        rows = x.numel() // x.shape[-1]
        log.gemms.append((rows, mod.inner.in_features, mod.inner.out_features, 2))

    def conv_hook(mod, args, _out):
        x = args[0]
        b, f, h, w, c = x.shape
        o = mod.inner.out_channels
        token = (b * f * h * w <= M.TCONV_TOKEN_MAX_ROWS and f <= M.TCONV_TOKEN_MAX_FRAMES)
        log.gemms.append((b * f * h * w, c, 3 * o, 4) if token else (b * f * h * w, 3 * c, o, 2))
    return linear_hook, conv_hook


def unet_step_count(unet_cfg: dict, frames: int, h_lat: int, w_lat: int,
                    call_batches: list, int8: bool = False, text_len: int = 77,
                    min_k: int = 1280) -> StepCount:
    """The count of one step whose UNet calls have the given batches, on
    latents [F, h_lat, w_lat] with text_len prompt tokens."""
    cfg = M.UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in unet_cfg.items()})
    with torch.device("meta"):
        unet = M.UNet(cfg)
    precision = M.Precision(min_k=min_k)
    s8 = _S8Log()
    if int8:
        M.quantize_(unet, precision)
        linear_hook, conv_hook = _log_s8(s8, precision)
        for mod in unet.modules():
            if isinstance(mod, M.QLinear):
                mod.register_forward_hook(linear_hook)
            elif isinstance(mod, M.QConv3d):
                mod.register_forward_hook(conv_hook)
    log = M.AttentionLog()
    M.ATTENTION_LOG = log
    meta = dict(device="meta", dtype=torch.float32)
    d, c = cfg.cross_attention_dim, cfg.in_channels
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            for b in call_batches:
                precision.call_batch_of = [b] * b
                unet(torch.empty(b, frames, h_lat, w_lat, c, **meta), 500,
                     torch.full((b,), 8, dtype=torch.long, device="meta"),
                     torch.empty(b, frames, h_lat, w_lat, c, **meta),
                     torch.empty(b, frames, d, **meta), torch.empty(b, text_len, d, **meta))
    finally:
        M.ATTENTION_LOG = None
    return StepCount(float(counter.get_total_flops()), log.calls, s8.gemms)


def call_batches(path: str, entries: int, objects: int) -> list:
    """The UNet calls of one step: "fused" one call of J*(N+3); "two_pass"
    one of J*(N+1) then one of 2J; "stream" N+1 calls of J then one of 2J;
    "inversion" one call of J."""
    j, n = entries, objects
    if path == "fused":
        return [j * (n + 3)]
    if path == "two_pass":
        return [j * (n + 1), 2 * j]
    if path == "stream":
        return [j] * (n + 1) + [2 * j]
    if path == "inversion":
        return [j]
    raise ValueError(f"path {path!r}: fused, two_pass, stream or inversion")
