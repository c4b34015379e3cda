"""Matmul-class operation counts of the port (counterpart of
mvoc_tpu/utils/flops.py): the yardstick of MFU, of the speed-of-light
floor of a step and of the per-class roofline budget on the card.

The JAX module walks jaxprs because XLA's cost analysis counts a
`lax.scan` body once and a Pallas call as zero; its walkers
(`stablehlo_matmul_flops`, `matmul_flops`, `jaxpr_matmul_flops` and their
scan / cond / Pallas-grid recursion) have no counterpart here.  The port's
step loops are eager Python: every op of every step executes, so a
dispatcher-level count sees each one as often as it runs, and the scan hole
cannot happen.  The port's one hole is the hand-written kernels: K1, K2
and K3 are ctypes launches, which the dispatcher never sees.  So the count
has two parts:

  * `torch.utils.flop_counter.FlopCounterMode` books the library ops
    (`aten.convolution` as "conv"; `mm`, `addmm`, `bmm`, `baddbmm` as
    "dot") at their own formulas: 2 * prod(out) * contraction;
  * the kernel entry points (`ops/attention.py: flash_attention`,
    `frame_attention`; `ops/s8gemm.py: s8_matmul`) book each call of a
    kernel in its own class at `kernel_flops(name, signature)`, whichever
    route computes it: the launch on a CUDA tensor, the plain version on a
    CPU tensor (its own products are not booked again), or nothing at all
    on a meta tensor (`forward_flops`: shape-only counting, an empty
    result of the right shape).  Everything that reaches a kernel through
    an entry point (`frame_axis_attention` beyond 64 frames, the sharded
    wrappers, every int8 layer of ops/quantize.py) is booked there.

The conventions are JAX's: attention is 4 * B * H * Sq * Sk * D for every
(query, key) pair, whatever a bias masks (JAX's `_attention_tally`), and a
GEMM 2 * M * K * N (its `dot_general` rule).  The five classes sum to the
total; the three kernel classes together are JAX's "pallas" class, and on
the CPU, where JAX's attention is an XLA einsum, JAX's "dot" is this
module's dot + flash_attention + frame_attention.

Where the two counts of one step differ (tests/test_torch_flops.py
asserts each at its size against JAX's count of the same core call):

  * branches.  JAX's walk takes the most expensive branch of a `cond`; the
    port runs the branch its Python takes.  JAX's step programs hold no
    `cond` (the goldens record 0 in every path), and the branches both
    sides take by a flag or a mask (the PnP injection gates, t in the
    schedule or t == 1000; the noise-fusion mask and the object branches'
    fusion latents; the fresh / cached split of the reuse modes, static on
    both sides) are elementwise or the same call: 0 operations apart on
    the fused, two_pass=True, stream, inversion and int8 steps.
  * dead code on a cached reuse step.  A forward given `cached_encoder`
    skips the image-latents stem (`image_latents_proj_in`,
    `image_latents_temporal_encoder`), whose output only conv_in reads; JAX
    traces it anyway (XLA drops it as dead code, the jaxpr walk counts it).
    With the PAB cache as well (deep inversion reuse, deep capture reuse)
    the port also skips the context embedding
    (`image_latents_context_embedding`, `context_embedding`), which no
    attention then reads.  JAX counts more by that much per cached step:
    at the tiny test geometry 4,136,960 (encoder reuse) and 11,601,920
    (deep reuse); at 512 px, 16 frames, 5 branches 2.265e9 and 3.786e9
    (0.002% and 0.004% of the step).
  * the class of the small temporal convs.  JAX runs a (3,1,1) conv over at
    most 4096 rows B*F*H*W and 16 frames as one dot_general
    (mvoc_tpu/ops/conv.py: tconv3_stack3), so its walk books it as "dot";
    the port runs it as a convolution, "conv".  The total is the same;
    with JAX's temporal convs counted as convolutions
    (`tconv_override("xla")`) the classes agree too.  Under int8 both run
    it as an s8 GEMM (int8_tconv_stack3), K3 here.

With no counter active, an entry point's added cost is one check of the
module global `COUNTER`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import torch

from mvoc_tpu_torch.utils.profiling import OUTSIDE

KERNEL_CLASSES = ("flash_attention", "frame_attention", "s8_matmul")
CLASSES = ("conv", "dot") + KERNEL_CLASSES

# the active counter; None outside `FlopCounter` (the hot path's one check)
COUNTER: Optional["FlopCounter"] = None


def kernel_flops(name: str, signature) -> float:
    """Operations of one launch of kernel `name` at `signature`, the tuple its
    `LAUNCH_SHAPES` key holds: K1 (B, H, Sq, Sk, D, dtype, biased) ->
    4*B*H*Sq*Sk*D; K2 (layout, B, F, S, heads, D, dtype, masked) ->
    4*B*heads*S*F^2*D; K3 (M, K, N, out dtype) -> 2*M*K*N (int8)."""
    if name == "flash_attention":
        b, h, sq, sk, d = signature[:5]
        return 4.0 * b * h * sq * sk * d
    if name == "frame_attention":
        _, b, f, s, heads, d = signature[:6]
        return 4.0 * b * heads * s * f * f * d
    if name == "s8_matmul":
        m, k, n = signature[:3]
        return 2.0 * m * k * n
    raise ValueError(f"no kernel named {name!r}: {KERNEL_CLASSES}")


def _zeros() -> dict:
    return dict.fromkeys(CLASSES, 0.0)


def with_total(by_class: dict) -> dict:
    """A copy of {class: flops} with its "total"."""
    out = {c: float(by_class.get(c, 0.0)) for c in CLASSES}
    out["total"] = sum(out.values())
    return out


class FlopCounter:
    """Counts the matmul-class operations of what runs inside it, by class
    (CLASSES) and by the UNet's top-level child around them (`by_module`:
    the `I2VGenXLUNet/<child>` names of models/unet_i2vgen.py's profiler
    scopes, `utils.profiling.OUTSIDE` elsewhere), as
    `utils.profiling.device_op_breakdown` books device time.  Counters do
    not nest."""

    def __init__(self):
        self.by_module: dict[str, dict] = {}
        self._stack = [OUTSIDE]
        self._suspended = 0
        self._mode = None

    # -- booking ---------------------------------------------------------

    def _book(self, cls: str, flops: float) -> None:
        row = self.by_module.get(self._stack[-1])
        if row is None:
            row = self.by_module[self._stack[-1]] = _zeros()
        row[cls] += flops

    def _library(self, op, formula):
        """FlopCounterMode's formula for `op`, booked here too, and 0 while a
        kernel's plain version runs (its products are the kernel's)."""
        cls = "conv" if "conv" in str(op) else "dot"

        def count(*args, out_val=None, **kwargs):
            if self._suspended:
                return 0
            n = formula(*args, out_val=out_val, **kwargs)
            self._book(cls, float(n))
            return n

        count._get_raw = True  # FlopCounterMode passes the op's own arguments
        return count

    def kernel(self, name: str, signature, device: torch.device, run, empty):
        """Book one call of kernel `name` at `signature` and compute it: on
        the card `run()` (its launch is invisible to the dispatcher), on the
        CPU `run()` with the library ops not booked (the plain version's
        products are this call's), on meta `empty()` (shape only)."""
        self._book(name, kernel_flops(name, signature))
        if device.type == "meta":
            return empty()
        if device.type == "cuda":
            return run()
        self._suspended += 1
        try:
            return run()
        finally:
            self._suspended -= 1

    @contextlib.contextmanager
    def scope(self, child: str, inner):
        """Book what runs inside to the UNet child `child`, inside `inner`
        (its profiler scope)."""
        with inner:
            self._stack.append(child)
            try:
                yield
            finally:
                self._stack.pop()

    # -- reading ---------------------------------------------------------

    def by_class(self) -> dict:
        """{class: flops} over every module, with "total"."""
        out = _zeros()
        for row in self.by_module.values():
            for c, v in row.items():
                out[c] += v
        return with_total(out)

    def modules(self) -> dict:
        """{UNet child or OUTSIDE: {class: flops, "total"}}."""
        return {m: with_total(row) for m, row in self.by_module.items()}

    def library_total(self) -> float:
        """FlopCounterMode's own total, which must be conv + dot."""
        return float(self._mode.get_total_flops())

    # -- context ---------------------------------------------------------

    def __enter__(self) -> "FlopCounter":
        global COUNTER
        from torch.utils.flop_counter import FlopCounterMode, flop_registry

        if COUNTER is not None:
            raise RuntimeError("FlopCounter: a counter is already active (counters do not nest)")
        mode = FlopCounterMode(display=False, custom_mapping={
            op: self._library(op, formula) for op, formula in flop_registry.items()})
        mode.__enter__()
        self._mode = mode
        COUNTER = self
        return self

    def __exit__(self, *exc):
        global COUNTER
        COUNTER = None
        return self._mode.__exit__(*exc)


def matmul_flops_by_class(fn, *args, **kwargs) -> dict:
    """{"conv", "dot", "flash_attention", "frame_attention", "s8_matmul",
    "total"} of one call of fn(*args, **kwargs), run as given (the
    counterpart of JAX's jaxpr_matmul_flops_by_class)."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.by_class()


def _meta_module(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of `module` whose parameters and buffers are meta tensors of
    the same shapes and dtypes: no data is copied and the module itself is
    left as it was."""
    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        if id(t) not in memo:
            meta = torch.empty_like(t, device="meta")
            if isinstance(t, torch.nn.Parameter):
                meta = torch.nn.Parameter(meta, requires_grad=t.requires_grad)
            memo[id(t)] = meta
    return copy.deepcopy(module, memo)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, torch.nn.Module):
        return _meta_module(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to_meta(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


def forward_flops(fn, *args, **kwargs) -> dict:
    """The shape-only count of one call of fn (the counterpart of JAX's
    forward_flops): every tensor among the arguments (in lists, tuples,
    dicts and dataclasses too), and every module, is replaced by a meta
    copy, and the call is counted by matmul_flops_by_class, so it computes
    nothing and gives full-width numbers on a machine without the card.
    Returns the by-class dict (JAX's returns its total: "total" here).  fn
    must not read a value on the host (`.item()`, numpy)."""
    return matmul_flops_by_class(fn, *_to_meta(args), **_to_meta(kwargs))
