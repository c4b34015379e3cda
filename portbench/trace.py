"""The reduction of a torch.profiler stretch to what the per-layer metrics
read, and the card's peaks: the benchmark's own copies, which no change to
the program can move.

`KERNEL_GROUPS` is a frozen copy of the port's kernel grouping (the
fragment of a lower-cased kernel name -> its group; the first match wins).
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

# NVIDIA H100 SXM, dense, at its 700 W limit: operations per second by
# class and bytes per second of HBM3
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

KERNEL_GROUPS = (("flash_", "K1 flash attention"), ("frame_", "K2 frame attention"),
                 ("s8_", "K3 s8 GEMM"), ("conv", "convolution"), ("fprop", "convolution"),
                 ("implicit", "convolution"), ("gemm", "GEMM"), ("cutlass", "GEMM"),
                 ("cublas", "GEMM"), ("nvjet", "GEMM"), ("norm", "normalisation"),
                 ("reduce", "reductions"),
                 ("copy", "copies and layout"), ("cat", "copies and layout"),
                 ("elementwise", "elementwise"), ("vectorized", "elementwise"))
# the groups that carry no matmul-class operations
NO_OP_GROUPS = ("elementwise", "copies and layout", "reductions", "normalisation")


def kernel_group(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in KERNEL_GROUPS if frag in low), "other")


@dataclasses.dataclass
class Stretch:
    """A traced stretch of whole steps: device kernels (name, start s, end
    s), host ops (name, start s, end s, parent name), its wall seconds and
    the steps it holds."""

    kernels: list
    host_ops: list
    wall_s: float
    steps: int
    _starts: list = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.host_ops = sorted(self.host_ops, key=lambda op: op[1])
        self._starts = [op[1] for op in self.host_ops]

    def busy_s(self) -> float:
        """The union of the kernels' intervals."""
        spans = sorted((a, b) for _, a, b in self.kernels)
        busy, cur = 0.0, None
        for a, b in spans:
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        return busy + (cur[1] - cur[0] if cur else 0.0)

    def by_group(self) -> dict:
        out = defaultdict(float)
        for name, a, b in self.kernels:
            out[kernel_group(name)] += b - a
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def matching(self, fragment: str) -> float:
        return sum(b - a for name, a, b in self.kernels if fragment in name.lower())

    def idle_gaps(self) -> dict:
        """Seconds of every gap between kernels, by the innermost host op
        running at its middle (a runtime call named with its parent op)."""
        spans = sorted((a, b) for _, a, b in self.kernels)
        out = defaultdict(float)
        end = None
        for a, b in spans:
            if end is not None and a > end:
                out[self._host_at((a + end) / 2)] += a - end
            end = b if end is None else max(end, b)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def _host_at(self, t: float) -> str:
        """The op with the latest start among those around t (ops nest, so
        it is the innermost), looked for among the 256 ops started last."""
        i = bisect.bisect_right(self._starts, t) - 1
        for name, a, b, parent in reversed(self.host_ops[max(0, i - 255):i + 1]):
            if a <= t <= b:
                return f"{parent} > {name}" if name.startswith("cuda") and parent else name
        return "(no host op)"


def from_profiler(prof, wall_s: float, steps: int) -> Stretch:
    """The stretch of a stopped torch.profiler.profile: device events that
    are kernels, copies or sets (not the device lane's copies of host
    annotations), and the host's ops, in seconds."""
    import torch

    kernels, host = [], []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("I2VGenXLUNet/"):
                continue
            kernels.append((e.name, start, end))
        else:
            parent = e.cpu_parent.name if getattr(e, "cpu_parent", None) is not None else ""
            host.append((e.name, start, end, parent))
    return Stretch(kernels, host, wall_s, steps)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in list(d.items())[:n]]
