"""The whole step's share, in %, of the bf16 peak: the operations of the
steps the device finished in the window (the reference's count, every
precision alike) over the window's seconds and 989 TF/s."""

from portbench.trace import PEAK_BF16


def read(r):
    if r.count is None or r.seconds <= 0 or r.steps <= 0:
        return None
    return 100.0 * r.count.flops * r.steps / r.seconds / PEAK_BF16
