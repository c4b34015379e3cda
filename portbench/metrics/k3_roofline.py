"""K3's share, in %, of its roofline: the least time the step's s8 x s8
products need (each the larger of 2*M*K*N at the int8 peak and its int8
operands, scales and output at the HBM rate) over the device time of
kernels named `s8_`."""

from portbench.trace import PEAK_BYTES, PEAK_INT8


def read(r):
    s = r.stretch
    if s is None or r.count is None or not r.count.s8:
        return None
    kernel_s = s.matching("s8_")
    if kernel_s <= 0:
        return None
    need = sum(max(2.0 * m * k * n / PEAK_INT8,
                   (m * k + k * n + out * m * n + 4 * (m + n)) / PEAK_BYTES)
               for m, k, n, out in r.count.s8)
    return 100.0 * need * s.steps / kernel_s
