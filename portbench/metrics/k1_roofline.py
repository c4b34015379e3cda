"""K1's share, in %, of its roofline: the least time its launches need
(each the larger of 4*B*H*Sq*Sk*D operations at the bf16 peak and its q, k,
v and output bytes at the HBM rate) over the device time of kernels named
`flash_`.  K1's launches are the attention calls not across the frame axis
and over more than 64 tokens (the shorter ones, and frame-axis calls of at
most 64 frames, run on K2), counted by the reference."""

from portbench.trace import PEAK_BF16, PEAK_BYTES


def k1_launches(count):
    return [(bh, sq, sk, d) for kind, bh, sq, sk, d in count.attention
            if (kind == "token" and not (sq == sk <= 64 and d in (4, 64)))
            or (kind == "frame" and sq > 64)]


def read(r):
    s = r.stretch
    if s is None or r.count is None:
        return None
    kernel_s = s.matching("flash_")
    launches = k1_launches(r.count)
    if kernel_s <= 0 or not launches:
        return None
    need = sum(max(4.0 * bh * sq * sk * d / PEAK_BF16,
                   r.act_bytes * bh * d * (2 * sq + 2 * sk) / PEAK_BYTES)
               for bh, sq, sk, d in launches)
    return 100.0 * need * s.steps / kernel_s
