"""Share, in %, of the traced stretch's wall time in which no kernel ran
on the device: 100 * (1 - union of the kernels' intervals / wall)."""


def read(r):
    s = r.stretch
    if s is None or not s.kernels or s.wall_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.wall_s)
