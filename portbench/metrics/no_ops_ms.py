"""Device milliseconds a step in the kernel groups that carry no
matmul-class operations (elementwise, copies, reductions, normalisation)."""

from portbench.trace import NO_OP_GROUPS


def read(r):
    s = r.stretch
    if s is None or not s.kernels or s.steps <= 0:
        return None
    groups = s.by_group()
    return 1e3 * sum(groups.get(g, 0.0) for g in NO_OP_GROUPS) / s.steps
