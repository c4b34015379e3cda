"""The card's idle time booked to the program layer the host was in: the
booking behind the per-layer metrics idle_step_loop_ms, idle_unet_ms and
idle_int8_glue_ms.

The program opens named spans at its layer boundaries (torch.profiler
`record_function` scopes, which land among a stretch's host ops). They are
recognised by name alone, so the yardstick imports nothing of the program:

    entry/<...>          the entry points' preparation (encodes, uploads)
    step, step/<...>     the step loops (fusion, capture, edit, DDIM)
    I2VGenXLUNet[/...]   the UNet forward, its children and sub-blocks
    int8/<...>           the int8 glue (quantize, im2col, K3's launch)

Every idle interval between consecutive kernels (the gaps of
`Stretch.idle_gaps`) is split exactly, instant by instant, over the
innermost span open on the host at that instant: the open span that
started last.  What no span covers is booked to None.  The parts sum to
the stretch's gap idle.
"""

from __future__ import annotations

from collections import defaultdict

ROOTS = ("entry", "step", "I2VGenXLUNet", "int8")


def root(name: str) -> str:
    """The layer of a span name (its first component), "" for other names."""
    head = name.split("/", 1)[0]
    return head if head in ROOTS else ""


def idle_intervals(kernels) -> list:
    """The gaps between consecutive kernels: (start s, end s), in order."""
    out, end = [], None
    for a, b in sorted((a, b) for _, a, b in kernels):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def innermost(host_ops) -> list:
    """The timeline of the innermost program span: (start s, end s, name)
    segments in order, each with the open span that started last (ties: the
    shorter), gaps where none is open left out."""
    spans = sorted(((a, b, name) for name, a, b, _ in host_ops if root(name) and b > a),
                   key=lambda s: (s[0], -s[1]))
    # boundaries: every start and end; between two, the open set is fixed
    marks = sorted({t for a, b, _ in spans for t in (a, b)})
    out, open_, k = [], [], 0
    for t0, t1 in zip(marks, marks[1:]):
        while k < len(spans) and spans[k][0] <= t0:
            open_.append(spans[k])
            k += 1
        open_ = [s for s in open_ if s[1] > t0]
        if open_:
            name = max(open_, key=lambda s: (s[0], -s[1]))[2]
            if out and out[-1][2] == name and out[-1][1] == t0:
                out[-1] = (out[-1][0], t1, name)
            else:
                out.append((t0, t1, name))
    return out


def idle_by_span(stretch) -> dict:
    """{innermost span name or None: idle seconds} over the stretch's gaps."""
    out = defaultdict(float)
    segs = innermost(stretch.host_ops)
    j = 0
    for a, b in idle_intervals(stretch.kernels):
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        i = j
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                out[segs[i][2]] += hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            out[None] += (b - a) - covered
    return dict(out)


def idle_ms_per_step(r, layer: str):
    """Idle ms a traced step under the spans of `layer` (a ROOTS entry);
    None without a stretch with kernels, or where no span of the layer was
    recorded."""
    s = r.stretch
    if s is None or not s.kernels or s.steps <= 0:
        return None
    if not any(root(name) == layer for name, *_ in s.host_ops):
        return None
    idle = idle_by_span(s)
    return 1e3 * sum(v for k, v in idle.items() if k is not None and root(k) == layer) / s.steps
