"""ops/norm.py on the CPU: the wrapper's routing to the plain versions
(bitwise the models layer's norms as they were written before the fused
kernels), its counters, its refusals, the tiling plans, and the kernel
names the profiler books to the "normalisation" group.  The kernels
themselves run in tests/test_torch_kernels.py on a card."""

import math
import pathlib
import re

import pytest
import torch
import torch.nn.functional as F

from mvoc_tpu_torch.models import layers
from mvoc_tpu_torch.ops import norm
from mvoc_tpu_torch.utils import profiling
from portbench import trace as bench_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _old_group_norm(x, weight, bias, groups, eps):
    """models/layers.py GroupNorm.forward before the fused kernels (the
    unsharded branch), as it was written."""
    b, c = x.shape[0], x.shape[-1]
    g = groups
    dims = tuple(range(1, x.ndim - 1))
    bshape = (b,) + (1,) * len(dims) + (c,)
    xf = x.float()

    def mean(t):
        return t.mean(dim=dims)
    mean_c = mean(xf)
    mean_ch = mean_c.view(b, g, c // g).mean(-1).repeat_interleave(c // g, -1)
    cen2_c = mean((xf - mean_ch.view(bshape)).square())
    var_g = cen2_c.view(b, g, c // g).mean(-1)
    inv_ch = torch.rsqrt(var_g + eps).repeat_interleave(c // g, -1)
    w = weight.float()[None]
    a_ch = (inv_ch * w).view(bshape).to(x.dtype)
    b_ch = (bias.float()[None] - mean_ch * inv_ch * w).view(bshape).to(x.dtype)
    return x * a_ch + b_ch


def _old_layer_norm(x, weight, bias, eps):
    """models/layers.py LayerNorm.forward before the fused kernel."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return xn * weight.to(x.dtype) + bias.to(x.dtype)


def _affine(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return ((1 + 0.3 * torch.randn(n, generator=g)).to(dtype),
            (0.2 * torch.randn(n, generator=g)).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 7, 32), (2, 3, 4, 5, 16)])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_on_cpu_is_the_old_code(shape, dtype, silu):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=g) * 3 + 2).to(dtype)
    c = shape[-1]
    w, b = _affine(c, dtype, 2)
    want = _old_group_norm(x, w, b, 4, 1e-6)
    want = F.silu(want) if silu else want
    assert torch.equal(norm.group_norm(x, w, b, 4, 1e-6, silu=silu), want)
    mod = layers.GroupNorm(4, c, eps=1e-6, silu=silu).to(dtype)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
    assert torch.equal(mod(x), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 16), (5, 4), (3, 2, 6, 40)])
def test_layer_norm_on_cpu_is_the_old_code(shape, dtype):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=g) + 1).to(dtype)
    w, b = _affine(shape[-1], torch.float32, 4)  # fp32 params, rounded to x's dtype
    want = _old_layer_norm(x, w, b, 1e-5)
    assert torch.equal(norm.layer_norm(x, w, b, 1e-5), want)
    mod = layers.LayerNorm(shape[-1])
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
    assert torch.equal(mod(x), want)


def test_counters_count_launches_and_cuda_plain_calls_only():
    """CPU and meta tensors take the plain versions without counting: the
    launch counters count kernel launches, PLAIN_CALLS CUDA tensors that took
    a plain version.  reset_launch_counts zeroes all three."""
    norm.LAUNCHES["group_norm"] = 3
    norm.LAUNCH_SHAPES["layer_norm"][((2, 4), 1e-5, "torch.float32")] = 2
    norm.PLAIN_CALLS["layer_norm"] = 5
    norm.reset_launch_counts()
    assert norm.LAUNCHES == {"group_norm": 0, "layer_norm": 0}
    assert norm.PLAIN_CALLS == {"group_norm": 0, "layer_norm": 0}
    assert all(not c for c in norm.LAUNCH_SHAPES.values())
    x = torch.randn(2, 3, 4, 8)
    w, b = torch.ones(8), torch.zeros(8)
    norm.group_norm(x, w, b, 2, 1e-5, silu=True)
    norm.layer_norm(x, w, b, 1e-5)
    meta = norm.group_norm(x.to("meta"), w.to("meta"), b.to("meta"), 2, 1e-5)
    assert meta.shape == x.shape and meta.device.type == "meta"
    norm.layer_norm(x.to("meta"), w.to("meta"), b.to("meta"), 1e-5)
    assert norm.LAUNCHES == {"group_norm": 0, "layer_norm": 0}
    assert norm.PLAIN_CALLS == {"group_norm": 0, "layer_norm": 0}


def _gn_refusal(case):
    x = torch.zeros(2, 4, 4, 32, dtype=torch.bfloat16)
    w = b = torch.ones(32, dtype=torch.bfloat16)
    if case == "3-D":
        return (x[0], w, b, 4)
    if case == "fp16":
        return (x.half(), w, b, 4)
    if case == "not contiguous":
        return (x.transpose(1, 2), w, b, 4)
    if case == "groups":
        return (x, w, b, 5)
    if case == "weight shape":
        return (x, torch.ones(16, dtype=torch.bfloat16), b, 4)
    if case == "weight dtype":
        return (x, w.half(), b, 4)
    if case == "empty":
        return (x[:, :0], w, b, 4)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["3-D", "fp16", "not contiguous", "groups", "weight shape",
                                  "weight dtype", "empty"])
def test_group_norm_refuses_what_the_kernels_do_not_take(case):
    x, w, b, groups = _gn_refusal(case)
    with pytest.raises(ValueError, match="group_norm"):
        norm._group_norm_cuda(x, w, b, groups, 1e-5, False)


@pytest.mark.parametrize("case", ["fp16", "not contiguous", "weight shape", "too wide", "empty"])
def test_layer_norm_refuses_what_the_kernel_does_not_take(case):
    x = torch.zeros(3, 5, 64)
    w = b = torch.ones(64)
    if case == "fp16":
        x = x.half()
    elif case == "not contiguous":
        x = torch.zeros(3, 6, 64)[:, :5]
    elif case == "weight shape":
        w = torch.ones(32)
    elif case == "too wide":  # 32 lanes x 16 vectors of 4 fp32 is 2048 wide at most
        x, w, b = torch.zeros(2, 2052), torch.ones(2052), torch.ones(2052)
    elif case == "empty":
        x = x[:0]
    with pytest.raises(ValueError, match="layer_norm"):
        norm._layer_norm_cuda(x, w, b, 1e-5)


@pytest.mark.parametrize("c,aligned,want", [
    (320, True, (8, 12)), (640, True, (8, 6)), (960, True, (8, 4)), (1280, True, (8, 3)),
    (1920, True, (8, 2)), (2560, True, (8, 1)), (128, True, (8, 32)), (320, False, (1, 1)),
    (36, True, (1, 14))])
def test_group_norm_plan_follows_the_channels(c, aligned, want):
    vec, by = norm.group_norm_plan(c, aligned)
    assert (vec, by) == want
    assert c % vec == 0 and (c // vec) * by <= norm.GN_MAX_THREADS


@pytest.mark.parametrize("c", [1030, 4104])
def test_group_norm_plan_refuses_too_many_threads(c):
    with pytest.raises(ValueError, match="group_norm"):
        norm.group_norm_plan(c, True)


@pytest.mark.parametrize("d,itemsize,align,want", [
    (4, 2, 16, (4, 1, 1)), (4, 4, 16, (4, 1, 1)), (320, 2, 16, (8, 8, 5)),
    (512, 2, 16, (8, 32, 2)), (640, 2, 16, (8, 16, 5)), (1024, 2, 16, (8, 32, 4)),
    (1280, 2, 16, (8, 32, 5)), (1280, 4, 16, (4, 32, 10)), (320, 4, 8, (2, 32, 5)),
    (72, 2, 16, (8, 1, 10)), (8, 2, 2, (1, 8, 1)), (1088, 2, 16, (8, 32, 5))])
def test_layer_norm_plan_follows_the_width(d, itemsize, align, want):
    vec, tpr, nv = norm.layer_norm_plan(d, itemsize, align)
    assert (vec, tpr, nv) == want
    assert d % vec == 0 and tpr * nv * vec >= d and nv in norm.LN_VECTORS
    assert 32 % tpr == 0


def _globals_of(path):
    text = path.read_text()
    return set(re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", text))


def test_kernel_names_are_booked_as_normalisation():
    """Every __global__ function of csrc/norm.cu is in KERNEL_NAMES, and its
    name as the profiler reports it (demangled, with its template arguments
    and parameter types) falls in the "normalisation" group of the port's
    KERNEL_GROUPS and of the benchmark's frozen copy: inside `no_ops_ms`."""
    names = _globals_of(ROOT / "mvoc_tpu_torch" / "csrc" / "norm.cu")
    assert names == set(norm.KERNEL_NAMES)
    for name in names:
        for targs in ("<__nv_bfloat16, 8>", "<float, 4, true>", "<__nv_bfloat16, 8, 5>",
                      "<float>"):
            full = (f"void mvoc::(anonymous namespace)::{name}{targs}(__nv_bfloat16 const*, "
                    f"float2*, void const*, int, long long, float)")
            assert profiling.kernel_group(full) == "normalisation", full
            assert bench_trace.kernel_group(full) == "normalisation", full
    assert "normalisation" in bench_trace.NO_OP_GROUPS


def test_gn_tiles_cover_the_rows():
    for s in (1, 95, 96, 97, 14400, 230400):
        vec, by = norm.group_norm_plan(320, True)
        n = norm.gn_tiles(s, by)
        rows = by * norm.GN_ROWS_PER_THREAD
        assert (n - 1) * rows < s <= n * rows
    assert math.ceil(14400 / 96) == norm.gn_tiles(14400, 12)


def _split_frames(norm_fn, x, pieces):
    """norm_fn(piece, gather) on each of `pieces` frame slices of x as the
    ranks of a "seq" axis would run it: a first pass records each piece's
    partial moments, a second hands every piece all of them in rank order
    (and checks that its own is the one at its rank).  -> the pieces'
    outputs joined along the frames."""
    xs = x.chunk(pieces, dim=1)
    parts = [None] * pieces

    def record(r):
        def gather(part):
            parts[r] = part.clone()
            return torch.stack([part] * pieces)
        return gather

    def replay(r):
        def gather(part):
            assert torch.equal(part, parts[r])
            return torch.stack(parts)
        return gather

    for r, xr in enumerate(xs):
        norm_fn(xr, record(r))
    return torch.cat([norm_fn(xr, replay(r)) for r, xr in enumerate(xs)], dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_over_split_frames_matches_the_whole(dtype, silu):
    """A 5-D x split over 2 or 4 "ranks" along its frames, the partial
    moments gathered: the whole video's GroupNorm (fp32 rounding apart);
    with each rank's own statistics (no gather) it is far off."""
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(2, 8, 3, 5, 32, generator=g) * 2 + 1).to(dtype)
    x[:, :4] += 3  # the frames' halves differ: local statistics are wrong
    w, b = _affine(32, dtype, 6)
    want = norm.group_norm_plain(x, w, b, 4, 1e-6, silu=silu).float()
    tol = (2e-5 if dtype == torch.float32 else 2e-2) * want.abs().max().item()
    for pieces in (2, 4):
        got = _split_frames(lambda t, gather: norm.group_norm(t, w, b, 4, 1e-6, silu=silu,
                                                              gather=gather), x, pieces)
        assert got.dtype == dtype and got.shape == x.shape
        assert (got.float() - want).abs().max().item() <= tol
    local = torch.cat([norm.group_norm(t, w, b, 4, 1e-6, silu=silu) for t in x.chunk(2, 1)], 1)
    assert (local.float() - want).abs().max().item() > 10 * tol


def test_group_norm_gather_refusals():
    x = torch.zeros(1, 2, 3, 3, 32)
    w, b = torch.ones(32), torch.zeros(32)
    with pytest.raises(ValueError, match="gather must return"):
        norm.group_norm(x, w, b, 4, 1e-5, gather=lambda p: p)
    with pytest.raises(ValueError, match="gather must return"):
        norm.group_norm(x, w, b, 4, 1e-5, gather=lambda p: torch.stack([p, p]).double())
    with pytest.raises(ValueError, match="gather takes a 5-D x"):
        norm._group_norm_cuda(x[0], w, b, 4, 1e-5, False, gather=lambda p: p[None])
