"""mvoc_tpu_torch/utils/flops.py against the JAX package's
mvoc_tpu/utils/flops.py:

* the closed forms tests/test_flops.py pins (a matmul, a 3x3 conv);
* `kernel_flops` against JAX's tally formulas (`_attention_tally`) and its
  dot_general rule, at the K1 / K2 / K3 signatures the card's bf16 and
  int8-mixed paths launch at 512 px;
* on the plain route (CPU tensors) each kernel call is booked once, in its
  own class, and its plain version's products are not booked as "dot":
  K1, K2 in both layouts, frame-axis attention over 65 frames (K1 with the
  band), an int8 QuantLinear (K3);
* the full-width 5-branch 512 px UNet forward, counted shape-only on meta,
  against JAX's `jaxpr_matmul_flops_by_class`, in float and under the
  int8-mixed selection;
* one step of each path of the pipeline cores at the tiny geometry
  (counted for real on the CPU; the fused steps also shape-only on meta)
  against JAX's count of the same core call: equal, but for the
  differences the module's docstring names, each asserted at its size.

The JAX counts come from tests/data/torch_parity_goldens.npz (flops/*,
written by scripts/torch_parity_goldens.py): no JAX UNet is traced here.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mvoc_tpu.ops import attention as jattn
from mvoc_tpu.utils import flops as JFL
from mvoc_tpu_torch import pnp as tp
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.ops import attention as A
from mvoc_tpu_torch.ops import quantize as tq
from mvoc_tpu_torch.ops.ddim import DDIM, SchedulerConfig
from mvoc_tpu_torch.pipeline import core as tcore
from mvoc_tpu_torch.utils import flops as FL
from torch_support import load_goldens
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

REL = 1e-12  # the counts are exact arithmetic
N_STEPS = 4  # the goldens' composite schedule
BF16 = "torch.bfloat16"
# signatures the card's phase 2 (bf16: inversion, stream composite, VAE) and
# phase 5 (int8-mixed) launch at 16 frames and 512 px
K1_SIGS = [(1, 1, 4096, 4096, 512, BF16, False), (16, 5, 4096, 4096, 64, BF16, False),
           (16, 5, 4096, 145, 64, BF16, False), (16, 10, 1024, 1024, 64, BF16, False),
           (32, 20, 256, 256, 64, BF16, False), (32, 20, 64, 145, 64, BF16, False)]
K2_SIGS = [("natural", 1, 16, 4096, 5, 64, BF16, False),
           ("natural", 2, 16, 64, 20, 64, BF16, False),
           ("natural", 1, 16, 4096, 8, 64, BF16, False), ("sf", 1, 16, 4096, 2, 4, BF16, False),
           ("sf", 1, 64, 16, 20, 64, BF16, False)]
K3_SIGS = [(4096, 1280, 1280, BF16), (1024, 1280, 3840, "torch.float32"),
           (65536, 1280, 320, BF16), (16, 1280, 4096, BF16), (8192, 5120, 1280, BF16)]
# the pipeline-core steps of the goldens' flops/step/* cases: (path, int8,
# core keywords, run steps); "invert" is ddim_inversion_core
STEPS = {"fused": (False, False, {}, 1), "two_pass": (True, False, {}, 1),
         "stream": ("stream", False, {}, 1), "invert": ("invert", False, {}, 1),
         "int8_fused": (False, True, {}, 1),
         "fused_k2": (False, False, dict(encoder_reuse_interval=2), 2),
         "invert_k2_deep": ("invert", False, dict(encoder_reuse_interval=2, deep_reuse=True), 2)}
# the steps also counted shape-only on meta (chip_smoke.py counts phase 9's
# one-process int8 fused step so); counting is host-bound, meta more so
META_STEPS = ("fused", "int8_fused")
# what a cached reuse step skips and JAX's program still computes (its
# output unused; XLA drops it as dead code, the jaxpr walk counts it)
JAX_ONLY_ON_CACHED = {
    "fused_k2": ("image_latents_proj_in", "image_latents_temporal_encoder"),
    "invert_k2_deep": ("image_latents_proj_in", "image_latents_temporal_encoder",
                       "image_latents_context_embedding", "context_embedding"),
}


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


def _jax(goldens, name):
    return {k[len(f"flops/{name}/"):]: float(v) for k, v in goldens.items()
            if k.startswith(f"flops/{name}/")}


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b), 1.0), (a, b)


def test_closed_forms():
    """A matmul and a 3x3 conv: the port's classes are JAX's numbers."""
    m, k, n = 32, 64, 16
    got = FL.matmul_flops_by_class(torch.matmul, torch.zeros(m, k), torch.zeros(k, n))
    want = JFL.jaxpr_matmul_flops_by_class(lambda a, b: a @ b, jnp.zeros((m, k)),
                                           jnp.zeros((k, n)))
    assert got["dot"] == want["dot"] == 2 * m * k * n
    assert got["total"] == got["dot"]
    x, w = jnp.zeros((2, 8, 8, 4)), jnp.zeros((3, 3, 4, 6))
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    want = JFL.jaxpr_matmul_flops_by_class(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (1, 1), [(1, 1), (1, 1)], dimension_numbers=dn), x, w)
    got = FL.matmul_flops_by_class(F.conv2d, torch.zeros(2, 4, 8, 8), torch.zeros(6, 4, 3, 3),
                                   padding=1)
    assert got["conv"] == want["conv"] == 2 * 2 * 8 * 8 * 6 * (3 * 3 * 4)
    assert got["total"] == got["conv"]


def test_kernel_flops_match_jax_formulas():
    """kernel_flops at each launched signature against JAX's attention tally
    (the Pallas entry points patched) and its dot_general rule."""
    sds = jax.ShapeDtypeStruct
    for sig in K1_SIGS:
        b, h, sq, sk, d = sig[:5]
        with JFL._attention_tally() as tally:
            jax.eval_shape(lambda q, k, v: jattn.flash_attention(q, k, v), sds((b, h, sq, d),
                           jnp.bfloat16), *[sds((b, h, sk, d), jnp.bfloat16)] * 2)
        assert FL.kernel_flops("flash_attention", sig) == tally["flops"] > 0, sig
    for sig in K2_SIGS:
        layout, b, f, s, heads, d = sig[:6]
        shape = (b, f, s, heads * d) if layout == "natural" else (s, f, heads * d)
        with JFL._attention_tally() as tally:
            jax.eval_shape(lambda q, k, v: jattn.frame_attention(q, k, v, f, heads, None),
                           *[sds(shape, jnp.bfloat16)] * 3)
        assert FL.kernel_flops("frame_attention", sig) == tally["flops"] > 0, sig
    for sig in K3_SIGS:
        m, k, n = sig[:3]
        want = JFL.jaxpr_matmul_flops(lambda x, w: jax.lax.dot_general(
            x, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32),
            sds((m, k), jnp.int8), sds((k, n), jnp.int8))
        assert FL.kernel_flops("s8_matmul", sig) == want == 2.0 * m * k * n, sig
    with pytest.raises(ValueError):
        FL.kernel_flops("sdpa", (1,))


def test_plain_route_books_each_kernel_once():
    """CPU tensors take the plain versions: each call books its kernel once,
    at the signature LAUNCH_SHAPES would key, and no "dot" (the plain
    versions' own products); FlopCounterMode's total is conv + dot."""
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731

    def count(fn):
        with FL.FlopCounter() as counter:
            out = fn()
        by = counter.by_class()
        assert counter.library_total() == by["conv"] + by["dot"]
        assert sum(by[c] for c in FL.CLASSES) == by["total"]
        return out, by

    q, k, v = rnd(2, 3, 40, 8), rnd(2, 3, 24, 8), rnd(2, 3, 24, 8)
    out, by = count(lambda: A.flash_attention(q, k, v))
    torch.testing.assert_close(out, A.flash_attention_plain(q, k, v), rtol=0, atol=0)
    assert by == FL.with_total({"flash_attention": 4.0 * 2 * 3 * 40 * 24 * 8})
    for layout, shape in (("natural", (2, 6, 5, 16)), ("sf", (5, 6, 16))):
        x = [rnd(*shape) for _ in range(3)]
        _, by = count(lambda: A.frame_attention(*x, 2, layout=layout))
        b = 2 if layout == "natural" else 1
        assert by == FL.with_total({"frame_attention": 4.0 * b * 2 * 5 * 6 * 6 * 8})
    # 65 frames: K1 once per entry of B with the band as its bias, all pairs
    x = [rnd(2, 65, 3, 8) for _ in range(3)]
    band = (torch.arange(65)[:, None] - torch.arange(65)[None, :]).abs() <= 8
    _, by = count(lambda: A.frame_axis_attention(*x, 2, mask=band))
    with JFL._attention_tally() as tally:
        jax.eval_shape(lambda q: jattn.frame_attention(q, q, q, 65, 2, None),
                       jax.ShapeDtypeStruct((2, 65, 3, 8), jnp.float32))
    assert by == FL.with_total({"flash_attention": tally["flops"]})
    assert by["flash_attention"] == 2 * FL.kernel_flops("flash_attention", (3, 2, 65, 65, 4))
    # int8: the QuantLinear's GEMM is K3's, its float64 plain version unbooked
    layer = tq.QuantLinear(rnd(8, 16), rnd(8))
    _, by = count(lambda: layer(rnd(3, 5, 16)))
    assert by == FL.with_total({"s8_matmul": 2.0 * 15 * 16 * 8})


def _meta_unet(int8: bool):
    with torch.device("meta"):
        unet = I2VGenXLUNet(dataclasses.replace(UNetConfig(), temporal_natural_layout=True))
    if int8:
        tq.quantize_unet_(unet, tq.mixed_unet_predicate)
    return unet


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8_mixed"])
def test_full_width_forward_matches_jax(goldens, int8):
    """The full-width forward (5 branches, 16 frames, 64 x 64 latents):
    the port's count of the same program equals JAX's to the last digit."""
    want = _jax(goldens, "unet_full_int8_mixed" if int8 else "unet_full")
    unet = _meta_unet(int8)
    b, f, lat = 5, 16, 64
    d = unet.config.cross_attention_dim
    x = [torch.empty(b, f, lat, lat, 4), 981, torch.full((b,), 8), torch.empty(b, f, lat, lat, 4),
         torch.empty(b, f, lat, lat, 4), torch.empty(b, f, d), torch.empty(b, 77, d)]
    with torch.inference_mode():
        got = FL.forward_flops(lambda u, *a: u(*a), unet, *x)
    total = want["conv"] + want["dot"] + want["pallas"]
    print({k: v / 1e12 for k, v in got.items()}, "JAX", {k: v / 1e12 for k, v in want.items()})
    _close(got["total"], total)
    assert want["conds"] == 0 and want["pallas"] == 0
    if int8:  # every int8 product of JAX's (dots and convs) is K3 here
        _close(got["s8_matmul"], want["int8"])
        assert got["s8_matmul"] > 0
        _close(got["conv"] + got["dot"] + got["flash_attention"] + got["frame_attention"],
               want["conv"] + want["dot"] - want["int8"])
    else:  # 104.675 TF: conv 46.968, JAX's dot (attention on the CPU) 57.708
        assert want["int8"] == 0 and got["s8_matmul"] == 0
        _close(got["conv"], want["conv"])
        _close(got["dot"] + got["flash_attention"] + got["frame_attention"], want["dot"])
        assert abs(got["total"] / 1e12 - 104.675) < 1e-3
        assert got["flash_attention"] > 0 and got["frame_attention"] > 0


def _cond(goldens, prefix):
    return tcore.UNetConditioning(**{f.name: torch.from_numpy(goldens[f"{prefix}/{f.name}"])
                                     for f in dataclasses.fields(tcore.UNetConditioning)})


def _pyramid(goldens, name):
    prefix = f"composite/{name}/"
    return {tuple(int(n) for n in k[len(prefix):].split("x")): torch.from_numpy(v)
            for k, v in goldens.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def unets():
    torch.manual_seed(0)
    unet = I2VGenXLUNet(UNetConfig.tiny()).eval()
    quant = copy.deepcopy(unet)
    tq.quantize_unet_(quant, tq.default_unet_predicate)  # the goldens' int8 selection
    return {False: unet, True: quant}


def _core_call(goldens, unets, name):
    """(core, args, kwargs) of the goldens' flops/step/<name> case."""
    path, int8, kw, n = STEPS[name]
    unet, ddim = unets[int8], DDIM(SchedulerConfig())
    if path == "invert":
        return tcore.ddim_inversion_core, (
            unet, ddim, torch.from_numpy(goldens["invert/x0"]), _cond(goldens, "invert"),
            goldens["invert/timesteps"][:n], 50), kw
    s = lambda k: goldens[f"composite/sched/{k}"]  # noqa: E731
    sched = tcore.CompositeSchedule(
        bg_traj=torch.from_numpy(s("bg_traj")[:n]), obj_traj=torch.from_numpy(s("obj_traj")[:n]),
        obj_fusion_lat=torch.from_numpy(s("obj_fusion_lat")),
        gate_spatial=s("gate_spatial")[:n], gate_temporal=s("gate_temporal")[:n],
        gate_conv=s("gate_conv")[:n], fusion_mask=s("fusion_mask")[:n],
        timesteps=s("timesteps")[:n])
    pb, ps = _pyramid(goldens, "pyr_bin"), _pyramid(goldens, "pyr_soft")
    return tcore.pnp_composite_core, (
        unet, ddim, torch.from_numpy(goldens["composite/init"]),
        _cond(goldens, "composite/cond"), sched, torch.from_numpy(goldens["composite/masks_soft"]),
        pb, ps), dict(kw, num_inference_steps=N_STEPS, guidance_scale=3.0,
                      random_noise_ratio=0.3, two_pass=path,
                      capture_weights=tp.build_capture_weights(pb, ps, True)
                      if path == "stream" else None)


@pytest.mark.parametrize("name", list(STEPS))
def test_tiny_step_matches_jax(goldens, unets, name):
    """One step of each path (two for the reuse modes: fresh, then cached)
    against JAX's count of the same core call.  Conv and dot + attention are
    compared with JAX's small temporal convs counted as convolutions (JAX
    runs them as a dot_general, ops/conv.py; the port as a convolution);
    the int8 products against JAX's int8 dots and convs.  JAX's programs
    hold no cond, and its count exceeds the port's only on the reuse modes'
    cached steps, by the modules JAX_ONLY_ON_CACHED names, at their size."""
    want = _jax(goldens, f"step/{name}")
    fn, args, kw = _core_call(goldens, unets, name)
    steps = []
    with FL.FlopCounter() as counter:
        fn(*args, **kw, step_callback=lambda i: steps.append(counter.modules()))
    got = counter.by_class()
    if name in META_STEPS:
        assert got == FL.forward_flops(fn, *args, **kw)
    assert sum(sum(r[c] for c in FL.CLASSES) for r in counter.modules().values()) == got["total"]
    assert want["conds"] == 0 and want["pallas"] == 0
    attn = got["dot"] + got["flash_attention"] + got["frame_attention"]
    # what JAX counts and the port does not run: the cached step's dead modules
    only = dict.fromkeys(("conv", "dot"), 0.0)
    if name in JAX_ONLY_ON_CACHED:
        fresh, whole = steps[0], counter.modules()
        for m in JAX_ONLY_ON_CACHED[name]:
            assert whole[m]["total"] == fresh[m]["total"] > 0  # none of it on the cached step
            only["conv"] += fresh[m]["conv"]
            only["dot"] += fresh[m]["total"] - fresh[m]["conv"]
    print(name, {k: v / 1e6 for k, v in got.items()}, "JAX", {k: v / 1e6 for k, v in want.items()},
          "JAX only", only)
    _close(got["total"] + only["conv"] + only["dot"], want["conv"] + want["dot"])
    if STEPS[name][1]:  # int8: K3 takes JAX's int8 dots and convs
        assert got["s8_matmul"] == want["int8"] > 0
        _close(got["conv"] + attn, want["conv"] + want["dot"] - want["int8"])
    else:
        assert got["s8_matmul"] == want["int8"] == 0
        assert want["conv_xla"] + want["dot_xla"] == want["conv"] + want["dot"]
        _close(got["conv"] + only["conv"], want["conv_xla"])
        _close(attn + only["dot"], want["dot_xla"])
        assert got["flash_attention"] > 0 and got["frame_attention"] > 0
