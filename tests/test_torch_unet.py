"""The tiny I2VGen-XL UNet of mvoc_tpu_torch against the JAX package's, with
the same (noise-replaced) weights: a plain forward, and the stream path's
per-branch capture then consume, in both temporal layouts (the fused PnP
forward is held against JAX through pnp_composite_core in
test_torch_pipeline.py).

The JAX side (params, inputs, outputs) comes from
tests/data/torch_parity_goldens.npz, written by
scripts/torch_parity_goldens.py: compiling the tiny UNet's programs here
would cost minutes of CPU that tier-1 cannot spare.  The stored param tree
is held against the JAX module's shapes live."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvoc_tpu import pnp as jp
from mvoc_tpu.models.unet_i2vgen import I2VGenXLUNet as JaxUNet
from mvoc_tpu.models.unet_i2vgen import UNetConfig as JaxConfig
from mvoc_tpu_torch import pnp as tp
from mvoc_tpu_torch.models.convert import unet_state_dict_from_flax
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from torch_support import load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

N_OBJ, F, LAT = 2, 2, 8
REL = 1e-4  # max error <= REL * max|JAX output|
ARGS = ("sample", "timestep", "fps", "image_latents_first", "image_latents",
        "image_embeddings", "encoder_hidden_states")


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def params(goldens):
    return nest(goldens, "params")


def test_golden_params_have_the_jax_unet_shapes(goldens, params):
    x = {k: jnp.asarray(goldens[f"unet/plain/{k}"][:1]) for k in ARGS}
    shapes = jax.eval_shape(lambda: JaxUNet(JaxConfig.tiny()).init(jax.random.key(0), **x))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes["params"])
    got = jax.tree.map(lambda a: tuple(a.shape), params)
    assert got == want


@pytest.fixture(scope="module", params=[False, True], ids=["standard", "natural"])
def model(request, params):
    tu = I2VGenXLUNet(dataclasses.replace(UNetConfig.tiny(),
                                          temporal_natural_layout=request.param))
    tu.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    return ("natural" if request.param else "standard"), tu.eval()


def _args(goldens, name, lo=None, hi=None):
    return [torch.as_tensor(goldens[f"unet/{name}/{k}"][lo:hi]) for k in ARGS]


def _check(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    print(f"max |err| {err:.3g} of max |jax| {np.abs(want).max():.3g}")
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def test_plain_forward(goldens, model):
    layout, tu = model
    with torch.no_grad():
        got = tu(*_args(goldens, "plain"))
    _check(got.numpy(), goldens[f"unet/{layout}/plain_out"])


def _state():
    binary = np.zeros((N_OBJ, F, LAT, LAT), np.float32)
    binary[0, :, : LAT // 2] = 1.0
    binary[1, :, :, : LAT // 2] = 1.0
    soft = np.clip(binary * 0.8 + 0.1, 0, 1).astype(np.float32)
    res = [(LAT, LAT), (LAT // 2, LAT // 2), (LAT // 4, LAT // 4)]
    pyr = lambda m: {k: torch.from_numpy(v) for k, v in jp.build_mask_pyramid(m, res).items()}
    return tp.PnPState(masks=pyr(binary), masks_soft=pyr(soft), gate_spatial=True,
                       gate_temporal=True, gate_conv=True)


def test_stream_capture_then_consume(goldens, model):
    """Per-branch streamed capture summed over the N+1 source branches, then
    the batch-2 edit pass consuming the pre-composited features."""
    layout, tu = model
    ts = _state()
    cw = tp.build_capture_weights(ts.masks, ts.masks_soft, True)
    feats = None
    for b in range(N_OBJ + 1):
        st = dataclasses.replace(ts, capture_weight={k: {r: w[b] for r, w in pyr.items()}
                                                     for k, pyr in cw.items()})
        with torch.no_grad():
            _, fb = tu(*_args(goldens, "src", b, b + 1), pnp=st, pnp_capture=True)
        feats = fb if feats is None else {
            k: tuple(a + c for a, c in zip(feats[k], v)) if isinstance(v, tuple)
            else feats[k] + v for k, v in fb.items()}
    prefix = f"unet/{layout}/feats/"
    want_sites = {k[len(prefix):].rsplit("/", 1)[0] for k in goldens if k.startswith(prefix)}
    assert sorted(feats) == sorted(want_sites)
    for site, val in feats.items():
        for i, leaf in enumerate(val if isinstance(val, tuple) else (val,)):
            _check(leaf.numpy(), goldens[f"{prefix}{site}/{i}"])
    with torch.no_grad():
        got = tu(*_args(goldens, "edit"),
                 pnp=dataclasses.replace(ts, mode="consume_pre", features=feats))
    _check(got.numpy(), goldens[f"unet/{layout}/stream_out"])
