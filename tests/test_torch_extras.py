"""The port's dormant extras against the JAX package's:

* UNet forwards with FreeU (at a 16 x 16 latent, so up blocks 0 and 1
  filter 2 x 2 and 4 x 4 skips) and with multi_frame_guidance, against the
  goldens within MODULE_ATOL;
* apply_freeu and _fourier_filter, ops/freeinit.py (lowpass_mask,
  freq_mix, frameinit with the noise passed in) and ops/affine.py
  (cv_affine_to_normalized, warp_affine nearest and bilinear,
  place_object) against the JAX functions called directly, within
  FUNC_REL of max |x| in fp32 (the libraries' FFT and gather orders
  differ);
* enable_freeu / disable_freeu on the pipeline: FreeU reaches every path
  (the reuse paths included), and disabling it is bitwise the plain run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvoc_tpu.models import unet_i2vgen as junet
from mvoc_tpu.ops import affine as jaffine
from mvoc_tpu.ops import freeinit as jfreeinit
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models import unet_i2vgen as tunet
from mvoc_tpu_torch.models.convert import unet_state_dict_from_flax
from mvoc_tpu_torch.ops import affine, freeinit
from mvoc_tpu_torch.ops.ddim import DDIM, SchedulerConfig, inversion_timesteps
from mvoc_tpu_torch.utils import testing as tt
from torch_support import load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

MODULE_ATOL = 2e-5  # single forwards (as test_torch_pipeline)
FUNC_REL = 1e-6  # the functions called directly: max |err| <= FUNC_REL * max |JAX|
EXTRAS_FREEU = dict(s1=0.9, s2=0.2, b1=1.1, b2=1.2)  # scripts/torch_parity_goldens.py's
HW, F, STEPS = 16, 2, 4
KEYS = ("sample", "timestep", "fps", "image_latents_first", "image_latents",
        "image_embeddings", "encoder_hidden_states")


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def unet(goldens):
    u = tunet.I2VGenXLUNet(tunet.UNetConfig.tiny())
    u.load_state_dict(unet_state_dict_from_flax(nest(goldens, "params")), strict=True)
    return u.eval()


def _inputs(goldens, prefix):
    return [torch.from_numpy(goldens[f"{prefix}/{k}"]) for k in KEYS]


def _check(got, want, rel=None, atol=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    print(f"max |err| {err:.3g} of max |jax| {scale:.3g}")
    assert err <= (atol if atol is not None else rel * scale), (err, scale)


def test_freeu_forward_matches_jax(goldens, unet):
    x = _inputs(goldens, "extras/unet16")
    with torch.inference_mode():
        got = unet(*x, freeu=tunet.FreeUConfig(**EXTRAS_FREEU))
        plain = unet(*x)
    _check(got, goldens["extras/freeu_out"], atol=MODULE_ATOL)
    assert (got - plain).abs().max() > 100 * MODULE_ATOL  # FreeU engaged


def test_multi_frame_guidance_forward_matches_jax(goldens, unet):
    x = _inputs(goldens, "unet/plain")
    with torch.inference_mode():
        got = unet(*x, multi_frame_guidance=True)
    _check(got, goldens["extras/mfg_out"], atol=MODULE_ATOL)
    assert np.abs(got.numpy() - goldens["unet/standard/plain_out"]).max() > 100 * MODULE_ATOL


def test_apply_freeu_and_fourier_filter_match_jax():
    rng = np.random.default_rng(0)
    for shape, thr, scale in (((2, 5, 7, 6), 1, 0.2), ((3, 4, 4, 8), 2, 0.9),
                              ((1, 9, 16, 3), 3, 1.7), ((2, 1, 1, 4), 1, 0.5)):
        x = rng.standard_normal(shape).astype(np.float32)
        _check(tunet._fourier_filter(torch.from_numpy(x), thr, scale),
               junet._fourier_filter(jnp.asarray(x), thr, scale), rel=FUNC_REL)
    cfg_t, cfg_j = tunet.FreeUConfig(**EXTRAS_FREEU), junet.FreeUConfig(**EXTRAS_FREEU)
    hidden = rng.standard_normal((2, 4, 4, 7)).astype(np.float32)
    skip = rng.standard_normal((2, 4, 4, 5)).astype(np.float32)
    for block in (0, 1, 2):
        for ct, cj in ((cfg_t, cfg_j), (None, None)):
            got = tunet.apply_freeu(block, torch.from_numpy(hidden), torch.from_numpy(skip), ct)
            want = junet.apply_freeu(block, jnp.asarray(hidden), jnp.asarray(skip), cj)
            for g, w in zip(got, want):
                _check(g, w, rel=FUNC_REL)


@pytest.mark.parametrize("method", ["gaussian", "ideal", "butterworth"])
def test_freeinit_matches_jax(method):
    rng = np.random.default_rng(1)
    f, h, w = 5, 6, 7
    lat = rng.standard_normal((f, h, w, 4)).astype(np.float32)
    noise = rng.standard_normal((f, h, w, 4)).astype(np.float32)
    for d_s, d_t in ((0.25, 0.25), (0.5, 0.1)):
        _check(freeinit.lowpass_mask(f, h, w, d_s, d_t, method),
               jfreeinit.lowpass_mask(f, h, w, d_s, d_t, method), rel=FUNC_REL)
    np.testing.assert_array_equal(freeinit.lowpass_mask(f, h, w, 0.0, 0.3, method).numpy(),
                                  np.asarray(jfreeinit.lowpass_mask(f, h, w, 0.0, 0.3, method)))
    mask = np.array(jfreeinit.lowpass_mask(f, h, w, 0.3, 0.4, method))
    _check(freeinit.freq_mix(torch.from_numpy(lat), torch.from_numpy(noise),
                             torch.from_numpy(mask)),
           jfreeinit.freq_mix(jnp.asarray(lat), jnp.asarray(noise), jnp.asarray(mask)),
           rel=FUNC_REL)
    # frameinit: JAX draws its noise from the key; the port takes that noise
    alphas = DDIM(SchedulerConfig()).alphas_cumprod
    key = jax.random.key(3)
    want = jfreeinit.frameinit(jnp.asarray(lat), key, jnp.asarray(np.asarray(alphas)),
                               noise_level=850, method=method)
    drawn = np.array(jax.random.normal(key, lat.shape, dtype=jnp.float32))
    _check(freeinit.frameinit(torch.from_numpy(lat), alphas, noise_level=850, method=method,
                              noise=torch.from_numpy(drawn)), want, rel=FUNC_REL)
    g = torch.Generator().manual_seed(0)
    drawn_here = freeinit.frameinit(torch.from_numpy(lat), alphas, generator=g)
    assert drawn_here.shape == lat.shape and torch.isfinite(drawn_here).all()


def test_affine_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    for theta_cv, dst in ((np.array([[0.7, 0.1, 2.0], [-0.2, 1.3, -1.5]]), (9, 11)),
                          (np.array([[1.5, 0.0, -3.0], [0.0, 0.5, 4.0]]), (12, 8))):
        t_np = affine.cv_affine_to_normalized(theta_cv, (9, 11), dst)
        j_np = jaffine.cv_affine_to_normalized(theta_cv, (9, 11), dst)
        np.testing.assert_array_equal(t_np, j_np)
        for mode in ("nearest", "bilinear"):
            _check(affine.warp_affine(torch.from_numpy(x), t_np, dst, mode=mode),
                   jaffine.warp_affine(jnp.asarray(x), jnp.asarray(j_np), dst, mode=mode),
                   rel=FUNC_REL)
    _check(affine.place_object(torch.from_numpy(x), 0.6, 2.0, 1.0, out_hw=(10, 12)),
           jaffine.place_object(jnp.asarray(x), 0.6, 2.0, 1.0, out_hw=(10, 12)), rel=FUNC_REL)


def test_enable_and_disable_freeu_on_the_pipeline(tmp_path):
    """FreeU reaches the inversion (exact and with encoder reuse at depth 1:
    the reuse path binds it too) and the composite; disable_freeu restores
    the plain runs bitwise."""
    pipe = tt.build_tiny_pipeline(device="cpu")
    kw = dict(height=HW, width=HW, num_frames=F, num_inference_steps=STEPS)
    frames = tt.tiny_frames(seed=3)
    ts = inversion_timesteps(SchedulerConfig(), STEPS)
    rng = np.random.default_rng(4)
    stores = []
    for j in range(3):
        d = str(tmp_path / f"traj{j}")
        TrajectoryStore(d, prefer_native=False).save(
            ts, rng.standard_normal((len(ts), F, HW // 2, HW // 2, 4)).astype(np.float32))
        stores.append(TrajectoryStore(d))
    masks = np.zeros((2, F, HW // 2, HW // 2), np.float32)
    masks[0, :, :4] = 1.0
    masks[1, :, :, :4] = 1.0
    args = ("a cat", frames[0], frames, tt.tiny_frames(seed=0),
            [tt.tiny_frames(seed=1), tt.tiny_frames(seed=2)], masks, masks, stores[0],
            stores[1:])
    comp_kw = dict(kw, guidance_scale=3.0, fusion_steps=(0, 1), decode=False)

    def runs():
        return (pipe.invert(frames, **kw)[1],
                pipe.invert(frames, encoder_reuse_interval=2, encoder_reuse_depth=1, **kw)[1],
                pipe.sample_composite(*args, **comp_kw).numpy())

    plain = runs()
    pipe.enable_freeu(**EXTRAS_FREEU)
    with_freeu = runs()
    pipe.disable_freeu()
    again = runs()
    for p, w, a in zip(plain, with_freeu, again):
        assert np.isfinite(w).all()
        assert np.abs(w - p).max() > 0.0
        np.testing.assert_array_equal(a, p)
