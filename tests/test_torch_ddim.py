"""mvoc_tpu_torch DDIM scheduler vs the JAX package's (same numpy inputs)."""

import numpy as np
import pytest
import torch

from mvoc_tpu.ops import ddim as jddim
from mvoc_tpu_torch.ops import ddim as tddim


def test_timestep_golden_anchors():
    cfg = tddim.SchedulerConfig()
    ts = tddim.sampling_timesteps(cfg, 50)
    assert list(ts[[0, 3, 9, 20]]) == [981, 921, 801, 581]
    np.testing.assert_array_equal(ts, jddim.sampling_timesteps(jddim.SchedulerConfig(), 50))
    np.testing.assert_array_equal(tddim.inversion_timesteps(cfg, 500),
                                  jddim.inversion_timesteps(jddim.SchedulerConfig(), 500))


@pytest.mark.parametrize("kw", [{}, {"rescale_betas_zero_snr": True, "prediction_type": "v_prediction",
                                     "timestep_spacing": "trailing"}])
def test_step_inverse_step_add_noise_match_jax(kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    jd, td = jddim.DDIM(jddim.SchedulerConfig(**kw)), tddim.DDIM(tddim.SchedulerConfig(**kw))
    np.testing.assert_allclose(td.alphas_cumprod, np.asarray(jd.alphas_cumprod), rtol=1e-7)
    xt, et = torch.from_numpy(x), torch.from_numpy(eps)
    for t in (981, 501, 21, 1):
        np.testing.assert_allclose(td.step(et, t, xt, 50).numpy(),
                                   np.asarray(jd.step(eps, t, x, 50)), atol=2e-6)
        np.testing.assert_allclose(td.inverse_step(et, t, xt, 50).numpy(),
                                   np.asarray(jd.inverse_step(eps, t, x, 50)), atol=2e-6)
        np.testing.assert_allclose(td.add_noise(xt, et, t).numpy(),
                                   np.asarray(jd.add_noise(x, eps, t)), atol=2e-6)


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
def test_step_with_eta_matches_jax(eta):
    """DDIM's stochastic step: eta times the DDIM sigma, the noise passed in."""
    rng = np.random.default_rng(1)
    x, eps, noise = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    jd, td = jddim.DDIM(jddim.SchedulerConfig()), tddim.DDIM(tddim.SchedulerConfig())
    for t in (981, 501, 21):
        want = np.asarray(jd.step(eps, t, x, 50, eta=eta, noise=noise if eta else None))
        got = td.step(torch.from_numpy(eps), t, torch.from_numpy(x), 50, eta=eta,
                      noise=torch.from_numpy(noise) if eta else None)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    with pytest.raises(ValueError, match="noise"):
        td.step(torch.from_numpy(eps), 501, torch.from_numpy(x), 50, eta=0.5)
