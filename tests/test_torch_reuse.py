"""The port's reuse and broadcast modes against the JAX package's:

* every mode the goldens hold (scripts/torch_parity_goldens.py: the
  inversion with encoder reuse, deep reuse and reuse depth 1, batched with
  deep reuse; the composite with encoder reuse on all three paths, depth 1,
  PAB, capture reuse on two_pass=True and stream, deep capture reuse,
  batched deep capture reuse; all at k = 2 over 3 steps), port against JAX
  on the same weights and inputs within CORE_REL of max |JAX|;
* the mode combinations the JAX core asserts against are exactly those the
  port refuses (with a ValueError naming the rule);
* the reuse schedule (fresh_steps) is that of JAX's blockwise scan;
* the UNet calls of each mode, step by step: which are fresh, which read a
  cache, and their batches;
* every knob at interval 1 (or False / None) is bitwise the exact loop.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvoc_tpu.pipeline import core as jcore
from mvoc_tpu_torch import pnp as tp
from mvoc_tpu_torch.models.convert import unet_state_dict_from_flax
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.ops.ddim import DDIM, SchedulerConfig
from mvoc_tpu_torch.pipeline import core
from torch_support import load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

N_STEPS = 4  # 4-step schedule, t_idx 1 -> 3 composite steps
CORE_REL = 1e-3  # port vs JAX, fp32: max error <= CORE_REL * max|JAX| (as test_torch_pipeline)
# the goldens' composite modes: name -> (two_pass, the core's keywords, reuse depth)
COMPOSITES = {
    "fused_k2": (False, dict(encoder_reuse_interval=2), None),
    "two_pass_k2": (True, dict(encoder_reuse_interval=2), None),
    "stream_k2": ("stream", dict(encoder_reuse_interval=2), None),
    "fused_k2_depth1": (False, dict(encoder_reuse_interval=2), 1),
    "fused_pab_k2": (False, dict(pab_interval=2), None),
    "two_pass_capture_k2": (True, dict(capture_reuse_interval=2), None),
    "stream_capture_k2": ("stream", dict(capture_reuse_interval=2), None),
    "stream_capture_deep_k2": ("stream", dict(capture_reuse_interval=2,
                                              capture_reuse_deep=True), None),
}
INVERSIONS = {"k2": (dict(encoder_reuse_interval=2), None),
              "k2_deep": (dict(encoder_reuse_interval=2, deep_reuse=True), None),
              "k2_depth1": (dict(encoder_reuse_interval=2), 1)}


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def unet(goldens):
    u = I2VGenXLUNet(UNetConfig.tiny())
    u.load_state_dict(unet_state_dict_from_flax(nest(goldens, "params")), strict=True)
    return u.eval()


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"max |err| {err:.3g} of max |jax| {np.abs(want).max():.3g}")
    return err / float(np.abs(want).max())


def _cond(goldens, prefix):
    return core.UNetConditioning(**{
        f.name: torch.from_numpy(goldens[f"{prefix}/{f.name}"])
        for f in dataclasses.fields(core.UNetConditioning)})


def _depth(unet, depth):
    return functools.partial(unet, encoder_reuse_depth=depth) if depth else unet


def _composite_inputs(goldens, root):
    """(init, cond, sched, masks_soft, pyr_bin, pyr_soft) as JAX's
    _prepare_composite built them (root "composite": one entry;
    "composite_batch": two, each with its leading entry axis)."""
    s = lambda name: goldens[f"{root}/sched/{name}"]  # noqa: E731
    sched = core.CompositeSchedule(**{
        f.name: torch.from_numpy(s(f.name)) if f.name.endswith(("traj", "lat")) else s(f.name)
        for f in dataclasses.fields(core.CompositeSchedule)})

    def pyramid(name):
        prefix = f"{root}/{name}/"
        return {tuple(int(n) for n in k[len(prefix):].split("x")): torch.from_numpy(v)
                for k, v in goldens.items() if k.startswith(prefix)}

    return (torch.from_numpy(goldens[f"{root}/init"]), _cond(goldens, f"{root}/cond"), sched,
            torch.from_numpy(goldens[f"{root}/masks_soft"]), pyramid("pyr_bin"),
            pyramid("pyr_soft"))


def _composite(unet, inputs, two_pass, batch=False, **kw):
    init, cond, sched, ms, pb, ps = inputs
    fn = core.pnp_composite_batch_core if batch else core.pnp_composite_core
    return fn(unet, DDIM(SchedulerConfig()), init, cond, sched, ms, pb, ps,
              capture_weights=tp.build_capture_weights(pb, ps, True)
              if two_pass == "stream" else None,
              num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
              two_pass=two_pass, **kw)


def _inversion(unet, goldens, **kw):
    return core.ddim_inversion_core(unet, DDIM(SchedulerConfig()),
                                    torch.from_numpy(goldens["invert/x0"]),
                                    _cond(goldens, "invert"), goldens["invert/timesteps"], 50,
                                    **kw)


@pytest.mark.parametrize("name", sorted(INVERSIONS))
def test_inversion_mode_matches_jax(goldens, unet, name):
    kw, depth = INVERSIONS[name]
    got = _inversion(_depth(unet, depth), goldens, **kw)
    assert _rel_err(got.numpy(), goldens[f"reuse/invert/{name}"]) <= CORE_REL
    # JAX's mode left the exact trajectory by more than CORE_REL, so a port
    # that ignored the knob would fail the check above
    assert _rel_err(goldens[f"reuse/invert/{name}"], goldens["invert/trajectory"]) > CORE_REL


def test_inversion_batch_deep_reuse_matches_jax(goldens, unet):
    got = core.ddim_inversion_batch_core(
        unet, DDIM(SchedulerConfig()), torch.from_numpy(goldens["invert_batch/x0"]),
        _cond(goldens, "invert_batch"), goldens["invert/timesteps"], 50,
        encoder_reuse_interval=2, deep_reuse=True)
    assert _rel_err(got.numpy(), goldens["reuse/invert_batch/k2_deep"]) <= CORE_REL
    assert _rel_err(got[:, 0].numpy(), goldens["reuse/invert/k2_deep"]) <= CORE_REL


@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composite_mode_matches_jax(goldens, unet, name):
    two_pass, kw, depth = COMPOSITES[name]
    got = _composite(_depth(unet, depth), _composite_inputs(goldens, "composite"), two_pass, **kw)
    want = goldens[f"reuse/composite/{name}"]
    assert _rel_err(got.numpy(), want) <= CORE_REL
    assert _rel_err(want, goldens["composite/fused_out"]) > CORE_REL  # as in the inversion


def test_composite_batch_capture_deep_matches_jax(goldens, unet):
    """J = 2 entries on the stream path with deep capture reuse: the caches
    carry both entries' batch."""
    got = _composite(unet, _composite_inputs(goldens, "composite_batch"), "stream", batch=True,
                     capture_reuse_interval=2, capture_reuse_deep=True)
    want = goldens["reuse/composite_batch/stream_capture_deep_k2"]
    assert _rel_err(got.numpy(), want) <= CORE_REL
    assert _rel_err(got[0].numpy(), goldens["reuse/composite/stream_capture_deep_k2"]) <= CORE_REL


def test_refused_combinations_match_jax():
    """Over every combination of the five knobs and the three paths, the port
    refuses (ValueError) exactly where the JAX core asserts."""
    masks = jnp.zeros((2, 2, 8, 8))
    for two_pass, enc, pab, cap, deep in itertools.product(
            (False, True, "stream"), (1, 2), (1, 2), (1, 3), (False, True)):
        knobs = dict(encoder_reuse_interval=enc, pab_interval=pab, capture_reuse_interval=cap,
                     capture_reuse_deep=deep)
        try:
            jcore.pnp_composite_core(None, None, None, None, None, None, masks, {}, {},
                                     num_inference_steps=4, guidance_scale=3.0,
                                     two_pass=two_pass, capture_weights={}, **knobs)
            jax_refuses = False
        except AssertionError:
            jax_refuses = True
        except Exception:  # past the asserts, on the missing inputs
            jax_refuses = False
        if jax_refuses:
            with pytest.raises(ValueError, match="composes with|extends capture reuse"):
                core.check_composite_modes(two_pass, **knobs)
        else:
            core.check_composite_modes(two_pass, **knobs)


def test_reuse_schedule_is_the_blockwise_scans():
    """fresh_steps(n, k) marks the steps JAX's _blockwise_cached_scan runs
    fresh (each step yields 1 when fresh, 0 when cached)."""
    for n, k in ((6, 3), (7, 3), (5, 2), (4, 5), (1, 3), (3, 2), (8, 1)):
        if k == 1:
            assert core.fresh_steps(n, k) == [True] * n
            continue
        _, ys = jcore._blockwise_cached_scan(
            lambda lat, x: (lat, lat, jnp.float32(1.0)),
            lambda lat, c, x: (lat, jnp.float32(0.0)),
            jnp.float32(0.0), jnp.arange(float(n)), n, k)
        assert core.fresh_steps(n, k) == [bool(v) for v in np.asarray(ys)], (n, k)


class RecordingUNet:
    """The UNet, recording each call's batch and how it used the caches."""

    def __init__(self, unet):
        self.unet, self.calls = unet, []

    def __call__(self, sample, *args, **kw):
        tags = [k for k in ("return_encoder", "pab_capture") if kw.get(k)]
        tags += [k for k in ("cached_encoder", "pab_cache") if kw.get(k) is not None]
        self.calls.append((sample.shape[0], "+".join(tags) or "plain"))
        return self.unet(sample, *args, **kw)


# per step: the calls (batch, cache use) of one entry (N = 2)
FRESH_ENC, CACHED_ENC = "return_encoder", "cached_encoder"
STEP_CALLS = {
    "fused_k2": ([(5, FRESH_ENC)], [(5, CACHED_ENC)]),
    "fused_pab_k2": ([(5, "pab_capture")], [(5, "pab_cache")]),
    "two_pass_k2": ([(3, FRESH_ENC), (2, FRESH_ENC)], [(3, CACHED_ENC), (2, CACHED_ENC)]),
    "stream_k2": ([(1, FRESH_ENC)] * 3 + [(2, FRESH_ENC)], [(1, CACHED_ENC)] * 3 + [(2, CACHED_ENC)]),
    "two_pass_capture_k2": ([(3, "plain"), (2, "plain")], [(2, "plain")]),
    "stream_capture_k2": ([(1, "plain")] * 3 + [(2, "plain")], [(2, "plain")]),
    "stream_capture_deep_k2": ([(1, "plain")] * 3 + [(2, "return_encoder+pab_capture")],
                               [(2, "cached_encoder+pab_cache")]),
}


def test_unet_calls_per_step(goldens, unet):
    """Over the 3 run steps at k = 2 (fresh, cached, fresh): a fresh step
    makes its cache, a cached step reads it; capture reuse skips the source
    forwards of a cached step; the batch doubles with J = 2 entries."""
    for name, (fresh, cached) in STEP_CALLS.items():
        two_pass, kw, _ = COMPOSITES[name]
        for batch, j in ((False, 1), (True, 2)):
            rec = RecordingUNet(unet)
            root = "composite_batch" if batch else "composite"
            _composite(rec, _composite_inputs(goldens, root), two_pass, batch=batch, **kw)
            want = [(b * j, use) for b, use in fresh + cached + fresh]
            assert rec.calls == want, (name, j, rec.calls)
    for deep, (fresh, cached) in ((False, (FRESH_ENC, CACHED_ENC)),
                                  (True, ("return_encoder+pab_capture",
                                          "cached_encoder+pab_cache"))):
        rec = RecordingUNet(unet)
        _inversion(rec, goldens, encoder_reuse_interval=2, deep_reuse=deep)
        assert rec.calls == [(1, fresh), (1, cached), (1, fresh)], rec.calls


def test_interval_one_is_the_exact_loop_bitwise(goldens, unet):
    """Each knob at interval 1 (or False / None, with depth bound) runs the
    exact loop: bitwise the default call, on every path and in both
    inversion cores."""
    inputs = _composite_inputs(goldens, "composite")
    off = dict(encoder_reuse_interval=1, pab_interval=1, capture_reuse_interval=1,
               capture_reuse_deep=False)
    for two_pass in (False, True, "stream"):
        exact = _composite(unet, inputs, two_pass)
        assert torch.equal(_composite(_depth(unet, 2), inputs, two_pass, **off), exact)
    exact = _inversion(unet, goldens)
    assert torch.equal(_inversion(_depth(unet, 1), goldens, encoder_reuse_interval=1,
                                  deep_reuse=True), exact)
    x0, cond = torch.from_numpy(goldens["invert_batch/x0"]), _cond(goldens, "invert_batch")
    ts = goldens["invert/timesteps"]
    exact = core.ddim_inversion_batch_core(unet, DDIM(SchedulerConfig()), x0, cond, ts, 50)
    assert torch.equal(core.ddim_inversion_batch_core(
        unet, DDIM(SchedulerConfig()), x0, cond, ts, 50, encoder_reuse_interval=1,
        deep_reuse=True), exact)
