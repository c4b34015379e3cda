"""The port's drift bounds for the approximate modes (utils/quality.py) and
its automatic reuse gate (utils/autoreuse.py), against the JAX package's:

* the port's approx_quality_report, run on the JAX drift harness's own
  parameters and inputs (`_TinyHarness(seed=0)`, stored in the goldens by
  scripts/torch_parity_goldens.py), meets the bounds of
  tests/test_approx_quality.py: COMPOSITE_BOUNDS on the composite modes,
  0 < rel_l2 < 0.15 on the inversion trajectories with x_T < 0.30, deep
  reuse drifting at least as far as plain reuse, a stale capture (one
  capture broadcast over every step) drifting further than k = 2;
* each rel_l2 is within REPORT_ATOL of the JAX report's, and the exact
  baselines match JAX's within CORE_REL;
* select_reuse_k picks what the JAX function picks on scripted probes;
* `encoder_reuse_interval: auto` resolves through cli.inverse.run on the
  tiny CPU pipeline (the largest passing candidate, or k = 1 with deep
  reuse turned off when none passes), and the trajectory store records
  the k chosen.
"""

import json
import os

import numpy as np
import pytest

from mvoc_tpu.utils import autoreuse as jautoreuse
from mvoc_tpu_torch import config as tcfg
from mvoc_tpu_torch.cli import inverse as tinverse
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models.convert import unet_state_dict_from_flax
from mvoc_tpu_torch.utils import autoreuse, quality
from mvoc_tpu_torch.utils import testing as tt
from torch_support import ROOT, load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

# tests/test_approx_quality.py's bounds (max rel_l2 of the final composite latents)
COMPOSITE_BOUNDS = {"encoder_reuse_k2": 0.85, "capture_reuse_k2": 0.72,
                    "capture_reuse_k2_deep": 0.95}
COMPOSITE_MODES = tuple(m for m in quality.COMPOSITE_MODES
                        if m[0] in tuple(COMPOSITE_BOUNDS) + ("pab_k2",))
INVERSION_MODES = tuple(m for m in quality.INVERSION_MODES if "int8" not in m[0])
REPORT_ATOL = 1e-3  # port rel_l2 vs JAX's stored figure
CORE_REL = 1e-3
HW, F, STEPS = 16, 2, 4  # the tiny pipeline's demo tree


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def harness(goldens):
    return quality._TinyHarness(seed=0, unet_state=unet_state_dict_from_flax(
        nest(goldens, "quality/params")))


@pytest.fixture(scope="module")
def report(harness):
    out = quality.approx_quality_report(composite_modes=COMPOSITE_MODES,
                                        inversion_modes=INVERSION_MODES, harness=harness)
    stale = harness.run_composite(capture_reuse_interval=harness.compose_steps * 2)
    out["capture_reuse_stale"] = quality.latent_metrics(stale, harness.run_composite())
    print(json.dumps(out, indent=1))
    return out


def _jax_report(goldens, mode):
    return {k: float(goldens[f"quality/report/{mode}/{k}"]) for k in ("rel_l2", "psnr_db")}


def test_harness_inputs_and_exact_runs_are_jaxs(goldens, harness):
    """The port's harness draws the JAX harness's inputs bitwise, and its
    exact stream composite and inversion match JAX's."""
    for name in ("x0", "xT", "masks"):
        np.testing.assert_array_equal(np.asarray(getattr(harness, name)),
                                      goldens[f"quality/{name}"])
    for tag in ("cond1", "condN"):
        cond = getattr(harness, tag)
        for f in ("encoder_hidden_states", "image_latents_first", "image_latents",
                  "image_embeddings", "fps"):
            np.testing.assert_array_equal(getattr(cond, f).numpy(), goldens[f"quality/{tag}/{f}"])
    for got, key in ((harness.run_composite(), "exact_stream"),
                     (harness.run_inversion(), "exact_inversion")):
        want = goldens[f"quality/{key}"]
        err = np.abs(got - want).max()
        print(f"{key}: max |err| {err:.3g} of max |jax| {np.abs(want).max():.3g}")
        assert err <= CORE_REL * np.abs(want).max()


@pytest.mark.parametrize("mode", sorted(COMPOSITE_BOUNDS) + ["pab_k2"])
def test_composite_mode_drift_bounded_and_jaxs(goldens, report, mode):
    m, want = report[mode], _jax_report(goldens, mode)
    print(mode, m, "jax", want)
    assert m["rel_l2"] > 0.0, f"{mode} bit-identical to exact: the knob did nothing"
    assert m["rel_l2"] < COMPOSITE_BOUNDS.get(mode, 1.0), m
    assert abs(m["rel_l2"] - want["rel_l2"]) <= REPORT_ATOL


def test_inversion_reuse_drift_bounded_and_jaxs(goldens, report):
    for mode in ("inv_encoder_reuse_k2", "inv_deep_reuse_k2"):
        m = report[mode]
        assert 0.0 < m["rel_l2"] < 0.15, f"{mode}: {m}"
        assert 0.0 < m["xT_rel_l2"] < 0.30, f"{mode} xT: {m}"
    # deep (encoder + attention broadcast) drifts at least as far as plain reuse
    assert report["inv_deep_reuse_k2"]["rel_l2"] >= report["inv_encoder_reuse_k2"]["rel_l2"]
    for mode, _ in INVERSION_MODES:
        for key in ("rel_l2", "xT_rel_l2"):
            want = float(goldens[f"quality/report/{mode}/{key}"])
            assert abs(report[mode][key] - want) <= REPORT_ATOL, (mode, key, report[mode], want)


def test_stale_capture_drifts_further_than_k2(goldens, report):
    """One capture broadcast over every step (the stale-cache fault)."""
    stale, k2 = report["capture_reuse_stale"], report["capture_reuse_k2"]
    assert stale["rel_l2"] > k2["rel_l2"], (stale, k2)
    assert abs(stale["rel_l2"] - _jax_report(goldens, "capture_reuse_stale")["rel_l2"]) \
        <= REPORT_ATOL


def test_select_reuse_k_matches_jax():
    probes = ({5: 28.0, 3: 31.0, 2: 33.0}, {5: 35.0, 3: 38.0, 2: 41.0}, {5: 20.0, 3: 20.0, 2: 20.0})
    for scores in probes:
        for candidates in ((2, 3, 5), (5, 3, 2), (3,), (1, 2), ()):
            for thr in (19.0, 30.0, 34.0, 37.0, 40.0, 45.0):
                calls = {"port": [], "jax": []}
                out = {}
                for tag, fn in (("port", autoreuse.select_reuse_k),
                                ("jax", jautoreuse.select_reuse_k)):
                    out[tag] = fn(lambda k, tag=tag: calls[tag].append(k) or scores[k],
                                  candidates=candidates, threshold_db=thr)
                assert out["port"] == out["jax"] and calls["port"] == calls["jax"]


@pytest.fixture(scope="module")
def tiny_pipe():
    return tt.build_tiny_pipeline(device="cpu")


def test_auto_reuse_resolves_through_the_cli(tiny_pipe, tmp_path):
    """`encoder_reuse_interval: auto` with deep_reuse through cli.inverse.run:
    a threshold every candidate clears picks the largest (3, probed alone),
    one none clears falls back to k = 1 and turns deep reuse off; the store's
    meta records the k that ran."""
    root = str(tmp_path / "tree")
    paths = tt.write_demo_tree(root, HW, HW, F, STEPS)
    template = tcfg.merge(tcfg.load(os.path.join(ROOT, "configs", "group_inversion",
                                                 "template.yaml")), {"device": "cpu"})
    entries = tcfg.load_json_list(paths["inversion"])[:1]
    for thr, want_k, want_probed in ((-1000.0, 3, [3]), (1000.0, 1, [3, 2])):
        entry = dict(entries[0], force_recompute_latents=True)
        entry["inverse_config"] = dict(entry["inverse_config"], encoder_reuse_interval="auto",
                                       reuse_auto_candidates=[2, 3], reuse_auto_threshold_db=thr,
                                       reuse_auto_probe_steps=3, deep_reuse=True)
        entry["recon_config"] = {"enable_recon": False}
        (config,) = tinverse.configure(template, [entry])
        tinverse.run(tiny_pipe, [config])
        inv = config.inverse_config
        report = list(inv.reuse_auto_report)
        assert inv.encoder_reuse_interval == want_k
        assert [r["k"] for r in report] == want_probed
        assert all(np.isfinite(r["psnr_db"]) for r in report)
        assert inv.deep_reuse is (want_k > 1)
        store = TrajectoryStore(inv.output_dir)
        assert store.meta["encoder_reuse_interval"] == want_k
        assert np.isfinite(store.gather(store.timesteps)).all()
