"""The port's batch entry points and batch cores against the JAX package's,
and against the port's own single-entry runs:

* ddim_inversion_batch_core (J = 2 videos) and pnp_composite_batch_core
  (J = 2 entries, fused, two_pass=True and stream) against the JAX
  package's batch cores on the same inputs, through the goldens
  (scripts/torch_parity_goldens.py; the JAX side vmaps its single-entry
  scans, the port runs the entries on the UNet batch axis);
* batched equals sequential in the port: each entry of a J = 2 batch equals
  its single-entry run in fp32 on the CPU, within BATCH_REL; the entries'
  masks exchanged inside the batch move the result beyond it;
* the UNet runs once per step over all J entries (calls and their batch
  sizes counted);
* invert_batch and sample_composite_batch against invert and
  sample_composite on the tiny CPU pipeline;
* utils.profiling.device_op_breakdown on a synthetic Chrome trace with
  known kernels, launches and scopes, and on a CPU trace of one tiny UNet
  forward.

The CLIs' --batch is held against the JAX CLIs' in test_torch_cli.py.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mvoc_tpu_torch import pnp as tp
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models.convert import unet_state_dict_from_flax
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.ops.ddim import DDIM, SchedulerConfig
from mvoc_tpu_torch.pipeline import core
from mvoc_tpu_torch.utils import profiling
from mvoc_tpu_torch.utils import testing as tt
from torch_support import load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

F, HW, LAT = 2, 16, 8
J, N_OBJ, N_STEPS = 2, 2, 4  # 4-step schedule, t_idx 1 -> 3 composite steps
CORE_REL = 1e-3  # port vs JAX, fp32: max error <= CORE_REL * max|JAX| (as test_torch_pipeline)
BATCH_REL = 1e-4  # batched vs single-entry in the port, fp32 on the CPU (measured <= 2e-6)
PATHS = {"fused": False, "two_pass": True, "stream": "stream"}


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def unet(goldens):
    """The tiny UNet with the goldens' weights."""
    u = I2VGenXLUNet(UNetConfig.tiny())
    u.load_state_dict(unet_state_dict_from_flax(nest(goldens, "params")), strict=True)
    return u.eval()


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"max |err| {err:.3g} of max |ref| {np.abs(want).max():.3g}")
    return err / float(np.abs(want).max())


def _cond(goldens, prefix):
    return core.UNetConditioning(**{
        f.name: torch.from_numpy(goldens[f"{prefix}/{f.name}"])
        for f in dataclasses.fields(core.UNetConditioning)})


def _pyramid(goldens, name):
    prefix = f"composite_batch/{name}/"
    return {tuple(int(n) for n in k[len(prefix):].split("x")): torch.from_numpy(v)
            for k, v in goldens.items() if k.startswith(prefix)}


def _batch_inputs(goldens):
    """The batched composite's inputs as JAX's _prepare_composite built them,
    every one with its leading entry axis: (init, cond, sched, masks_soft,
    pyr_bin, pyr_soft)."""
    s = lambda name: goldens[f"composite_batch/sched/{name}"]  # noqa: E731
    sched = core.CompositeSchedule(**{
        f.name: torch.from_numpy(s(f.name)) if f.name.endswith(("traj", "lat")) else s(f.name)
        for f in dataclasses.fields(core.CompositeSchedule)})
    return (torch.from_numpy(goldens["composite_batch/init"]),
            _cond(goldens, "composite_batch/cond"), sched,
            torch.from_numpy(goldens["composite_batch/masks_soft"]),
            _pyramid(goldens, "pyr_bin"), _pyramid(goldens, "pyr_soft"))


class CountingUNet:
    """The UNet, recording the batch of every call."""

    def __init__(self, unet):
        self.unet, self.batches = unet, []

    def __call__(self, sample, *args, **kwargs):
        self.batches.append(sample.shape[0])
        return self.unet(sample, *args, **kwargs)


def _run_batch(unet, inputs, two_pass):
    init, cond, sched, ms, pb, ps = inputs
    return core.pnp_composite_batch_core(
        unet, DDIM(SchedulerConfig()), init, cond, sched, ms, pb, ps,
        capture_weights=tp.build_capture_weights(pb, ps, True) if two_pass == "stream" else None,
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=two_pass)


@pytest.fixture(scope="module")
def port_batches(goldens, unet):
    """Per path: the port's batched composite and its UNet calls' batches."""
    out = {}
    for name, two_pass in PATHS.items():
        counting = CountingUNet(unet)
        out[name] = (_run_batch(counting, _batch_inputs(goldens), two_pass).numpy(),
                     counting.batches)
    return out


def test_inversion_batch_core_matches_jax(goldens, unet):
    x0 = goldens["invert_batch/x0"]
    assert x0.shape[0] == J
    counting = CountingUNet(unet)
    got = core.ddim_inversion_batch_core(
        counting, DDIM(SchedulerConfig()), torch.from_numpy(x0),
        _cond(goldens, "invert_batch"), goldens["invert/timesteps"], 50)
    assert counting.batches == [J] * len(goldens["invert/timesteps"])
    assert _rel_err(got.numpy(), goldens["invert_batch/trajectory"]) <= CORE_REL
    # video 0 is the single-video case of test_torch_pipeline.py
    assert _rel_err(got[:, 0].numpy(), goldens["invert/trajectory"]) <= CORE_REL


@pytest.mark.parametrize("name", PATHS)
def test_composite_batch_core_matches_jax(goldens, port_batches, name):
    """Each path against JAX's batched composite of the same path (its vmap
    of pnp_composite_core); entry 0 is the single-entry case of
    test_torch_pipeline.py, so it also matches JAX's fused composite."""
    got = port_batches[name][0]
    assert got.shape == (J, F, LAT, LAT, 4)
    assert _rel_err(got, goldens[f"composite_batch/{name}_out"]) <= CORE_REL
    assert _rel_err(got[0], goldens["composite/fused_out"]) <= CORE_REL


@pytest.mark.parametrize("name", PATHS)
def test_unet_runs_once_per_step_over_all_entries(port_batches, name):
    """fused: one call of J*(N+3) branches a step; two_pass=True: a capture
    of J*(N+1) and a consume of J*2; stream: N+1 captures of J (branch b of
    every entry), then a consume of J*2.  No call per entry."""
    per_step = {"fused": [J * (N_OBJ + 3)], "two_pass": [J * (N_OBJ + 1), J * 2],
                "stream": [J] * (N_OBJ + 1) + [J * 2]}[name]
    assert port_batches[name][1] == per_step * (N_STEPS - 1)


def _entry(inputs, e):
    """Entry e of the batched inputs, as pnp_composite_core takes them."""
    init, cond, sched, ms, pb, ps = inputs
    one = dataclasses.replace(sched, **{f.name: getattr(sched, f.name)[e]
                                        for f in dataclasses.fields(sched)})
    return (init[e], cond.slice(e, e + 1).flatten_entries(), one, ms[e],
            {r: m[e] for r, m in pb.items()}, {r: m[e] for r, m in ps.items()})


@pytest.mark.parametrize("name", PATHS)
def test_batched_equals_sequential_and_sees_swapped_masks(goldens, unet, port_batches, name):
    """Each entry of the batch equals its own single-entry run within
    BATCH_REL of max |x|; with the two entries' masks exchanged inside the
    batch (pyramids, soft masks and, for stream, the capture weights built
    from them), each entry lands beyond it."""
    two_pass = PATHS[name]
    inputs = _batch_inputs(goldens)
    batched = port_batches[name][0]
    seq = []
    for e in range(J):
        init, cond, sched, ms, pb, ps = _entry(inputs, e)
        seq.append(core.pnp_composite_core(
            unet, DDIM(SchedulerConfig()), init, cond, sched, ms, pb, ps,
            num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
            two_pass=two_pass,
            capture_weights=tp.build_capture_weights(pb, ps, True) if two_pass == "stream"
            else None).numpy())
        assert _rel_err(batched[e], seq[e]) <= BATCH_REL, e
    init, cond, sched, ms, pb, ps = inputs
    swap = lambda pyr: {r: m.flip(0) for r, m in pyr.items()}  # noqa: E731
    swapped = _run_batch(unet, (init, cond, sched, ms.flip(0), swap(pb), swap(ps)),
                         two_pass).numpy()
    for e in range(J):
        assert _rel_err(swapped[e], seq[e]) > BATCH_REL, e


def test_batch_core_refuses_unequal_schedules(goldens):
    """The entries of a batch share timesteps, gates and fusion mask."""
    init, cond, sched, ms, pb, ps = _batch_inputs(goldens)
    for field in core.SHARED_SCHEDULE:
        v = np.array(getattr(sched, field))
        v[1, 0] = (not v[1, 0]) if v.dtype == bool else v[1, 0] + 1
        bad = dataclasses.replace(sched, **{field: v})
        with pytest.raises(ValueError, match=f"sched.{field} differs"):
            core.pnp_composite_batch_core(None, None, init, cond, bad, ms, pb, ps,
                                          num_inference_steps=N_STEPS, guidance_scale=3.0)


@pytest.fixture(scope="module")
def tiny_pipe():
    return tt.build_tiny_pipeline(device="cpu", natural=True)


def test_invert_batch_equals_invert(tiny_pipe, tmp_path):
    """Each video draws what invert(video, seed) draws, so the batch inverts
    what the sequential calls invert; one store per video, with invert's
    meta (cfg 1); with encoder reuse and deep reuse too, one cache over the
    batch."""
    videos = [tt.tiny_frames(seed=s) for s in (3, 4)]
    kw = dict(height=HW, width=HW, num_frames=F, num_inference_steps=N_STEPS, seed=7)
    dirs = [str(tmp_path / f"v{j}") for j in range(J)]
    ts, traj = tiny_pipe.invert_batch(videos, prompt="a boat", output_dirs=dirs, **kw)
    assert traj.shape == (N_STEPS, J, F, LAT, LAT, 4)
    for j, frames in enumerate(videos):
        ts1, one = tiny_pipe.invert(frames, prompt="a boat", output_dir=str(tmp_path / "s"),
                                    **kw)
        np.testing.assert_array_equal(ts, ts1)
        assert _rel_err(traj[:, j], one) <= BATCH_REL
        store = TrajectoryStore(dirs[j])
        # the store keeps fp16
        np.testing.assert_allclose(store.gather(store.timesteps), traj[:, j], rtol=2**-11,
                                   atol=2**-24)
        assert store.meta == TrajectoryStore(str(tmp_path / "s")).meta
    reuse = dict(kw, encoder_reuse_interval=2, deep_reuse=True)
    _, traj = tiny_pipe.invert_batch(videos, **reuse)
    for j, frames in enumerate(videos):
        one = tiny_pipe.invert(frames, **reuse)[1]
        assert _rel_err(traj[:, j], one) <= BATCH_REL
        assert np.abs(one - tiny_pipe.invert(frames, **kw)[1]).max() > 0.0


def test_sample_composite_batch_equals_sample_composite(tiny_pipe, tmp_path):
    """Two entries (other prompt, seed and masks) through the batch entry
    point, decoded, against sample_composite of each; latents without
    decode; and with deep capture reuse on the stream path (fusion on the
    first step only, so the two cached steps reach the result), each entry
    against its own sample_composite."""
    ts_inv = tiny_pipe.invert_batch([tt.tiny_frames(seed=s) for s in range(N_OBJ + 1)],
                                    height=HW, width=HW, num_frames=F,
                                    num_inference_steps=N_STEPS,
                                    output_dirs=[str(tmp_path / f"t{j}") for j in range(3)])[0]
    assert len(ts_inv) == N_STEPS
    stores = [TrajectoryStore(str(tmp_path / f"t{j}")) for j in range(3)]
    masks = np.zeros((N_OBJ, F, LAT, LAT), np.float32)
    masks[0, :, :4] = 1.0
    masks[1, :, :, :4] = 1.0
    frames = tt.tiny_frames(seed=5)
    entries = [dict(prompt=p, main_first_image=frames[0], main_image_list=frames,
                    background_image_list=tt.tiny_frames(seed=0),
                    objs_image_list=[tt.tiny_frames(seed=1), tt.tiny_frames(seed=2)],
                    masks_soft=m, masks_binary=m, bg_store=stores[0], obj_stores=stores[1:],
                    seed=s)
               for p, m, s in (("a cat", masks, 3), ("a dog", masks[::-1].copy(), 4))]
    shared = dict(height=HW, width=HW, num_frames=F, num_inference_steps=N_STEPS,
                  guidance_scale=3.0, two_pass="stream")
    videos = tiny_pipe.sample_composite_batch(entries, **shared)
    latents = tiny_pipe.sample_composite_batch(entries, decode=False, **shared)
    assert len(videos) == J and latents.shape == (J, F, LAT, LAT, 4)
    for e, entry in enumerate(entries):
        want = tiny_pipe.sample_composite(**entry, **shared)
        assert videos[e].shape == (F, HW, HW, 3)
        np.testing.assert_allclose(videos[e], want, rtol=0, atol=1e-5)
    reuse = dict(shared, fusion_steps=(0, 1), capture_reuse_interval=3, capture_reuse_deep=True,
                 decode=False)
    batched = tiny_pipe.sample_composite_batch(entries, **reuse)
    for e, entry in enumerate(entries):
        one = tiny_pipe.sample_composite(**entry, **reuse)
        assert _rel_err(batched[e].numpy(), one.numpy()) <= BATCH_REL
        exact = tiny_pipe.sample_composite(**entry, **dict(reuse, capture_reuse_interval=1,
                                                           capture_reuse_deep=False))
        assert (one - exact).abs().max() > 0.0


# -- device_op_breakdown ---------------------------------------------------------


def _event(cat, name, pid, tid, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, pid=pid, tid=tid, ts=ts, dur=dur, args=args)


def test_device_op_breakdown_synthetic_trace(tmp_path):
    """Known kernels, each booked by its correlation id to the innermost
    UNet scope around its launch on the launching thread: exact sums."""
    host, dev = 1, 0
    events = [
        dict(ph="M", name="process_name", pid=host, args=dict(name="python")),
        _event("user_annotation", "I2VGenXLUNet/conv_in", host, 1, 100, 100),
        _event("user_annotation", "I2VGenXLUNet/up_blocks.0", host, 1, 300, 200),
        _event("user_annotation", "I2VGenXLUNet/up_blocks.0/inner", host, 1, 320, 100),
        _event("user_annotation", "not a unet scope", host, 1, 340, 10),
        _event("cpu_op", "aten::conv2d", host, 1, 120, 50),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 150, 5, correlation=1),
        _event("cuda_runtime", "cudaMemcpyAsync", host, 1, 160, 5, correlation=4),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 345, 5, correlation=2),
        _event("cuda_driver", "cuLaunchKernel", host, 1, 450, 5, correlation=5),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 600, 5, correlation=3),
        _event("cuda_runtime", "cudaLaunchKernel", host, 2, 350, 5, correlation=6),
        _event("kernel", "cudnn::fprop_implicit_gemm", dev, 7, 1000, 20, correlation=1),
        _event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", dev, 7, 1020, 3, correlation=4),
        _event("kernel", "flash_wgmma_d64<64>", dev, 7, 1030, 30, correlation=2),
        _event("kernel", "flash_wgmma_d64<64>", dev, 7, 1060, 10, correlation=5),
        _event("kernel", "vectorized_elementwise_kernel", dev, 7, 1070, 7, correlation=3),
        _event("kernel", "some_kernel", dev, 7, 1080, 5, correlation=99),
        _event("kernel", "frame_mma_kernel", dev, 7, 1090, 4, correlation=6),
    ]
    (tmp_path / "run").mkdir()
    with open(tmp_path / "run" / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    out = profiling.device_op_breakdown(str(tmp_path), top=2)
    assert out["trace"] == str(tmp_path / "run" / "trace.json")
    us = 1e-6
    approx = lambda d: {k: pytest.approx(v * us, rel=1e-12) for k, v in d.items()}  # noqa: E731
    assert out["by_category"] == approx({"K1 flash attention": 40, "convolution": 20,
                                         "elementwise": 7, "K2 frame attention": 4,
                                         "other": 8})  # memcpy is not "copy"
    assert out["by_module"] == approx({"up_blocks.0": 40, "conv_in": 23,
                                       "(outside unet)": 16})
    assert out["by_module_category"]["conv_in"] == approx({"convolution": 20, "other": 3})
    assert out["top_ops"] == approx({"flash_wgmma_d64<64>": 40,
                                     "cudnn::fprop_implicit_gemm": 20})
    assert out["total_s"] == pytest.approx(79 * us, rel=1e-12)
    for key in ("by_category", "by_module"):
        assert sum(out[key].values()) == pytest.approx(out["total_s"], rel=1e-12)
    assert list(out["by_module"]) == ["up_blocks.0", "conv_in", "(outside unet)"]


def test_device_op_breakdown_cpu_trace_of_a_unet_forward(unet, tmp_path):
    """A CPU trace (no device lane): the host's ops by self time; every
    top-level child of the UNet appears, and each table sums to total_s."""
    rng = np.random.default_rng(0)
    x = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in (
        ("sample", (1, F, LAT, LAT, 4)), ("image_latents_first", (1, F, LAT, LAT, 4)),
        ("image_latents", (1, F, LAT, LAT, 4)), ("image_embeddings", (1, F, 16)),
        ("encoder_hidden_states", (1, 7, 16)))}
    with profiling.trace(str(tmp_path)), torch.no_grad():
        unet(x.pop("sample"), 981, fps=torch.tensor([8]), **x)
    out = profiling.device_op_breakdown(str(tmp_path))
    children = set()
    for name, child in unet.named_children():
        if isinstance(child, torch.nn.ModuleList) and name in ("down_blocks", "up_blocks"):
            children |= {f"{name}.{i}" for i in range(len(child))}
        else:
            children.add(name)
    assert children <= set(out["by_module"]), children - set(out["by_module"])
    assert set(out["by_module"]) <= children | {profiling.OUTSIDE}
    assert out["total_s"] > 0
    for key in ("by_category", "by_module"):
        assert sum(out[key].values()) == pytest.approx(out["total_s"], rel=1e-9)
    assert sum(sum(v.values()) for v in out["by_module_category"].values()) == pytest.approx(
        out["total_s"], rel=1e-9)
