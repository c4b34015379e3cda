"""The port's CLIs (mvoc_tpu_torch.cli) against the JAX package's:

* argument parity: both `main`s, each with a recording stub pipeline, on
  the same demo tree and group JSONs; every argument reaching `invert`,
  `sample` and `sample_composite` is equal (images as arrays, masks,
  trajectory contents, every static knob), and so are the files written
  (the parameter-encoded export directory name, run configs, recon
  metrics).  JAX draws noise from jax.random, which torch cannot
  reproduce, so the CLIs are compared on what they hand the pipeline;
* the port's CLIs end to end on the tiny CPU pipeline (`device: cpu`);
* every refusal of a mode that is not ported names its ROADMAP.md item
  (the reuse and broadcast modes and `encoder_reuse_interval: auto` now
  run: on the tiny pipeline against its exact runs, and auto through both
  CLIs on the recording stub);
  a missing checkpoint, an unknown quantize mode and a template without a
  CPU device on a machine without CUDA raise as the JAX CLI does (or, for
  the device, as the port's entry points do);
* what used to be refused and is ported now: two_pass=True, the template's
  enable_vae_tiling (argument parity with the JAX CLI), a checkpoint
  directory (the pipeline both CLIs build from the tiny checkpoint),
  --mesh_seq / --mesh_job without a mesh size (passed through, as in JAX),
  and --batch / batch_inversions / batch_composites (argument parity with
  the JAX CLIs through invert_batch and sample_composite_batch);
* the device mesh: both CLIs under torchrun on two gloo ranks against the
  single-process CLIs, and --mesh without a launcher refused, naming
  torchrun.
"""

import argparse
import copy
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from mvoc_tpu import config as jcfg
from mvoc_tpu.cli import common as jcommon
from mvoc_tpu.cli import composite as jcomposite
from mvoc_tpu.cli import inverse as jinverse
from mvoc_tpu_torch import config as tcfg
from mvoc_tpu_torch.cli import common as tcommon
from mvoc_tpu_torch.cli import composite as tcomposite
from mvoc_tpu_torch.cli import inverse as tinverse
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models.unet_i2vgen import UNetConfig
from mvoc_tpu_torch.ops.ddim import SchedulerConfig, inversion_timesteps
from mvoc_tpu_torch.utils import testing as tt
from torch_support import ROOT, load_goldens, write_tiny_checkpoint
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

HW, F, STEPS = 16, 2, 4  # the tiny pipeline: 16 x 16 px, VAE x2 -> 8 x 8 latents
OUTPUTS = ("inversions", "Results")


class RecordingPipeline:
    """Stands in for a pipeline: records every call, writes deterministic
    trajectories, returns deterministic videos."""

    vae_scale_factor = 2
    scheduler_config = SchedulerConfig()

    def __init__(self):
        self.calls = []

    def invert(self, frames, **kw):
        self.calls.append(("invert", frames, kw))
        ts = inversion_timesteps(self.scheduler_config, kw["num_inference_steps"])
        rng = np.random.default_rng(len(self.calls))
        h, w = kw["height"] // 2, kw["width"] // 2
        traj = rng.standard_normal((len(ts), kw["num_frames"], h, w, 4)).astype(np.float32)
        meta = {k: kw[k] for k in ("prompt", "seed", "height", "width")}
        meta.update(n_steps=kw["num_inference_steps"], num_frames=kw["num_frames"])
        if kw.get("output_dir") is not None:  # the auto-reuse probes keep theirs
            TrajectoryStore(kw["output_dir"], prefer_native=False).save(ts, traj, meta=meta)
        return ts, traj

    def encode_vae_video(self, frames, height, width, **kw):  # the auto-reuse probe's latents
        return np.zeros((len(frames), height // 2, width // 2, 4), np.float32)

    def _generator(self, seed):
        return seed

    def _video(self, kw):
        n = kw["num_frames"] * kw["height"] * kw["width"] * 3
        return np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(
            kw["num_frames"], kw["height"], kw["width"], 3)

    def sample(self, image, **kw):
        self.calls.append(("sample", image, kw))
        return self._video(kw)

    def sample_composite(self, **kw):
        self.calls.append(("sample_composite", None, kw))
        return self._video(kw)

    def invert_batch(self, videos, **kw):
        self.calls.append(("invert_batch", videos, kw))
        ts = inversion_timesteps(self.scheduler_config, kw["num_inference_steps"])
        rng = np.random.default_rng(len(self.calls))
        h, w = kw["height"] // 2, kw["width"] // 2
        traj = rng.standard_normal((len(ts), len(videos), kw["num_frames"], h, w, 4)).astype(
            np.float32)
        meta = {k: kw[k] for k in ("prompt", "seed", "height", "width")}
        meta.update(n_steps=kw["num_inference_steps"], num_frames=kw["num_frames"])
        for j, out_dir in enumerate(kw["output_dirs"]):
            TrajectoryStore(out_dir, prefer_native=False).save(ts, traj[:, j], meta=meta)
        return ts, traj

    def sample_composite_batch(self, entries, **kw):
        self.calls.append(("sample_composite_batch", entries, kw))
        return [self._video(kw) for _ in entries]


def _norm(v):
    """A comparable form of a recorded argument."""
    if isinstance(v, Image.Image):
        return ("image", v.size, np.asarray(v).tobytes())
    if hasattr(v, "gather") and hasattr(v, "path"):  # a trajectory store of either package
        ts = np.asarray(v.timesteps)
        return ("store", v.path, ts.tolist(), v.gather(ts).tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_norm(x) for x in v])
    if isinstance(v, dict):
        return ("dict", sorted((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return ("array", str(a.dtype), a.shape, a.tobytes())


def _recorded(calls):
    return [(name, _norm(first), {k: _norm(v) for k, v in kw.items()})
            for name, first, kw in calls]


def _files(root):
    out = {}
    for kind in OUTPUTS:
        for dirpath, _, names in os.walk(os.path.join(root, kind)):
            for n in names:
                p = os.path.join(dirpath, n)
                rel = os.path.relpath(p, root)
                if n.endswith((".txt", ".yaml", ".json")):
                    with open(p) as f:
                        out[rel] = f.read()
                else:
                    out[rel] = os.path.getsize(p) > 0
    return out


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo"))
    return root, tt.write_demo_tree(root, HW, HW, F, STEPS)


def _template_args(kind, configs_json):
    return ["--template_config", os.path.join(ROOT, "configs", f"group_{kind}", "template.yaml"),
            "--configs_json", configs_json]


def _run_jax(monkeypatch, demo, kinds=("inversion", "composite"), argv=None):
    root, paths = demo
    pipe = RecordingPipeline()
    monkeypatch.setattr(jcommon, "build_pipeline", lambda args, t: pipe)
    monkeypatch.setattr(jcommon, "apply_unet_options", lambda p, t: p)
    for kind in kinds:
        monkeypatch.setattr(sys, "argv", ["prog"] + (argv or _template_args(kind, paths[kind])))
        {"inversion": jinverse, "composite": jcomposite}[kind].main()
    return pipe


def _run_port(monkeypatch, demo, kinds=("inversion", "composite"), argv=None):
    root, paths = demo
    pipe = RecordingPipeline()
    monkeypatch.setattr(tcommon, "build_pipeline", lambda args, t: pipe)
    monkeypatch.setattr(tcommon, "apply_unet_options", lambda p, t: p)
    for kind in kinds:
        {"inversion": tinverse, "composite": tcomposite}[kind].main(
            argv or _template_args(kind, paths[kind]))
    return pipe


def _clear(root):
    for kind in OUTPUTS:
        shutil.rmtree(os.path.join(root, kind), ignore_errors=True)


def test_cli_argument_parity_with_jax(demo, monkeypatch):
    root = demo[0]
    _clear(root)
    jpipe = _run_jax(monkeypatch, demo)
    jfiles = _files(root)
    _clear(root)
    tpipe = _run_port(monkeypatch, demo)
    tfiles = _files(root)
    assert [c[0] for c in tpipe.calls] == ["invert", "sample", "invert", "invert",
                                          "sample_composite"]
    got, want = _recorded(tpipe.calls), _recorded(jpipe.calls)
    for (name, g_first, g_kw), (_, w_first, w_kw) in zip(got, want):
        assert g_first == w_first, name
        assert sorted(g_kw) == sorted(w_kw), name
        for k in w_kw:
            assert g_kw[k] == w_kw[k], (name, k)
    assert got == want
    # the files written, by name (the parameter-encoded export directory
    # included) and, for text, by content
    assert tfiles == jfiles
    export = [p for p in tfiles if p.startswith("Results") and p.endswith("video.gif")]
    assert export == [os.path.join(
        "Results", "demo", "i2vgen-xl", "bg", "boat and surfer",
        "ddim_init_latents_t_idx_1_nsteps_4_cfg_9.0_pnpf0.2_pnps0.2_pnpt0.5_ratio0.8"
        "noise_fusion_step0-1", "video.gif")]
    assert sum(p.endswith(".png") for p in tfiles) == F
    assert any(p.endswith("recon_metrics.txt") for p in tfiles)


def test_cli_inversion_modes_parity_with_jax(tmp_path, monkeypatch):
    """The inversion CLI's other inputs, argument for argument: a null first
    image, a static video, a video given as an mp4 (decoded with OpenCV and
    saved as frames), and an inactive entry."""
    import json

    import cv2

    root = str(tmp_path / "tree")
    paths = tt.write_demo_tree(root, HW, HW, F, STEPS)
    with open(paths["inversion"]) as f:
        entries = json.load(f)
    entries[1]["inverse_config"]["null_image_inversion"] = True
    entries[2]["inverse_config"]["inverse_static_video"] = True
    writer = cv2.VideoWriter(os.path.join(root, "demo", "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 8, (HW, HW))
    for i in range(F + 1):
        writer.write(np.asarray(Image.open(os.path.join(root, "demo", "bg", "00000.png")))
                     [:, ::-1] // (i + 1))
    writer.release()
    entries += [dict(entries[0], video_name="clip", recon_config={"enable_recon": False}),
                dict(entries[0], video_name="off", active=False)]
    with open(paths["inversion"], "w") as f:
        json.dump(entries, f)
    calls = {}
    for tag, run in (("jax", _run_jax), ("port", _run_port)):
        _clear(root)
        shutil.rmtree(os.path.join(root, "demo", "clip"), ignore_errors=True)
        calls[tag] = _recorded(run(monkeypatch, (root, paths), kinds=("inversion",)).calls)
    assert [c[0] for c in calls["port"]] == ["invert", "sample", "invert", "invert", "invert"]
    assert calls["port"] == calls["jax"]
    assert sorted(os.listdir(os.path.join(root, "demo", "clip"))) == [
        f"{i:05d}.png" for i in range(F + 1)]


def test_cli_cached_inversion_is_skipped_alike(demo, monkeypatch):
    """With the stores of a first run on disk and matching meta, both CLIs
    skip the inversions (only the reconstruction and the composite run);
    after a seed change both recompute."""
    root, paths = demo
    _clear(root)
    _run_port(monkeypatch, demo)
    calls = {}
    for tag, run in (("port", _run_port), ("jax", _run_jax)):
        calls[tag] = [c[0] for c in run(monkeypatch, demo).calls]
    assert calls["port"] == calls["jax"] == ["sample", "sample_composite"]
    template = os.path.join(ROOT, "configs", "group_inversion", "template.yaml")
    for mod, cfg in ((tinverse, tcfg), (jinverse, jcfg)):
        config = cfg.merge(cfg.load(template), cfg.load_json_list(paths["inversion"])[0])
        assert mod._has_valid_cache(config), mod.__name__
        assert not mod._has_valid_cache(cfg.merge(config, {"seed": 7})), mod.__name__


def test_cli_end_to_end_on_the_tiny_cpu_pipeline(tmp_path):
    root = str(tmp_path / "tree")
    paths = tt.write_demo_tree(root, HW, HW, F, STEPS)
    args = {}
    for kind in ("inversion", "composite"):
        template = tcfg.merge(tcfg.load(os.path.join(
            ROOT, "configs", f"group_{kind}", "template.yaml")), {"device": "cpu"})
        args[kind] = str(tmp_path / f"{kind}.yaml")
        with open(args[kind], "w") as f:
            f.write(tcfg.to_yaml(template))
    for kind, mod in (("inversion", tinverse), ("composite", tcomposite)):
        mod.main(["--template_config", args[kind], "--configs_json", paths[kind],
                  "--checkpoint", "tiny"])
    for name in tt.DEMO_VIDEOS:
        store = TrajectoryStore(os.path.join(root, "inversions", "i2vgen-xl", name,
                                             "ddim_latents"))
        assert store.gather(store.timesteps).shape == (STEPS, F, HW // 2, HW // 2, 4)
        assert store.meta["n_steps"] == STEPS
    bg = os.path.join(root, "inversions", "i2vgen-xl", "bg")
    for n in ("ddim_reconstruction.mp4", "ddim_reconstruction.gif", "recon_metrics.txt",
              "run_config.yaml"):
        assert os.path.getsize(os.path.join(bg, n)) > 0, n
    with open(os.path.join(bg, "recon_metrics.txt")) as f:
        scores = dict(line.split("=") for line in f.read().split())
    assert np.isfinite(float(scores["psnr_db"])) and np.isfinite(float(scores["ssim"]))
    (config,) = tcomposite.configure(tcfg.load(args["composite"]),
                                     tcfg.load_json_list(paths["composite"]))
    out = tcomposite.export_dir(config)
    frames = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert frames == [f"video_{i:05d}.png" for i in range(F)]
    assert Image.open(os.path.join(out, frames[0])).size == (HW, HW)
    for n in ("video.mp4", "video.gif"):
        assert os.path.getsize(os.path.join(out, n)) > 0


# -- refusals and errors --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipe():
    return tt.build_tiny_pipeline(device="cpu")


@pytest.mark.parametrize("kw", [{"encoder_reuse_interval": 2}, {"encoder_reuse_depth": 1},
                                {"deep_reuse": True}])
def test_invert_runs_reuse_modes(tiny_pipe, kw):
    """Each inversion keyword of the JAX package runs: encoder_reuse_depth and
    deep_reuse alone leave the exact inversion bitwise (they act only with an
    interval > 1, as in JAX), and each moves the k = 2 run; k = 2 itself
    leaves the exact trajectory, finite, without running away from it."""
    common = dict(height=HW, width=HW, num_frames=F, num_inference_steps=STEPS)
    frames = tt.tiny_frames()
    exact = tiny_pipe.invert(frames, **common)[1]
    reuse = tiny_pipe.invert(frames, encoder_reuse_interval=2, **common)[1]
    got = tiny_pipe.invert(frames, **common, **kw)[1]
    assert np.isfinite(got).all()
    if "encoder_reuse_interval" in kw:
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert 0.0 < rel < 0.5, rel
        return
    np.testing.assert_array_equal(got, exact)
    moved = tiny_pipe.invert(frames, encoder_reuse_interval=2, **common, **kw)[1]
    assert np.isfinite(moved).all() and np.abs(moved - reuse).max() > 0.0


def _composite_inputs(root):
    """Seeded trajectory stores (bg, 2 objects), frames and masks for a
    tiny composite."""
    ts = inversion_timesteps(SchedulerConfig(), STEPS)
    rng = np.random.default_rng(4)
    stores = []
    for j in range(3):
        d = os.path.join(root, f"traj{j}")
        TrajectoryStore(d, prefer_native=False).save(
            ts, rng.standard_normal((len(ts), F, HW // 2, HW // 2, 4)).astype(np.float32))
        stores.append(TrajectoryStore(d))
    masks = np.zeros((2, F, HW // 2, HW // 2), np.float32)
    masks[0, :, :4] = 1.0
    masks[1, :, :, :4] = 1.0
    frames = tt.tiny_frames(seed=5)
    return ("a cat", frames[0], frames, tt.tiny_frames(seed=0),
            [tt.tiny_frames(seed=1), tt.tiny_frames(seed=2)], masks, masks, stores[0], stores[1:])


@pytest.mark.parametrize("kw", [
    {"encoder_reuse_interval": 3}, {"encoder_reuse_depth": 2}, {"pab_interval": 2},
    {"capture_reuse_interval": 2, "two_pass": True}, {"capture_reuse_deep": True},
    {"two_pass": True}])
def test_sample_composite_runs_reuse_modes(tiny_pipe, tmp_path, kw):
    """The reuse and broadcast modes run (fusion on the first step only, so
    the cached steps reach the result): each interval > 1 moves the
    composite off its path's exact run, finite; encoder_reuse_depth alone is
    bitwise exact and moves the k = 2 run; capture_reuse_deep alone is
    refused as JAX asserts, and deepens stream capture reuse;
    two_pass=True runs the fused path's function."""
    args = _composite_inputs(str(tmp_path))
    common = dict(height=HW, width=HW, num_frames=F, num_inference_steps=STEPS,
                  guidance_scale=3.0, fusion_steps=(0, 1), decode=False)
    two_pass = kw.get("two_pass", False)
    exact = tiny_pipe.sample_composite(*args, **dict(common, two_pass=two_pass))
    if kw == {"two_pass": True}:
        fused = tiny_pipe.sample_composite(*args, **common, two_pass=False)
        assert torch.isfinite(exact).all()
        assert (exact - fused).abs().max() <= 1e-5 * fused.abs().max()
        return
    if kw == {"capture_reuse_deep": True}:
        with pytest.raises(ValueError, match="capture_reuse_deep extends capture reuse"):
            tiny_pipe.sample_composite(*args, **common, two_pass="stream", **kw)
        # conv injection off: it replaces the edit pair's features wholesale
        # with the captured ones (inject_background), which would hide the
        # edit pair's own (deep-reused) encoder
        shallow, deep = (tiny_pipe.sample_composite(
            *args, **common, two_pass="stream", capture_reuse_interval=2, capture_reuse_deep=d,
            pnp_f_t=0.0) for d in (False, True))
        assert torch.isfinite(deep).all() and (deep - shallow).abs().max() > 0.0
        return
    got = tiny_pipe.sample_composite(*args, **dict(common, **kw))
    assert torch.isfinite(got).all()
    if kw == {"encoder_reuse_depth": 2}:
        assert torch.equal(got, exact)
        k2 = tiny_pipe.sample_composite(*args, **common, encoder_reuse_interval=2)
        k2_depth = tiny_pipe.sample_composite(*args, **common, encoder_reuse_interval=2, **kw)
        assert (k2_depth - k2).abs().max() > 0.0
        return
    rel = ((got - exact).norm() / exact.norm()).item()
    assert 0.0 < rel < 1.0, rel


class TilingRecorder(RecordingPipeline):
    def enable_vae_tiling(self, *args, **kw):
        self.calls.append(("enable_vae_tiling", None, dict(args=args, **kw)))


def test_vae_tiling_refused(demo, tiny_pipe, tmp_path, monkeypatch):
    """The template's enable_vae_tiling: both composite CLIs turn tiling on
    with the same arguments before the same sample_composite call, and
    write the same files; the port's pipeline then decodes through
    tiled_decode (64-latent tiles, 8 of overlap, as in JAX)."""
    root, paths = demo
    template = tmp_path / "tiling.yaml"
    with open(os.path.join(ROOT, "configs", "group_composite", "template.yaml")) as f:
        template.write_text(f.read() + "\nenable_vae_tiling: true\n")
    argv = ["--template_config", str(template), "--configs_json", paths["composite"]]
    recorded = {}
    for name, mod, cli in (("jax", jcommon, jcomposite), ("port", tcommon, tcomposite)):
        _clear(root)
        (_run_jax if name == "jax" else _run_port)(monkeypatch, demo, kinds=("inversion",))
        pipe = TilingRecorder()
        monkeypatch.setattr(mod, "build_pipeline", lambda args, t, pipe=pipe: pipe)
        monkeypatch.setattr(mod, "apply_unet_options", lambda p, t: p)
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["prog"] + argv)
            cli.main()
        else:
            cli.main(argv)
        recorded[name] = (_recorded(pipe.calls), _files(root))
    assert [c[0] for c in recorded["port"][0]] == ["enable_vae_tiling", "sample_composite"]
    assert recorded["port"] == recorded["jax"]
    pipe = copy.copy(tiny_pipe)
    pipe.enable_vae_tiling()
    assert pipe.vae_tiling == (64, 8)
    pipe.disable_vae_tiling()
    assert pipe.vae_tiling is None


def _args(**kw):
    base = dict(template_config=None, configs_json=None, checkpoint=None, dtype="bfloat16",
                profile_dir=None, mesh=None, batch=False, mesh_seq=None, mesh_job=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("args,template", [
    ({"mesh": "2"}, {}), ({"mesh": "auto"}, {}), ({}, {"mesh_devices": 4}),
    ({"mesh_seq": 2}, {}), ({"mesh_job": 2}, {})])
def test_mesh_refused(args, template, monkeypatch):
    """Without a launcher a mesh size is refused, naming the torchrun command
    (the port runs one process per rank; test_cli_under_a_launcher runs
    one); --mesh_seq / --mesh_job alone leave the pipeline as it is, as the
    JAX CLI's apply_mesh does."""
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tcommon.apply_mesh("pipe", _args(), tcfg.create({})) == "pipe"
    if "mesh" not in args and "mesh_devices" not in template:
        assert jcommon.apply_mesh("pipe", _args(**args), jcfg.create(template)) == "pipe"
        assert tcommon.apply_mesh("pipe", _args(**args), tcfg.create(template)) == "pipe"
        return
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
        tcommon.apply_mesh("pipe", _args(**args), tcfg.create(template))


def _cpu_templates(tmp_path, **extra):
    out = {}
    for kind in ("inversion", "composite"):
        template = tcfg.merge(tcfg.load(os.path.join(
            ROOT, "configs", f"group_{kind}", "template.yaml")), dict(device="cpu", **extra))
        out[kind] = str(tmp_path / f"{kind}.yaml")
        with open(out[kind], "w") as f:
            f.write(tcfg.to_yaml(template))
    return out


def test_cli_under_a_launcher(tmp_path, monkeypatch):
    """Both CLIs under `python -m torch.distributed.run --nproc_per_node 2`
    with --mesh 2 (gloo, `device: cpu`; 2 frames over seq = 2), and with
    --mesh 1 (rank 0 alone on the mesh, rank 1 leaves), write what the
    single-process CLIs write: rank 0 alone saves (one log line per
    trajectory and per video), the trajectories equal the single-process
    ones within 1e-5 of max |x| plus the store's fp16 rounding (one fp16
    step of the value), and the same files exist.  Without a
    launcher --mesh 2 raises, naming torchrun; a template quantizing
    after a mesh raises as the JAX CLI does (apply_mesh runs before
    apply_quantize, and enable_int8 refuses a mesh)."""
    import socket
    import subprocess

    templates = _cpu_templates(tmp_path)
    roots = {}
    for run, mesh_arg in (("single", None), ("mesh", "2"), ("mesh1", "1")):
        roots[run] = str(tmp_path / run)
        paths = tt.write_demo_tree(roots[run], HW, HW, F, STEPS)
        for kind, mod in (("inversion", tinverse), ("composite", tcomposite)):
            argv = ["--template_config", templates[kind], "--configs_json", paths[kind],
                    "--checkpoint", "tiny"]
            if run == "single":
                mod.main(argv)
                continue
            if run == "mesh":
                with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
                    mod.main(argv + ["--mesh", "2"])
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                 "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
                 f"mvoc_tpu_torch.cli.{mod.__name__.rsplit('.', 1)[1]}"] + argv
                + ["--mesh", mesh_arg],
                env=env, capture_output=True, text=True, timeout=300)
            log = proc.stdout + proc.stderr
            assert proc.returncode == 0, log[-4000:]
            if run == "mesh1":
                assert log.count("rank outside the 1-rank mesh") == 1, log[-4000:]
            if kind == "inversion":
                assert log.count("saved trajectory") == len(tt.DEMO_VIDEOS), log[-4000:]
                assert log.count("saved reconstruction") == 1
            else:
                assert log.count("saved composite video") == 1, log[-4000:]
    for run in ("mesh", "mesh1"):
        for name in tt.DEMO_VIDEOS:
            stores = [TrajectoryStore(os.path.join(roots[r], "inversions", "i2vgen-xl", name,
                                                   "ddim_latents")) for r in ("single", run)]
            one, mesh = (st.gather(st.timesteps) for st in stores)
            np.testing.assert_allclose(mesh, one, rtol=2**-10, atol=1e-5 * np.abs(one).max())
        assert sorted(_files(roots[run])) == sorted(_files(roots["single"])), run
    pipe = tt.build_tiny_pipeline(device="cpu")
    pipe.mesh = tcommon.pm.Mesh(seq=2)  # as enable_mesh leaves it on a 2-rank mesh
    with pytest.raises(NotImplementedError, match="call enable_int8 BEFORE enable_mesh"):
        tcommon.apply_quantize(pipe, tcfg.create({"quantize": "int8"}))


@pytest.mark.parametrize("kind,key", [("inversion", "batch_inversions"),
                                      ("composite", "batch_composites")])
def test_batch_refused(tmp_path, monkeypatch, kind, key):
    """--batch and the template's batch_* key (refused until the batch entry
    points were ported) now batch as the JAX CLIs do, argument for argument
    on the recording stub: the inversion CLI inverts the three uncached
    videos in one invert_batch call, then the per-entry pass finds their
    stores and runs only bg's reconstruction; the composite CLI groups
    entries by the JAX key, so two entries that differ in prompt, seed and
    target_fps share one sample_composite_batch call at the first entry's
    fps (the JAX quirk the port copies), and an entry with other steps
    runs alone.  The files written match too."""
    import json

    root = str(tmp_path / "tree")
    paths = tt.write_demo_tree(root, HW, HW, F, STEPS)
    demo = (root, paths)
    with open(paths["composite"]) as f:
        (entry,) = json.load(f)
    entries = [entry,
               dict(entry, editing_prompt="a blue boat", seed=9, target_fps=12,
                    edited_video_name="blue boat"),
               dict(entry, n_steps=STEPS - 1, edited_video_name="fewer steps")]
    with open(paths["composite"], "w") as f:
        json.dump(entries, f)
    template = os.path.join(ROOT, "configs", f"group_{kind}", "template.yaml")
    keyed = tmp_path / "keyed.yaml"
    with open(template) as f:
        keyed.write_text(f.read() + f"\n{key}: true\n")
    want_calls = {"inversion": ["invert_batch", "sample"],
                  "composite": ["sample_composite_batch", "sample_composite"]}[kind]
    for argv in (_template_args(kind, paths[kind]) + ["--batch"],
                 ["--template_config", str(keyed), "--configs_json", paths[kind]]):
        recorded = {}
        for name, run in (("jax", _run_jax), ("port", _run_port)):
            _clear(root)
            if kind == "composite":  # the trajectories the composites read
                run(monkeypatch, demo, kinds=("inversion",))
            pipe = run(monkeypatch, demo, kinds=(kind,), argv=argv)
            recorded[name] = (_recorded(pipe.calls), _files(root))
        assert [c[0] for c in recorded["port"][0]] == want_calls
        assert recorded["port"] == recorded["jax"]
    first, batch = recorded["port"][0][0][1], recorded["port"][0][0][2]
    if kind == "inversion":
        assert len(first[1]) == 3 and len(batch["output_dirs"][1]) == 3
    else:
        assert [e[1][[k for k, _ in e[1]].index("seed")][1] for e in first[1]] == [6, 9]
        assert batch["target_fps"] == 8  # the first entry's, the second asked for 12
        assert sum(p.endswith("video.gif") for p in recorded["port"][1]) == 3


def test_auto_reuse_runs_as_in_jax(tmp_path, monkeypatch):
    """`encoder_reuse_interval: auto` (with deep_reuse and its knobs): both
    inversion CLIs probe the entry's video with the same invert / sample
    calls on the recording stub, resolve the same k (the largest candidate
    whose probe clears the threshold), run the entry's inversion with it,
    and write the same files; the cached entries skip the probe."""
    import json

    root = str(tmp_path / "tree")
    paths = tt.write_demo_tree(root, HW, HW, F, STEPS)
    with open(paths["inversion"]) as f:
        entries = json.load(f)
    entries[0]["inverse_config"].update(encoder_reuse_interval="auto", deep_reuse=True,
                                        reuse_auto_candidates=[2, 3],
                                        reuse_auto_threshold_db=-1000.0,
                                        reuse_auto_probe_steps=3)
    with open(paths["inversion"], "w") as f:
        json.dump(entries, f)
    recorded = {}
    for name, run in (("jax", _run_jax), ("port", _run_port)):
        _clear(root)
        pipe = run(monkeypatch, (root, paths), kinds=("inversion",))
        recorded[name] = (_recorded(pipe.calls), _files(root))
    calls = recorded["port"][0]
    assert [c[0] for c in calls] == ["invert", "sample", "invert", "sample", "invert", "invert"]
    probe_invert, _, entry_invert = calls[:3]
    assert probe_invert[2]["encoder_reuse_interval"] == 3
    assert probe_invert[2]["num_inference_steps"] == 3
    assert entry_invert[2]["encoder_reuse_interval"] == 3 and entry_invert[2]["deep_reuse"]
    assert recorded["port"] == recorded["jax"]


def _dtype_name(dtype) -> str:
    """torch.float32 / jnp.float32 -> "float32"."""
    return str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name


def test_checkpoint_errors(tmp_path, monkeypatch):
    """A missing checkpoint raises as in JAX; a checkpoint directory (the
    tiny one) reaches `I2VGenXLPipeline.from_pretrained` from both CLIs'
    build_pipeline with the same directory and --dtype, and the port's
    builds the pipeline on the template's device in that dtype, with the
    checkpoint's tokenizer (the ids of transformers.CLIPTokenizer, which
    the JAX loader uses).  Loader parity, tensor for tensor:
    tests/test_torch_convert.py."""
    from mvoc_tpu.pipeline.i2vgen import I2VGenXLPipeline as JPipe
    from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline as TPipe

    template = tcfg.create({"device": "cpu"})
    missing = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError) as te:
        tcommon.build_pipeline(_args(checkpoint=missing), template)
    with pytest.raises(FileNotFoundError) as je:
        jcommon.build_pipeline(_args(checkpoint=missing), jcfg.create({"device": "cpu"}))
    assert str(te.value) == str(je.value)
    ckpt = str(tmp_path / "ckpt")
    write_tiny_checkpoint(ckpt, load_goldens())
    calls = {}
    for name, cls, cfg in (("jax", JPipe, jcfg), ("port", TPipe, tcfg)):
        for dtype in ("float32", "bfloat16"):
            with monkeypatch.context() as m:
                m.setattr(cls, "from_pretrained", staticmethod(
                    lambda d, dtype, **kw: (os.path.abspath(d), _dtype_name(dtype))))
                build = jcommon.build_pipeline if name == "jax" else tcommon.build_pipeline
                calls[name, dtype] = build(_args(checkpoint=ckpt, dtype=dtype),
                                           cfg.create({"device": "cpu"}))
            assert calls[name, dtype] == (ckpt, dtype)
    tpipe = tcommon.build_pipeline(_args(checkpoint=ckpt, dtype="float32"), template)
    assert tpipe.device == torch.device("cpu") and tpipe.dtype == torch.float32
    assert tpipe.unet.dtype == torch.float32
    hf = pytest.importorskip("transformers").CLIPTokenizer.from_pretrained(
        os.path.join(ckpt, "tokenizer"))
    prompts = tt.template_prompts() + [""]
    want = hf(prompts, padding="max_length", max_length=hf.model_max_length, truncation=True,
              return_tensors="np")["input_ids"]
    np.testing.assert_array_equal(tpipe.tokenize(prompts), want)


def test_quantize_modes_and_errors():
    for q in (None, "", False, "off", "none"):
        assert tcommon.apply_quantize("pipe", tcfg.create({"quantize": q})) == "pipe"
    seen = []
    stub = types.SimpleNamespace(enable_int8=lambda mode: seen.append(mode) or "quantized")
    assert tcommon.apply_quantize(stub, tcfg.create({"quantize": "int8"})) == "quantized"
    assert tcommon.apply_quantize(stub, tcfg.create({"quantize": "int8_mixed"})) == "quantized"
    assert seen == ["full", "mixed"]
    with pytest.raises(ValueError) as te:
        tcommon.apply_quantize(stub, tcfg.create({"quantize": "int4"}))
    with pytest.raises(ValueError) as je:
        jcommon.apply_quantize(stub, jcfg.create({"quantize": "int4"}))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("device", [None, "tpu", "cuda", "cuda:1"])
def test_template_device_without_cuda_raises(monkeypatch, device):
    """No fall-back to the CPU: only a template that names the CPU runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    template = tcfg.create({} if device is None else {"device": device})
    with pytest.raises(RuntimeError, match="CUDA"):
        tcommon.build_pipeline(_args(checkpoint="tiny"), template)
    pipe = tcommon.build_pipeline(_args(checkpoint="tiny"), tcfg.create({"device": "cpu"}))
    assert pipe.device == torch.device("cpu")


def test_apply_unet_options_keeps_weights(tiny_pipe):
    pipe = copy.copy(tiny_pipe)
    before = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    rng = np.random.default_rng(0)
    x = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in (
        ("sample", (1, F, 8, 8, 4)), ("image_latents_first", (1, F, 8, 8, 4)),
        ("image_latents", (1, F, 8, 8, 4)), ("image_embeddings", (1, F, 16)),
        ("encoder_hidden_states", (1, 7, 16)))}
    with torch.no_grad():
        want = pipe.unet(x["sample"], 981, fps=torch.tensor([8]), **{
            k: v for k, v in x.items() if k != "sample"})
    assert not pipe.unet.config.temporal_natural_layout
    tcommon.apply_unet_options(pipe, tcfg.create({"temporal_window": 16}))
    assert pipe.unet.config == UNetConfig(**{**UNetConfig.tiny().__dict__,
                                           "temporal_window": 16,
                                           "temporal_natural_layout": True})
    after = pipe.unet.state_dict()
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert after[k].device == v.device and after[k].dtype == v.dtype
        assert torch.equal(after[k], v), k
    with torch.no_grad():
        got = pipe.unet(x["sample"], 981, fps=torch.tensor([8]), **{
            k: v for k, v in x.items() if k != "sample"})
    # the natural layout and a window of 16 >= F frames compute the same function
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    """--profile_dir: torch.profiler around the run, a Chrome trace written,
    with StepTimer's stages as spans in it; StepTimer sums a stage's calls."""
    import json

    from mvoc_tpu_torch.utils.profiling import StepTimer, save_run_config, trace

    timer = StepTimer()
    with trace(str(tmp_path / "prof")):
        for _ in range(2):
            with timer.stage("work"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert [e.get("name") for e in events].count("stage/work") == 2
    assert list(timer.summary()) == ["work"] and timer.summary()["work"] > 0
    path = save_run_config(tcfg.create({"a": "${b}", "b": 1}), str(tmp_path / "cfg"))
    with open(path) as f:
        assert f.read() == "a: ${b}\nb: 1\n"
