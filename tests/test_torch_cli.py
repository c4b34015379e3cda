"""The port's CLIs (mvoc_tpu_torch.cli) against the JAX package's:

* argument parity: both `main`s, each with a recording stub pipeline, on
  the same demo tree and group JSONs; every argument reaching `invert`,
  `sample` and `sample_composite` is equal (images as arrays, masks,
  trajectory contents, every static knob), and so are the files written
  (the parameter-encoded export directory name, run configs, recon
  metrics).  JAX draws noise from jax.random, which torch cannot
  reproduce, so the CLIs are compared on what they hand the pipeline;
* the port's CLIs end to end on the tiny CPU pipeline (`device: cpu`);
* every refusal of a mode that is not ported names its ROADMAP.md item;
  a missing checkpoint, an unknown quantize mode and a template without a
  CPU device on a machine without CUDA raise as the JAX CLI does (or, for
  the device, as the port's entry points do);
* what used to be refused and is ported now: two_pass=True, the template's
  enable_vae_tiling (argument parity with the JAX CLI), a checkpoint
  directory (the pipeline both CLIs build from the tiny checkpoint), and
  --mesh_seq / --mesh_job without a mesh size (passed through, as in JAX).
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
        TrajectoryStore(kw["output_dir"], prefer_native=False).save(ts, traj, meta=meta)
        return ts, traj

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


def _norm(v):
    """A comparable form of a recorded argument."""
    if isinstance(v, Image.Image):
        return ("image", v.size, np.asarray(v).tobytes())
    if hasattr(v, "gather") and hasattr(v, "path"):  # a trajectory store of either package
        ts = np.asarray(v.timesteps)
        return ("store", v.path, ts.tolist(), v.gather(ts).tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_norm(x) for x in v])
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


def _run_jax(monkeypatch, demo, kinds=("inversion", "composite")):
    root, paths = demo
    pipe = RecordingPipeline()
    monkeypatch.setattr(jcommon, "build_pipeline", lambda args, t: pipe)
    monkeypatch.setattr(jcommon, "apply_unet_options", lambda p, t: p)
    for kind in kinds:
        monkeypatch.setattr(sys, "argv", ["prog"] + _template_args(kind, paths[kind]))
        {"inversion": jinverse, "composite": jcomposite}[kind].main()
    return pipe


def _run_port(monkeypatch, demo, kinds=("inversion", "composite")):
    root, paths = demo
    pipe = RecordingPipeline()
    monkeypatch.setattr(tcommon, "build_pipeline", lambda args, t: pipe)
    monkeypatch.setattr(tcommon, "apply_unet_options", lambda p, t: p)
    for kind in kinds:
        {"inversion": tinverse, "composite": tcomposite}[kind].main(
            _template_args(kind, paths[kind]))
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


@pytest.mark.parametrize("kw,item", [
    ({"encoder_reuse_interval": 2}, 4), ({"encoder_reuse_depth": 1}, 4),
    ({"deep_reuse": True}, 4)])
def test_invert_refuses_unported_modes(tiny_pipe, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 item {item}"):
        tiny_pipe.invert(tt.tiny_frames(), height=HW, width=HW, num_frames=F, **kw)


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


@pytest.mark.parametrize("kw,item", [
    ({"encoder_reuse_interval": 3}, 4), ({"encoder_reuse_depth": 2}, 4),
    ({"pab_interval": 2}, 4), ({"capture_reuse_interval": 2}, 4),
    ({"capture_reuse_deep": True}, 4), ({"two_pass": True}, None)])
def test_sample_composite_refuses_unported_modes(tiny_pipe, tmp_path, kw, item):
    """The reuse and broadcast modes stay refused; two_pass=True (item 3) is
    ported and runs the fused path's function."""
    if item is None:
        args = _composite_inputs(str(tmp_path))
        common = dict(height=HW, width=HW, num_frames=F, num_inference_steps=STEPS,
                      guidance_scale=3.0, decode=False)
        got = tiny_pipe.sample_composite(*args, **common, **kw)
        fused = tiny_pipe.sample_composite(*args, **common, two_pass=False)
        assert torch.isfinite(got).all()
        assert (got - fused).abs().max() <= 1e-5 * fused.abs().max()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 item {item}"):
        tiny_pipe.sample_composite("a cat", *([None] * 8), height=HW, width=HW, **kw)


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
def test_mesh_refused(args, template):
    """A mesh size stays refused (item 10); --mesh_seq / --mesh_job alone
    leave the pipeline as it is, as the JAX CLI's apply_mesh does."""
    assert tcommon.apply_mesh("pipe", _args(), tcfg.create({})) == "pipe"
    if "mesh" not in args and "mesh_devices" not in template:
        assert jcommon.apply_mesh("pipe", _args(**args), jcfg.create(template)) == "pipe"
        assert tcommon.apply_mesh("pipe", _args(**args), tcfg.create(template)) == "pipe"
        return
    with pytest.raises(NotImplementedError, match="item 10"):
        tcommon.apply_mesh("pipe", _args(**args), tcfg.create(template))


@pytest.mark.parametrize("kind,mod,key", [("inversion", tinverse, "batch_inversions"),
                                          ("composite", tcomposite, "batch_composites")])
def test_batch_refused(demo, tmp_path, kind, mod, key):
    argv = _template_args(kind, demo[1][kind])
    with pytest.raises(NotImplementedError, match="item 8"):
        mod.main(argv + ["--batch"])
    template = tmp_path / "t.yaml"
    template.write_text(f"{key}: true\n")
    with pytest.raises(NotImplementedError, match="item 8"):
        mod.main(["--template_config", str(template), "--configs_json", demo[1][kind]])


def test_auto_reuse_refused(demo):
    template = tcfg.load(os.path.join(ROOT, "configs", "group_inversion", "template.yaml"))
    entries = tcfg.load_json_list(demo[1]["inversion"])
    entries[0]["inverse_config"]["encoder_reuse_interval"] = "auto"
    entries[0]["force_recompute_latents"] = True
    with pytest.raises(NotImplementedError, match="item 4"):
        tinverse.run(None, tinverse.configure(template, entries))


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
    """--profile_dir: torch.profiler around the run, a Chrome trace written;
    StepTimer sums a stage's calls and dumps them as JSON."""
    import json

    from mvoc_tpu_torch.utils.profiling import StepTimer, save_run_config, trace

    timer = StepTimer()
    with trace(str(tmp_path / "prof")):
        for _ in range(2):
            with timer.stage("work"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert list(timer.summary()) == ["work"] and timer.summary()["work"] > 0
    timer.dump(str(tmp_path / "t" / "timings.json"))
    with open(tmp_path / "t" / "timings.json") as f:
        assert json.load(f) == timer.summary()
    path = save_run_config(tcfg.create({"a": "${b}", "b": 1}), str(tmp_path / "cfg"))
    with open(path) as f:
        assert f.read() == "a: ${b}\nb: 1\n"
