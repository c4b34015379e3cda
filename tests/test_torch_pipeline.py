"""mvoc_tpu_torch models and pipeline cores against the JAX package, with the
same (noise-replaced) weights and the same inputs:

* the weight bridge round-trips through mvoc_tpu.models.convert;
* VAE encode / decode and both CLIP towers (live against JAX);
* 3-step DDIM inversion, and the 3-step PnP composite (fused and stream)
  against JAX's fused composite, on inputs the JAX pipeline's own
  _prepare_composite built (JAX's stream path is held equal to its fused
  path by tests/test_pipeline.py);
* the port's tiny invert -> sample_composite end to end on the CPU;
* the entry points refuse to fall back to the CPU without CUDA.

The JAX side of the inversion and composite cores (and the tiny pipeline's
params) comes from tests/data/torch_parity_goldens.npz, written by
scripts/torch_parity_goldens.py: compiling those scans here would cost
minutes of CPU that tier-1 cannot spare.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvoc_tpu.models import clip as jclip
from mvoc_tpu.models import convert as jconvert
from mvoc_tpu.models import vae as jvae
from mvoc_tpu.pipeline import core as jcore
from mvoc_tpu.utils import testing as jtt
from mvoc_tpu_torch import pnp as tp
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models import clip as tclip
from mvoc_tpu_torch.models import convert as tconvert
from mvoc_tpu_torch.models import vae as tvae
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.ops.ddim import SchedulerConfig
from mvoc_tpu_torch.pipeline import core as tcore
from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline
from mvoc_tpu_torch.utils import testing as tt
from torch_support import load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

F, HW, LAT = 2, 16, 8
N_OBJ, N_STEPS = 2, 4  # 4-step schedule, t_idx 1 -> 3 composite steps
MODULE_ATOL = 2e-5
CORE_REL = 1e-3
JAX_MODULES = {
    "vae": (jvae.AutoencoderKL(jvae.VAEConfig.tiny()), lambda: (jnp.zeros((1, HW, HW, 3)),)),
    "text_encoder": (jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny()),
                     lambda: (jnp.zeros((1, 7), jnp.int32),)),
    "image_encoder": (jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig.tiny()),
                      lambda: (jnp.zeros((1, 28, 28, 3)),)),
}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def params(goldens):
    """The tiny pipeline's flax params (every leaf seeded noise)."""
    out = {"unet": nest(goldens, "params")}
    for name in JAX_MODULES:
        out[name] = nest(goldens, f"pipe/{name}")
    return out


@pytest.fixture(scope="module")
def tpipe(params):
    """The port's tiny pipeline with the same weights carried across."""
    tu = I2VGenXLUNet(UNetConfig.tiny())
    tu.load_state_dict(tconvert.unet_state_dict_from_flax(params["unet"]), strict=True)
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny())
    tv.load_state_dict(tconvert.vae_state_dict_from_flax(params["vae"]), strict=True)
    ttext = tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny())
    ttext.load_state_dict(tconvert.clip_text_state_dict_from_flax(params["text_encoder"]),
                          strict=True)
    tvis = tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig.tiny())
    tvis.load_state_dict(tconvert.clip_vision_state_dict_from_flax(params["image_encoder"]),
                         strict=True)
    return I2VGenXLPipeline(tu, tv, ttext, tvis, SchedulerConfig(),
                            tokenizer=jtt.DummyTokenizer(64, 12), device="cpu")


@pytest.mark.parametrize("name", sorted(JAX_MODULES))
def test_golden_params_have_the_jax_shapes(params, name):
    module, example = JAX_MODULES[name]
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *example()))
    assert (jax.tree.map(lambda a: tuple(a.shape), params[name])
            == jax.tree.map(lambda s: tuple(s.shape), shapes["params"]))


@pytest.mark.parametrize("model,key_fn", [
    ("unet", jconvert.unet_key_fn), ("vae", jconvert.vae_key_fn),
    ("text_encoder", jconvert.clip_text_key_fn), ("image_encoder", jconvert.clip_vision_key_fn)])
def test_weight_bridge_round_trips(params, tpipe, model, key_fn):
    """port state dict -> the JAX package's own converter -> the flax tree,
    structurally (verify_tree) and leaf for leaf."""
    module = {"unet": tpipe.unet, "vae": tpipe.vae, "text_encoder": tpipe.text_encoder,
              "image_encoder": tpipe.image_encoder}[model]
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    tree = jconvert.convert_state_dict(sd, key_fn)
    if model in ("text_encoder", "image_encoder"):
        tree = jconvert._fix_clip_raw_params(tree)
    jconvert.verify_tree(tree, params[model], model)
    got = dict(_leaves(tree))
    for name, value in _leaves(params[model]):
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_vae_encode_decode(params, tpipe):
    vae = JAX_MODULES["vae"][0]
    p = {"params": params["vae"]}
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
    mean_j, logvar_j = vae.apply(p, x, method=jvae.AutoencoderKL.encode)
    with torch.no_grad():
        mean_t, logvar_t = tpipe.vae.encode(torch.from_numpy(x))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=MODULE_ATOL)
    np.testing.assert_allclose(logvar_t.numpy(), np.asarray(logvar_j), atol=MODULE_ATOL)
    noise = rng.standard_normal(mean_t.shape).astype(np.float32)
    z_t = tvae.sample_latents(mean_t, logvar_t, torch.from_numpy(noise))
    z_j = np.asarray(mean_j) + np.exp(0.5 * np.asarray(logvar_j)) * noise
    np.testing.assert_allclose(z_t.numpy(), z_j, atol=MODULE_ATOL)
    img_j = np.asarray(vae.apply(p, z_j, method=jvae.AutoencoderKL.decode))
    with torch.no_grad():
        img_t = tpipe.vae.decode(torch.from_numpy(z_j)).numpy()
    np.testing.assert_allclose(img_t, img_j, atol=MODULE_ATOL * max(1.0, np.abs(img_j).max()))


def test_clip_towers(params, tpipe):
    text, vision = JAX_MODULES["text_encoder"][0], JAX_MODULES["image_encoder"][0]
    ids = tpipe.tokenize(["a red boat on the sea", ""])  # ids compared within one process
    for skip in (0, 1):
        want = np.asarray(text.apply({"params": params["text_encoder"]}, jnp.asarray(ids),
                                     clip_skip=skip))
        with torch.no_grad():
            got = tpipe.text_encoder(torch.as_tensor(ids, dtype=torch.long), clip_skip=skip)
        np.testing.assert_allclose(got.numpy(), want, atol=MODULE_ATOL)
    px = np.random.default_rng(8).uniform(0, 1, (2, 28, 28, 3)).astype(np.float32)
    want = np.asarray(vision.apply({"params": params["image_encoder"]},
                                   jclip.normalize_clip_image(jnp.asarray(px))))
    with torch.no_grad():
        got = tpipe.image_encoder(tclip.normalize_clip_image(torch.from_numpy(px)))
    np.testing.assert_allclose(got.numpy(), want, atol=MODULE_ATOL)


def _cond(goldens, prefix):
    return tcore.UNetConditioning(**{
        f.name: torch.from_numpy(goldens[f"{prefix}/{f.name}"])
        for f in dataclasses.fields(jcore.UNetConditioning)})


def _check_core(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"max |err| {err:.3g} of max |jax| {np.abs(want).max():.3g}")
    assert err <= CORE_REL * np.abs(want).max(), (err, np.abs(want).max())


def test_inversion_core_3_steps(goldens, tpipe):
    got = tcore.ddim_inversion_core(
        tpipe.unet, tpipe.ddim, torch.from_numpy(goldens["invert/x0"]),
        _cond(goldens, "invert"), goldens["invert/timesteps"], 50)
    _check_core(got.numpy(), goldens["invert/trajectory"])


def _pyramid(goldens, name):
    prefix = f"composite/{name}/"
    return {tuple(int(n) for n in k[len(prefix):].split("x")): torch.from_numpy(v)
            for k, v in goldens.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def port_composites(goldens, tpipe):
    """The port's composite on the inputs JAX's _prepare_composite built,
    fused and stream."""
    s = lambda name: goldens[f"composite/sched/{name}"]
    sched = tcore.CompositeSchedule(
        bg_traj=torch.from_numpy(s("bg_traj")), obj_traj=torch.from_numpy(s("obj_traj")),
        obj_fusion_lat=torch.from_numpy(s("obj_fusion_lat")), gate_spatial=s("gate_spatial"),
        gate_temporal=s("gate_temporal"), gate_conv=s("gate_conv"),
        fusion_mask=s("fusion_mask"), timesteps=s("timesteps"))
    pb, ps = _pyramid(goldens, "pyr_bin"), _pyramid(goldens, "pyr_soft")
    return {two_pass: tcore.pnp_composite_core(
        tpipe.unet, tpipe.ddim, torch.from_numpy(goldens["composite/init"]),
        _cond(goldens, "composite/cond"), sched,
        torch.from_numpy(goldens["composite/masks_soft"]), pb, ps,
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=two_pass,
        capture_weights=tp.build_capture_weights(pb, ps, True) if two_pass else None).numpy()
        for two_pass in (False, "stream")}


@pytest.mark.parametrize("two_pass", [False, "stream"])
def test_composite_core_3_steps(goldens, port_composites, two_pass):
    assert len(goldens["composite/sched/timesteps"]) == 3
    _check_core(port_composites[two_pass], goldens["composite/fused_out"])


def test_port_stream_equals_fused(port_composites):
    fused, stream = port_composites[False], port_composites["stream"]
    assert np.abs(fused - stream).max() <= CORE_REL * np.abs(fused).max()


def test_port_invert_then_composite_end_to_end(tmp_path):
    pipe = tt.build_tiny_pipeline(device="cpu", natural=True)
    dirs = []
    for j in range(N_OBJ + 1):
        d = str(tmp_path / f"inv{j}")
        ts, traj = pipe.invert(tt.tiny_frames(seed=j), height=HW, width=HW, num_frames=F,
                               num_inference_steps=N_STEPS, output_dir=d)
        assert traj.shape == (N_STEPS, F, LAT, LAT, 4) and np.isfinite(traj).all()
        dirs.append(d)
    binary = np.zeros((N_OBJ, F, LAT, LAT), np.float32)
    binary[0, :, :4] = 1.0
    binary[1, :, :, :4] = 1.0
    frames = tt.tiny_frames(seed=5)
    video = pipe.sample_composite(
        "a cat", frames[0], frames, tt.tiny_frames(seed=0),
        [tt.tiny_frames(seed=1), tt.tiny_frames(seed=2)], binary, binary,
        TrajectoryStore(dirs[0]), [TrajectoryStore(d) for d in dirs[1:]], height=HW, width=HW,
        num_frames=F, num_inference_steps=N_STEPS, guidance_scale=3.0, two_pass="stream")
    assert video.shape == (F, HW, HW, 3)
    assert np.isfinite(video).all() and video.min() >= 0.0 and video.max() <= 1.0


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.build_tiny_pipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        I2VGenXLPipeline(I2VGenXLUNet(UNetConfig.tiny()), tvae.AutoencoderKL(tvae.VAEConfig.tiny()),
                         tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()),
                         tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig.tiny()),
                         SchedulerConfig())
