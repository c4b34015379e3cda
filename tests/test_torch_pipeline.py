"""mvoc_tpu_torch models and pipeline cores against the JAX package, with the
same (noise-replaced) weights and the same inputs:

* the weight bridge round-trips through mvoc_tpu.models.convert;
* VAE encode / decode and both CLIP towers (live against JAX);
* 3-step DDIM inversion, and the 3-step PnP composite (fused, stream and
  two_pass=True) against JAX's fused and two_pass=True composites, on
  inputs the JAX pipeline's own _prepare_composite built (JAX's stream path
  is held equal to its fused path by tests/test_pipeline.py);
* tiled_decode against the JAX function, both tiling one shared decode
  function (the tiny VAE's decode, and a plain upsampling map) over a
  ragged 13 x 21 latent;
* the int8 path (enable_int8's "full" selection): the 3-step inversion and
  the 3-step composite, fused and stream, against JAX's int8 inversion and
  fused composite, replaying the JAX runs' tapes of int8 activations (see
  test_torch_unet.py for why);
* 3 steps of plain DDIM sampling (ddim_sampling_core, the reconstruction
  path: cfg, no cfg, eta > 0 with the noise passed in) against JAX's;
* at a 5 x 9 latent whose halvings go odd (the 720p geometry in
  miniature): a UNet forward and one fused composite step with its mask
  pyramid, against JAX's;
* the port's tiny invert -> sample_composite end to end on the CPU, in
  fp32 and in int8, and sample / generate_background;
* the entry points refuse to fall back to the CPU without CUDA.

The JAX side of the inversion and composite cores (and the tiny pipeline's
params) comes from tests/data/torch_parity_goldens.npz, written by
scripts/torch_parity_goldens.py: compiling those scans here would cost
minutes of CPU that tier-1 cannot spare.
"""

import copy
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
from mvoc_tpu_torch.ops import quantize as tq
from mvoc_tpu_torch.ops.ddim import SchedulerConfig
from mvoc_tpu_torch.pipeline import core as tcore
from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline
from mvoc_tpu_torch.utils import testing as tt
from torch_support import (batch_slice, check_int8, check_int8_replay, load_goldens, load_tape,
                           nest)
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


def _pyramid(goldens, name, root="composite"):
    prefix = f"{root}/{name}/"
    return {tuple(int(n) for n in k[len(prefix):].split("x")): torch.from_numpy(v)
            for k, v in goldens.items() if k.startswith(prefix)}


def _composite(goldens, tpipe, unet, two_pass):
    """The port's composite on the inputs JAX's _prepare_composite built."""
    s = lambda name: goldens[f"composite/sched/{name}"]
    sched = tcore.CompositeSchedule(
        bg_traj=torch.from_numpy(s("bg_traj")), obj_traj=torch.from_numpy(s("obj_traj")),
        obj_fusion_lat=torch.from_numpy(s("obj_fusion_lat")), gate_spatial=s("gate_spatial"),
        gate_temporal=s("gate_temporal"), gate_conv=s("gate_conv"),
        fusion_mask=s("fusion_mask"), timesteps=s("timesteps"))
    pb, ps = _pyramid(goldens, "pyr_bin"), _pyramid(goldens, "pyr_soft")
    return tcore.pnp_composite_core(
        unet, tpipe.ddim, torch.from_numpy(goldens["composite/init"]),
        _cond(goldens, "composite/cond"), sched,
        torch.from_numpy(goldens["composite/masks_soft"]), pb, ps,
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=two_pass,
        capture_weights=tp.build_capture_weights(pb, ps, True) if two_pass == "stream"
        else None).numpy()


@pytest.fixture(scope="module")
def port_composites(goldens, tpipe):
    """The port's composite, fused, stream and two_pass=True."""
    return {two_pass: _composite(goldens, tpipe, tpipe.unet, two_pass)
            for two_pass in (False, "stream", True)}


@pytest.mark.parametrize("two_pass", [False, "stream", True])
def test_composite_core_3_steps(goldens, port_composites, two_pass):
    """Each path against JAX's fused composite; two_pass=True also against
    JAX's own two_pass=True run."""
    assert len(goldens["composite/sched/timesteps"]) == 3
    _check_core(port_composites[two_pass], goldens["composite/fused_out"])
    if two_pass is True:
        _check_core(port_composites[True], goldens["composite/two_pass_out"])


def test_port_stream_equals_fused(port_composites):
    fused, stream = port_composites[False], port_composites["stream"]
    assert np.abs(fused - stream).max() <= CORE_REL * np.abs(fused).max()


def test_port_two_pass_equals_fused(port_composites):
    fused, two = port_composites[False], port_composites[True]
    assert np.abs(fused - two).max() <= CORE_REL * np.abs(fused).max()


def _upsample_map(z):  # [B, h, w, 4] -> [B, 2h, 2w, 3]: a plain decode stand-in
    rgb = np.tanh(0.7 * z[..., :3] + z[..., 3:]).astype(np.float32)
    return rgb.repeat(2, axis=1).repeat(2, axis=2)


@pytest.mark.parametrize("fn", ["tiny_vae", "upsample"])
def test_tiled_decode_matches_jax(tpipe, fn):
    """One decode function (numpy in, numpy out) tiled by both packages'
    tiled_decode over a ragged 13 x 21 latent (tile 8, overlap 2: clamped
    edge tiles, ramps on every inner seam): the same placement, ramps and
    fp32 blend; and a latent that fits one tile is decoded whole."""
    if fn == "tiny_vae":
        def shared(z):
            with torch.no_grad():
                return tpipe.vae.decode(torch.from_numpy(np.asarray(z))).numpy()
    else:
        shared = _upsample_map
    z = np.random.default_rng(8).standard_normal((2, 13, 21, 4)).astype(np.float32)
    want = np.asarray(jvae.tiled_decode(lambda t: jnp.asarray(shared(np.asarray(t))),
                                        jnp.asarray(z), tile_latent=8, overlap_latent=2))
    got = tvae.tiled_decode(lambda t: torch.from_numpy(shared(t.numpy())), torch.from_numpy(z),
                            tile_latent=8, overlap_latent=2).numpy()
    assert got.shape == want.shape == (2, 26, 42, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    whole = tvae.tiled_decode(lambda t: torch.from_numpy(shared(t.numpy())),
                              torch.from_numpy(z[:, :8, :8]), tile_latent=8)
    np.testing.assert_array_equal(whole.numpy(), shared(z[:, :8, :8]))


@pytest.fixture(scope="module")
def int8_unet(tpipe):
    """The tiny UNet quantized with enable_int8's "full" selection."""
    unet = copy.deepcopy(tpipe.unet)
    tq.quantize_unet_(unet, tq.default_unet_predicate)
    return unet


def test_int8_inversion_core_3_steps(goldens, tpipe, int8_unet):
    tape = tt.ActivationTape(load_tape(goldens, "invert"))
    with tape.active():
        got = tcore.ddim_inversion_core(
            int8_unet, tpipe.ddim, torch.from_numpy(goldens["invert/x0"]),
            _cond(goldens, "invert"), goldens["invert/timesteps"], 50)
    check_int8_replay(tape)
    check_int8(got.numpy(), goldens["invert/int8_trajectory"], goldens["invert/trajectory"])


def _stream_tape(records, n_steps, n_obj):
    """JAX's fused composite runs one batch of N+3 branches per step; the
    stream path runs the N+1 source branches one by one, then the
    uncond/cond pair.  Every int8 activation is batch-major, so the fused
    tape cut by branch is the stream path's tape."""
    per_step = len(records) // n_steps
    assert per_step * n_steps == len(records)
    n = n_obj + 3
    out = []
    for i in range(n_steps):
        step = records[i * per_step:(i + 1) * per_step]
        for b in range(n_obj + 1):
            out += batch_slice(step, n, b, b + 1)
        out += batch_slice(step, n, n_obj + 1, n)
    return out


@pytest.mark.parametrize("two_pass", [False, "stream"])
def test_int8_composite_core_3_steps(goldens, tpipe, int8_unet, two_pass):
    """Both paths against JAX's fused int8 composite: at these sizes every
    (3,1,1) conv has fewer than 4096 rows, so the capture passes (batch 1)
    and the edit pass (batch 2) take the stacked GEMM as the fused batch of
    5 does, and the per-row / per-sample activation scales do not depend on
    the batch: the stream path quantizes what the fused path quantizes."""
    records = load_tape(goldens, "composite")
    if two_pass == "stream":
        records = _stream_tape(records, N_STEPS - 1, N_OBJ)
    tape = tt.ActivationTape(records)
    with tape.active():
        got = _composite(goldens, tpipe, int8_unet, two_pass)
    check_int8_replay(tape)
    check_int8(got, goldens["composite/int8_fused_out"], goldens["composite/fused_out"])


@pytest.mark.parametrize("case", ["cfg", "nocfg", "eta"])
def test_sampling_core_3_steps(goldens, tpipe, case):
    """ddim_sampling_core (the reconstruction path) against JAX's: cfg 3.0,
    no cfg (batch 1), and eta 0.5 with the noise passed in; tolerance
    CORE_REL of max |JAX|, as the inversion's."""
    cond = _cond(goldens, "sample")
    if case == "nocfg":
        cond = cond.slice(1, 2)
    eta = 0.5 if case == "eta" else 0.0
    got = tcore.ddim_sampling_core(
        tpipe.unet, tpipe.ddim, torch.from_numpy(goldens["sample/latents"]), cond,
        goldens["sample/timesteps"], 50, 1.0 if case == "nocfg" else 3.0, eta=eta,
        noise=torch.from_numpy(goldens["sample/noise"]) if eta else None)
    _check_core(got.numpy(), goldens[f"sample/{case}_out"])


def test_odd_geometry_unet_forward(goldens, tpipe):
    """A 5 x 9 latent whose halvings go odd (3 x 5, 2 x 3, 1 x 2: the
    90 x 160 latent of 720p in miniature), so every up block meets a ragged
    skip; tolerance CORE_REL of max |JAX|."""
    x = {k: torch.from_numpy(goldens[f"odd/unet/{k}"]) for k in (
        "sample", "fps", "image_latents_first", "image_latents", "image_embeddings",
        "encoder_hidden_states")}
    with torch.no_grad():
        got = tpipe.unet(x.pop("sample"), int(goldens["odd/unet/timestep"][0]), **x)
    assert got.shape == (2, F, 5, 9, 4)
    _check_core(got.numpy(), goldens["odd/unet/out"])


def test_odd_geometry_composite_step(goldens, tpipe):
    """One fused composite step at the 5 x 9 latent, on the inputs JAX's
    _prepare_composite built; the port's own mask pyramid at the injection
    resolutions of that latent equals JAX's bitwise."""
    pre = "odd/composite"
    pb, ps = _pyramid(goldens, "pyr_bin", pre), _pyramid(goldens, "pyr_soft", pre)
    res = tpipe._injection_resolutions(5, 9)
    assert sorted(res) == sorted(pb) and (3, 5) in res and (2, 3) in res
    for name, pyr, masks in (("binary", pb, goldens[f"{pre}/masks_binary"]),
                             ("soft", ps, goldens[f"{pre}/masks_soft"])):
        own = tp.build_mask_pyramid(masks, res)
        for k, v in pyr.items():
            np.testing.assert_array_equal(np.asarray(own[k]), v.numpy(), err_msg=f"{name} {k}")
    s = lambda name: goldens[f"{pre}/sched/{name}"]
    sched = tcore.CompositeSchedule(
        bg_traj=torch.from_numpy(s("bg_traj")), obj_traj=torch.from_numpy(s("obj_traj")),
        obj_fusion_lat=torch.from_numpy(s("obj_fusion_lat")), gate_spatial=s("gate_spatial"),
        gate_temporal=s("gate_temporal"), gate_conv=s("gate_conv"),
        fusion_mask=s("fusion_mask"), timesteps=s("timesteps"))
    assert len(sched.timesteps) == 1 and sched.fusion_mask[0] and sched.gate_spatial[0]
    got = tcore.pnp_composite_core(
        tpipe.unet, tpipe.ddim, torch.from_numpy(goldens[f"{pre}/init"]),
        _cond(goldens, f"{pre}/cond"), sched, torch.from_numpy(goldens[f"{pre}/masks_soft"]),
        pb, ps, num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3)
    _check_core(got.numpy(), goldens[f"{pre}/fused_out"])


def test_port_sample_and_generate_background(tmp_path):
    """The reconstruction entry point on the CPU: the inverted latents at the
    schedule's step t_idx run the rest of the schedule; the result is a
    finite video in [0, 1], the same from the same seed, and t_idx = N
    (nothing left to run) decodes the start latents unchanged."""
    pipe = tt.build_tiny_pipeline(device="cpu", natural=True)
    frames = tt.tiny_frames(seed=3)
    ts, traj = pipe.invert(frames, height=HW, width=HW, num_frames=F,
                           num_inference_steps=N_STEPS, output_dir=str(tmp_path))
    start = TrajectoryStore(str(tmp_path)).load_at_t(int(ts[-2]))  # = sampling step 1
    kw = dict(height=HW, width=HW, num_frames=F, num_inference_steps=N_STEPS,
              guidance_scale=3.0, ddim_init_latents_t_idx=1, seed=2)
    video = pipe.sample(frames[0], latents=torch.from_numpy(start), **kw)
    assert video.shape == (F, HW, HW, 3) and np.isfinite(video).all()
    assert 0.0 <= video.min() and video.max() <= 1.0
    np.testing.assert_array_equal(video, pipe.sample(frames[0], latents=start, **kw))
    kw["ddim_init_latents_t_idx"] = N_STEPS
    final = pipe.sample(frames[0], latents=start, decode=False, **kw)
    np.testing.assert_array_equal(final.numpy(), start)
    bg = pipe.generate_background("a beach", height=HW, width=HW, num_frames=F,
                                  num_inference_steps=2)
    assert bg.shape == (F, HW, HW, 3) and np.isfinite(bg).all()


def _invert_then_composite(tmp_path, int8: bool):
    pipe = tt.build_tiny_pipeline(device="cpu", natural=True)
    if int8:
        pipe.enable_int8(mode="full")
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


def test_port_invert_then_composite_end_to_end(tmp_path):
    _invert_then_composite(tmp_path, int8=False)


def test_port_int8_invert_then_composite_end_to_end(tmp_path):
    _invert_then_composite(tmp_path, int8=True)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.build_tiny_pipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        I2VGenXLPipeline(I2VGenXLUNet(UNetConfig.tiny()), tvae.AutoencoderKL(tvae.VAEConfig.tiny()),
                         tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()),
                         tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig.tiny()),
                         SchedulerConfig())
