"""Write the JAX side of the port's heavier parity tests to
tests/data/torch_parity_goldens.npz.

The tiny I2VGen-XL UNet costs ~20 s of XLA compile per program on a CPU,
and the UNet and pipeline-core parity tests of mvoc_tpu_torch need eight
such programs (plain forward, stream capture and consume in both temporal
layouts, the inversion and composite scans).  Compiled during tier-1 they
compete for CPU with tests/test_pipeline.py and push the suite over its time
limit, so this script runs the JAX package once and stores, as numpy:

  * the UNet params (every flax leaf replaced by seeded noise);
  * for each temporal layout: the inputs and output of a plain forward, and
    of the stream path (per-branch capture summed over the source branches,
    then the batch-2 consume), with the summed site features;
  * a 3-step DDIM inversion (inputs and trajectory);
  * a 3-step PnP composite (fused): the inputs JAX's own _prepare_composite
    built from seeded frames, masks and trajectory stores, and the result;
  * a digest of the sources these outputs come from
    (tests/torch_support.py: GOLDEN_SOURCES).

tests/test_torch_unet.py and tests/test_torch_pipeline.py run the port on the
same inputs and compare; they also check that the stored param tree still
has the shapes of the JAX modules, and fail while the digest differs from
that of the sources on disk.  Rerun after changing the JAX package or these
cases:

    JAX_PLATFORMS=cpu python scripts/torch_parity_goldens.py
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_support import GOLDENS as OUT  # noqa: E402
from torch_support import golden_sources_digest, noisy_params  # noqa: E402

F, HW, LAT, D = 2, 16, 8, 16
N_OBJ = 2
N_STEPS = 4  # 4-step schedule, t_idx 1 -> 3 composite steps


def unet_inputs(b, seed):
    r = np.random.default_rng(seed)

    def mk(*s):
        return r.standard_normal(s).astype(np.float32)

    return dict(sample=mk(b, F, LAT, LAT, 4), timestep=np.array([981] * b),
                fps=np.array([8] * b), image_latents_first=mk(b, F, LAT, LAT, 4),
                image_latents=mk(b, F, LAT, LAT, 4), image_embeddings=mk(b, F, D),
                encoder_hidden_states=mk(b, 7, D))


def masks():
    binary = np.zeros((N_OBJ, F, LAT, LAT), np.float32)
    binary[0, :, : LAT // 2] = 1.0
    binary[1, :, :, : LAT // 2] = 1.0
    soft = np.clip(binary * 0.8 + 0.1, 0, 1).astype(np.float32)
    return binary, soft


def flatten(tree, prefix, out):
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            flatten(v, key, out)
        else:
            out[key] = np.asarray(v)


def main() -> int:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    sys.path.insert(0, ROOT)
    from mvoc_tpu import pnp as jp
    from mvoc_tpu.io.trajectory import TrajectoryStore
    from mvoc_tpu.models import clip as jclip
    from mvoc_tpu.models import vae as jvae
    from mvoc_tpu.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
    from mvoc_tpu.ops.ddim import SchedulerConfig, inversion_timesteps
    from mvoc_tpu.pipeline import core
    from mvoc_tpu.pipeline.i2vgen import I2VGenXLPipeline
    from mvoc_tpu.utils import testing as jtt

    out: dict[str, np.ndarray] = {}
    x1 = {k: jnp.asarray(v) for k, v in unet_inputs(1, 0).items()}
    shapes = jax.eval_shape(lambda: I2VGenXLUNet(UNetConfig.tiny()).init(jax.random.key(0), **x1))
    params = {"params": noisy_params(shapes["params"], np.random.default_rng(1))}
    flatten(params["params"], "params", out)

    # UNet: plain forward and the stream path, in both temporal layouts
    binary, soft = masks()
    res = [(LAT, LAT), (LAT // 2, LAT // 2), (LAT // 4, LAT // 4)]
    pb = {k: jnp.asarray(v) for k, v in jp.build_mask_pyramid(binary, res).items()}
    ps = {k: jnp.asarray(v) for k, v in jp.build_mask_pyramid(soft, res).items()}
    state = jp.PnPState(masks=pb, masks_soft=ps, gate_spatial=jnp.asarray(True),
                        gate_temporal=jnp.asarray(True), gate_conv=jnp.asarray(True))
    cw = jp.build_capture_weights(pb, ps, True)
    plain_in, src_in, edit_in = unet_inputs(2, 3), unet_inputs(N_OBJ + 1, 5), unet_inputs(2, 6)
    for name, inp in (("plain", plain_in), ("src", src_in), ("edit", edit_in)):
        for k, v in inp.items():
            out[f"unet/{name}/{k}"] = v
    for layout, natural in (("standard", False), ("natural", True)):
        unet = I2VGenXLUNet(dataclasses.replace(UNetConfig.tiny(), temporal_natural_layout=natural))
        out[f"unet/{layout}/plain_out"] = np.asarray(jax.jit(unet.apply)(params, **plain_in))
        capture = jax.jit(lambda p, x, s: unet.apply(p, **x, pnp=s, pnp_capture=True,
                                                     mutable=["pnp_features"])[1])
        feats = None
        for b in range(N_OBJ + 1):
            xb = {k: v[b:b + 1] for k, v in src_in.items()}
            sb = dataclasses.replace(state, capture_weight=jax.tree.map(lambda w: w[b], cw))
            fb = {k: v[0] for k, v in capture(params, xb, sb)["pnp_features"].items()}
            feats = fb if feats is None else jax.tree.map(jnp.add, feats, fb)
        for site, val in feats.items():
            for i, leaf in enumerate(jax.tree.leaves(val)):
                out[f"unet/{layout}/feats/{site}/{i}"] = np.asarray(leaf)
        consume = dataclasses.replace(state, mode="consume_pre", features=feats)
        out[f"unet/{layout}/stream_out"] = np.asarray(
            jax.jit(lambda p, x, s: unet.apply(p, **x, pnp=s))(params, edit_in, consume))
        print(f"unet {layout}: done", flush=True)

    # pipeline cores, on a JAX tiny pipeline with these UNet params
    unet = I2VGenXLUNet(UNetConfig.tiny())
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    text = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny())
    vision = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig.tiny())
    z = jnp.zeros
    other = {
        "vae": jax.eval_shape(lambda: vae.init(jax.random.key(0), z((1, HW, HW, 3)))),
        "text_encoder": jax.eval_shape(lambda: text.init(jax.random.key(0), z((1, 7), jnp.int32))),
        "image_encoder": jax.eval_shape(lambda: vision.init(jax.random.key(0), z((1, 28, 28, 3)))),
    }
    pipe_params = {k: {"params": noisy_params(v["params"], np.random.default_rng(i + 10))}
                   for i, (k, v) in enumerate(sorted(other.items()))}
    pipe_params["unet"] = params
    for k in sorted(other):
        flatten(pipe_params[k]["params"], f"pipe/{k}", out)
    pipe = I2VGenXLPipeline(unet, vae, text, vision, pipe_params, SchedulerConfig(),
                            tokenizer=jtt.DummyTokenizer(64, 12))

    rng = np.random.default_rng(9)

    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)

    inv = dict(x0=mk(F, LAT, LAT, 4), encoder_hidden_states=mk(1, 7, D),
               image_latents_first=mk(1, F, LAT, LAT, 4), image_latents=mk(1, F, LAT, LAT, 4),
               image_embeddings=mk(1, F, D), fps=np.array([8]))
    cond = core.UNetConditioning(**{k: jnp.asarray(v) for k, v in inv.items() if k != "x0"})
    ts = inversion_timesteps(SchedulerConfig(), 50)[:3]
    traj = core.ddim_inversion_core(pipe._unet_apply, pipe.ddim, params, jnp.asarray(inv["x0"]),
                                    cond, jnp.asarray(ts), 50)
    for k, v in inv.items():
        out[f"invert/{k}"] = v
    out["invert/timesteps"] = ts
    out["invert/trajectory"] = np.asarray(traj)
    print("inversion: done", flush=True)

    with tempfile.TemporaryDirectory() as root:
        its = inversion_timesteps(SchedulerConfig(), N_STEPS)
        r = np.random.default_rng(10)
        stores = []
        for j in range(N_OBJ + 1):
            path = os.path.join(root, f"v{j}")
            TrajectoryStore(path, prefer_native=False).save(
                its, r.standard_normal((len(its), F, LAT, LAT, 4)).astype(np.float32))
            stores.append(TrajectoryStore(path))
        frames = [jtt.tiny_frames(seed=s) for s in range(N_OBJ + 2)]
        c_binary = np.zeros((N_OBJ, F, LAT, LAT), np.float32)
        c_binary[0, :, : LAT // 2] = 1.0
        c_binary[1, :, :, : LAT // 2] = 1.0
        c_soft = np.clip(c_binary * 0.7 + 0.2, 0, 1).astype(np.float32)
        init, ccond, sched, ms, cpb, cps, _ = pipe._prepare_composite(
            "a cat", frames[0][0], frames[0], frames[1], frames[2:], c_soft, c_binary,
            stores[0], stores[1:], height=HW, width=HW, num_frames=F,
            num_inference_steps=N_STEPS, guidance_scale=3.0, fusion_steps=(0, 1),
            two_pass="stream", seed=3)
    fused = core.pnp_composite_core(
        pipe._unet_apply, pipe.ddim, params, init, ccond, sched, ms, cpb, cps,
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=False)
    out["composite/init"] = np.asarray(init)
    for f in dataclasses.fields(core.UNetConditioning):
        out[f"composite/cond/{f.name}"] = np.asarray(getattr(ccond, f.name))
    for f in dataclasses.fields(core.CompositeSchedule):
        out[f"composite/sched/{f.name}"] = np.asarray(getattr(sched, f.name))
    out["composite/masks_soft"] = np.asarray(ms)
    for (h, w), v in cpb.items():
        out[f"composite/pyr_bin/{h}x{w}"] = np.asarray(v)
    for (h, w), v in cps.items():
        out[f"composite/pyr_soft/{h}x{w}"] = np.asarray(v)
    out["composite/fused_out"] = np.asarray(fused)
    print("composite: done", flush=True)

    out["sources_digest"] = np.array(golden_sources_digest())
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
