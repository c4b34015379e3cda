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
  * a 3-step PnP composite (fused, and two_pass=True: the batched capture
    over the source branches, then the consume): the inputs JAX's own
    _prepare_composite built from seeded frames, masks and trajectory
    stores, and both results;
  * 3 steps of plain DDIM sampling (ddim_sampling_core: cfg 3.0, no cfg,
    and eta 0.5 with the noise passed in);
  * at a 5 x 9 latent (halvings 3 x 5, 2 x 3, 1 x 2, the 720p geometry in
    miniature): a UNet forward, and one fused composite step with its mask
    pyramid on inputs JAX's _prepare_composite built;
  * the int8 path (`enable_int8(mode="full")`'s selection,
    `default_unet_predicate`): the quantized kernels (int8 data and scales),
    the plain forward in both layouts, the inversion and the fused
    composite, on the same inputs as the float cases, each with the tape
    of its activation quantizations (every (int8 activation, scale) pair in
    call order, taken with an ordered jax.debug.callback) for the port's
    tests to replay (mvoc_tpu_torch.utils.testing.ActivationTape);
  * the layer sets `quantize_params` selects at the full I2VGen-XL geometry
    under `default_unet_predicate` and `mixed_unet_predicate` (from
    `jax.eval_shape`, which takes ~10 s here);
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
ODD_LAT = (5, 9)  # a non-square latent whose halvings go odd, like 90 x 160 at 720p


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


class Tape:
    """Records every jq._quantize_activation of the programs traced while
    active, in execution order."""

    def __init__(self, jq):
        self.jq, self.records = jq, []

    def __enter__(self):
        import jax

        self.orig = self.jq._quantize_activation

        def taped(x, reduce_axes):
            q, scale = self.orig(x, reduce_axes)
            jax.debug.callback(lambda q, s: self.records.append((np.asarray(q), np.asarray(s))),
                               q, scale, ordered=True)
            return q, scale

        self.jq._quantize_activation = taped
        return self

    def __exit__(self, *exc):
        self.jq._quantize_activation = self.orig

    def store(self, out, case):
        """int8/tape/<case>/{q, s}: the flattened records end to end;
        .../{q_shapes, s_shapes}: their shapes, padded with -1."""
        def shapes(arrs):
            table = np.full((len(arrs), 6), -1, np.int64)
            for i, a in enumerate(arrs):
                table[i, :a.ndim] = a.shape
            return table

        qs, ss = [r[0] for r in self.records], [r[1] for r in self.records]
        out[f"int8/tape/{case}/q"] = np.concatenate([q.reshape(-1) for q in qs])
        out[f"int8/tape/{case}/s"] = np.concatenate([x.reshape(-1) for x in ss])
        out[f"int8/tape/{case}/q_shapes"] = shapes(qs)
        out[f"int8/tape/{case}/s_shapes"] = shapes(ss)
        print(f"tape {case}: {len(qs)} activation quantizations", flush=True)


def quantized_paths(tree, leaf_type):
    """Key paths (tuples of names) of the `leaf_type` leaves of a pytree."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]
    return [tuple(str(k.key) for k in path) for path, leaf in flat
            if isinstance(leaf, leaf_type)]


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
    from mvoc_tpu.ops import quantize as jq
    from mvoc_tpu.ops.ddim import SchedulerConfig, inversion_timesteps
    from mvoc_tpu.pipeline import core
    from mvoc_tpu.pipeline.i2vgen import I2VGenXLPipeline
    from mvoc_tpu.utils import testing as jtt

    out: dict[str, np.ndarray] = {}
    x1 = {k: jnp.asarray(v) for k, v in unet_inputs(1, 0).items()}
    shapes = jax.eval_shape(lambda: I2VGenXLUNet(UNetConfig.tiny()).init(jax.random.key(0), **x1))
    params = {"params": noisy_params(shapes["params"], np.random.default_rng(1))}
    flatten(params["params"], "params", out)
    # the int8 path as the JAX pipeline's enable_int8(mode="full") runs it (jitted)
    qparams = jax.jit(lambda p: jq.quantize_params(p, predicate=jq.default_unet_predicate))(params)
    for path in quantized_paths(qparams["params"], jq.QuantizedTensor):
        leaf = qparams["params"]
        for k in path:
            leaf = leaf[k]
        out["int8/params/" + "/".join(path) + "/data"] = np.asarray(leaf.data)
        out["int8/params/" + "/".join(path) + "/scale"] = np.asarray(leaf.scale)
    full_x = {k: jnp.asarray(v) for k, v in unet_inputs(1, 0).items()}
    d_full = UNetConfig().cross_attention_dim
    full_x.update(image_embeddings=jnp.zeros((1, F, d_full)),
                  encoder_hidden_states=jnp.zeros((1, 7, d_full)))
    full = jax.eval_shape(lambda: I2VGenXLUNet(UNetConfig()).init(jax.random.key(0), **full_x))
    for name, pred in (("default", jq.default_unet_predicate), ("mixed", jq.mixed_unet_predicate)):
        q = jax.eval_shape(lambda p: jq.quantize_params(p, predicate=pred), full["params"])
        out[f"int8/selection/{name}"] = np.array(
            sorted("/".join(p[:-1]) for p in quantized_paths(q, jq.QuantizedTensor)))
    print("int8 params and selections: done", flush=True)

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
        with Tape(jq) as tape:
            int8_out = jax.jit(unet.apply)(qparams, **plain_in)
            out[f"unet/{layout}/int8_out"] = np.asarray(int8_out)
            jax.effects_barrier()
        tape.store(out, f"unet_{layout}")
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
    with Tape(jq) as tape:
        out["invert/int8_trajectory"] = np.asarray(core.ddim_inversion_core(
            pipe._unet_apply, pipe.ddim, qparams, jnp.asarray(inv["x0"]), cond,
            jnp.asarray(ts), 50))
        jax.effects_barrier()
    tape.store(out, "invert")
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
    out["composite/two_pass_out"] = np.asarray(core.pnp_composite_core(
        pipe._unet_apply, pipe.ddim, params, init, ccond, sched, ms, cpb, cps,
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=True))
    with Tape(jq) as tape:
        out["composite/int8_fused_out"] = np.asarray(core.pnp_composite_core(
            pipe._unet_apply, pipe.ddim, qparams, init, ccond, sched, ms, cpb, cps,
            num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
            two_pass=False))
        jax.effects_barrier()
    tape.store(out, "composite")
    print("composite: done", flush=True)

    # plain DDIM sampling (the reconstruction path): 3 steps with cfg 3.0,
    # without cfg, and with eta > 0 and the noise passed in
    from mvoc_tpu.ops.ddim import sampling_timesteps

    r = np.random.default_rng(11)
    samp = dict(latents=r.standard_normal((F, LAT, LAT, 4)).astype(np.float32),
                encoder_hidden_states=r.standard_normal((2, 7, D)).astype(np.float32),
                image_latents_first=r.standard_normal((2, F, LAT, LAT, 4)).astype(np.float32),
                image_latents=r.standard_normal((2, F, LAT, LAT, 4)).astype(np.float32),
                image_embeddings=r.standard_normal((2, F, D)).astype(np.float32),
                fps=np.array([8, 8]),
                noise=r.standard_normal((3, F, LAT, LAT, 4)).astype(np.float32),
                timesteps=sampling_timesteps(SchedulerConfig(), 50)[10:13])
    for k, v in samp.items():
        out[f"sample/{k}"] = v
    cond2 = core.UNetConditioning(**{f.name: jnp.asarray(samp[f.name])
                                     for f in dataclasses.fields(core.UNetConditioning)})
    cond1 = jax.tree.map(lambda a: a[1:], cond2)
    for case, c, cfg, eta in (("cfg", cond2, 3.0, 0.0), ("nocfg", cond1, 1.0, 0.0),
                              ("eta", cond2, 3.0, 0.5)):
        out[f"sample/{case}_out"] = np.asarray(core.ddim_sampling_core(
            pipe._unet_apply, pipe.ddim, params, jnp.asarray(samp["latents"]), c,
            jnp.asarray(samp["timesteps"]), 50, cfg, eta=eta,
            noise=jnp.asarray(samp["noise"]) if eta > 0 else None))
    print("sampling: done", flush=True)

    # the 720p geometry in miniature: a 5 x 9 latent whose halvings go odd
    # (5x9 -> 3x5 -> 2x3 -> 1x2): one UNet forward, and one fused composite
    # step with its mask pyramid, on inputs JAX's _prepare_composite built
    OH, OW = ODD_LAT
    r = np.random.default_rng(12)
    odd_in = dict(sample=r.standard_normal((2, F, OH, OW, 4)).astype(np.float32),
                  timestep=np.array([981, 981]), fps=np.array([8, 8]),
                  image_latents_first=r.standard_normal((2, F, OH, OW, 4)).astype(np.float32),
                  image_latents=r.standard_normal((2, F, OH, OW, 4)).astype(np.float32),
                  image_embeddings=r.standard_normal((2, F, D)).astype(np.float32),
                  encoder_hidden_states=r.standard_normal((2, 7, D)).astype(np.float32))
    for k, v in odd_in.items():
        out[f"odd/unet/{k}"] = v
    out["odd/unet/out"] = np.asarray(jax.jit(unet.apply)(params, **odd_in))
    with tempfile.TemporaryDirectory() as root:
        its = inversion_timesteps(SchedulerConfig(), N_STEPS)
        stores = []
        for j in range(N_OBJ + 1):
            path = os.path.join(root, f"v{j}")
            TrajectoryStore(path, prefer_native=False).save(
                its, r.standard_normal((len(its), F, OH, OW, 4)).astype(np.float32))
            stores.append(TrajectoryStore(path))
        from PIL import Image

        frames = [[Image.fromarray(r.integers(0, 255, (2 * OH, 2 * OW, 3), dtype=np.uint8))
                   for _ in range(F)] for _ in range(N_OBJ + 2)]
        o_binary = np.zeros((N_OBJ, F, OH, OW), np.float32)
        o_binary[0, :, : OH // 2 + 1] = 1.0
        o_binary[1, :, :, OW // 2:] = 1.0
        o_soft = np.clip(o_binary * 0.7 + 0.2, 0, 1).astype(np.float32)
        init, ccond, sched, ms, cpb, cps, _ = pipe._prepare_composite(
            "a cat", frames[0][0], frames[0], frames[1], frames[2:], o_soft, o_binary,
            stores[0], stores[1:], height=2 * OH, width=2 * OW, num_frames=F,
            num_inference_steps=N_STEPS, guidance_scale=3.0, fusion_steps=(0, 1), seed=4)
    # the schedule cut to its first run step (t = 501: injection and fusion on)
    sched = dataclasses.replace(sched, **{
        f.name: getattr(sched, f.name)[:1] for f in dataclasses.fields(sched)
        if f.name != "obj_fusion_lat"})
    odd = core.pnp_composite_core(
        pipe._unet_apply, pipe.ddim, params, init, ccond, sched, ms, cpb, cps,
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=False)
    out["odd/composite/init"] = np.asarray(init)
    for f in dataclasses.fields(core.UNetConditioning):
        out[f"odd/composite/cond/{f.name}"] = np.asarray(getattr(ccond, f.name))
    for f in dataclasses.fields(core.CompositeSchedule):
        out[f"odd/composite/sched/{f.name}"] = np.asarray(getattr(sched, f.name))
    out["odd/composite/masks_soft"] = np.asarray(ms)
    out["odd/composite/masks_binary"] = o_binary
    for (h, w), v in cpb.items():
        out[f"odd/composite/pyr_bin/{h}x{w}"] = np.asarray(v)
    for (h, w), v in cps.items():
        out[f"odd/composite/pyr_soft/{h}x{w}"] = np.asarray(v)
    out["odd/composite/fused_out"] = np.asarray(odd)
    print("odd geometry: done", flush=True)

    out["sources_digest"] = np.array(golden_sources_digest())
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
