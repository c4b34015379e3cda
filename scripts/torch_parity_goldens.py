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
  * a 3-step DDIM inversion (inputs and trajectory), and the same batched
    over J = 2 videos (ddim_inversion_batch_core: today's inputs as video
    0, seeded ones as video 1);
  * a 3-step PnP composite (fused, and two_pass=True: the batched capture
    over the source branches, then the consume): the inputs JAX's own
    _prepare_composite built from seeded frames, masks and trajectory
    stores, and both results; and the batched composite over J = 2
    entries (pnp_composite_batch_core: that entry, and a second one with
    another prompt, seed and masks) fused, two_pass=True and stream;
  * the reuse and broadcast modes on those inputs, each at k = 2: the
    inversion with encoder reuse, with deep reuse, with reuse depth 1, and
    batched (J = 2, deep); the composite with encoder reuse on all three
    paths, with depth 1 (fused), PAB (fused), capture reuse (two_pass=True
    and stream), deep capture reuse (stream), and the batched stream
    composite with deep capture reuse (REUSE_COMPOSITES);
  * UNet forwards with FreeU (at a 16 x 16 latent) and with
    multi_frame_guidance;
  * the drift harness of mvoc_tpu/utils/quality.py (`_TinyHarness(seed=0)`):
    its parameters and inputs, its exact stream composite and inversion,
    and its approx_quality_report over tests/test_approx_quality.py's modes,
    PAB and the float inversion modes, plus one stale capture;
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
  * the device mesh, on JAX's 8-device CPU mesh (XLA_FLAGS
    --xla_force_host_platform_device_count=8, set here): the tiny UNet
    under (seq 4, model 2) in both temporal layouts on 4-frame inputs, the
    64-frame UNet with `temporal_window: 8` and ring context parallelism of
    tests/test_parallel.py (seq 4), and one fused composite step of the
    composite case under enable_mesh(8, seq=2) (2 frames over seq 2,
    model 4);
  * the matmul-class operation counts of mvoc_tpu/utils/flops.py
    (`jaxpr_matmul_flops_by_class`, trace only; flops/*): the full-width
    I2VGen-XL UNet forward (5 branches, 16 frames, 64 x 64 latents, the
    natural temporal layout) in float and under `mixed_unet_predicate`'s
    int8 selection, and one step of each path of the pipeline cores on the
    composite and inversion inputs above (fused, two_pass=True, stream, the
    inversion, the fused composite under the int8 "full" selection, and a
    fresh then a cached step of encoder reuse k = 2 on the fused composite
    and of deep reuse k = 2 on the inversion), each with its int8 products
    (int8 operands), the `cond`s in its program, and its conv and dot
    counts with every temporal conv as a convolution (`tconv_override("xla")`;
    JAX runs the small ones as a dot_general);
  * a digest of the sources these outputs come from
    (tests/torch_support.py: GOLDEN_SOURCES).

tests/test_torch_unet.py and tests/test_torch_pipeline.py run the port on the
same inputs and compare; they also check that the stored param tree still
has the shapes of the JAX modules, and fail while the digest differs from
that of the sources on disk.  Rerun after changing the JAX package or these
cases:

    JAX_PLATFORMS=cpu python scripts/torch_parity_goldens.py

`--mesh-only` recomputes only the mesh cases from the params and inputs
already in the file (a few minutes) and rewrites it with the new digest;
the other cases depend on none of the mesh code.  `--flops-only` does the
same for the flops/* counts (under a minute).
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
from torch_support import golden_sources_digest, nest, noisy_params  # noqa: E402

# the mesh cases need JAX's 8 virtual CPU devices, fixed before JAX starts
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

F, HW, LAT, D = 2, 16, 8, 16
N_OBJ = 2
N_STEPS = 4  # 4-step schedule, t_idx 1 -> 3 composite steps
ODD_LAT = (5, 9)  # a non-square latent whose halvings go odd, like 90 x 160 at 720p
# the composite's reuse and broadcast modes: (name, "depth1" or the plain
# apply, two_pass, the core's keywords), all at k = 2 over the 3 run steps
REUSE_COMPOSITES = (
    ("fused_k2", None, False, dict(encoder_reuse_interval=2)),
    ("two_pass_k2", None, True, dict(encoder_reuse_interval=2)),
    ("stream_k2", None, "stream", dict(encoder_reuse_interval=2)),
    ("fused_k2_depth1", "depth1", False, dict(encoder_reuse_interval=2)),
    ("fused_pab_k2", None, False, dict(pab_interval=2)),
    ("two_pass_capture_k2", None, True, dict(capture_reuse_interval=2)),
    ("stream_capture_k2", None, "stream", dict(capture_reuse_interval=2)),
    ("stream_capture_deep_k2", None, "stream",
     dict(capture_reuse_interval=2, capture_reuse_deep=True)),
)
EXTRAS_FREEU = dict(s1=0.9, s2=0.2, b1=1.1, b2=1.2)
# the drift harness's composite modes in the goldens: tests/test_approx_quality.py's
# CI modes and PAB
QUALITY_COMPOSITE = ("encoder_reuse_k2", "capture_reuse_k2", "capture_reuse_k2_deep", "pab_k2")


def unet_inputs(b, seed, f=F):
    r = np.random.default_rng(seed)

    def mk(*s):
        return r.standard_normal(s).astype(np.float32)

    return dict(sample=mk(b, f, LAT, LAT, 4), timestep=np.array([981] * b),
                fps=np.array([8] * b), image_latents_first=mk(b, f, LAT, LAT, 4),
                image_latents=mk(b, f, LAT, LAT, 4), image_embeddings=mk(b, f, D),
                encoder_hidden_states=mk(b, 7, D))


# the mesh cases: (inputs seed, batch, frames) of the (seq 4, model 2) UNet
# and of the 64-frame ring UNet (tests/torch_parallel_worker.py draws the same)
MESH_UNET = (31, 2, 4)
MESH_RING = (41, 1, 64)
RING_WINDOW = 8


def mesh_cases(out: dict) -> None:
    """The JAX package on its 8-device CPU mesh, from the params and composite
    inputs in `out`: adds mesh/* to it."""
    import jax
    import jax.numpy as jnp

    from mvoc_tpu.models import clip as jclip
    from mvoc_tpu.models import vae as jvae
    from mvoc_tpu.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
    from mvoc_tpu.ops.ddim import SchedulerConfig
    from mvoc_tpu.parallel import mesh as pm
    from mvoc_tpu.pipeline import core
    from mvoc_tpu.pipeline.i2vgen import I2VGenXLPipeline
    from mvoc_tpu.utils import testing as jtt

    assert len(jax.devices()) == 8, jax.devices()
    params = {"params": nest(out, "params")}

    def sharded_inputs(seed, b, f, mesh):
        x = unet_inputs(b, seed, f)
        xs = {k: jnp.asarray(v) for k, v in x.items()}
        for key in ("sample", "image_latents_first", "image_latents"):
            xs[key] = pm.shard_video(xs[key], mesh)
        return x, xs

    mesh = pm.make_mesh(8, seq=4)
    assert dict(mesh.shape) == {"job": 1, "seq": 4, "model": 2}
    params_s = pm.shard_params(params, mesh)
    x, xs = sharded_inputs(*MESH_UNET, mesh)
    for k, v in x.items():
        out[f"mesh/unet/inputs/{k}"] = v
    for layout, natural in (("standard", False), ("natural", True)):
        unet = I2VGenXLUNet(dataclasses.replace(UNetConfig.tiny(), attn_mesh=mesh,
                                                temporal_natural_layout=natural))
        out[f"mesh/unet/{layout}_out"] = np.asarray(jax.jit(unet.apply)(params_s, **xs))
    print("mesh unet: done", flush=True)

    x, xs = sharded_inputs(*MESH_RING, mesh)
    for k, v in x.items():
        out[f"mesh/ring/inputs/{k}"] = v
    unet = I2VGenXLUNet(dataclasses.replace(UNetConfig.tiny(), temporal_window=RING_WINDOW,
                                            temporal_cp=("ring", mesh)))
    out["mesh/ring/out"] = np.asarray(jax.jit(unet.apply)(params_s, **xs))
    print("mesh ring unet: done", flush=True)

    unet = I2VGenXLUNet(UNetConfig.tiny())
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    text = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny())
    vision = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig.tiny())
    pipe_params = {k: {"params": nest(out, f"pipe/{k}")}
                   for k in ("vae", "text_encoder", "image_encoder")}
    pipe_params["unet"] = params
    pipe = I2VGenXLPipeline(unet, vae, text, vision, pipe_params, SchedulerConfig(),
                            tokenizer=jtt.DummyTokenizer(64, 12))
    pipe.enable_mesh(8, seq=2)
    sched = core.CompositeSchedule(**{
        f.name: jnp.asarray(out[f"composite/sched/{f.name}"])[:1]
        if f.name != "obj_fusion_lat" else jnp.asarray(out[f"composite/sched/{f.name}"])
        for f in dataclasses.fields(core.CompositeSchedule)})
    cond = core.UNetConditioning(**{f.name: jnp.asarray(out[f"composite/cond/{f.name}"])
                                    for f in dataclasses.fields(core.UNetConditioning)})

    def pyramid(name):
        prefix = f"composite/{name}/"
        return {tuple(int(n) for n in k[len(prefix):].split("x")): jnp.asarray(v)
                for k, v in out.items() if k.startswith(prefix)}

    out["mesh/composite/fused_1step_out"] = np.asarray(core.pnp_composite_core(
        pipe._unet_apply, pipe.ddim, pipe.params["unet"],
        pipe._shard_video(jnp.asarray(out["composite/init"]), 0), pipe._shard_cond(cond), sched,
        jnp.asarray(out["composite/masks_soft"]), pyramid("pyr_bin"), pyramid("pyr_soft"),
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=False))
    print("mesh composite step: done", flush=True)


# the full-width UNet forward the flops/* counts take: branches, frames, latent side
FLOPS_FULL = (5, 16, 64)
# the steps of the pipeline cores the flops/* counts take: (name, two_pass or
# "invert", int8, the core's keywords, run steps)
FLOPS_STEPS = (
    ("fused", False, False, {}, 1),
    ("two_pass", True, False, {}, 1),
    ("stream", "stream", False, {}, 1),
    ("invert", "invert", False, {}, 1),
    ("int8_fused", False, True, {}, 1),
    ("fused_k2", False, False, dict(encoder_reuse_interval=2), 2),
    ("invert_k2_deep", "invert", False, dict(encoder_reuse_interval=2, deep_reuse=True), 2),
)


def jaxpr_counts(fn, *args) -> dict:
    """mvoc_tpu/utils/flops.py's jaxpr_matmul_flops_by_class of fn(*args),
    plus, by the same walk (scan bodies times their length, a cond's most
    expensive branch), "int8": the dot_general and conv products with int8
    operands, and "conds": the number of cond equations executed."""
    import jax
    import jax.numpy as jnp

    from mvoc_tpu.utils import flops as FL

    out = FL.jaxpr_matmul_flops_by_class(fn, *args)
    spec = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
                        if hasattr(x, "shape") else x, args)

    def walk(jaxpr):
        int8, conds = 0.0, 0.0
        for eqn in jaxpr.eqns:
            prim = eqn.primitive.name
            if prim in ("dot_general", "conv_general_dilated"):
                if eqn.invars[0].aval.dtype == jnp.int8:
                    int8 += (FL._eqn_dot_flops if prim == "dot_general"
                             else FL._eqn_conv_flops)(eqn)
            elif prim == "scan":
                i, c = walk(eqn.params["jaxpr"].jaxpr)
                int8, conds = int8 + eqn.params["length"] * i, conds + eqn.params["length"] * c
            elif prim == "cond":
                best = max((walk(b.jaxpr) for b in eqn.params["branches"]), key=lambda r: r[0])
                int8, conds = int8 + best[0], conds + 1 + best[1]
            elif prim == "while":
                i, c = walk(eqn.params["body_jaxpr"].jaxpr)
                int8, conds = int8 + i, conds + c
            else:
                for v in eqn.params.values():
                    inner = getattr(v, "jaxpr", v if hasattr(v, "eqns") else None)
                    if inner is not None and hasattr(inner, "eqns"):
                        i, c = walk(inner)
                        int8, conds = int8 + i, conds + c
        return int8, conds

    out["int8"], out["conds"] = walk(jax.make_jaxpr(fn)(*spec).jaxpr)
    return out


def flops_cases(out: dict) -> None:
    """The JAX package's operation counts (trace only), from the params and
    inputs in `out`: adds flops/* to it."""
    import jax
    import jax.numpy as jnp

    from mvoc_tpu import pnp as jp
    from mvoc_tpu.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
    from mvoc_tpu.ops import conv as conv_forms
    from mvoc_tpu.ops import quantize as jq
    from mvoc_tpu.ops.ddim import DDIM, SchedulerConfig
    from mvoc_tpu.pipeline import core

    def store(name, counts):
        for k, v in counts.items():
            out[f"flops/{name}/{k}"] = np.asarray(float(v))
        print(f"flops {name}: { {k: float(v) for k, v in counts.items()} }", flush=True)

    b, f, lat = FLOPS_FULL
    full = I2VGenXLUNet(dataclasses.replace(UNetConfig(), temporal_natural_layout=True))
    d = full.config.cross_attention_dim
    sds = jax.ShapeDtypeStruct
    x = dict(sample=sds((b, f, lat, lat, 4), jnp.float32), timestep=sds((b,), jnp.int32),
             fps=sds((b,), jnp.int32), image_latents_first=sds((b, f, lat, lat, 4), jnp.float32),
             image_latents=sds((b, f, lat, lat, 4), jnp.float32),
             image_embeddings=sds((b, f, d), jnp.float32),
             encoder_hidden_states=sds((b, 77, d), jnp.float32))
    fparams = jax.eval_shape(lambda x: full.init(jax.random.key(0), **x), x)
    store("unet_full", jaxpr_counts(lambda p, x: full.apply(p, **x), fparams, x))
    qfull = jax.eval_shape(lambda p: jq.quantize_params(p, predicate=jq.mixed_unet_predicate),
                           fparams)
    store("unet_full_int8_mixed", jaxpr_counts(lambda p, x: full.apply(p, **x), qfull, x))

    params = {"params": nest(out, "params")}
    qparams = jax.eval_shape(
        lambda p: jq.quantize_params(p, predicate=jq.default_unet_predicate), params)
    unet = I2VGenXLUNet(UNetConfig.tiny())
    unet_apply = lambda p, **kw: unet.apply(p, **kw)  # noqa: E731
    ddim = DDIM(SchedulerConfig())
    sched = core.CompositeSchedule(**{f.name: jnp.asarray(out[f"composite/sched/{f.name}"])
                                      for f in dataclasses.fields(core.CompositeSchedule)})
    ccond = core.UNetConditioning(**{f.name: jnp.asarray(out[f"composite/cond/{f.name}"])
                                     for f in dataclasses.fields(core.UNetConditioning)})

    def pyramid(name):
        prefix = f"composite/{name}/"
        return {tuple(int(n) for n in k[len(prefix):].split("x")): jnp.asarray(v)
                for k, v in out.items() if k.startswith(prefix)}

    pb, ps = pyramid("pyr_bin"), pyramid("pyr_soft")
    cw = jp.build_capture_weights(pb, ps, True)
    icond = core.UNetConditioning(**{f.name: jnp.asarray(out[f"invert/{f.name}"])
                                     for f in dataclasses.fields(core.UNetConditioning)})
    for name, two_pass, int8, kw, n in FLOPS_STEPS:
        p = qparams if int8 else params
        if two_pass == "invert":
            fn = lambda p: core.ddim_inversion_core(  # noqa: E731
                unet_apply, ddim, p, jnp.asarray(out["invert/x0"]), icond,
                jnp.asarray(out["invert/timesteps"][:n]), 50, **kw)
        else:
            one = dataclasses.replace(sched, **{
                f.name: getattr(sched, f.name)[:n] for f in dataclasses.fields(sched)
                if f.name != "obj_fusion_lat"})
            fn = lambda p: core.pnp_composite_core(  # noqa: E731
                unet_apply, ddim, p, jnp.asarray(out["composite/init"]), ccond, one,
                jnp.asarray(out["composite/masks_soft"]), pb, ps, num_inference_steps=N_STEPS,
                guidance_scale=3.0, random_noise_ratio=0.3, two_pass=two_pass,
                capture_weights=cw if two_pass == "stream" else None, **kw)
        counts = jaxpr_counts(fn, p)
        # JAX runs the small (3,1,1) temporal convs as a dot_general
        # (ops/conv.py: tconv3_stack3), the port as a convolution
        with conv_forms.tconv_override("xla"):
            xla = jaxpr_counts(fn, p)
        counts.update(conv_xla=xla["conv"], dot_xla=xla["dot"])
        store(f"step/{name}", counts)


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
    # the same inversion batched over two videos: video 0 as above, video 1 seeded
    inv1 = dict(x0=mk(F, LAT, LAT, 4), encoder_hidden_states=mk(1, 7, D),
                image_latents_first=mk(1, F, LAT, LAT, 4), image_latents=mk(1, F, LAT, LAT, 4),
                image_embeddings=mk(1, F, D), fps=np.array([8]))
    inv2 = {k: np.concatenate([inv[k][None] if k == "x0" else inv[k],
                               inv1[k][None] if k == "x0" else inv1[k]]) for k in inv}
    cond2 = core.UNetConditioning(**{k: jnp.asarray(v) for k, v in inv2.items() if k != "x0"})
    for k, v in inv2.items():
        out[f"invert_batch/{k}"] = v
    out["invert_batch/trajectory"] = np.asarray(core.ddim_inversion_batch_core(
        pipe._unet_apply, pipe.ddim, params, jnp.asarray(inv2["x0"]), cond2, jnp.asarray(ts), 50))
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
        init, ccond, sched, ms, cpb, cps, ccw = pipe._prepare_composite(
            "a cat", frames[0][0], frames[0], frames[1], frames[2:], c_soft, c_binary,
            stores[0], stores[1:], height=HW, width=HW, num_frames=F,
            num_inference_steps=N_STEPS, guidance_scale=3.0, fusion_steps=(0, 1),
            two_pass="stream", seed=3)
        # a second entry for the batched composite: same sources, another
        # prompt and seed, the objects' masks moved
        b_binary = np.zeros((N_OBJ, F, LAT, LAT), np.float32)
        b_binary[0, :, LAT // 2:, LAT // 4:] = 1.0
        b_binary[1, :, : 3 * LAT // 4, LAT // 2:] = 1.0
        b_soft = np.clip(b_binary * 0.6 + 0.3, 0, 1).astype(np.float32)
        second = pipe._prepare_composite(
            "a dog on a boat", frames[0][0], frames[0], frames[1], frames[2:], b_soft, b_binary,
            stores[0], stores[1:], height=HW, width=HW, num_frames=F,
            num_inference_steps=N_STEPS, guidance_scale=3.0, fusion_steps=(0, 1),
            two_pass="stream", seed=5)
        batch = jax.tree.map(lambda *xs: jnp.stack(xs),
                             (init, ccond, sched, ms, cpb, cps, ccw), second)
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
    b_init, b_cond, b_sched, b_ms, b_pb, b_ps, b_cw = batch
    out["composite_batch/init"] = np.asarray(b_init)
    for f in dataclasses.fields(core.UNetConditioning):
        out[f"composite_batch/cond/{f.name}"] = np.asarray(getattr(b_cond, f.name))
    for f in dataclasses.fields(core.CompositeSchedule):
        out[f"composite_batch/sched/{f.name}"] = np.asarray(getattr(b_sched, f.name))
    out["composite_batch/masks_soft"] = np.asarray(b_ms)
    for (h, w), v in b_pb.items():
        out[f"composite_batch/pyr_bin/{h}x{w}"] = np.asarray(v)
    for (h, w), v in b_ps.items():
        out[f"composite_batch/pyr_soft/{h}x{w}"] = np.asarray(v)
    for name, two_pass in (("fused", False), ("two_pass", True), ("stream", "stream")):
        out[f"composite_batch/{name}_out"] = np.asarray(core.pnp_composite_batch_core(
            pipe._unet_apply, pipe.ddim, params, b_init, b_cond, b_sched, b_ms, b_pb, b_ps,
            capture_weights=b_cw if two_pass == "stream" else None,
            num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
            two_pass=two_pass))
        print(f"batched composite {name}: done", flush=True)
    print("composite: done", flush=True)

    # the reuse and broadcast modes, on the same inputs as the exact runs above
    depth1 = lambda p, **kw: unet.apply(p, **kw, encoder_reuse_depth=1)  # noqa: E731
    for name, apply, kw in (("k2", pipe._unet_apply, dict(encoder_reuse_interval=2)),
                            ("k2_deep", pipe._unet_apply,
                             dict(encoder_reuse_interval=2, deep_reuse=True)),
                            ("k2_depth1", depth1, dict(encoder_reuse_interval=2))):
        out[f"reuse/invert/{name}"] = np.asarray(core.ddim_inversion_core(
            apply, pipe.ddim, params, jnp.asarray(inv["x0"]), cond, jnp.asarray(ts), 50, **kw))
    out["reuse/invert_batch/k2_deep"] = np.asarray(core.ddim_inversion_batch_core(
        pipe._unet_apply, pipe.ddim, params, jnp.asarray(inv2["x0"]), cond2, jnp.asarray(ts), 50,
        encoder_reuse_interval=2, deep_reuse=True))
    print("reuse inversion: done", flush=True)
    for name, apply, two_pass, kw in REUSE_COMPOSITES:
        out[f"reuse/composite/{name}"] = np.asarray(core.pnp_composite_core(
            depth1 if apply == "depth1" else pipe._unet_apply, pipe.ddim, params, init, ccond,
            sched, ms, cpb, cps, num_inference_steps=N_STEPS, guidance_scale=3.0,
            random_noise_ratio=0.3, two_pass=two_pass,
            capture_weights=ccw if two_pass == "stream" else None, **kw))
        print(f"reuse composite {name}: done", flush=True)
    out["reuse/composite_batch/stream_capture_deep_k2"] = np.asarray(
        core.pnp_composite_batch_core(
            pipe._unet_apply, pipe.ddim, params, b_init, b_cond, b_sched, b_ms, b_pb, b_ps,
            capture_weights=b_cw, num_inference_steps=N_STEPS, guidance_scale=3.0,
            random_noise_ratio=0.3, two_pass="stream", capture_reuse_interval=2,
            capture_reuse_deep=True))
    print("reuse: done", flush=True)

    # FreeU and multi_frame_guidance: UNet forwards (FreeU at a 16 x 16 latent,
    # so that up blocks 0 and 1 filter 2 x 2 and 4 x 4 skips)
    from mvoc_tpu.models.unet_i2vgen import FreeUConfig

    r = np.random.default_rng(13)
    big = dict(sample=r.standard_normal((2, F, 16, 16, 4)).astype(np.float32),
               timestep=np.array([501, 501]), fps=np.array([8, 8]),
               image_latents_first=r.standard_normal((2, F, 16, 16, 4)).astype(np.float32),
               image_latents=r.standard_normal((2, F, 16, 16, 4)).astype(np.float32),
               image_embeddings=r.standard_normal((2, F, D)).astype(np.float32),
               encoder_hidden_states=r.standard_normal((2, 7, D)).astype(np.float32))
    for k, v in big.items():
        out[f"extras/unet16/{k}"] = v
    freeu = FreeUConfig(**EXTRAS_FREEU)
    out["extras/freeu_out"] = np.asarray(jax.jit(
        lambda p, x: unet.apply(p, **x, freeu=freeu))(params, big))
    out["extras/mfg_out"] = np.asarray(jax.jit(
        lambda p, x: unet.apply(p, **x, multi_frame_guidance=True))(params, plain_in))
    print("extras: done", flush=True)

    # the drift harness of mvoc_tpu/utils/quality.py: its parameters and
    # inputs, and its report over the modes tests/test_approx_quality.py pins
    # plus PAB and the inversion modes (int8 left out: its comparisons need the
    # activation tape), and one stale capture broadcast over every step
    from mvoc_tpu.utils import quality as jquality

    h = jquality._TinyHarness(seed=0)
    flatten(h.params["params"], "quality/params", out)
    for name in ("x0", "xT", "masks"):
        out[f"quality/{name}"] = np.asarray(getattr(h, name))
    for tag, c in (("cond1", h.cond1), ("condN", h.condN)):
        for f in dataclasses.fields(core.UNetConditioning):
            out[f"quality/{tag}/{f.name}"] = np.asarray(getattr(c, f.name))
    comp_modes = tuple(m for m in jquality.COMPOSITE_MODES if m[0] in QUALITY_COMPOSITE)
    inv_modes = tuple(m for m in jquality.INVERSION_MODES if "int8" not in m[0])
    report = jquality.approx_quality_report(composite_modes=comp_modes,
                                            inversion_modes=inv_modes, harness=h)
    stale = h.run_composite(capture_reuse_interval=h.compose_steps * 2)
    report["capture_reuse_stale"] = jquality.latent_metrics(stale, h.run_composite())
    for mode, metrics in report.items():
        for k, v in metrics.items():
            out[f"quality/report/{mode}/{k}"] = np.asarray(v)
    out["quality/exact_stream"] = h.run_composite()
    out["quality/exact_inversion"] = h.run_inversion()
    print(f"quality harness: {report}", flush=True)

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

    mesh_cases(out)
    flops_cases(out)
    out["sources_digest"] = np.array(golden_sources_digest())
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT) / 1e6:.2f} MB")
    return 0


def only(prefix: str, cases) -> int:
    """Recompute the cases under `prefix` from the params and inputs already
    in the file, and rewrite it with the digest of the sources on disk."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    sys.path.insert(0, ROOT)
    with np.load(OUT) as z:
        out = {k: z[k] for k in z.files if not k.startswith(prefix)}
    cases(out)
    out["sources_digest"] = np.array(golden_sources_digest())
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    if "--mesh-only" in sys.argv[1:]:
        sys.exit(only("mesh/", mesh_cases))
    if "--flops-only" in sys.argv[1:]:
        sys.exit(only("flops/", flops_cases))
    sys.exit(main())
