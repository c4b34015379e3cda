"""The ranks of tests/test_torch_parallel.py: each spawned process joins a
gloo process group on the CPU, builds the port's tiny models from the
goldens' weights, runs every case of its world on a (job, seq, model) mesh,
and rank 0 writes the full results (numpy) for the test module to compare.
Imports no JAX, so that a rank starts in seconds."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from mvoc_tpu_torch import pnp as tp
from mvoc_tpu_torch.models import clip as tclip
from mvoc_tpu_torch.models import convert as tconvert
from mvoc_tpu_torch.models import layers as tlayers
from mvoc_tpu_torch.models import vae as tvae
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.ops import attention as tattn
from mvoc_tpu_torch.ops import quantize as tq
from mvoc_tpu_torch.ops import ring_attention as tring
from mvoc_tpu_torch.ops.ddim import SchedulerConfig
from mvoc_tpu_torch.parallel import collectives as coll
from mvoc_tpu_torch.parallel import mesh as pm
from mvoc_tpu_torch.pipeline import core as tcore
from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline
from mvoc_tpu_torch.utils import testing as tt
from torch_support import NICENESS, load_goldens, nest

UNET_ARGS = ("sample", "timestep", "fps", "image_latents_first", "image_latents",
             "image_embeddings", "encoder_hidden_states")
N_STEPS = 4
MESH_F = 4  # frames of the mesh UNet inputs (split over seq = 2 and 4)
RING_F, RING_WINDOW = 64, 8
JOB_F, JOB_STEPS = 4, 3
ATTN = dict(b=2, s=16, heads=4, d=8, window=5)
FLASH_SHAPES = ((8, 4, 1037), (5, 3, 1111))  # tests/test_sharded_kernels.py
FRAME_NATURAL, FRAME_SF = (2, 8, 64, 16), (128, 8, 16)


def attention_inputs(seed: int = 21) -> dict:
    """The attention cases' inputs (the test module builds the same)."""
    r = np.random.default_rng(seed)

    def mk(*s):
        return r.standard_normal(s).astype(np.float32)

    a = ATTN
    out = {f"ring_{n}": mk(a["b"], a["s"], a["heads"] * a["d"]) for n in "qkv"}
    for b, h, sq in FLASH_SHAPES:
        for n in "qkv":
            out[f"flash_{b}x{h}x{sq}_{n}"] = mk(b, h, sq, 16)
    for n in "qkv":
        out[f"frame_natural_{n}"] = mk(*FRAME_NATURAL)
        out[f"frame_sf_{n}"] = mk(*FRAME_SF)
    return out


def unet_inputs(b: int, f: int, seed: int, lat: int = 8, d: int = 16) -> dict:
    r = np.random.default_rng(seed)

    def mk(*s):
        return r.standard_normal(s).astype(np.float32)

    return dict(sample=mk(b, f, lat, lat, 4), timestep=np.array([981] * b),
                fps=np.array([8] * b), image_latents_first=mk(b, f, lat, lat, 4),
                image_latents=mk(b, f, lat, lat, 4), image_embeddings=mk(b, f, d),
                encoder_hidden_states=mk(b, 7, d))


def torch_args(x: dict) -> list:
    return [torch.as_tensor(x[k]) for k in UNET_ARGS]


def tiny_unet(params, **cfg) -> I2VGenXLUNet:
    unet = I2VGenXLUNet(dataclasses.replace(UNetConfig.tiny(), **cfg))
    unet.load_state_dict(tconvert.unet_state_dict_from_flax(params), strict=True)
    return unet.eval()


def golden_pipeline(goldens) -> I2VGenXLPipeline:
    """The port's tiny pipeline with the goldens' weights (test_torch_pipeline's)."""
    p = lambda name: nest(goldens, f"pipe/{name}")
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny())
    tv.load_state_dict(tconvert.vae_state_dict_from_flax(p("vae")), strict=True)
    ttext = tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny())
    ttext.load_state_dict(tconvert.clip_text_state_dict_from_flax(p("text_encoder")), strict=True)
    tvis = tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig.tiny())
    tvis.load_state_dict(tconvert.clip_vision_state_dict_from_flax(p("image_encoder")),
                         strict=True)
    return I2VGenXLPipeline(tiny_unet(nest(goldens, "params")), tv, ttext, tvis, SchedulerConfig(),
                            tokenizer=tt.DummyTokenizer(64, 12), device="cpu")


def golden_cond(goldens, prefix: str) -> tcore.UNetConditioning:
    return tcore.UNetConditioning(**{
        f.name: torch.from_numpy(goldens[f"{prefix}/{f.name}"])
        for f in dataclasses.fields(tcore.UNetConditioning)})


def golden_composite(goldens, pipe, two_pass, steps: int = 3):
    """The composite core on the inputs JAX's _prepare_composite built
    (test_torch_pipeline's), over the first `steps` run steps."""
    s = lambda name: goldens[f"composite/sched/{name}"][:steps]
    sched = tcore.CompositeSchedule(
        bg_traj=torch.from_numpy(s("bg_traj")), obj_traj=torch.from_numpy(s("obj_traj")),
        obj_fusion_lat=torch.from_numpy(goldens["composite/sched/obj_fusion_lat"]),
        gate_spatial=s("gate_spatial"), gate_temporal=s("gate_temporal"),
        gate_conv=s("gate_conv"), fusion_mask=s("fusion_mask"), timesteps=s("timesteps"))

    def pyramid(name):
        prefix = f"composite/{name}/"
        return {tuple(int(n) for n in k[len(prefix):].split("x")): torch.from_numpy(v)
                for k, v in goldens.items() if k.startswith(prefix)}

    pb, ps = pyramid("pyr_bin"), pyramid("pyr_soft")
    return tcore.pnp_composite_core(
        pipe.unet, pipe.ddim, torch.from_numpy(goldens["composite/init"]),
        golden_cond(goldens, "composite/cond"), sched,
        torch.from_numpy(goldens["composite/masks_soft"]), pb, ps,
        num_inference_steps=N_STEPS, guidance_scale=3.0, random_noise_ratio=0.3,
        two_pass=two_pass,
        capture_weights=tp.build_capture_weights(pb, ps, True) if two_pass == "stream"
        else None).numpy()


def golden_inversion(goldens, pipe):
    return tcore.ddim_inversion_core(
        pipe.unet, pipe.ddim, torch.from_numpy(goldens["invert/x0"]),
        golden_cond(goldens, "invert"), goldens["invert/timesteps"], 50).numpy()


class ShardedReplay(tt.ActivationTape):
    """Replays a single-rank run's activation tape in a rank of a mesh: each
    record is cut to this rank's block first, its frames of the running
    frame shard (the frame axis is the minor factor of a merged B*F axis)
    on any axis but the last, its "model" share of a row-split layer's
    contraction on the last."""

    def __init__(self, records, mesh):
        super().__init__(records)
        self.mesh = mesh

    def _local(self, rec: torch.Tensor, shape) -> torch.Tensor:
        fs = pm.current_frame_shard()
        for dim, (full, loc) in enumerate(zip(rec.shape, shape)):
            if full == loc:
                continue
            if dim == rec.ndim - 1:
                rec = rec.chunk(self.mesh.size_of(pm.MODEL_AXIS), dim=dim)[
                    self.mesh.rank_of(pm.MODEL_AXIS)]
                continue
            lead = full // fs.frames
            v = rec.reshape(*rec.shape[:dim], lead, fs.frames, *rec.shape[dim + 1:])
            v = v.narrow(dim + 1, fs.offset, fs.local)
            rec = v.reshape(*rec.shape[:dim], lead * fs.local, *rec.shape[dim + 1:])
        return rec

    def _replay(self, q, s):
        rq, rs = self.records[self.calls]
        self.records[self.calls] = (self._local(torch.as_tensor(rq), q.shape),
                                    self._local(torch.as_tensor(rs), s.shape))
        return super()._replay(q, s)


# ---------------------------------------------------------------------------
# cases: each returns {name: numpy array}, the same on every rank
# ---------------------------------------------------------------------------


def case_attention(mesh, goldens, tmp):
    x = {k: torch.from_numpy(v) for k, v in attention_inputs().items()}
    out = {}
    a = ATTN
    seq, r = mesh.size_of("seq"), mesh.rank_of("seq")
    loc = lambda t, dim: t.chunk(seq, dim=dim)[r]
    for method in ("ring", "ulysses"):
        for window in (None, a["window"]):
            got = tring.ring_sdpa(*(loc(x[f"ring_{n}"], 1) for n in "qkv"), a["heads"], mesh,
                                  "seq", method, window)
            out[f"attn/{method}_{window}"] = coll.all_gather(got, mesh, "seq", 1).numpy()
    for b, h, sq in FLASH_SHAPES:
        key = f"flash_{b}x{h}x{sq}"
        out[f"attn/{key}"] = tattn.sharded_flash_attention(
            *(x[f"{key}_{n}"] for n in "qkv"), mesh).numpy()
    for layout in ("natural", "sf"):
        qkv = [x[f"frame_{layout}_{n}"] for n in "qkv"]
        out[f"attn/frame_{layout}"] = tattn.sharded_frame_attention(
            *qkv, 4, mesh, layout=layout).numpy()
        got = tattn.sharded_frame_attention(*(loc(t, 1) for t in qkv), 4, mesh, layout=layout,
                                            frames_sharded=True)
        out[f"attn/frame_{layout}_from_frames"] = coll.all_gather(got, mesh, "seq", 1).numpy()
    return out


def case_unet(mesh, goldens, tmp):
    params = nest(goldens, "params")
    x = torch_args(unet_inputs(2, MESH_F, 31))
    out = {}
    for layout, natural in (("standard", False), ("natural", True)):
        unet = tiny_unet(params, temporal_natural_layout=natural)
        pm.shard_params(unet, mesh)
        unet.set_parallel(mesh)
        with torch.inference_mode():
            out[f"unet/{layout}"] = unet(*x).numpy()
        if natural:  # planted fault: each rank normalises with its own frames' statistics
            keep = tlayers.norm_ops.group_norm

            def local(t, *args, gather=None, **kwargs):
                return keep(t, *args, **kwargs)
            tlayers.norm_ops.group_norm = local
            try:
                with torch.inference_mode():
                    out["fault/local_groupnorm"] = unet(*x).numpy()
            finally:
                tlayers.norm_ops.group_norm = keep
    return out


def case_ring_unet(mesh, goldens, tmp):
    params = nest(goldens, "params")
    x = torch_args(unet_inputs(1, RING_F, 41))
    unet = tiny_unet(params, temporal_window=RING_WINDOW)
    pm.shard_params(unet, mesh)
    unet.set_parallel(mesh, "ring")
    wide = tiny_unet(params, temporal_window=MESH_F)  # a band as wide as the video: none
    pm.shard_params(wide, mesh)
    wide.set_parallel(mesh, "ring")
    out = {}
    with torch.inference_mode():
        out["ring_unet_wide"] = wide(*torch_args(unet_inputs(2, MESH_F, 31))).numpy()
        out["ring_unet"] = unet(*x).numpy()
        keep = tring._block_positions  # planted fault: the band on local positions
        tring._block_positions = lambda src, s_loc, device: torch.arange(s_loc, device=device)
        try:
            out["fault/ring_local_band"] = unet(*x).numpy()
        finally:
            tring._block_positions = keep
    return out


def case_cores(mesh, goldens, tmp):
    pipe = golden_pipeline(goldens)
    pipe.enable_mesh(mesh.size, seq=mesh.size_of("seq"))
    out = {"cores/inversion": golden_inversion(goldens, pipe)}
    for name, two_pass in (("fused", False), ("stream", "stream")):
        out[f"cores/{name}"] = golden_composite(goldens, pipe, two_pass)
    out["cores/fused_1step"] = golden_composite(goldens, pipe, False, steps=1)
    # refusals on a live mesh
    for name, fn in (("int8_after_mesh", lambda: pipe.enable_int8()),
                     ("mesh_above_world", lambda: pm.make_mesh(2 * mesh.size))):
        try:
            fn()
            out[f"refused/{name}"] = np.array("")
        except (NotImplementedError, ValueError, RuntimeError) as e:
            out[f"refused/{name}"] = np.array(f"{type(e).__name__}: {e}")
    return out


def case_int8(mesh, goldens, tmp):
    """The int8 tiny UNet (enable_int8 before the mesh): the single-rank run
    records its activation tape, the mesh run replays it (ShardedReplay)."""
    unet = tiny_unet(nest(goldens, "params"), temporal_natural_layout=True)
    tq.quantize_unet_(unet, tq.default_unet_predicate)
    x = torch_args(unet_inputs(2, MESH_F, 31))
    tape = tt.ActivationTape()
    with torch.inference_mode(), tape.active():
        single = unet(*x)
    pm.shard_params(unet, mesh)
    unet.set_parallel(mesh)
    replay = ShardedReplay(tape.records, mesh)
    with torch.inference_mode(), replay.active():
        got = unet(*x)
    return {"int8/single": single.numpy(), "int8/mesh": got.numpy(),
            "int8/tape": np.array([replay.calls, len(replay.records), replay.flips,
                                   replay.elements, replay.max_step]),
            "int8/scale_rel": np.array(replay.max_scale_rel)}


def _job_entries(stores):
    masks = np.zeros((2, JOB_F, 8, 8), np.float32)
    masks[0, :, :4] = 1.0
    masks[1, :, :, :4] = 1.0
    frames = tt.tiny_frames(n=JOB_F, seed=5)
    return [dict(prompt=p, main_first_image=frames[0], main_image_list=frames,
                 background_image_list=tt.tiny_frames(n=JOB_F, seed=0),
                 objs_image_list=[tt.tiny_frames(n=JOB_F, seed=1),
                                  tt.tiny_frames(n=JOB_F, seed=2)],
                 masks_soft=m, masks_binary=m, bg_store=stores[0], obj_stores=stores[1:], seed=s)
            for p, m, s in (("a cat", masks, 3), ("a dog", masks[::-1].copy(), 4))]


JOB_SHARED = dict(height=16, width=16, num_frames=JOB_F, num_inference_steps=JOB_STEPS,
                  guidance_scale=3.0, decode=False)


def case_job(mesh, goldens, tmp):
    """invert_batch of 3 videos (J = 3 does not divide job = 2: replicated)
    and of 2 (split), and a J = 2 fused sample_composite_batch, on the mesh."""
    pipe = tt.build_tiny_pipeline(device="cpu", natural=True)
    pipe.enable_mesh(mesh.size, seq=mesh.size_of("seq"), job=mesh.size_of("job"))
    videos = [tt.tiny_frames(n=JOB_F, seed=s) for s in range(3)]
    kw = dict(height=16, width=16, num_frames=JOB_F, num_inference_steps=JOB_STEPS, seed=7)
    dirs = [os.path.join(tmp, f"t{j}") for j in range(3)]
    _, traj3 = pipe.invert_batch(videos, output_dirs=dirs, **kw)
    _, traj2 = pipe.invert_batch(videos[1:], **kw)
    from mvoc_tpu_torch.io.trajectory import TrajectoryStore

    entries = _job_entries([TrajectoryStore(d) for d in dirs])
    lat = pipe.sample_composite_batch(entries, **JOB_SHARED)
    return {"job/invert3": traj3, "job/invert2": traj2, "job/composite": lat.numpy()}


CASES = {"attention": case_attention, "unet": case_unet, "ring_unet": case_ring_unet,
         "cores": case_cores, "int8": case_int8, "job": case_job}


def run(rank: int, world: int, port: int, shape: tuple, cases: tuple, out_path: str,
        tmp: str) -> None:
    """One rank: the process group, the mesh, every case; rank 0 saves."""
    torch.set_num_threads(1)
    try:
        os.nice(NICENESS)
    except OSError:
        pass
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        job, seq, model = shape
        mesh = pm.make_mesh(world, seq=seq, job=job)
        goldens = load_goldens()
        results, errors = {}, {}
        for name in cases:
            try:
                results.update(CASES[name](mesh, goldens, tmp))
            except Exception:  # noqa: BLE001 - reported by the test of that case
                errors[name] = traceback.format_exc()
                dist.barrier()  # ranks stay in step if every rank raised
        if rank == 0:
            for name, tb in errors.items():
                results[f"error/{name}"] = np.array(tb)
            np.savez(out_path, **results)
    finally:
        dist.destroy_process_group()


def spawn(shape: tuple, cases: tuple, tmp: str) -> dict:
    """Run `cases` on a (job, seq, model) mesh of gloo ranks on the CPU and
    return rank 0's results."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = int(np.prod(shape))
    out_path = os.path.join(tmp, "results.npz")
    mp.spawn(run, args=(world, port, shape, cases, out_path, tmp), nprocs=world)
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":  # a manual run: python tests/torch_parallel_worker.py
    with tempfile.TemporaryDirectory() as d:
        res = spawn((1, 2, 2), tuple(CASES), d)
        print(sorted(res))
