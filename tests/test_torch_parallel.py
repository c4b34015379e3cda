"""The port's device mesh (mvoc_tpu_torch/parallel, ops/ring_attention.py,
the sharded kernel wrappers of ops/attention.py, the mesh through the UNet
and the pipeline) against the single-process port and the JAX package.

Two worlds of four gloo ranks on the CPU, each spawned once for the module
(tests/torch_parallel_worker.py): (job 1, seq 2, model 2) runs every case
but the job axis, (job 2, seq 2, model 1) the batch entry points.  The
single-process references run here, in fp32.  The JAX side: make_mesh,
_kernel_spec, _assign_mesh_axes, ring_sdpa and the shard_map kernel
wrappers (Pallas interpret mode) are called on the 8-device CPU mesh of
tests/conftest.py; the UNet, ring UNet and composite step on JAX's mesh
come from tests/data/torch_parity_goldens.npz (no JAX UNet compiles here).

Tolerances: a module or UNet forward within MODULE_ATOL of the single-process
port (fp32), a step loop within LOOP_REL * max |x|; against JAX the
golden comparisons' own (REL for a UNet, CORE_REL for a loop), the attention
functions within ATTN_ATOL.  Both planted faults (a shard-local GroupNorm,
the ring's band on local positions) must land beyond them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_parallel_worker as w
from mvoc_tpu.models.layers import _block_diag_bias, _head_group_size
from mvoc_tpu.ops import attention as JA
from mvoc_tpu.ops.ring_attention import ring_sdpa as jax_ring_sdpa
from mvoc_tpu.parallel import mesh as jpm
from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.ops import attention as tattn
from mvoc_tpu_torch.ops import ring_attention as tring
from mvoc_tpu_torch.parallel import mesh as pm
from mvoc_tpu_torch.utils import testing as tt
from torch_support import load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

MODULE_ATOL = 2e-5  # tests/test_torch_pipeline.py
LOOP_REL = 1e-4
REL = 1e-4          # tests/test_torch_unet.py, a UNet against JAX
CORE_REL = 1e-3     # tests/test_torch_pipeline.py, a step loop against JAX
ATTN_ATOL = 1e-5


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every case but the job axis on (job 1, seq 2, model 2)."""
    return w.spawn((1, 2, 2), ("attention", "unet", "ring_unet", "cores", "int8"),
                   str(tmp_path_factory.mktemp("mesh")))


@pytest.fixture(scope="module")
def job_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("job"))
    return tmp, w.spawn((2, 2, 1), ("job",), tmp)


def _result(run, key):
    for name, tb in run.items():
        if name.startswith("error/"):
            pytest.fail(f"rank 0's case {name[6:]} raised:\n{tb}")
    return run[key]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_make_mesh_matches_jax():
    """The (job, seq, model) split of JAX's make_mesh on the same (n, seq,
    job); one device is the no-op mesh, which needs no process group."""
    for n, kw in ((8, {}), (1, {}), (8, dict(job=4)), (4, dict(seq=2)), (4, dict(seq=4))):
        want = jpm.make_mesh(n, **kw).shape
        assert pm.split_sizes(n, kw.get("seq"), kw.get("job", 1)) == (
            want["job"], want["seq"], want["model"]), (n, kw)
    one = pm.make_mesh(1)
    assert one.size == 1 and one.member and pm.is_writer(one)


def test_kernel_spec_and_tp_units(goldens):
    """kernel_spec equals JAX's _kernel_spec on every leaf of the tiny UNet,
    at model sizes 2 and 4; shard_params splits a unit only where JAX splits
    its kernels and its heads (or inner width) divide: at the published
    geometry the 320-channel attention (5 heads) stays replicated over
    model = 2 and the 640 / 1280 ones split."""
    leaves = {tuple(k.split("/")[1:]): v.shape for k, v in goldens.items()
              if k.startswith("params/")}
    assert len(leaves) > 100
    for model in (2, 4):
        for names, shape in leaves.items():
            assert pm.kernel_spec(names, shape, model) == tuple(
                jpm._kernel_spec(names, shape, model)), (names, shape, model)
    with torch.device("meta"):
        unet = I2VGenXLUNet(UNetConfig())
    split = set(pm.shard_params(unet, pm.Mesh(model=2)))
    attn = [n for n in split if n.endswith((".attn1", ".attn2"))]
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1" not in split
    assert "down_blocks.1.attentions.0.transformer_blocks.0.attn1" in split
    assert "down_blocks.0.attentions.0.transformer_blocks.0.ff" in split
    assert unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1.heads == 5
    assert {"time_embedding", "fps_embedding"} <= split and len(attn) > 20


def test_assign_mesh_axes_matches_jax():
    jmesh = jpm.make_mesh(8)
    tmesh = pm.Mesh(*pm.split_sizes(8))
    for dims in ([80, 5, 4096], [5, 6, 4096], [5, 3, 1111], [8, 4, 1037], [64, 2]):
        assert tattn.assign_mesh_axes(tmesh, dims) == JA._assign_mesh_axes(jmesh, dims), dims


def test_ring_and_ulysses_match_jax(mesh_run):
    """ring_sdpa on frames split over seq = 2 (ring and Ulysses, with and
    without a band) against JAX's ring_sdpa on its 8-device mesh and the
    single-process port (one block: plain attention)."""
    x = w.attention_inputs()
    a = w.ATTN
    q, k, v = (jnp.asarray(x[f"ring_{n}"]) for n in "qkv")
    for method, seq in (("ring", 8), ("ulysses", 4)):
        for window in (None, a["window"]):
            want = np.asarray(jax_ring_sdpa(q, k, v, a["heads"], jpm.make_mesh(8, seq=seq),
                                            method=method, window=window))
            got = _result(mesh_run, f"attn/{method}_{window}")
            np.testing.assert_allclose(got, want, atol=ATTN_ATOL, err_msg=f"{method} {window}")
            single = tring.ring_sdpa(*(torch.from_numpy(x[f"ring_{n}"]) for n in "qkv"),
                                     a["heads"], pm.Mesh(), "seq", method, window).numpy()
            np.testing.assert_allclose(got, single, atol=MODULE_ATOL)


def test_sharded_kernels_match_jax(mesh_run):
    """sharded_flash_attention and sharded_frame_attention (both layouts,
    from replicated inputs and, frame attention, from frames split over
    seq) against the JAX wrappers in Pallas interpret mode at
    tests/test_sharded_kernels.py's shapes."""
    x = w.attention_inputs()
    jmesh = jpm.make_mesh(8)
    for b, h, sq in w.FLASH_SHAPES:
        key = f"flash_{b}x{h}x{sq}"
        want = np.asarray(JA.sharded_flash_attention(
            *(jnp.asarray(x[f"{key}_{n}"]) for n in "qkv"), jmesh, interpret=True))
        np.testing.assert_allclose(_result(mesh_run, f"attn/{key}"), want, atol=ATTN_ATOL)
    f, heads = w.FRAME_NATURAL[1], 4
    bias = _block_diag_bias(f, _head_group_size(heads, f), None)
    for layout in ("natural", "sf"):
        want = np.asarray(JA.sharded_frame_attention(
            *(jnp.asarray(x[f"frame_{layout}_{n}"]) for n in "qkv"), f, heads, bias, jmesh,
            sf_layout=layout == "sf", interpret=True))
        for suffix in ("", "_from_frames"):
            np.testing.assert_allclose(_result(mesh_run, f"attn/frame_{layout}{suffix}"), want,
                                       atol=ATTN_ATOL, err_msg=layout + suffix)


@pytest.mark.parametrize("layout", ["standard", "natural"])
def test_sharded_unet_matches_single_process_and_jax(goldens, mesh_run, layout):
    """The tiny UNet, 4 frames over seq = 2 and its heads / MLPs over model =
    2, against the port in one process and JAX's (seq 4, model 2) mesh."""
    x = w.unet_inputs(2, w.MESH_F, 31)
    for k, v in x.items():
        np.testing.assert_array_equal(v, goldens[f"mesh/unet/inputs/{k}"])
    unet = w.tiny_unet(nest(goldens, "params"), temporal_natural_layout=layout == "natural")
    with torch.inference_mode():
        single = unet(*w.torch_args(x)).numpy()
    got = _result(mesh_run, f"unet/{layout}")
    assert np.abs(got - single).max() <= MODULE_ATOL
    want = goldens[f"mesh/unet/{layout}_out"]
    assert _rel(got, want) <= REL


def test_ring_unet_64_frames(goldens, mesh_run):
    """tests/test_parallel.py's long-video case: 64 frames, temporal_window 8,
    ring context parallelism over seq = 2 against the port's windowed
    single-process forward and JAX's ring over seq = 4."""
    x = w.unet_inputs(1, w.RING_F, 41)
    for k, v in x.items():
        np.testing.assert_array_equal(v, goldens[f"mesh/ring/inputs/{k}"])
    unet = w.tiny_unet(nest(goldens, "params"), temporal_window=w.RING_WINDOW)
    with torch.inference_mode():
        single = unet(*w.torch_args(x)).numpy()
    got = _result(mesh_run, "ring_unet")
    assert np.abs(got - single).max() <= MODULE_ATOL
    assert _rel(got, goldens["mesh/ring/out"]) <= REL


def test_ring_unet_window_over_frames(goldens, mesh_run):
    """temporal_window 4 on a 4-frame video (as wide as the video, so no
    band: the templates' temporal_window 16 at 16 frames) with ring context
    parallelism over seq = 2: every frame attends to every frame, as in the
    single-process forward."""
    unet = w.tiny_unet(nest(goldens, "params"), temporal_window=w.MESH_F)
    with torch.inference_mode():
        single = unet(*w.torch_args(w.unet_inputs(2, w.MESH_F, 31))).numpy()
    assert np.abs(_result(mesh_run, "ring_unet_wide") - single).max() <= MODULE_ATOL


def test_sharded_inversion_and_composites(goldens, mesh_run):
    """The 3-step inversion and the fused and stream composites through
    enable_mesh (2 frames over seq = 2, model 2) against the single-process
    port and JAX's single-device goldens; one fused step against JAX's step
    on its mesh."""
    pipe = w.golden_pipeline(goldens)
    got = _result(mesh_run, "cores/inversion")
    assert _rel(got, w.golden_inversion(goldens, pipe)) <= LOOP_REL
    assert _rel(got, goldens["invert/trajectory"]) <= CORE_REL
    for name, two_pass in (("fused", False), ("stream", "stream")):
        got = _result(mesh_run, f"cores/{name}")
        assert _rel(got, w.golden_composite(goldens, pipe, two_pass)) <= LOOP_REL, name
        assert _rel(got, goldens["composite/fused_out"]) <= CORE_REL, name
    got = _result(mesh_run, "cores/fused_1step")
    assert _rel(got, w.golden_composite(goldens, pipe, False, steps=1)) <= LOOP_REL
    assert _rel(got, goldens["mesh/composite/fused_1step_out"]) <= CORE_REL


def test_job_axis_batches_equal_sequential(job_run):
    """On (job 2, seq 2): invert_batch of 3 videos (J does not divide job:
    replicated) and of 2 (one per job slice), and a J = 2 fused
    sample_composite_batch from the stores rank 0 wrote, each entry against
    the sequential single-process call."""
    tmp, run = job_run
    pipe = tt.build_tiny_pipeline(device="cpu", natural=True)
    videos = [tt.tiny_frames(n=w.JOB_F, seed=s) for s in range(3)]
    kw = dict(height=16, width=16, num_frames=w.JOB_F, num_inference_steps=w.JOB_STEPS, seed=7)
    inv3, inv2 = _result(run, "job/invert3"), _result(run, "job/invert2")
    for j, frames in enumerate(videos):
        one = pipe.invert(frames, **kw)[1]
        assert _rel(inv3[:, j], one) <= LOOP_REL
        if j:
            assert _rel(inv2[:, j - 1], one) <= LOOP_REL
    stores = [TrajectoryStore(f"{tmp}/t{j}") for j in range(3)]
    lat = _result(run, "job/composite")
    for e, entry in enumerate(w._job_entries(stores)):
        one = pipe.sample_composite(**entry, **w.JOB_SHARED).numpy()
        assert _rel(lat[e], one) <= LOOP_REL, e


def test_int8_unet_on_the_mesh_replays_the_single_rank_tape(mesh_run):
    """enable_int8 before the mesh: the tiny int8 UNet (K3's plain version
    on each rank's tensor-parallel share, row-split layers summing fp32
    partial products) replaying the single-rank run's activation tape, each
    record cut to the rank's block, lands on the single-rank output."""
    calls, records, flips, elements, max_step = _result(mesh_run, "int8/tape")
    assert calls == records > 0 and max_step <= 1 and flips <= 1e-5 * elements
    assert float(mesh_run["int8/scale_rel"]) <= 1e-5
    got, want = mesh_run["int8/mesh"], mesh_run["int8/single"]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_planted_faults_land_beyond_the_gates(goldens, mesh_run):
    """A GroupNorm that takes its statistics over its own frames only, and a
    ring that bands on local positions, each move the UNet far beyond the
    tolerance the true runs meet."""
    unet = w.tiny_unet(nest(goldens, "params"), temporal_natural_layout=True)
    with torch.inference_mode():
        single = unet(*w.torch_args(w.unet_inputs(2, w.MESH_F, 31))).numpy()
        ring_single = w.tiny_unet(nest(goldens, "params"), temporal_window=w.RING_WINDOW)(
            *w.torch_args(w.unet_inputs(1, w.RING_F, 41))).numpy()
    assert np.abs(_result(mesh_run, "fault/local_groupnorm") - single).max() > 1e3 * MODULE_ATOL
    assert np.abs(_result(mesh_run, "fault/ring_local_band") - ring_single).max() > \
        1e3 * MODULE_ATOL


def test_refusals(mesh_run):
    """enable_int8 after a mesh of more than one rank (JAX's refusal), a mesh
    above the world size, NCCL without a card, a mesh without a process
    group (naming torchrun)."""
    assert "call enable_int8 BEFORE enable_mesh" in str(
        _result(mesh_run, "refused/int8_after_mesh"))
    assert "> world size" in str(mesh_run["refused/mesh_above_world"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA device"):
            pm.init_distributed(torch.device("cuda"))
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        pm.make_mesh(2)
