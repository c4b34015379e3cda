"""The (job, seq, model) device mesh on torch.distributed (counterpart of
mvoc_tpu/parallel/mesh.py).

Axes, as in the JAX package:
  * "job":   independent videos or composite entries (the batch entry
    points' J axis), pure data parallelism;
  * "seq":   the FRAME axis of video tensors: each rank runs the UNet on its
    frames; the cross-frame ops (temporal attention, temporal convs, the
    joint (F, H, W) GroupNorm of the temporal layers) exchange frames or
    statistics over this axis;
  * "model": Megatron tensor parallelism of the attention and MLP
    projections (column split in, row split out, one all-reduce after each
    row-split projection).

The JAX package annotates shardings and lets GSPMD insert collectives;
here every rank runs the same program on its local blocks and calls the
collectives itself (`parallel.collectives`), the way JAX's `shard_map`
bodies see local blocks.  The mesh is built with `init_device_mesh` (or a
`DeviceMesh` over ranks 0..n-1 when the world is larger) over an
initialised process group; one device is the no-op 1x1x1 mesh and needs
no process group.

Backend.  The process group's backend is the mesh's: `init_distributed`
takes NCCL for CUDA tensors and gloo for CPU tensors, and a caller who wants
gloo on CUDA tensors (ranks sharing one card: NCCL refuses two ranks on one
device) initialises gloo itself; the mesh then moves CUDA tensors through
host memory (`transport == "host"`).  NCCL without a card raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from datetime import timedelta
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from mvoc_tpu_torch.parallel import collectives as coll


SEQ_AXIS = "seq"
MODEL_AXIS = "model"
JOB_AXIS = "job"
AXES = (JOB_AXIS, SEQ_AXIS, MODEL_AXIS)


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched() -> bool:
    """Whether a launcher (torchrun) set up this process's rank."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device: torch.device) -> None:
    """Initialise the default process group from a launcher's environment
    (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR/PORT, LOCAL_RANK), once:
    the backend by the device, and on CUDA this rank's card LOCAL_RANK
    (ranks beyond the visible cards share them round-robin)."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = default_backend(device)
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device; use gloo on the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=timedelta(minutes=30))


class Mesh:
    """A (job, seq, model) mesh over the ranks 0..size-1 of the default
    process group: each axis's size, this rank's index on it, its process
    group.  `member` is False on a rank outside the mesh (a world larger
    than the mesh), which must not run the mesh's program."""

    def __init__(self, job: int = 1, seq: int = 1, model: int = 1, device_mesh=None,
                 backend: Optional[str] = None, device: Optional[torch.device] = None,
                 member: bool = True):
        self.shape = {JOB_AXIS: job, SEQ_AXIS: seq, MODEL_AXIS: model}
        self.size = job * seq * model
        self.axis_names = AXES
        self.device_mesh = device_mesh
        self.backend = backend
        self.device = torch.device(device) if device is not None else None
        coord = None if device_mesh is None else device_mesh.get_coordinate()
        self.member = member if device_mesh is None else coord is not None
        self._coord = dict(zip(AXES, coord)) if coord else {a: 0 for a in AXES}
        if backend is None:
            self.transport = "none"
        elif backend == "gloo":
            self.transport = "host"
        else:
            self.transport = "device"

    def size_of(self, axis: str) -> int:
        return self.shape[axis]

    def rank_of(self, axis: str) -> int:
        return self._coord[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh(job={self.shape[JOB_AXIS]}, seq={self.shape[SEQ_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, backend={self.backend}, "
                f"transport={self.transport})")


def split_sizes(n: int, seq: Optional[int] = None, job: int = 1) -> tuple[int, int, int]:
    """(job, seq, model) for n devices, JAX's rule: seq = min(n / job, 4),
    halved until it divides, unless given; model = the rest."""
    if n % job != 0:
        raise ValueError(f"job axis {job} must divide device count {n}")
    per_job = n // job
    if seq is None:
        seq = min(per_job, 4)
        while per_job % seq != 0:
            seq //= 2
    if per_job % seq != 0:
        raise ValueError(f"seq axis {seq} must divide {per_job} devices per job")
    return job, seq, per_job // seq


def make_mesh(n_devices: Optional[int] = None, seq: Optional[int] = None, job: int = 1,
              device=None) -> Mesh:
    """Build a (job, seq, model) mesh over ranks 0..n-1 of the initialised
    default process group (n = the world size by default).  One device is
    the no-op mesh.  A mesh larger than the world, or NCCL without a card,
    raise; ranks n.. of a larger world get a Mesh with member False."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    job, seq, model = split_sizes(n, seq, job)
    if n == 1:
        return Mesh(device=device, member=_world_rank() == 0)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n} devices needs one process per device: launch with "
            f"`torchrun --nproc_per_node {n} ...` (the port runs a mesh as one process "
            "per rank; the JAX package runs it in one process)")
    if n > world:
        raise ValueError(f"mesh of {n} devices > world size {world}")
    pg_backend = dist.get_backend()
    if pg_backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dev_type = "cuda" if pg_backend == "nccl" or (
        device is not None and torch.device(device).type == "cuda") else "cpu"
    if n == world:
        dm = init_device_mesh(dev_type, (job, seq, model), mesh_dim_names=AXES)
    else:
        dm = DeviceMesh(dev_type, torch.arange(n).reshape(job, seq, model), mesh_dim_names=AXES)
    return Mesh(job, seq, model, device_mesh=dm, backend=pg_backend, device=device)


def _world_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes files: every process without a mesh,
    else rank 0 of the world, which is rank 0 of the mesh."""
    return mesh is None or (mesh.member and _world_rank() == 0)


# ---------------------------------------------------------------------------
# tensor parallelism of the parameters
# ---------------------------------------------------------------------------

COL_SPLIT = ("to_q", "to_k", "to_v", "net_0_proj", "mlp_fc1", "q_proj", "k_proj", "v_proj",
             "linear_1")
ROW_SPLIT = ("to_out_0", "net_2", "mlp_fc2", "out_proj", "linear_2")


def kernel_spec(path_names: Sequence[str], shape: Sequence[int], model_size: int) -> tuple:
    """The JAX package's `_kernel_spec` rule for a flax-layout kernel [.., K, N]
    named path_names (.., module, "kernel"): the column-split layers over
    "model" on N, the row-split ones on K, each only where the dim divides;
    everything else replicated.  Returned as the PartitionSpec's entries
    (() is replicated)."""
    name = path_names[-2] if len(path_names) >= 2 else ""
    leaf = path_names[-1]
    if leaf != "kernel" or len(shape) < 2 or model_size == 1:
        return ()
    out_dim, in_dim = shape[-1], shape[-2]
    if name in COL_SPLIT and out_dim % model_size == 0:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    if name in ROW_SPLIT and in_dim % model_size == 0:
        return (None,) * (len(shape) - 2) + (MODEL_AXIS, None)
    return ()


def flax_name(module_name: str) -> str:
    """The flax module name of a port module (its dotted diffusers key):
    "to_out.0" -> "to_out_0", "net.0.proj" -> "net_0_proj", "net.2" ->
    "net_2", else the last part."""
    parts = module_name.split(".")
    if len(parts) >= 3 and parts[-1] == "proj" and parts[-2].isdigit():
        return "_".join(parts[-3:])
    if len(parts) >= 2 and parts[-1].isdigit():
        return "_".join(parts[-2:])
    return parts[-1]


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    return t.chunk(n, dim=dim)[i].contiguous()


def _split_linear(layer: nn.Module, kind: str, n: int, i: int, halves: int = 1) -> None:
    """Keep rank i's share of a Linear / QuantLinear (weight [N, K]):
    "col" its rows (of each of `halves` concatenated blocks, the GEGLU's
    [hidden, gate]) with their bias and int8 scales, "row" its columns."""
    w = layer.weight
    if kind == "col":
        blocks = w.chunk(halves, dim=0)
        new_w = torch.cat([_chunk(b, 0, n, i) for b in blocks])
        if layer.bias is not None:
            layer.bias = nn.Parameter(torch.cat([_chunk(b, 0, n, i) for b in
                                                 layer.bias.data.chunk(halves)]),
                                      requires_grad=False)
        if hasattr(layer, "weight_scale"):
            layer.weight_scale = torch.cat([_chunk(b, 0, n, i) for b in
                                            layer.weight_scale.chunk(halves)])
    else:
        new_w = _chunk(w, 1, n, i)
    if isinstance(w, nn.Parameter):
        layer.weight = nn.Parameter(new_w, requires_grad=False)
    else:  # QuantLinear keeps its int8 weight as a buffer
        layer.weight = new_w
    layer.tp_split = (kind, n, halves)


def _gather_linear(layer: nn.Module, mesh: Mesh) -> None:
    """Undo _split_linear: all-gather the shares over "model"."""
    kind, n, halves = layer.tp_split

    def gather(t, dim):
        full = coll.all_gather(t, mesh, MODEL_AXIS, dim)
        if halves == 1 or dim != 0:
            return full
        # [r0 h0, r0 h1, r1 h0, ...] -> [h0 r0, h0 r1, ..., h1 r0, ...]
        per = t.shape[0] // halves
        shares = full.split(per)
        return torch.cat([shares[r * halves + h] for h in range(halves) for r in range(n)])

    w = gather(layer.weight, 0 if kind == "col" else 1)
    layer.weight = nn.Parameter(w, requires_grad=False) if isinstance(
        layer.weight, nn.Parameter) else w
    if kind == "col":
        if layer.bias is not None:
            layer.bias = nn.Parameter(gather(layer.bias.data, 0), requires_grad=False)
        if hasattr(layer, "weight_scale"):
            layer.weight_scale = gather(layer.weight_scale, 0)
    del layer.tp_split


def _tp_units(model: nn.Module):
    """(module, [(linear, kind, halves)], divides) per tensor-parallel unit
    of the UNet: each attention (heads split), feed-forward (inner split,
    the GEGLU's hidden and gate halves each) and timestep MLP."""
    from mvoc_tpu_torch.models import layers

    for name, m in model.named_modules():
        if isinstance(m, layers.Attention):
            yield name, m, [("to_q", m.to_q, "col", 1), ("to_k", m.to_k, "col", 1),
                            ("to_v", m.to_v, "col", 1), ("to_out.0", m.to_out[0], "row", 1)], \
                lambda n, m=m: m.heads % n == 0
        elif isinstance(m, layers.FeedForward):
            geglu = isinstance(m.net[0], layers._GEGLU)
            yield name, m, [("net.0.proj", m.net[0].proj, "col", 2 if geglu else 1),
                            ("net.2", m.net[2], "row", 1)], \
                lambda n, m=m: m.inner % n == 0
        elif isinstance(m, layers.TimestepEmbedding):
            yield name, m, [("linear_1", m.linear_1, "col", 1),
                            ("linear_2", m.linear_2, "row", 1)], \
                lambda n, m=m: m.linear_1.out_features % n == 0


def _flax_shape(layer: nn.Module) -> tuple[int, int]:
    """[K, N] of a Linear or QuantLinear (torch weight [N, K])."""
    return tuple(layer.weight.shape[::-1])


def shard_params(model: nn.Module, mesh: Mesh) -> list[str]:
    """Megatron tensor parallelism over "model", in place: every unit whose
    layers `kernel_spec` splits, and whose heads (attention) or inner width
    (feed-forward, timestep MLP) divide the axis, keeps this rank's share;
    its module records the mesh (`tp`) for the all-reduce after its
    row-split output projection.  A unit that does not divide stays
    replicated (the 320-channel attention's 5 heads over model = 2, say:
    splitting it would cut a head).  int8 layers (QuantLinear) split their
    int8 weight and, column-wise, their scales.  Returns the split units."""
    n = mesh.size_of(MODEL_AXIS)
    if n == 1:
        return []
    i = mesh.rank_of(MODEL_AXIS)
    done = []
    for name, unit, linears, divides in _tp_units(model):
        specs_ok = all(
            kernel_spec((flax_name(sub), "kernel"), _flax_shape(lin), n)
            for sub, lin, _, _ in linears)
        if not (specs_ok and divides(n)):
            continue
        for _, lin, kind, halves in linears:
            _split_linear(lin, kind, n, i, halves)
        unit.tp = mesh
        if hasattr(unit, "heads"):
            unit.heads //= n
        done.append(name)
    return done


def unshard_params(model: nn.Module, mesh: Mesh) -> None:
    """Undo shard_params (all-gather every split layer), in place."""
    for _, unit, linears, _ in _tp_units(model):
        if getattr(unit, "tp", None) is None:
            continue
        for _, lin, _, _ in linears:
            _gather_linear(lin, mesh)
        if hasattr(unit, "heads"):
            unit.heads *= mesh.size_of(MODEL_AXIS)
        unit.tp = None


# ---------------------------------------------------------------------------
# sharded video tensors
# ---------------------------------------------------------------------------


def shard_video(x: torch.Tensor, mesh: Mesh, frame_axis: int = 1) -> torch.Tensor:
    """This rank's frames of x over "seq", or all of x when they do not
    divide (replicated, as JAX's shard_video)."""
    n = mesh.size_of(SEQ_AXIS)
    if n == 1 or x.shape[frame_axis] % n:
        return x
    return x.chunk(n, dim=frame_axis)[mesh.rank_of(SEQ_AXIS)]


def gather_video(x: torch.Tensor, mesh: Mesh, total: int, frame_axis: int = 1) -> torch.Tensor:
    """The full tensor back from shard_video's slice (total = the full
    frame count; a replicated x is returned as it is)."""
    if x.shape[frame_axis] == total:
        return x
    return coll.all_gather(x, mesh, SEQ_AXIS, frame_axis)


def job_slice(j: int, mesh: Optional[Mesh]) -> slice:
    """The entries of a J-entry batch this rank's job slice runs: its share
    when J divides the "job" axis, else all J (replicated).  The batch
    entry points take these entries of every prepared input; the frames of
    each entry are split inside the UNet forward, so a stacked video is
    never sliced on both axes (JAX's shard_stacked_video)."""
    n = 1 if mesh is None else mesh.size_of(JOB_AXIS)
    if n == 1 or j % n:
        return slice(0, j)
    per = j // n
    r = mesh.rank_of(JOB_AXIS)
    return slice(r * per, (r + 1) * per)


# ---------------------------------------------------------------------------
# the frame shard of the running UNet forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """How the running UNet forward holds its video tensors: `frames` in
    all, split over the mesh's "seq" axis when `sharded` (this rank then
    holds frames offset .. offset + local - 1), else every rank holds all
    of them (the frame count does not divide the axis)."""

    mesh: Mesh
    frames: int
    sharded: bool

    @property
    def local(self) -> int:
        return self.frames // self.mesh.size_of(SEQ_AXIS) if self.sharded else self.frames

    @property
    def offset(self) -> int:
        return self.mesh.rank_of(SEQ_AXIS) * self.local if self.sharded else 0


_FRAME_SHARD: contextvars.ContextVar[Optional[FrameShard]] = contextvars.ContextVar(
    "mvoc_frame_shard", default=None)


def current_frame_shard() -> Optional[FrameShard]:
    return _FRAME_SHARD.get()


@contextlib.contextmanager
def frame_shard(fs: Optional[FrameShard]) -> Iterator[None]:
    """Run the body with `fs` as the frame shard the layers see (None: the
    layers act on whole, unsharded tensors)."""
    token = _FRAME_SHARD.set(fs)
    try:
        yield
    finally:
        _FRAME_SHARD.reset(token)
