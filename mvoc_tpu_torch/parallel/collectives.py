"""Collectives over one axis of a `parallel.mesh.Mesh`, on torch.distributed.

Each function takes the mesh and the axis by name ("job", "seq", "model")
and is the identity on an axis of size 1, so the same code runs unsharded.
They are the port's counterparts of what the JAX package gets from GSPMD
and `shard_map` (all-gathers, `all_to_all`, `ppermute`, `psum`).

Transport.  An NCCL mesh moves CUDA tensors on the device.  A gloo mesh
moves everything through host memory (`Mesh.transport == "host"`): CPU
tensors in place; CUDA tensors through gloo's own CUDA path (pinned host
staging inside gloo) for all-reduce, all-gather and all-to-all, which gloo
takes on CUDA tensors (chip_smoke.py phase 9 checks it on the card), and
through explicit host copies for the ring's point-to-point exchange, which
gloo takes on CPU tensors only.  A failed collective raises; nothing falls
back.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:  # pragma: no cover
    from mvoc_tpu_torch.parallel.mesh import Mesh

# every collective call, by kind, counted where it runs (chip_smoke.py and
# the tests read them; a size-1 axis runs none)
CALLS = {"all_gather": 0, "all_to_all": 0, "ring_exchange": 0, "all_reduce": 0}


def reset_call_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _p2p_buffer(mesh: "Mesh", t: torch.Tensor) -> torch.Tensor:
    """The tensor a point-to-point exchange sends: a contiguous host copy of
    a CUDA tensor on a gloo mesh, else t made contiguous."""
    if mesh.transport == "host" and t.is_cuda:
        return t.detach().to("cpu", copy=True).contiguous()
    return t.contiguous()


def all_gather(x: torch.Tensor, mesh: "Mesh", axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's x along `dim`, in the axis's rank order."""
    n = mesh.size_of(axis)
    if n == 1:
        return x
    CALLS["all_gather"] += 1
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, mesh: "Mesh", axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's tiled `all_to_all`: x is cut into n equal pieces along
    split_dim, piece i goes to rank i of the axis, and the n pieces a rank
    receives are concatenated along concat_dim in rank order."""
    n = mesh.size_of(axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all over {axis}={n}: dim {split_dim} of {tuple(x.shape)} "
                         "does not divide")
    CALLS["all_to_all"] += 1
    send = torch.stack(x.chunk(n, dim=split_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    return torch.cat(recv.unbind(0), dim=concat_dim)


def ring_exchange(x: torch.Tensor, mesh: "Mesh", axis: str) -> torch.Tensor:
    """Send x to the next rank of the axis and return the previous rank's
    (JAX's `ppermute` with perm [(j, j + 1 mod n)])."""
    n = mesh.size_of(axis)
    if n == 1:
        return x
    CALLS["ring_exchange"] += 1
    ranks = dist.get_process_group_ranks(mesh.group(axis))
    me = mesh.rank_of(axis)
    send = _p2p_buffer(mesh, x)
    recv = torch.empty_like(send)
    group = mesh.group(axis)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(me + 1) % n], group),
        dist.P2POp(dist.irecv, recv, ranks[(me - 1) % n], group)])
    for r in reqs:
        r.wait()
    return recv.to(x.device)


def all_reduce(x: torch.Tensor, mesh: "Mesh", axis: str, op: str = "sum") -> torch.Tensor:
    """The sum (in fp32: the result is fp32 whatever x's dtype) or the max
    of x over the axis."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op {op!r}: 'sum' or 'max'")
    buf = x.float() if op == "sum" else x
    if mesh.size_of(axis) == 1:
        return buf
    CALLS["all_reduce"] += 1
    # reduced in place: never the caller's tensor
    buf = buf.clone(memory_format=torch.contiguous_format) if buf is x else buf.contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.group(axis))
    return buf


def barrier(mesh: "Mesh") -> None:
    """Every rank of the mesh waits for all the others: a one-element
    all-reduce over each axis in turn."""
    t = torch.zeros(1)
    if mesh.transport == "device":
        t = t.to(mesh.device)
    for axis in mesh.axis_names:
        if mesh.size_of(axis) > 1:
            dist.all_reduce(t, group=mesh.group(axis))
