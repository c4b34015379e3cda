"""Context-parallel self-attention over the mesh's "seq" axis: ring and
Ulysses (counterpart of mvoc_tpu/ops/ring_attention.py).

The sequence (for the temporal transformers: the frame axis) is split over
the axis.  Ring: each rank keeps its query block while the K/V blocks
rotate around the ring (`collectives.ring_exchange`), accumulated with an
online fp32 softmax, so no rank holds the [S, S] logits.  Ulysses: one
all-to-all swaps the split from the sequence to the heads, each rank
attends over the whole sequence on H/n heads, and a second all-to-all
swaps back.

The JAX package computes both bodies with plain einsums inside
`shard_map`, no Pallas kernel; so do these functions, with torch.matmul on
each rank's local blocks (the port has no `shard_map`: the arguments ARE
the local blocks).  `window` is the temporal band |q - k| <= window // 2 on
GLOBAL positions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mvoc_tpu_torch.parallel import collectives as coll
from mvoc_tpu_torch.parallel.mesh import Mesh

_NEG = torch.finfo(torch.float32).min


def _band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """[Sq, Sk] boolean band: |q - k| <= window // 2."""
    return (q_pos[:, None] - k_pos[None, :]).abs() <= window // 2


def _block_positions(src: int, s_loc: int, device) -> torch.Tensor:
    """The global sequence positions of the block that started on rank src."""
    return src * s_loc + torch.arange(s_loc, device=device)


def _local_attention(q, k, v, window: Optional[int]) -> torch.Tensor:
    """Softmax attention over [B, H, S, D] in fp32, band on 0..S-1."""
    s_len = q.shape[2]
    s = torch.matmul(q.float() * (1.0 / math.sqrt(q.shape[-1])), k.float().transpose(-1, -2))
    if window is not None and window < s_len:
        pos = torch.arange(s_len, device=q.device)
        s = torch.where(_band_mask(pos, pos, window), s, _NEG)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str,
                        axis_size: int, mesh: Optional[Mesh] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Blockwise self-attention with K/V rotating around `axis_name`.

    q, k, v: this rank's [B, H, S_local, D] blocks of a sequence split over
    the axis (axis_size blocks, rank r holding positions r*S_local ..).
    Exact: online softmax in fp32, no [S, S] logits beyond the local
    [S_local, S_local] block.  After `it` exchanges a rank holds the block
    that started on rank (my - it) mod n, whose global positions the band
    uses."""
    if axis_size == 1:
        return _local_attention(q, k, v, window)
    b, h, s_loc, d = q.shape
    my = mesh.rank_of(axis_name)
    qf = q.float() * (1.0 / math.sqrt(d))
    q_pos = _block_positions(my, s_loc, q.device)
    m = torch.full((b, h, s_loc, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for it in range(axis_size):
        s = torch.matmul(qf, kc.float().transpose(-1, -2))
        if window is not None:
            k_pos = _block_positions((my - it) % axis_size, s_loc, q.device)
            s = torch.where(_band_mask(q_pos, k_pos, window), s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vc.float())
        m = m_new
        if it + 1 < axis_size:  # JAX rotates after the last block too; nothing reads it
            kc = coll.ring_exchange(kc, mesh, axis_name)
            vc = coll.ring_exchange(vc, mesh, axis_name)
    return (acc / l).to(q.dtype)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str,
                           axis_size: int, mesh: Optional[Mesh] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses: all-to-all [B, H, S_local, D] -> [B, H/n, S, D],
    full-sequence attention on H/n heads, all-to-all back.  The head count
    must divide the axis (JAX asserts the same)."""
    if axis_size == 1:
        return _local_attention(q, k, v, window)
    h = q.shape[1]
    if h % axis_size:
        raise ValueError(f"heads {h} not divisible by axis {axis_size}")
    qg, kg, vg = (coll.all_to_all(t, mesh, axis_name, split_dim=1, concat_dim=2)
                  for t in (q, k, v))
    og = _local_attention(qg, kg, vg, window)
    return coll.all_to_all(og, mesh, axis_name, split_dim=2, concat_dim=1)


def ring_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, mesh: Mesh,
              axis_name: str = "seq", method: str = "ring",
              window: Optional[int] = None) -> torch.Tensor:
    """Drop-in sdpa over [B, S_local, H*D] local blocks of a token axis split
    over `mesh[axis_name]` (B is not split), as context-parallel attention:
    method "ring" (K/V rotate, n - 1 exchanges) or "ulysses" (two
    all-to-alls, heads must divide the axis).  window: the band on global
    positions."""
    impl = {"ring": ring_self_attention, "ulysses": ulysses_self_attention}.get(method)
    if impl is None:
        raise ValueError(f"context_parallel method {method!r}: 'ring' or 'ulysses'")
    b, s, inner = q.shape
    d = inner // heads

    def to_heads(x):
        return x.reshape(b, s, heads, d).transpose(1, 2)  # [B, H, S, D]

    out = impl(to_heads(q), to_heads(k), to_heads(v), axis_name, mesh.size_of(axis_name),
               mesh=mesh, window=window)
    return out.transpose(1, 2).reshape(b, s, inner)
