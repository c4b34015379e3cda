"""Plug-and-play (PnP) feature injection for multi-video composition
(PyTorch counterpart of mvoc_tpu/pnp.py).

The UNet forward takes an explicit `PnPState`; every injection site is a
composite of the source branches written into the edit branches, applied
when that site's gate is on.  The sampling loop runs on the host, so gates
are plain Python booleans here (the JAX package carries traced booleans
through `lax.scan`).

Semantics (from the reference, as in the JAX package):
* branch layout of the fused batch: [bg, obj_1..obj_N, uncond, cond],
  once per entry when J entries (group entries composited together) ride
  the batch, entry-major, each with its own masks;
* attention sites inject Q and K only; conv sites inject activations;
* composite: base = base*(1-m_j) + obj_j*m_j for j = 1..N (a later object
  wins overlaps), written into both the uncond and the cond chunk;
* inject_background picks the base of attention sites: bg if True, else
  the cond chunk; conv sites always use bg;
* a step injects when t is in the schedule or t == 1000;
* spatial attention and conv sites use binary masks, temporal attention
  the soft (un-thresholded) masks, nearest-resized to each resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Pyramid = Dict[Tuple[int, int], torch.Tensor]


def _freeze_sites(d) -> tuple:
    return tuple(sorted((int(k), tuple(int(i) for i in v)) for k, v in d.items()))


@dataclasses.dataclass(frozen=True)
class SiteMap:
    """Which up-block sub-layers inject, in frozen ((block, (layers...)), ...)
    form.  Construct with plain dicts via `make`."""

    spatial_attn: tuple = ()
    temporal_attn: tuple = ()
    resnet: tuple = ()
    temp_conv: tuple = ()
    out_conv: bool = True

    @staticmethod
    def make(spatial_attn=None, temporal_attn=None, resnet=None, temp_conv=None,
             out_conv: bool = True) -> "SiteMap":
        return SiteMap(spatial_attn=_freeze_sites(spatial_attn or {}),
                       temporal_attn=_freeze_sites(temporal_attn or {}),
                       resnet=_freeze_sites(resnet or {}),
                       temp_conv=_freeze_sites(temp_conv or {}), out_conv=out_conv)

    @staticmethod
    def _at(frozen: tuple, block: int) -> tuple:
        for b, layers in frozen:
            if b == block:
                return layers
        return ()

    def spatial_at(self, block: int) -> tuple:
        return self._at(self.spatial_attn, block)

    def temporal_at(self, block: int) -> tuple:
        return self._at(self.temporal_attn, block)

    def resnet_at(self, block: int) -> tuple:
        return self._at(self.resnet, block)

    def temp_conv_at(self, block: int) -> tuple:
        return self._at(self.temp_conv, block)

    def block_indices(self) -> set:
        return {b for field in (self.spatial_attn, self.temporal_attn, self.resnet,
                                self.temp_conv) for b, layers in field if layers}


# the reference's placement for the I2VGen-XL UNet
I2VGEN_SITES = SiteMap.make(
    spatial_attn={1: (1, 2), 2: (0, 1, 2), 3: (0, 1, 2)},
    temporal_attn={1: (1, 2), 2: (0, 1, 2), 3: (0, 1, 2)},
    resnet={3: (0, 1, 2)},
    temp_conv={3: (0, 1, 2)},
    out_conv=True,
)


@dataclasses.dataclass(frozen=True)
class PnPState:
    """Per-step injection state threaded through the UNet forward.

    masks / masks_soft: (h, w) -> binary / soft mask pyramids, [N, F, h, w]
        for one entry or [J, N, F, h, w] for J entries.  J entries ride the
        UNet batch entry-major: entry e owns batch rows e*B .. e*B + B-1
        (B = N+3 fused, N+1 in a capture, 2 in a consume, 1 in a stream
        capture), and every site composites each entry with its own masks.
    gate_*: whether each kind of site injects at this step.
    mode: "fused" (all branches in one batch) or "consume_pre" (the edit
        batch of 2 per entry, taking the pre-composited S of every site from
        `features`, [J*F, ...] per site).
    capture_weight: the current source branch's multipliers for streamed
        capture ("qk_binary" / "qk_soft" / "conv", res -> [F, h, w] or
        [J, F, h, w])."""

    masks: Pyramid
    gate_spatial: bool
    gate_temporal: bool
    gate_conv: bool
    masks_soft: Optional[Pyramid] = None
    inject_background: bool = True
    mode: str = "fused"
    features: Optional[Dict[str, object]] = None
    capture_weight: Optional[Dict[str, Pyramid]] = None

    @property
    def num_entries(self) -> int:
        m = next(iter(self.masks.values()))
        return m.shape[0] if m.ndim == 5 else 1

    @property
    def num_objects(self) -> int:
        return next(iter(self.masks.values())).shape[-4]

    @property
    def num_branches(self) -> int:
        """Branches of one entry in the fused batch."""
        return self.num_objects + 3

    def mask_at(self, h: int, w: int, soft: bool = False) -> torch.Tensor:
        table = self.masks_soft if (soft and self.masks_soft is not None) else self.masks
        try:
            return table[(h, w)]
        except KeyError:
            raise KeyError(f"no precomputed mask at resolution {(h, w)}; "
                           f"have {sorted(table)}") from None

    def entry_masks(self, h: int, w: int, soft: bool = False) -> torch.Tensor:
        """The masks at (h, w) with their entry axis: [J, N, F, h, w]."""
        m = self.mask_at(h, w, soft=soft)
        return m if m.ndim == 5 else m[None]


def frame_slice(state: PnPState, lo: int, hi: int) -> PnPState:
    """The state a UNet forward on frames lo..hi-1 of a mesh's frame shard
    reads: its masks and capture weights cut to those frames (axis -3 of
    [.., F, h, w]); `features` come from forwards on the same shard and
    are kept."""
    def cut(pyr):
        return None if pyr is None else {res: m[..., lo:hi, :, :] for res, m in pyr.items()}

    weights = None if state.capture_weight is None else {
        kind: cut(pyr) for kind, pyr in state.capture_weight.items()}
    return dataclasses.replace(state, masks=cut(state.masks), masks_soft=cut(state.masks_soft),
                               capture_weight=weights)


def build_mask_pyramid(masks: np.ndarray, resolutions: list[tuple[int, int]]
                       ) -> Dict[Tuple[int, int], np.ndarray]:
    """Nearest-resize [N, F, H, W] masks to every injection resolution
    (torch F.interpolate(mode='nearest') indexing: floor(i*H/h))."""
    n, f, H, W = masks.shape
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for (h, w) in resolutions:
        if (h, w) == (H, W):
            out[(h, w)] = masks.astype(np.float32)
            continue
        ys = (np.arange(h) * (H / h)).astype(np.int64)
        xs = (np.arange(w) * (W / w)).astype(np.int64)
        out[(h, w)] = masks[:, :, ys][:, :, :, xs].astype(np.float32)
    return out


def injection_gates(full_timesteps, run_timesteps, n_steps: int, pnp_f_t: float,
                    pnp_spatial_attn_t: float, pnp_temp_attn_t: float) -> dict[str, np.ndarray]:
    """Per-step booleans: a step injects iff its t is among the first
    int(n_steps * fraction) entries of the full schedule, or t == 1000."""
    full_timesteps = np.asarray(full_timesteps)
    out = {}
    for name, frac in (("conv", pnp_f_t), ("spatial", pnp_spatial_attn_t),
                       ("temporal", pnp_temp_attn_t)):
        sched = {int(t) for t in full_timesteps[: int(n_steps * frac)]}
        out[name] = np.asarray([int(t) in sched or int(t) == 1000 for t in run_timesteps],
                               dtype=bool)
    return out


# Every function below works on J entries at once: batch tensors hold the
# entries' branches entry-major, masks are [J, N, ...] (PnPState.entry_masks),
# and the object axis is axis 1.


def _composite(base: torch.Tensor, objs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """base [J, 1, ...], objs [J, N, ...], masks [J, N, ...]; later object wins."""
    for j in range(objs.shape[1]):
        m = masks[:, j:j + 1]
        base = base * (1.0 - m) + objs[:, j:j + 1] * m
    return base


def _inject_chunks(xb: torch.Tensor, injected: torch.Tensor, n_obj: int) -> torch.Tensor:
    """Overwrite each entry's uncond + cond chunks (its last two) with
    `injected` [J, 1, ...]; xb [J, N+3, ...]."""
    return torch.cat([xb[:, : n_obj + 1], injected, injected], dim=1)


# -- fused path --------------------------------------------------------------


def inject_spatial_qk(q, k, pnp: PnPState, h: int, w: int, soft: bool = False,
                      gate: Optional[bool] = None):
    """q, k: [J*B*F, h*w, C], B = N+3.  soft/gate serve the natural-layout
    temporal sites, whose [J*B, F, hw, C] tokens flatten to this layout."""
    if not (pnp.gate_spatial if gate is None else gate):
        return q, k
    J, n, B = pnp.num_entries, pnp.num_objects, pnp.num_branches
    bf, hw, c = q.shape
    f = bf // (J * B)
    mask = pnp.entry_masks(h, w, soft=soft).to(q.dtype).reshape(J, n, f, hw, 1)

    def edit(x):
        xb = x.reshape(J, B, f, hw, c)
        base = xb[:, 0:1] if pnp.inject_background else xb[:, B - 1:]
        inj = _composite(base, xb[:, 1:n + 1], mask)
        return _inject_chunks(xb, inj, n).reshape(bf, hw, c)

    return edit(q), edit(k)


def _pixel_major(mask: torch.Tensor, hw: int) -> torch.Tensor:
    """[J, N, F, h, w] -> [J, N, hw, F, 1]: pixels gate rows, frames columns."""
    J, n, f = mask.shape[:3]
    return mask.permute(0, 1, 3, 4, 2).reshape(J, n, hw, f, 1)


def inject_temporal_qk(q, k, pnp: PnPState, h: int, w: int):
    """q, k: [J*B*h*w, F, C] (entry, branch, then pixel); soft masks."""
    if not pnp.gate_temporal:
        return q, k
    J, n, B = pnp.num_entries, pnp.num_objects, pnp.num_branches
    bhw, f, c = q.shape
    hw = bhw // (J * B)
    mask = _pixel_major(pnp.entry_masks(h, w, soft=True).to(q.dtype), hw)

    def edit(x):
        xb = x.reshape(J, B, hw, f, c)
        base = xb[:, 0:1] if pnp.inject_background else xb[:, B - 1:]
        inj = _composite(base, xb[:, 1:n + 1], mask)
        return _inject_chunks(xb, inj, n).reshape(bhw, f, c)

    return edit(q), edit(k)


def inject_conv_features(x, pnp: PnPState, h: int, w: int):
    """x: [J*B*F, h, w, C]; the base is always the bg chunk."""
    if not pnp.gate_conv:
        return x
    J, n, B = pnp.num_entries, pnp.num_objects, pnp.num_branches
    bf, hh, ww, c = x.shape
    f = bf // (J * B)
    mask = pnp.entry_masks(h, w).to(x.dtype).reshape(J, n, f, hh, ww, 1)
    xb = x.reshape(J, B, f, hh, ww, c)
    inj = _composite(xb[:, 0:1], xb[:, 1:n + 1], mask)
    return _inject_chunks(xb, inj, n).reshape(bf, hh, ww, c)


# -- streamed capture: one source branch of every entry per UNet call ---------


def _transparency(masks: torch.Tensor) -> torch.Tensor:
    """masks [J, N, ...] -> prod_j (1 - m_j), [J, ...]."""
    w = 1.0 - masks[:, 0]
    for j in range(1, masks.shape[1]):
        w = w * (1.0 - masks[:, j])
    return w


def build_capture_weights(pyr_binary: Pyramid, pyr_soft: Pyramid, inject_background: bool
                          ) -> Dict[str, Pyramid]:
    """Per-branch capture multipliers M_b, stacked [N+1, F, h, w] (or
    [J, N+1, F, h, w] from [J, N, ...] pyramids):
        M_0 = prod_j (1 - m_j)   (attention sites: zero unless
                                  inject_background; conv sites: always)
        M_j = m_j * prod_{k>j} (1 - m_k)
    so that sum_b x_b * M_b is the pre-composited S of every site."""
    def stack(pyr, qk: bool):
        out = {}
        for res, m in pyr.items():
            m = torch.as_tensor(m)
            batched = m.ndim == 5
            m = m if batched else m[None]
            w_all = _transparency(m)
            branches = [torch.zeros_like(w_all) if (qk and not inject_background) else w_all]
            for j in range(m.shape[1]):
                t = m[:, j]
                for kk in range(j + 1, m.shape[1]):
                    t = t * (1.0 - m[:, kk])
                branches.append(t)
            out[res] = torch.stack(branches, dim=1) if batched else torch.stack(branches)[:, 0]
        return out

    return {"qk_binary": stack(pyr_binary, True), "qk_soft": stack(pyr_soft, True),
            "conv": stack(pyr_binary, False)}


def stream_capture_spatial(q, k, pnp: PnPState, h: int, w: int):
    """One source branch's term: q, k [J*F, hw, C] -> (q*M, k*M)."""
    wgt = pnp.capture_weight["qk_binary"][(h, w)].to(q.dtype).reshape(-1, h * w, 1)
    return q * wgt, k * wgt


def stream_capture_temporal(q, k, pnp: PnPState, h: int, w: int):
    """Pixel-major temporal layout: q, k [J*hw, F, C]."""
    wgt = pnp.capture_weight["qk_soft"][(h, w)].to(q.dtype)
    f = wgt.shape[-3]
    wgt = wgt.reshape(-1, f, h * w).transpose(1, 2).reshape(-1, f, 1)
    return q * wgt, k * wgt


def stream_capture_temporal_natural(q, k, pnp: PnPState, h: int, w: int):
    """Frame-major temporal layout flattened: q, k [J*F, hw, C]."""
    wgt = pnp.capture_weight["qk_soft"][(h, w)].to(q.dtype).reshape(-1, h * w, 1)
    return q * wgt, k * wgt


def stream_capture_conv(x, pnp: PnPState, h: int, w: int):
    """Conv sites: x [J*F, h, w, C] -> x*M (the bg term always included)."""
    return x * pnp.capture_weight["conv"][(h, w)].to(x.dtype).reshape(-1, h, w)[..., None]


# -- pre-composited capture: one branch-equivalent S per site and entry -------
#
# base <- base*(1-m_j) + obj_j*m_j expands to inj = base*W + S with
# W = prod_j (1-m_j) and S = sum_j obj_j*m_j*prod_{k>j}(1-m_k): W depends on
# the masks only, S on the source branches only (bg folded in when it is
# the base).  S is stored like one branch of every entry: [J*F, ...].


def _source_sum(objs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """objs, masks [J, N, ...] -> sum_j obj_j*m_j*prod_{k>j}(1-m_k), [J, ...]."""
    n = objs.shape[1]
    s = torch.zeros_like(objs[:, 0])
    for j in range(n):
        term = objs[:, j] * masks[:, j]
        for kk in range(j + 1, n):
            term = term * (1.0 - masks[:, kk])
        s = s + term
    return s


def precomposite_spatial(q, k, pnp: PnPState, h: int, w: int, soft: bool = False):
    """Source q/k [J*(N+1)*F, hw, C] -> per-site S [J*F, hw, C]."""
    J, n = pnp.num_entries, pnp.num_objects
    bf, hw, c = q.shape
    f = bf // (J * (n + 1))
    mask = pnp.entry_masks(h, w, soft=soft).to(q.dtype).reshape(J, n, f, hw, 1)

    def s_of(x):
        xb = x.reshape(J, n + 1, f, hw, c)
        s = _source_sum(xb[:, 1:], mask)
        if pnp.inject_background:
            s = s + xb[:, 0] * _transparency(mask)
        return s.reshape(J * f, hw, c)

    return s_of(q), s_of(k)


def precomposite_temporal(q, k, pnp: PnPState, h: int, w: int):
    """Source q/k [J*(N+1)*hw, F, C] (pixel-major temporal layout) -> S
    [J*hw, F, C]."""
    J, n = pnp.num_entries, pnp.num_objects
    bhw, f, c = q.shape
    hw = bhw // (J * (n + 1))
    mask = _pixel_major(pnp.entry_masks(h, w, soft=True).to(q.dtype), hw)

    def s_of(x):
        xb = x.reshape(J, n + 1, hw, f, c)
        s = _source_sum(xb[:, 1:], mask)
        if pnp.inject_background:
            s = s + xb[:, 0] * _transparency(mask)
        return s.reshape(J * hw, f, c)

    return s_of(q), s_of(k)


def precomposite_conv(x, pnp: PnPState, h: int, w: int):
    """Source x [J*(N+1)*F, h, w, C] -> the full composite [J*F, h, w, C]
    (base is bg)."""
    J, n = pnp.num_entries, pnp.num_objects
    bf, hh, ww, c = x.shape
    f = bf // (J * (n + 1))
    mask = pnp.entry_masks(h, w).to(x.dtype).reshape(J, n, f, hh, ww, 1)
    xb = x.reshape(J, n + 1, f, hh, ww, c)
    return (_source_sum(xb[:, 1:], mask) + xb[:, 0] * _transparency(mask)).reshape(
        J * f, hh, ww, c)


def consume_spatial_precomposited(q, k, s_q, s_k, pnp: PnPState, h: int, w: int,
                                  soft: bool = False, gate: Optional[bool] = None):
    """q, k: [J*2*F, hw, C]; s_*: the captured S [J*F, hw, C]."""
    if not (pnp.gate_spatial if gate is None else gate):
        return q, k
    J, n = pnp.num_entries, pnp.num_objects
    bf, hw, c = q.shape
    f = bf // (2 * J)
    mask = pnp.entry_masks(h, w, soft=soft).to(q.dtype).reshape(J, n, f, hw, 1)

    def edit(x, s):
        inj = s.reshape(J, 1, f, hw, c)
        if not pnp.inject_background:
            inj = x.reshape(J, 2, f, hw, c)[:, 1:2] * _transparency(mask)[:, None] + inj
        return torch.cat([inj, inj], dim=1).reshape(bf, hw, c)

    return edit(q, s_q), edit(k, s_k)


def consume_temporal_precomposited(q, k, s_q, s_k, pnp: PnPState, h: int, w: int):
    """q, k: [J*2*hw, F, C]; s_*: the captured S [J*hw, F, C]."""
    if not pnp.gate_temporal:
        return q, k
    J = pnp.num_entries
    bhw, f, c = q.shape
    hw = bhw // (2 * J)
    mask = _pixel_major(pnp.entry_masks(h, w, soft=True).to(q.dtype), hw)

    def edit(x, s):
        inj = s.reshape(J, 1, hw, f, c)
        if not pnp.inject_background:
            inj = x.reshape(J, 2, hw, f, c)[:, 1:2] * _transparency(mask)[:, None] + inj
        return torch.cat([inj, inj], dim=1).reshape(bhw, f, c)

    return edit(q, s_q), edit(k, s_k)


def consume_conv_precomposited(x, s, pnp: PnPState, h: int, w: int):
    """x: [J*2*F, h, w, C]; s: the captured composite [J*F, h, w, C]."""
    if not pnp.gate_conv:
        return x
    J = pnp.num_entries
    bf, hh, ww, c = x.shape
    s = s.reshape(J, 1, bf // (2 * J), hh, ww, c)
    return torch.cat([s, s], dim=1).reshape(bf, hh, ww, c)
