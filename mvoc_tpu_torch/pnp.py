"""Plug-and-play (PnP) feature injection for multi-video composition
(PyTorch counterpart of mvoc_tpu/pnp.py).

The UNet forward takes an explicit `PnPState`; every injection site is a
composite of the source branches written into the edit branches, applied
when that site's gate is on.  The sampling loop runs on the host, so gates
are plain Python booleans here (the JAX package carries traced booleans
through `lax.scan`).

Semantics (from the reference, as in the JAX package):
* branch layout of the fused batch: [bg, obj_1..obj_N, uncond, cond];
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

    masks / masks_soft: (h, w) -> [N, F, h, w] binary / soft mask pyramids.
    gate_*: whether each kind of site injects at this step.
    mode: "fused" (all branches in one batch) or "consume_pre" (the edit
        batch of 2, taking the pre-composited S of every site from
        `features`).
    capture_weight: the current source branch's multipliers for streamed
        capture ("qk_binary" / "qk_soft" / "conv", res -> [F, h, w])."""

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
    def num_objects(self) -> int:
        return next(iter(self.masks.values())).shape[0]

    @property
    def num_branches(self) -> int:
        return self.num_objects + 3

    def mask_at(self, h: int, w: int, soft: bool = False) -> torch.Tensor:
        table = self.masks_soft if (soft and self.masks_soft is not None) else self.masks
        try:
            return table[(h, w)]
        except KeyError:
            raise KeyError(f"no precomputed mask at resolution {(h, w)}; "
                           f"have {sorted(table)}") from None


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


def _composite(base: torch.Tensor, objs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """base, objs[j]: [...]; masks: [N, ...]; later object wins."""
    for j in range(objs.shape[0]):
        m = masks[j]
        base = base * (1.0 - m) + objs[j] * m
    return base


def _inject_chunks(x: torch.Tensor, injected: torch.Tensor, n_obj: int) -> torch.Tensor:
    """Overwrite the uncond + cond chunks (the last two) with `injected`."""
    return torch.cat([x[: n_obj + 1], injected, injected], dim=0)


# -- fused path --------------------------------------------------------------


def inject_spatial_qk(q, k, pnp: PnPState, h: int, w: int, soft: bool = False,
                      gate: Optional[bool] = None):
    """q, k: [B*F, h*w, C], B = N+3.  soft/gate serve the natural-layout
    temporal sites, whose [B, F, hw, C] tokens flatten to this layout."""
    if not (pnp.gate_spatial if gate is None else gate):
        return q, k
    n, B = pnp.num_objects, pnp.num_branches
    bf, hw, c = q.shape
    f = bf // B
    mask = pnp.mask_at(h, w, soft=soft).to(q.dtype).reshape(n, 1, f, hw, 1)

    def edit(x):
        xb = x.reshape(B, f, hw, c)
        base = xb[0:1] if pnp.inject_background else xb[B - 1:]
        inj = _composite(base, xb[1:n + 1][:, None], mask)
        return _inject_chunks(xb, inj, n).reshape(bf, hw, c)

    return edit(q), edit(k)


def inject_temporal_qk(q, k, pnp: PnPState, h: int, w: int):
    """q, k: [B*h*w, F, C] (branch, then pixel); soft masks, pixels gate
    rows and frames gate columns."""
    if not pnp.gate_temporal:
        return q, k
    n, B = pnp.num_objects, pnp.num_branches
    bhw, f, c = q.shape
    hw = bhw // B
    mask = pnp.mask_at(h, w, soft=True).to(q.dtype).permute(0, 2, 3, 1).reshape(n, 1, hw, f, 1)

    def edit(x):
        xb = x.reshape(B, hw, f, c)
        base = xb[0:1] if pnp.inject_background else xb[B - 1:]
        inj = _composite(base, xb[1:n + 1][:, None], mask)
        return _inject_chunks(xb, inj, n).reshape(bhw, f, c)

    return edit(q), edit(k)


def inject_conv_features(x, pnp: PnPState, h: int, w: int):
    """x: [B*F, h, w, C]; the base is always the bg chunk."""
    if not pnp.gate_conv:
        return x
    n, B = pnp.num_objects, pnp.num_branches
    bf, hh, ww, c = x.shape
    f = bf // B
    mask = pnp.mask_at(h, w).to(x.dtype).reshape(n, 1, f, hh, ww, 1)
    xb = x.reshape(B, f, hh, ww, c)
    inj = _composite(xb[0:1], xb[1:n + 1][:, None], mask)
    return _inject_chunks(xb, inj, n).reshape(bf, hh, ww, c)


# -- streamed capture: one source branch per UNet call -----------------------


def _transparency(masks: torch.Tensor) -> torch.Tensor:
    w = 1.0 - masks[0]
    for j in range(1, masks.shape[0]):
        w = w * (1.0 - masks[j])
    return w


def build_capture_weights(pyr_binary: Pyramid, pyr_soft: Pyramid, inject_background: bool
                          ) -> Dict[str, Pyramid]:
    """Per-branch capture multipliers M_b, stacked [N+1, F, h, w]:
        M_0 = prod_j (1 - m_j)   (attention sites: zero unless
                                  inject_background; conv sites: always)
        M_j = m_j * prod_{k>j} (1 - m_k)
    so that sum_b x_b * M_b is the pre-composited S of every site."""
    def stack(pyr, qk: bool):
        out = {}
        for res, m in pyr.items():
            m = torch.as_tensor(m)
            w_all = _transparency(m)
            branches = [torch.zeros_like(w_all) if (qk and not inject_background) else w_all]
            for j in range(m.shape[0]):
                t = m[j]
                for kk in range(j + 1, m.shape[0]):
                    t = t * (1.0 - m[kk])
                branches.append(t)
            out[res] = torch.stack(branches)
        return out

    return {"qk_binary": stack(pyr_binary, True), "qk_soft": stack(pyr_soft, True),
            "conv": stack(pyr_binary, False)}


def stream_capture_spatial(q, k, pnp: PnPState, h: int, w: int):
    """One source branch's term: q, k [F, hw, C] -> (q*M, k*M)."""
    wgt = pnp.capture_weight["qk_binary"][(h, w)].to(q.dtype)
    wgt = wgt.reshape(wgt.shape[0], h * w, 1)
    return q * wgt, k * wgt


def stream_capture_temporal(q, k, pnp: PnPState, h: int, w: int):
    """Pixel-major temporal layout: q, k [hw, F, C]."""
    wgt = pnp.capture_weight["qk_soft"][(h, w)].to(q.dtype)
    wgt = wgt.reshape(wgt.shape[0], h * w).T[:, :, None]
    return q * wgt, k * wgt


def stream_capture_temporal_natural(q, k, pnp: PnPState, h: int, w: int):
    """Frame-major temporal layout flattened: q, k [F, hw, C]."""
    wgt = pnp.capture_weight["qk_soft"][(h, w)].to(q.dtype)
    wgt = wgt.reshape(wgt.shape[0], h * w, 1)
    return q * wgt, k * wgt


def stream_capture_conv(x, pnp: PnPState, h: int, w: int):
    """Conv sites: x [F, h, w, C] -> x*M (the bg term always included)."""
    return x * pnp.capture_weight["conv"][(h, w)].to(x.dtype)[..., None]


# -- pre-composited capture: one branch-equivalent S per site -----------------
#
# base <- base*(1-m_j) + obj_j*m_j expands to inj = base*W + S with
# W = prod_j (1-m_j) and S = sum_j obj_j*m_j*prod_{k>j}(1-m_k): W depends on
# the masks only, S on the source branches only (bg folded in when it is
# the base).


def _source_sum(objs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    n = objs.shape[0]
    s = torch.zeros_like(objs[0])
    for j in range(n):
        term = objs[j] * masks[j]
        for kk in range(j + 1, n):
            term = term * (1.0 - masks[kk])
        s = s + term
    return s


def precomposite_spatial(q, k, pnp: PnPState, h: int, w: int, soft: bool = False):
    """Source q/k [(N+1)*F, hw, C] -> per-site S."""
    n = pnp.num_objects
    bf, hw, c = q.shape
    f = bf // (n + 1)
    mask = pnp.mask_at(h, w, soft=soft).to(q.dtype).reshape(n, 1, f, hw, 1)

    def s_of(x):
        xb = x.reshape(n + 1, 1, f, hw, c)
        s = _source_sum(xb[1:], mask)
        if pnp.inject_background:
            s = s + xb[0] * _transparency(mask)
        return s[0]

    return s_of(q), s_of(k)


def precomposite_temporal(q, k, pnp: PnPState, h: int, w: int):
    """Source q/k [(N+1)*hw, F, C] (pixel-major temporal layout) -> S."""
    n = pnp.num_objects
    bhw, f, c = q.shape
    hw = bhw // (n + 1)
    mask = pnp.mask_at(h, w, soft=True).to(q.dtype).permute(0, 2, 3, 1).reshape(n, 1, hw, f, 1)

    def s_of(x):
        xb = x.reshape(n + 1, 1, hw, f, c)
        s = _source_sum(xb[1:], mask)
        if pnp.inject_background:
            s = s + xb[0] * _transparency(mask)
        return s[0]

    return s_of(q), s_of(k)


def precomposite_conv(x, pnp: PnPState, h: int, w: int):
    """Source x [(N+1)*F, h, w, C] -> the full composite (base is bg)."""
    n = pnp.num_objects
    bf, hh, ww, c = x.shape
    f = bf // (n + 1)
    mask = pnp.mask_at(h, w).to(x.dtype).reshape(n, 1, f, hh, ww, 1)
    xb = x.reshape(n + 1, 1, f, hh, ww, c)
    return (_source_sum(xb[1:], mask) + xb[0] * _transparency(mask))[0]


def consume_spatial_precomposited(q, k, s_q, s_k, pnp: PnPState, h: int, w: int,
                                  soft: bool = False, gate: Optional[bool] = None):
    """q, k: [2*F, hw, C]; s_*: the captured S [F, hw, C]."""
    if not (pnp.gate_spatial if gate is None else gate):
        return q, k
    n = pnp.num_objects
    bf, hw, c = q.shape
    f = bf // 2
    mask = pnp.mask_at(h, w, soft=soft).to(q.dtype).reshape(n, f, hw, 1)

    def edit(x, s):
        if pnp.inject_background:
            inj = s[None]
        else:
            inj = x.reshape(2, f, hw, c)[1:2] * _transparency(mask)[None] + s[None]
        return torch.cat([inj, inj], dim=0).reshape(bf, hw, c)

    return edit(q, s_q), edit(k, s_k)


def consume_temporal_precomposited(q, k, s_q, s_k, pnp: PnPState, h: int, w: int):
    """q, k: [2*hw, F, C]; s_*: the captured S [hw, F, C]."""
    if not pnp.gate_temporal:
        return q, k
    n = pnp.num_objects
    bhw, f, c = q.shape
    hw = bhw // 2
    mask = pnp.mask_at(h, w, soft=True).to(q.dtype).permute(0, 2, 3, 1).reshape(n, hw, f, 1)

    def edit(x, s):
        if pnp.inject_background:
            inj = s[None]
        else:
            inj = x.reshape(2, hw, f, c)[1:2] * _transparency(mask)[None] + s[None]
        return torch.cat([inj, inj], dim=0).reshape(bhw, f, c)

    return edit(q, s_q), edit(k, s_k)


def consume_conv_precomposited(x, s, pnp: PnPState, h: int, w: int):
    if not pnp.gate_conv:
        return x
    bf, hh, ww, c = x.shape
    return torch.cat([s[None], s[None]], dim=0).reshape(bf, hh, ww, c)
