"""Affine object placement: an OpenCV affine converted to a normalised grid
warp (the port's copy of mvoc_tpu/ops/affine.py).

The reference ships (dormant) repositioning utilities,
`cvt_cv_aff2torch_aff` and `warp_affine_torch` (utils.py:157-180, plumbed
through `obj_width_height` at composite.py:185): convert a 2x3 OpenCV affine
into the normalised-coordinate convention and warp a channels-last tensor,
to move and resize object masks and latents on the collage canvas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def cv_affine_to_normalized(theta_cv: np.ndarray, src_hw: tuple[int, int],
                            dst_hw: tuple[int, int]) -> np.ndarray:
    """A 2x3 OpenCV affine (pixel coordinates, src -> dst) -> the 2x3 inverse
    map in normalised coordinates (dst -> src), align_corners=False."""
    m = np.concatenate([np.asarray(theta_cv, np.float64), [[0.0, 0.0, 1.0]]])
    m_inv = np.linalg.inv(m)

    def norm(hw):
        h, w = hw
        # pixel -> [-1, 1], centres at (i + 0.5) / n * 2 - 1
        return np.array([[2.0 / w, 0.0, 1.0 / w - 1.0],
                         [0.0, 2.0 / h, 1.0 / h - 1.0],
                         [0.0, 0.0, 1.0]])

    return (norm(src_hw) @ m_inv @ np.linalg.inv(norm(dst_hw)))[:2].astype(np.float32)


def warp_affine(x: torch.Tensor, theta, out_hw: tuple[int, int],
                mode: str = "nearest") -> torch.Tensor:
    """Warp x [B, H, W, C] by a normalised 2x3 theta (the dst -> src map) to
    [B, out_h, out_w, C]; samples outside the source are zero."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    dev = x.device
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    ys = (torch.arange(oh, device=dev, dtype=torch.float32) + 0.5) / oh * 2.0 - 1.0
    xs = (torch.arange(ow, device=dev, dtype=torch.float32) + 0.5) / ow * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [oh, ow, 3]
    src = coords @ theta.T  # [oh, ow, 2]: normalised (x, y) in the source
    sx = (src[..., 0] + 1.0) * 0.5 * w - 0.5
    sy = (src[..., 1] + 1.0) * 0.5 * h - 0.5

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        g = x[:, yy.clamp(0, h - 1), xx.clamp(0, w - 1), :]
        return torch.where(valid[None, :, :, None], g, torch.zeros((), dtype=x.dtype, device=dev))

    if mode == "nearest":
        return gather(torch.round(sy).long(), torch.round(sx).long()).to(x.dtype)
    if mode == "bilinear":
        x0, y0 = torch.floor(sx).long(), torch.floor(sy).long()
        fx, fy = (sx - x0)[None, :, :, None], (sy - y0)[None, :, :, None]
        out = (gather(y0, x0) * ((1 - fx) * (1 - fy)) + gather(y0, x0 + 1) * (fx * (1 - fy))
               + gather(y0 + 1, x0) * ((1 - fx) * fy) + gather(y0 + 1, x0 + 1) * (fx * fy))
        return out.to(x.dtype)
    raise ValueError(f"unknown mode {mode}")


def place_object(x: torch.Tensor, scale: float, tx: float, ty: float,
                 out_hw: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """Scale an object about its top-left corner and translate it by (tx,
    ty) pixels on the canvas (the `obj_width_height` use)."""
    _, h, w, _ = x.shape
    theta_cv = np.array([[scale, 0.0, tx], [0.0, scale, ty]], np.float32)
    out_hw = out_hw or (h, w)
    return warp_affine(x, cv_affine_to_normalized(theta_cv, (h, w), out_hw), out_hw)
