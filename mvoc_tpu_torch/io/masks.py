"""Per-object masks at latent resolution (the port's own copy of
mvoc_tpu/io/masks.py).

Reference semantics (utils.py:92-154, used at pipeline_i2vgen_xl.py:1586-1599):

* a static mask is one grayscale PNG, a dynamic mask a directory of
  per-frame PNGs (numeric-stem sorted, cut to n_frames, the last frame
  repeated when short);
* each is downscaled x8 from the mask file's OWN size with PIL's default
  BICUBIC resample; the soft mask is gray / 255 (noise fusion, temporal
  injection), the binary mask gray > 10 of the downscaled gray (spatial and
  conv injection).

Arrays are [F, h, w] float32; the per-resolution pyramid is built once by
pnp.build_mask_pyramid.
"""

from __future__ import annotations

import os.path as osp
from glob import glob

import numpy as np
from PIL import Image

from mvoc_tpu_torch.io.media import _frame_sort_key


def _load_one(
    path: str, downscale: int, target_wh: tuple[int, int] | None = None
) -> tuple[np.ndarray, np.ndarray]:
    m = Image.open(path).convert("L")
    w, h = m.size
    # target_wh: an explicit size for masks authored at another size than
    # the working resolution (the same as //downscale when they match)
    m = m.resize(target_wh or (w // downscale, h // downscale))  # PIL default = BICUBIC
    arr = np.asarray(m, dtype=np.float32)
    soft = arr / 255.0
    binary = (arr > 10).astype(np.float32)  # cv2.threshold(.., 10, 255, BINARY)
    return soft, binary


def mask_preprocess(
    mask_path: str,
    n_frames: int,
    downscale: int = 8,
    target_wh: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (soft, binary), each [F, h, w] float32."""
    if osp.isdir(mask_path):
        paths = glob(osp.join(mask_path, "*.png"))
        if not paths:
            raise FileNotFoundError(f"no mask frames in {mask_path}")
        paths.sort(key=_frame_sort_key)
        paths = paths[:n_frames]
        pairs = [_load_one(p, downscale, target_wh) for p in paths]
        soft = np.stack([p[0] for p in pairs])
        binary = np.stack([p[1] for p in pairs])
        if soft.shape[0] < n_frames:  # repeat last frame if short
            pad = n_frames - soft.shape[0]
            soft = np.concatenate([soft, np.repeat(soft[-1:], pad, 0)])
            binary = np.concatenate([binary, np.repeat(binary[-1:], pad, 0)])
        return soft, binary
    soft, binary = _load_one(mask_path, downscale, target_wh)
    return (
        np.repeat(soft[None], n_frames, axis=0),
        np.repeat(binary[None], n_frames, axis=0),
    )


def masks_from_arrays(
    masks01: np.ndarray, n_frames: int, downscale: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """The same from in-memory [*, H, W] arrays in [0, 1]."""
    out_s, out_b = [], []
    frames = masks01 if masks01.ndim == 3 else masks01[None]
    for fr in frames:
        img = Image.fromarray((fr * 255).astype(np.uint8), mode="L")
        w, h = img.size
        img = img.resize((w // downscale, h // downscale))
        arr = np.asarray(img, dtype=np.float32)
        out_s.append(arr / 255.0)
        out_b.append((arr > 10).astype(np.float32))
    soft, binary = np.stack(out_s), np.stack(out_b)
    if soft.shape[0] == 1:
        soft = np.repeat(soft, n_frames, axis=0)
        binary = np.repeat(binary, n_frames, axis=0)
    return soft[:n_frames], binary[:n_frames]


def exclusive_occlusion_masks(
    masks_binary: np.ndarray, masks_soft: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-object EXCLUSIVE masks: object j's region minus everything a
    later object covers, so each pixel belongs to at most one object, the
    later one winning.  The reference computes this and then discards it
    (pipeline_i2vgen_xl.py:1606-1632): later-object-wins comes from the
    injection order instead.  An analysis utility.

    masks_*: [N, F, h, w]; returns (soft_exclusive, binary_exclusive)."""
    n = masks_binary.shape[0]
    b = masks_binary.astype(bool)
    cum_union = [b[i:].any(axis=0) for i in range(n)]  # union of j >= i
    out_b, out_s = [], []
    for i in range(n):
        later = cum_union[i + 1] if i + 1 < n else np.zeros_like(b[i])
        exclusive = np.logical_xor(cum_union[i], later)
        out_b.append(np.logical_and(b[i], exclusive).astype(np.float32))
        out_s.append(masks_soft[i] * exclusive.astype(np.float32))
    return np.stack(out_s), np.stack(out_b)
