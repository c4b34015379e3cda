"""Host-side image preprocessing the pipeline calls (own copy of the PIL
helpers of mvoc_tpu/io/media.py, which the port does not import)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image


def center_crop_wide(image: Image.Image, resolution: tuple[int, int]) -> Image.Image:
    """Aspect-preserving scale, then a centre crop to (w, h)."""
    tw, th = resolution
    scale = max(tw / image.size[0], th / image.size[1])
    new_size = (round(image.size[0] * scale), round(image.size[1] * scale))
    image = image.resize(new_size, resample=Image.Resampling.BOX, reducing_gap=1)
    left = (image.size[0] - tw) // 2
    top = (image.size[1] - th) // 2
    return image.crop((left, top, left + tw, top + th))


def resize_bilinear(image: Image.Image, resolution: tuple[int, int]) -> Image.Image:
    return image.resize(tuple(resolution), resample=Image.Resampling.BILINEAR)


def pil_to_neg1_1(images: Sequence[Image.Image]) -> np.ndarray:
    """[F, H, W, 3] float32 in [-1, 1]."""
    arr = np.stack([np.asarray(im.convert("RGB"), dtype=np.float32) for im in images])
    return arr / 127.5 - 1.0


def pil_to_01(images: Sequence[Image.Image]) -> np.ndarray:
    arr = np.stack([np.asarray(im.convert("RGB"), dtype=np.float32) for im in images])
    return arr / 255.0


def video_to_pil(video01: np.ndarray) -> list[Image.Image]:
    """[F, H, W, 3] in [0, 1] -> PIL frames."""
    arr = np.clip(video01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return [Image.fromarray(f) for f in arr]
