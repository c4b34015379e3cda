"""Host-side media IO: frame loading, video decode/encode, preprocessing
(the port's own copy of mvoc_tpu/io/media.py, which it does not import).

Videos are decoded and encoded with OpenCV, frames handled as PIL images
with the reference's LANCZOS resize (reference: utils.py:49-89,
common/filesystem.py scan_dir, pipeline_i2vgen_xl.py:2040-2076).  Without
OpenCV, video decode and mp4 export raise RuntimeError; frame directories
and GIF export need only PIL.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
from PIL import Image

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


# -- directory scanning ------------------------------------------------------------

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def scan_dir(path: str, exts: Iterable[str] = _IMG_EXTS) -> tuple[int, list[str]]:
    """List image files under `path` (non-recursive). Returns (count, paths)."""
    paths = [
        os.path.join(path, f)
        for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in exts
    ]
    return len(paths), paths


def may_make_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


# -- frame loading -------------------------------------------------------------------

def _frame_sort_key(p: str):
    stem = os.path.basename(p).split(".")[0]
    m = re.search(r"\d+", stem)
    return int(m.group()) if m else stem


def load_video_frames(
    frames_path: str, n_frames: int, image_size: tuple[int, int] = (512, 512)
) -> tuple[list[str], list[Image.Image]]:
    """The first n_frames images of a directory, sorted by numeric stem,
    LANCZOS-resized to image_size (w, h) (reference inverse.py:32-45)."""
    count, paths = scan_dir(frames_path)
    if count == 0:
        raise FileNotFoundError(f"no frames found in {frames_path}")
    paths.sort(key=_frame_sort_key)
    paths = paths[:n_frames]
    frames = []
    for p in paths:
        img = Image.open(p).convert("RGB")
        if img.size != tuple(image_size):
            img = img.resize(tuple(image_size), resample=Image.Resampling.LANCZOS)
        frames.append(img)
    return paths, frames


def convert_video_to_frames(
    video_path: str, img_size: tuple[int, int] = (512, 512), save_frames: bool = True
) -> list[Image.Image]:
    """Decode an mp4/mov into LANCZOS-resized PIL frames (reference:
    utils.py:49-72; the torchvision .mov -90 degree rotation quirk is
    reproduced), saved as <video dir>/<stem>/00000.png... when save_frames."""
    if cv2 is None:
        raise RuntimeError("OpenCV not available for video decode")
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        img = Image.fromarray(frame)
        if video_path.endswith(".mov"):
            img = img.rotate(-90, expand=True)
        if img.size != tuple(img_size):
            img = img.resize(tuple(img_size), resample=Image.Resampling.LANCZOS)
        frames.append(img)
    cap.release()
    if save_frames:
        out_dir = Path(video_path).parent / Path(video_path).stem
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(frames):
            img.save(out_dir / f"{i:05d}.png")
    return frames


# -- video export --------------------------------------------------------------------

def export_to_video(frames: Sequence[Image.Image], path: str, fps: int = 8) -> str:
    if cv2 is None:
        raise RuntimeError("OpenCV not available for video encode")
    may_make_dir(os.path.dirname(path) or ".")
    w, h = frames[0].size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(np.asarray(f.convert("RGB")), cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def export_to_gif(frames: Sequence[Image.Image], path: str, fps: int = 8) -> str:
    may_make_dir(os.path.dirname(path) or ".")
    frames[0].save(
        path, save_all=True, append_images=list(frames[1:]),
        duration=int(1000 / fps), loop=0,
    )
    return path


# -- preprocessing ---------------------------------------------------------------------

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
