"""Everything a run feeds the program, made from `--seed`: the weights, the
videos, masks and prompts of each call, and the source trajectories of a
composite.  The same seed gives the same inputs on every machine of one
kind; the program and the reference are handed the same ones.

Weights: the flax-like initialisation the port's tests use (lecun-normal
kernels truncated at two standard deviations, zero biases, unit norm
scales, zero `conv4` of every temporal conv layer, the CLIP embeddings'
normal initialisers), drawn on the device in a few large calls into one
flat buffer per model part, in the dtype the configuration serves, by
inverse-CDF sampling of the truncated normal, then copied out into a
tensor of its own per parameter, as a checkpoint loader allocates them (so
that a layer the int8 mode replaces frees its float weight).
"""

from __future__ import annotations

import dataclasses
import math
import re
import zlib
from typing import Optional

import numpy as np
import torch
from PIL import Image

from portbench.reference.pipeline import alphas_cumprod, sampling_timesteps

# flax's truncated-normal variance scaling divides by the std of a unit
# normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978
ALIGN = 64  # elements between the starts of two parameters in the buffer
DRAW_CHUNK = 1 << 26  # float32 elements per draw

_CONV4 = re.compile(r"temp_convs\.\d+\.conv4\.2\.(weight|bias)$")


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed for one use of the run's seed."""
    mix = np.random.SeedSequence([int(seed) % (1 << 63)] + [zlib.crc32(str(x).encode())
                                                         for x in labels])
    return int(mix.generate_state(1, dtype=np.uint64)[0] >> 1)


def _kinds(module: torch.nn.Module) -> list:
    """(name, shape, kind, scale) of every parameter: kind "trunc" (scale =
    its standard deviation), "normal", "zero" or "one"."""
    out = []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            if name.endswith("text_model.embeddings.position_embedding.weight"):
                out.append((name, shape, "normal", 0.01))
            elif name.endswith(("vision_model.embeddings.position_embedding.weight",
                                "vision_model.embeddings.class_embedding")):
                out.append((name, shape, "normal", 0.02))
            elif isinstance(mod, torch.nn.Embedding):
                out.append((name, shape, "normal", 1.0 / math.sqrt(shape[1])))
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d)):
                if pname == "bias" or _CONV4.search(name):
                    out.append((name, shape, "zero", 0.0))
                else:
                    fan_in = shape[1] * math.prod(shape[2:])
                    out.append((name, shape, "trunc", math.sqrt(1.0 / fan_in) / TRUNC_STD))
            else:  # norms: unit scale, zero shift
                out.append((name, shape, "one" if pname == "weight" else "zero", 0.0))
    return out


@torch.no_grad()
def make_weights(module: torch.nn.Module, seed: int, device, dtype) -> dict:
    """{name: tensor} for every parameter of `module` (built on the meta
    device), drawn into one flat `dtype` buffer on `device`."""
    kinds = _kinds(module)
    order = sorted(range(len(kinds)), key=lambda i: ("trunc", "normal", "zero", "one").index(
        kinds[i][2]))
    offsets, pos = {}, 0
    bounds = {}
    for i in order:
        name, shape, kind, _ = kinds[i]
        offsets[name] = pos
        bounds.setdefault(kind, [pos, pos])
        pos = -(-(pos + math.prod(shape)) // ALIGN) * ALIGN
        bounds[kind][1] = pos
    flat = torch.empty(pos, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lo, hi = bounds.get("trunc", (0, 0))
    # inverse CDF of the normal truncated to [-2, 2]
    c_lo, c_hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2
    for a in range(lo, hi, DRAW_CHUNK):
        n = min(DRAW_CHUNK, hi - a)
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
        u.mul_(c_hi - c_lo).add_(c_lo).mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
        flat[a:a + n].copy_(u.clamp_(-2.0, 2.0))
    lo, hi = bounds.get("normal", (0, 0))
    for a in range(lo, hi, DRAW_CHUNK):
        n = min(DRAW_CHUNK, hi - a)
        flat[a:a + n].copy_(torch.randn(n, generator=gen, device=device, dtype=torch.float32))
    for kind, value in (("zero", 0.0), ("one", 1.0)):
        if kind in bounds:
            flat[bounds[kind][0]:bounds[kind][1]].fill_(value)
    out = {}
    for name, shape, kind, scale in kinds:
        view = flat[offsets[name]:offsets[name] + math.prod(shape)].view(shape)
        if kind in ("trunc", "normal"):
            view.mul_(scale)
        out[name] = view.clone()
    return out


# -- traffic ---------------------------------------------------------------------


class Tokenizer:
    """Word ids by CRC-32 (a stand-in for the CLIP tokenizer with its call
    contract): [BOS, words..., EOS], padded with 1 to max_length."""

    def __init__(self, vocab_size: int, model_max_length: int):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def __call__(self, texts, padding=None, max_length=None, truncation=True,
                 return_tensors="np"):
        max_length = max_length or self.model_max_length
        ids = np.ones((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [0] + [zlib.crc32(w.encode()) % (self.vocab_size - 2) + 2 for w in t.split()]
            toks = toks[: max_length - 1] + [1]
            ids[i, : len(toks)] = toks
        return {"input_ids": ids}


def synthetic_video(rng: np.random.Generator, frames: int, width: int, height: int) -> list:
    """A smooth colour field with a bright square moving sideways."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yy, xx = yy / height, xx / width
    phase = rng.uniform(0, 2 * np.pi, 3)
    base = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy) + p) for p in phase], -1)
    out = []
    for i in range(frames):
        img = base.copy()
        x0 = (width // 8 + i * width // (4 * frames)) % (width - width // 4)
        img[height // 3: height // 3 + height // 6, x0: x0 + width // 6] = 1.0
        out.append(Image.fromarray((img * 255).astype(np.uint8)))
    return out


def object_masks(rng: np.random.Generator, n: int, frames: int, h: int, w: int):
    """(soft, binary) [N, F, h, w] float32: ellipses drifting across the
    frames, soft edges one tenth of their radius wide, binary at 0.5."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    soft = np.zeros((n, frames, h, w), np.float32)
    for j in range(n):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.2, 0.8) * w
        ry, rx = rng.uniform(0.15, 0.3) * h, rng.uniform(0.1, 0.2) * w
        vy, vx = rng.uniform(-0.01, 0.01) * h, rng.uniform(-0.02, 0.02) * w
        for f in range(frames):
            r = np.sqrt(((yy - cy - vy * f) / ry) ** 2 + ((xx - cx - vx * f) / rx) ** 2)
            soft[j, f] = np.clip((1.1 - r) / 0.2, 0.0, 1.0)
    return soft, (soft >= 0.5).astype(np.float32)


@dataclasses.dataclass
class CompositeEntry:
    """One composite's raw inputs.  Trajectories [S, F, h, w, C] hold
    float16 values (the trajectory store's precision) as float32, at the
    full schedule's timesteps `full_ts`."""

    seed: int
    prompts: dict
    ids: dict
    main_first: Image.Image
    main_frames: list
    bg_frames: list
    obj_frames: list
    masks_soft: np.ndarray
    masks_binary: np.ndarray
    full_ts: np.ndarray
    bg_traj: np.ndarray
    obj_traj: np.ndarray
    # the run schedule's views, set by check.composite_plan
    bg_run: Optional[np.ndarray] = None
    obj_run: Optional[np.ndarray] = None
    obj_fusion: Optional[np.ndarray] = None


def source_trajectories(seed: int, n_videos: int, full_ts: np.ndarray, frames: int, h: int,
                        w: int, channels: int, device) -> np.ndarray:
    """[V, S, F, h, w, C]: noised latents x_t = sqrt(a_t) x0 + sqrt(1 - a_t) e
    of a smooth random x0 at each timestep of the full schedule, rounded to
    float16, as a DDIM inversion of a video leaves them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    acp = torch.as_tensor(alphas_cumprod()[np.asarray(full_ts)], device=device)
    coarse = torch.randn((n_videos * frames, channels, max(1, h // 4), max(1, w // 4)),
                         generator=gen, device=device)
    x0 = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                         align_corners=False)
    x0 = x0.reshape(n_videos, frames, channels, h, w).permute(0, 1, 3, 4, 2)
    eps = torch.randn(x0.shape, generator=gen, device=device)
    a = acp[None, :, None, None, None, None]
    traj = a.sqrt() * x0[:, None] + (1 - a).sqrt() * eps[:, None]
    return traj.half().float().cpu().numpy()


def composite_entry(seed: int, call: dict, tokenizer: Tokenizer, latent_scale: int,
                    channels: int, device) -> CompositeEntry:
    """One composite's inputs at the call's geometry (width, height, frames,
    objects) and schedule (n_steps), with the call's prompts."""
    rng = np.random.default_rng(sub_seed(seed, "entry"))
    W, H, F_, n = call["width"], call["height"], call["frames"], call["objects"]
    h, w = H // latent_scale, W // latent_scale
    bg = synthetic_video(rng, F_, W, H)
    objs = [synthetic_video(rng, F_, W, H) for _ in range(n)]
    main = synthetic_video(rng, F_, W, H)
    main_first = synthetic_video(rng, 1, W, H)[0]
    soft, binary = object_masks(rng, n, F_, h, w)
    full_ts = sampling_timesteps(call["n_steps"])
    traj = source_trajectories(sub_seed(seed, "trajectories"), n + 1, full_ts, F_, h, w,
                               channels, device)
    prompts = {"prompt": call["prompt"], "negative": call["negative_prompt"],
               "inversion": call.get("inversion_prompt", "")}
    ids = {k: tokenizer([v], padding="max_length", max_length=tokenizer.model_max_length)[
        "input_ids"] for k, v in prompts.items()}
    return CompositeEntry(seed=int(rng.integers(0, 2 ** 31 - 1)), prompts=prompts, ids=ids,
                          main_first=main_first, main_frames=main, bg_frames=bg, obj_frames=objs,
                          masks_soft=soft, masks_binary=binary, full_ts=full_ts,
                          bg_traj=traj[0], obj_traj=traj[1:])


def inversion_videos(seed: int, call: dict) -> list:
    """J videos of the call's geometry."""
    rng = np.random.default_rng(sub_seed(seed, "videos"))
    return [synthetic_video(rng, call["frames"], call["width"], call["height"])
            for _ in range(call["entries"])]
