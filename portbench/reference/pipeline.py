"""The reference's pipeline equations: preprocessing, conditioning, the DDIM
updates, noise fusion and one step of each entry point's loop, in plain
PyTorch (float32 unless the weights are given in another dtype).

Each `*_step` function computes one step of the program's loop from that
step's input latents, and returns (next, base): `next` the latents the
program's next step takes as its input (after the next step's noise fusion,
where it has one), `base` the same with the UNet's noise set to 0.  So
next - base is what the UNet contributed, and a comparison can scale the
program's distance from `next` by it.

The random draws are the published pipeline's: one torch.Generator seeded
from the call's seed, on the call's device, drawn in the pipeline's order
(the start latents, then each VAE sample).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from portbench.reference import model as M

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# -- preprocessing (host, PIL) ------------------------------------------------


def center_crop_wide(image: Image.Image, size: tuple[int, int]) -> Image.Image:
    """Aspect-preserving BOX resize, then a centre crop to (w, h)."""
    tw, th = size
    scale = max(tw / image.size[0], th / image.size[1])
    image = image.resize((round(image.size[0] * scale), round(image.size[1] * scale)),
                         resample=Image.Resampling.BOX, reducing_gap=1)
    left, top = (image.size[0] - tw) // 2, (image.size[1] - th) // 2
    return image.crop((left, top, left + tw, top + th))


def to_array(images: Sequence[Image.Image]) -> np.ndarray:
    return np.stack([np.asarray(im.convert("RGB"), dtype=np.float32) for im in images])


def clip_pixels(images: Sequence[Image.Image], size: int, device, dtype) -> torch.Tensor:
    """Bilinear resize to the CLIP size, [0, 1], CLIP-normalised."""
    px = to_array([im.resize((size, size), resample=Image.Resampling.BILINEAR) for im in images])
    t = torch.as_tensor(px / 255.0, device=device).to(dtype)
    mean = torch.tensor(CLIP_MEAN, device=device, dtype=dtype)
    std = torch.tensor(CLIP_STD, device=device, dtype=dtype)
    return (t - mean) / std


# -- schedules ------------------------------------------------------------------


def alphas_cumprod(n_train: int = 1000, beta_start: float = 0.00085,
                   beta_end: float = 0.012) -> np.ndarray:
    """The scaled-linear schedule's alpha-bar table, float32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_train, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def sampling_timesteps(n_steps: int, n_train: int = 1000) -> np.ndarray:
    """Descending, "leading" spacing, offset 1."""
    return (np.arange(n_steps) * (n_train // n_steps)).round()[::-1].astype(np.int64) + 1


def inversion_timesteps(n_steps: int, n_train: int = 1000) -> np.ndarray:
    return (np.arange(n_steps) * (n_train // n_steps)).round().astype(np.int64) + 1


def injection_gates(full_ts, run_ts, n_steps: int, fracs: dict) -> dict:
    """{kind: [S'] bool}: a run step injects iff its t is among the first
    int(n_steps * fraction) timesteps of the full schedule, or t == 1000."""
    out = {}
    for kind, frac in fracs.items():
        keep = {int(t) for t in full_ts[: int(n_steps * frac)]}
        out[kind] = np.array([int(t) in keep or int(t) == 1000 for t in run_ts], dtype=bool)
    return out


class DDIM:
    def __init__(self, n_train: int = 1000):
        self.n_train = n_train
        self.acp = alphas_cumprod(n_train)

    def _a(self, t: int, boundary: float) -> np.float32:
        return np.float32(boundary) if t < 0 else self.acp[min(t, self.n_train - 1)]

    @staticmethod
    def _x0(sample, eps, a):
        return (sample - float(np.sqrt(np.float32(1.0) - a)) * eps) / float(np.sqrt(a))

    def step(self, eps, t: int, sample, n_steps: int):
        """DDIM, eta 0: the sample at the previous timestep."""
        a_t = self._a(t, self.acp[0])
        a_prev = self._a(t - self.n_train // n_steps, self.acp[0])
        x0 = self._x0(sample, eps, a_t)
        return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(np.float32(1.0) - a_prev)) * eps

    def inverse_step(self, eps, t_to: int, sample, n_steps: int):
        """DDIM inversion: from t_to - n_train // n_steps up to t_to."""
        t_from = min(t_to - self.n_train // n_steps, self.n_train - 1)
        a_from, a_to = self._a(t_from, 1.0), self._a(t_to, 1.0)
        x0 = self._x0(sample, eps, a_from)
        return float(np.sqrt(a_to)) * x0 + float(np.sqrt(np.float32(1.0) - a_to)) * eps


# -- masks ------------------------------------------------------------------------


def injection_resolutions(h_lat: int, w_lat: int, levels: int) -> list:
    """(h, w) of every injection site: up block b at the latent size
    ceil-halved levels-1-b times (b in the site blocks), and the full size."""
    res = {(h_lat, w_lat)}
    for b in set(M.SPATIAL_SITES) | set(M.TEMPORAL_SITES) | set(M.RESNET_SITES):
        h, w = h_lat, w_lat
        for _ in range(levels - 1 - b):
            h, w = (h + 1) // 2, (w + 1) // 2
        res.add((h, w))
    return sorted(res, reverse=True)


def mask_pyramid(masks: np.ndarray, resolutions) -> dict:
    """Nearest-resize [..., H, W] masks to each resolution: floor(i*H/h)."""
    H, W = masks.shape[-2:]
    out = {}
    for h, w in resolutions:
        ys = (np.arange(h) * (H / h)).astype(np.int64)
        xs = (np.arange(w) * (W / w)).astype(np.int64)
        out[(h, w)] = masks[..., ys, :][..., xs].astype(np.float32)
    return out


def fuse(lat, bg, objs, masks_soft, ratio: float, obj_noise: bool):
    """Noise fusion: lat [J, F, h, w, C], bg [J, ...], objs [J, N, ...],
    masks_soft [J, N, F, h, w]."""
    lat = ratio * lat + (1.0 - ratio) * bg
    for j in range(objs.shape[1]):
        m = masks_soft[:, j][..., None]
        paste = objs[:, j] * m
        fg = lat * m * ratio + (1.0 - ratio) * paste if obj_noise else paste
        lat = lat * (1.0 - m) + fg
    return lat


# -- the reference pipeline ---------------------------------------------------------


@dataclasses.dataclass
class Towers:
    """The reference's modules, built from one state dict per part."""

    unet: M.UNet
    vae: M.VAEEncoder
    text: M.CLIPText
    vision: M.CLIPVision
    scaling: float
    latent_scale: int  # pixels per latent


def build_towers(cfg: dict, weights: dict, device, dtype=torch.float32,
                 precision: Optional[M.Precision] = None) -> Towers:
    """Modules of configuration file `cfg` ({"unet": {...}, "vae": ..., ...})
    holding `weights` ({part: {name: tensor}}) cast to `dtype`.  With a
    precision, the UNet's selected layers run fake-quantised."""
    parts = {
        "unet": (M.UNet, M.UNetConfig(**_tuples(cfg["unet"]))),
        "vae": (M.VAEEncoder, M.VAEConfig(**_tuples(cfg["vae"]))),
        "text_encoder": (M.CLIPText, M.CLIPTextConfig(**cfg["text_encoder"])),
        "image_encoder": (M.CLIPVision, M.CLIPVisionConfig(**cfg["image_encoder"])),
    }
    built = {}
    for part, (cls, conf) in parts.items():
        with torch.device("meta"):
            mod = cls(conf)
        names = [n for n, _ in mod.named_parameters()]
        state = {n: weights[part][n].to(device=device, dtype=dtype) for n in names}
        mod.load_state_dict(state, assign=True)
        mod.requires_grad_(False)
        built[part] = mod.eval()
    if precision is not None:
        M.quantize_(built["unet"], precision)
    vae_cfg = parts["vae"][1]
    return Towers(built["unet"], built["vae"], built["text_encoder"], built["image_encoder"],
                  vae_cfg.scaling_factor, 2 ** (len(vae_cfg.block_out_channels) - 1))


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Reference:
    """The entry points' equations over `Towers`, on `device`."""

    def __init__(self, towers: Towers, device, dtype=torch.float32):
        self.t, self.device, self.dtype = towers, torch.device(device), dtype
        self.ddim = DDIM()

    def text(self, ids: np.ndarray) -> torch.Tensor:
        return self.t.text(torch.as_tensor(ids, dtype=torch.long, device=self.device))

    def image_embedding(self, image: Image.Image, crop_width: Optional[int]) -> torch.Tensor:
        """[1, D]: a square centre crop of width crop_width first, or (None)
        the uncropped frame, as the composite's per-frame encode takes it."""
        if crop_width is not None:
            image = center_crop_wide(image, (crop_width, crop_width))
        size = self.t.vision.config.image_size
        return self.t.vision(clip_pixels([image], size, self.device, self.dtype))

    def vae_sample(self, frames, width: int, height: int, gen: torch.Generator,
                   block: int = 1) -> torch.Tensor:
        """Scaled latents [F, h, w, C] of frames at (width, height), the
        posterior sampled with noise from gen (one draw for all frames),
        encoded `block` frames at a time."""
        px = to_array([center_crop_wide(f, (width, height)) for f in frames]) / 127.5 - 1.0
        moments = []
        for i in range(0, len(frames), block):
            x = torch.as_tensor(px[i:i + block], device=self.device).to(self.dtype)
            moments.append(self.t.vae.encode(x))
        mean = torch.cat([m for m, _ in moments])
        logvar = torch.cat([lv for _, lv in moments])
        noise = torch.randn(mean.shape, generator=gen, device=self.device, dtype=torch.float32)
        return (mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)) * self.t.scaling

    @staticmethod
    def first_frame_latents(z: torch.Tensor, frames: int) -> torch.Tensor:
        """[h, w, C] -> [F, h, w, C]: frame 0 the latent, frame k the plane k/(F-1)."""
        h, w, c = z.shape
        ramp = torch.arange(1, frames, dtype=z.dtype, device=z.device) / (frames - 1)
        return torch.cat([z[None], ramp[:, None, None, None].expand(frames - 1, h, w, c)])

    def generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g

    # -- composite ------------------------------------------------------------

    def composite_cond(self, entry, call: dict) -> dict:
        """One entry's conditioning, its start latents and its mask tables,
        from the raw inputs and the call's seed."""
        W, H, F_ = call["width"], call["height"], call["frames"]
        gen = self.generator(entry.seed)
        s = self.t.latent_scale
        lat_shape = (F_, H // s, W // s, self.t.unet.config.in_channels)
        init = torch.randn(lat_shape, generator=gen, device=self.device, dtype=torch.float32)
        firsts = [entry.bg_frames[0]] + [o[0] for o in entry.obj_frames] + [entry.main_first]
        lats = [self.first_frame_latents(self.vae_sample([im], W, H, gen)[0], F_)
                for im in firsts]
        lats.append(lats[-1])
        embs = [self.image_embedding(v[0], None)
                for v in [entry.bg_frames] + list(entry.obj_frames) + [entry.main_frames]]
        embs.insert(len(embs) - 1, torch.zeros_like(embs[-1]))
        n = len(entry.obj_frames)
        inv = self.text(entry.ids["inversion"]).expand(n + 1, -1, -1)
        text = torch.cat([inv, self.text(entry.ids["negative"]), self.text(entry.ids["prompt"])])
        levels = len(self.t.unet.config.block_out_channels)
        res = injection_resolutions(lat_shape[1], lat_shape[2], levels)
        return dict(init=init, image_latents=torch.stack(lats),
                    image_embeddings=torch.stack([e.expand(F_, -1) for e in embs]),
                    text=text, masks=mask_pyramid(entry.masks_binary, res),
                    masks_soft=mask_pyramid(entry.masks_soft, res))

    def composite_step(self, s: int, lat: torch.Tensor, conds: list, plan: "CompositePlan"):
        """Step s of the composite loop over J entries from its input
        latents lat [J, F, h, w, C]: (next, base) as the module says."""
        dev, f32 = self.device, torch.float32
        t = int(plan.run_ts[s])
        nb = plan.n_obj + 3

        def per_entry(key, i=None):
            return torch.stack([torch.as_tensor(getattr(e, key) if i is None else
                                                getattr(e, key)[i], device=dev, dtype=f32)
                                for e in plan.entries])
        bg = per_entry("bg_run", s)
        objs = per_entry("obj_fusion") if plan.fusion[s] else per_entry("obj_run", s)
        inp = torch.cat([bg[:, None], objs, lat[:, None], lat[:, None]], 1).flatten(0, 1)

        def cat(key):
            return torch.cat([c[key] for c in conds]).to(self.dtype)

        def pyr(key):
            return {r: torch.as_tensor(np.stack([c[key][r] for c in conds]), device=dev)
                    for r in conds[0][key]}
        inj = M.Injection(masks=pyr("masks"), masks_soft=pyr("masks_soft"),
                          gate_spatial=bool(plan.gates["spatial"][s]),
                          gate_temporal=bool(plan.gates["temporal"][s]),
                          gate_conv=bool(plan.gates["conv"][s]),
                          inject_background=plan.inject_background)
        fps = torch.full((inp.shape[0],), plan.fps, dtype=torch.long, device=dev)
        eps = self.t.unet(inp.to(self.dtype), t, fps, cat("image_latents"),
                          cat("image_embeddings"), cat("text"), inj).float()
        eps = eps.unflatten(0, (len(plan.entries), nb))
        g = eps[:, nb - 2] + plan.guidance * (eps[:, nb - 1] - eps[:, nb - 2])
        nxt = self.ddim.step(g, t, lat, plan.n_steps)
        base = self.ddim.step(torch.zeros_like(g), t, lat, plan.n_steps)
        if s + 1 < len(plan.run_ts) and plan.fusion[s + 1]:
            soft = torch.as_tensor(np.stack([e.masks_soft for e in plan.entries]), device=dev)
            nbg, nobj = per_entry("bg_run", s + 1), per_entry("obj_fusion")
            nxt, base = (fuse(x, nbg, nobj, soft, plan.noise_ratio, plan.obj_noise)
                         for x in (nxt, base))
        return nxt, base

    def composite_start(self, conds: list, plan: "CompositePlan") -> torch.Tensor:
        """The input latents of the loop's first step: the start draw, fused
        when step 0 is a fusion step."""
        lat = torch.stack([c["init"] for c in conds])
        if plan.fusion[0]:
            dev, f32 = self.device, torch.float32
            bg = torch.stack([torch.as_tensor(e.bg_run[0], device=dev, dtype=f32)
                              for e in plan.entries])
            objs = torch.stack([torch.as_tensor(e.obj_fusion, device=dev, dtype=f32)
                                for e in plan.entries])
            soft = torch.as_tensor(np.stack([e.masks_soft for e in plan.entries]), device=dev)
            lat = fuse(lat, bg, objs, soft, plan.noise_ratio, plan.obj_noise)
        return lat

    # -- inversion --------------------------------------------------------------

    def inversion_cond(self, videos, ids: np.ndarray, call: dict, seed: int,
                       cfg_scale: float = 1.0) -> dict:
        """x0 latents [J, F, h, w, C] and the conditioning of J videos at
        cfg 1 (each video one branch), every video drawing from a generator
        seeded from `seed`."""
        W, H, F_ = call["width"], call["height"], call["frames"]
        x0s, lats, embs = [], [], []
        for frames in videos:
            gen = self.generator(seed)
            x0s.append(self.vae_sample(frames, W, H, gen))
            embs.append(self.image_embedding(frames[0], W).expand(F_, -1))
            lats.append(self.first_frame_latents(self.vae_sample([frames[0]], W, H, gen)[0], F_))
        text = self.text(ids).expand(len(videos), -1, -1)
        return dict(x0=torch.stack(x0s).float(), image_latents=torch.stack(lats),
                    image_embeddings=torch.stack(embs), text=text)

    def inversion_step(self, s: int, lat: torch.Tensor, cond: dict, ts, n_steps: int, fps: int):
        t = int(ts[s])
        b = lat.shape[0]
        fpst = torch.full((b,), fps, dtype=torch.long, device=self.device)
        eps = self.t.unet(lat.to(self.dtype), t, fpst, cond["image_latents"].to(self.dtype),
                          cond["image_embeddings"].to(self.dtype), cond["text"].to(self.dtype)
                          ).float()
        return (self.ddim.inverse_step(eps, t, lat, n_steps),
                self.ddim.inverse_step(torch.zeros_like(eps), t, lat, n_steps))


@dataclasses.dataclass
class CompositePlan:
    """A composite call's schedule as the reference steps it: entries (each
    with bg_run [S', ...], obj_run [S', N, ...], obj_fusion [N, ...],
    masks_soft [N, F, h, w]), run timesteps, gates and fusion steps."""

    entries: list
    run_ts: np.ndarray
    gates: dict
    fusion: np.ndarray
    n_steps: int
    n_obj: int
    guidance: float
    noise_ratio: float
    obj_noise: bool
    inject_background: bool
    fps: int
