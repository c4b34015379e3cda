"""Automatic reuse-interval selection gated on reconstruction fidelity (the
port's copy of mvoc_tpu/utils/autoreuse.py).

The encoder-reuse and deep-reuse inversion modes approximate the inverted
trajectory that every composite consumes, and the right interval k depends
on the content: slow, smooth footage tolerates a larger k than fast or
textured footage.  `encoder_reuse_interval: auto` in an inversion entry
picks k with a cheap probe on the entry's own video: invert it with a short
schedule (default 50 steps instead of the template's 500) at a candidate k,
reconstruct from the resulting x_T with the same schedule at cfg 1, and
score the PSNR against the source frames.  Adjacent timesteps of a short
schedule lie further apart, so the features drift more between steps and
the probe overstates the production run's drift, which is the safe side
for a gate.  Candidates are probed largest first; probing stops at the
first k that clears the threshold.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

logger = logging.getLogger("mvoc_tpu_torch.autoreuse")

DEFAULT_CANDIDATES = (5, 3, 2)
DEFAULT_THRESHOLD_DB = 30.0
DEFAULT_PROBE_STEPS = 50


def select_reuse_k(probe_fn: Callable[[int], float],
                   candidates: Sequence[int] = DEFAULT_CANDIDATES,
                   threshold_db: float = DEFAULT_THRESHOLD_DB) -> tuple[int, list[dict]]:
    """The largest candidate k whose probe PSNR clears threshold_db, else 1.
    Probes in descending order and stops at the first pass.  Returns (k,
    report), the report listing every probed candidate."""
    report: list[dict] = []
    for k in sorted({int(k) for k in candidates if int(k) > 1}, reverse=True):
        score = float(probe_fn(k))
        passed = score >= threshold_db
        report.append({"k": k, "psnr_db": round(score, 3), "passed": passed})
        logger.info("reuse probe k=%d: recon PSNR %.2f dB (threshold %.1f) %s",
                    k, score, threshold_db, "PASS" if passed else "fail")
        if passed:
            return k, report
    return 1, report


def make_invert_probe(pipe, frames, first_frame=None, *, height: int, width: int,
                      num_frames: int, target_fps: int = 8, prompt: str = "", seed: int = 8888,
                      probe_steps: int = DEFAULT_PROBE_STEPS, deep_reuse: bool = False,
                      encoder_reuse_depth: Optional[int] = None) -> Callable[[int], float]:
    """probe(k) -> the reconstruction PSNR (dB) of the invert -> reconstruct
    round trip at reuse interval k on these frames.  The source latents are
    VAE-encoded once (with the draw invert(seed=seed) takes) and shared by
    every probed candidate."""
    from mvoc_tpu_torch.io import media
    from mvoc_tpu_torch.utils.metrics import psnr

    src = media.pil_to_01(frames)
    first = first_frame or frames[0]
    x0 = pipe.encode_vae_video(frames, height, width, generator=pipe._generator(seed))

    def probe(k: int) -> float:
        _, trajectory = pipe.invert(
            frames, first_frame=first, prompt=prompt, height=height, width=width,
            target_fps=target_fps, num_frames=num_frames, num_inference_steps=probe_steps,
            seed=seed, latents=x0, encoder_reuse_interval=int(k), deep_reuse=deep_reuse,
            encoder_reuse_depth=encoder_reuse_depth)
        video = pipe.sample(
            first, prompt=prompt, height=height, width=width, target_fps=target_fps,
            num_frames=num_frames, num_inference_steps=probe_steps, guidance_scale=1.0,
            ddim_init_latents_t_idx=0, latents=trajectory[-1], seed=seed)
        return float(psnr(video, src))

    return probe


def resolve_auto_reuse(pipe, config) -> None:
    """Resolve `encoder_reuse_interval: auto` of one inversion entry in
    place, probing the entry's own video.  Knobs under inverse_config, with
    their defaults: reuse_auto_candidates [5, 3, 2], reuse_auto_threshold_db
    30.0, reuse_auto_probe_steps 50.  When every candidate fails, k = 1 and
    deep_reuse is turned off; the probe report goes to
    inverse_config.reuse_auto_report."""
    inv = config.inverse_config
    if inv.get("encoder_reuse_interval", 1) != "auto":
        return
    from mvoc_tpu_torch.cli.inverse import _load_entry_frames

    frames, first = _load_entry_frames(config)
    image_size = tuple(config.image_size)
    probe = make_invert_probe(
        pipe, frames, first, height=image_size[1], width=image_size[0],
        num_frames=config.n_frames, target_fps=inv.target_fps, prompt=inv.prompt,
        seed=config.get("seed", 8888),
        probe_steps=int(inv.get("reuse_auto_probe_steps", DEFAULT_PROBE_STEPS)),
        deep_reuse=inv.get("deep_reuse", False),
        encoder_reuse_depth=inv.get("encoder_reuse_depth", None))
    k, report = select_reuse_k(
        probe, candidates=list(inv.get("reuse_auto_candidates", DEFAULT_CANDIDATES)),
        threshold_db=float(inv.get("reuse_auto_threshold_db", DEFAULT_THRESHOLD_DB)))
    inv.encoder_reuse_interval = k
    if k == 1:
        # every candidate failed on this content: the production run must not
        # keep the deep approximation either
        inv.deep_reuse = False
    inv.reuse_auto_report = report
    # a config's sub-node is a copy (config.py), so the change goes back
    # through the parent
    config.inverse_config = inv
    logger.info("auto reuse gate for %s selected k=%d (%s)", config.get("video_name", "?"), k,
                report)
