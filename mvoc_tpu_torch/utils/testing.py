"""Random-weight pipelines for tests and the on-card smoke run (counterpart
of mvoc_tpu/utils/testing.py; no checkpoint needed).

`init_flax_like_` gives a module the initialisation the JAX package's
flax modules get: lecun-normal kernels (truncated normal, fan-in),
zero biases, unit norm scales, the zero `conv4` of every
TemporalConvLayer, and the CLIP embeddings' normal initialisers — so a
random-weight run behaves like the random-weight runs of the JAX
package.  All draws come from one seeded torch.Generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from mvoc_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel, CLIPVisionConfig,
                                        CLIPVisionModelWithProjection)
from mvoc_tpu_torch.models.layers import GroupNorm, LayerNorm, TemporalConvLayer
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from mvoc_tpu_torch.ops.ddim import SchedulerConfig
from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline
from mvoc_tpu_torch.utils.device import resolve_device

# tiny geometry: 16x16 px -> 8x8 latents (VAE /2), F frames
TINY_HW = 16
TINY_FRAMES = 2

# flax's truncated-normal variance scaling divides by the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class DummyTokenizer:
    """Hash-based stand-in for CLIPTokenizer with the same call contract
    (ids are stable within one process only: Python's hash is salted)."""

    def __init__(self, vocab_size: int, model_max_length: int):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def __call__(self, texts, padding=None, max_length=None, truncation=True,
                 return_tensors="np"):
        max_length = max_length or self.model_max_length
        ids = np.ones((len(texts), max_length), dtype=np.int32)  # pad = 1
        for i, t in enumerate(texts):
            toks = [0] + [hash(w) % (self.vocab_size - 2) + 2 for w in t.split()]
            toks = toks[: max_length - 1] + [1]
            ids[i, : len(toks)] = toks
        return {"input_ids": ids}


def _lecun_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_flax_like_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    zero = set()
    for m in model.modules():
        if isinstance(m, TemporalConvLayer):
            zero.add(id(m.conv4[2]))
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            if id(m) in zero:
                m.weight.zero_()
            else:
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                _lecun_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1]), generator=generator)
    for name, p in model.named_parameters():
        if name.endswith("text_model.embeddings.position_embedding.weight"):
            p.normal_(0.0, 0.01, generator=generator)
        elif name.endswith(("vision_model.embeddings.position_embedding.weight",
                            "vision_model.embeddings.class_embedding")):
            p.normal_(0.0, 0.02, generator=generator)
    return model


def build_pipeline(unet_cfg: UNetConfig, vae_cfg: VAEConfig, text_cfg: CLIPTextConfig,
                   vision_cfg: CLIPVisionConfig, seed: int = 0, dtype=torch.float32,
                   device=None) -> I2VGenXLPipeline:
    """A random-weight pipeline, built and initialised on `device` (CUDA
    unless asked otherwise) in `dtype`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.device(dev):
        parts = [I2VGenXLUNet(unet_cfg), AutoencoderKL(vae_cfg), CLIPTextModel(text_cfg),
                 CLIPVisionModelWithProjection(vision_cfg)]
    for part in parts:
        init_flax_like_(part, gen)
    return I2VGenXLPipeline(*parts, scheduler_config=SchedulerConfig(),
                            tokenizer=DummyTokenizer(text_cfg.vocab_size,
                                                     text_cfg.max_position_embeddings),
                            dtype=dtype, device=dev)


def build_tiny_pipeline(seed: int = 0, dtype=torch.float32, device=None,
                        natural: bool = False) -> I2VGenXLPipeline:
    import dataclasses

    unet_cfg = dataclasses.replace(UNetConfig.tiny(), temporal_natural_layout=natural)
    return build_pipeline(unet_cfg, VAEConfig.tiny(), CLIPTextConfig.tiny(),
                          CLIPVisionConfig.tiny(), seed=seed, dtype=dtype, device=device)


def build_full_pipeline(seed: int = 0, dtype=torch.bfloat16, device=None,
                        natural: bool = True) -> I2VGenXLPipeline:
    """The published I2VGen-XL geometry (UNetConfig() defaults, the SD-2.x
    VAE, OpenCLIP-H towers) with seeded random weights."""
    return build_pipeline(UNetConfig(temporal_natural_layout=natural), VAEConfig(),
                          CLIPTextConfig(), CLIPVisionConfig(), seed=seed, dtype=dtype,
                          device=device)


def tiny_frames(n: int = TINY_FRAMES, size: int = TINY_HW, seed: int = 0):
    """Deterministic synthetic PIL frames (a random image rolled sideways)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    return [Image.fromarray(np.roll(base, shift=i, axis=1)) for i in range(n)]

