"""Random-weight pipelines for tests and the on-card smoke run (counterpart
of mvoc_tpu/utils/testing.py; no checkpoint needed).

`init_flax_like_` gives a module the initialisation the JAX package's
flax modules get: lecun-normal kernels (truncated normal, fan-in),
zero biases, unit norm scales, the zero `conv4` of every
TemporalConvLayer, and the CLIP embeddings' normal initialisers — so a
random-weight run behaves like the random-weight runs of the JAX
package.  All draws come from one seeded torch.Generator.

`ActivationTape` records or replays the int8 activations of a run, for
comparisons of int8 runs whose float activations differ by roundings.
"""

from __future__ import annotations

import contextlib
import math
import os
import zlib
from typing import Optional

import numpy as np
import torch
from torch import nn

from mvoc_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel, CLIPVisionConfig,
                                        CLIPVisionModelWithProjection)
from mvoc_tpu_torch.models.layers import GroupNorm, LayerNorm, TemporalConvLayer
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from mvoc_tpu_torch.ops import quantize
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
    """Hash-based stand-in for CLIPTokenizer with the same call contract.
    The ids come from CRC-32 of each word, so they are the same in every
    process (Python's own hash is salted per process, which made the
    seeded pipelines' prompt embeddings, and every composite, differ from
    one run to the next)."""

    def __init__(self, vocab_size: int, model_max_length: int):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def __call__(self, texts, padding=None, max_length=None, truncation=True,
                 return_tensors="np"):
        max_length = max_length or self.model_max_length
        ids = np.ones((len(texts), max_length), dtype=np.int32)  # pad = 1
        for i, t in enumerate(texts):
            toks = [0] + [zlib.crc32(w.encode()) % (self.vocab_size - 2) + 2 for w in t.split()]
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


def synthetic_video(rng, frames: int, width: int, height: Optional[int] = None):
    """A seeded smooth colour field with a bright square moving sideways
    (PIL frames, width x height)."""
    from PIL import Image

    height = height or width
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


DEMO_VIDEOS = ("bg", "obj1", "obj2")


def write_demo_tree(root: str, width: int, height: int, n_frames: int, steps: int,
                    seed: int = 0) -> dict:
    """A demo tree for the CLIs under `root`, laid out like the reference's
    data directory: three synthetic videos (bg, obj1, obj2) as PNG frame
    directories at width x height, an edited first frame, two rectangle
    masks authored at width x height, and the two group JSONs over the
    shipped templates: inversion of the three videos in `steps` steps with
    the reconstruction round trip on for bg (from the schedule's step 1),
    and one composite of bg with both objects in `steps` steps from step 1,
    noise fusion at its first step.  Returns the JSON paths
    {"inversion": ..., "composite": ...}."""
    import json

    from PIL import Image

    rng = np.random.default_rng(seed)
    demo = os.path.join(root, "demo")
    for name in DEMO_VIDEOS:
        d = os.path.join(demo, name)
        os.makedirs(d, exist_ok=True)
        for i, img in enumerate(synthetic_video(rng, n_frames, width, height)):
            img.save(os.path.join(d, f"{i:05d}.png"))
    synthetic_video(rng, 1, width, height)[0].save(os.path.join(demo, "edited_first_frame.png"))
    os.makedirs(os.path.join(demo, "masks"), exist_ok=True)
    boxes = ((width // 8, height // 8, width // 2, height // 2),
             (width // 2, height // 2, 7 * width // 8, 7 * height // 8))
    for j, (x0, y0, x1, y1) in enumerate(boxes):
        arr = np.zeros((height, width), np.uint8)
        arr[y0:y1, x0:x1] = 255
        Image.fromarray(arr, mode="L").save(os.path.join(demo, "masks", f"obj{j + 1}.png"))
    size = [width, height]
    inversion = [dict(active=True, video_name=name, data_dir=root, image_size=size,
                      n_frames=n_frames, inverse_config=dict(n_steps=steps),
                      recon_config=dict(enable_recon=name == "bg", n_steps=steps,
                                        ddim_init_latents_t_idx=1))
                 for name in DEMO_VIDEOS]
    latents = "inversions/i2vgen-xl/{}/ddim_latents"
    composite = [dict(
        active=True, task_name="demo", video_name="bg", data_dir=root, image_size=size,
        n_frames=n_frames, edited_first_frame_path="demo/edited_first_frame.png",
        editing_prompt="a red boat and a surfer on the sea", edited_video_name="boat and surfer",
        n_steps=steps, ddim_init_latents_t_idx=1, fusion_step=[0, 1],
        obj_mask_path=["demo/masks/obj1.png", "demo/masks/obj2.png"],
        obj_ddim_latents_path=[latents.format("obj1"), latents.format("obj2")],
        bg_ddim_latents_path=latents.format("bg"),
        edited_contorl_frame_path_main="demo/bg", edited_contorl_frame_path_background="demo/bg",
        edited_contorl_frame_path=["demo/obj1", "demo/obj2"])]
    out = {}
    for name, entries in (("inversion", inversion), ("composite", composite)):
        out[name] = os.path.join(root, f"group_{name}.json")
        with open(out[name], "w") as f:
            json.dump(entries, f, indent=1)
    return out


class ActivationTape:
    """Every activation quantization of ops/quantize.py, in call order.

    An int8 network is discontinuous: where two runs' float activations
    differ by roundings (two frameworks, or the card and the CPU), a value
    next to a rounding boundary quantizes one step apart, and the step
    propagates into further flips downstream, so at the tiny test widths a
    1e-7 relative input perturbation moves the int8 output as far as int8
    moves it from fp32.  To hold two int8 runs against each other, record
    one run's (int8 activation, scale) pairs, then replay them in the other:
    each call still quantizes its own input and counts how many elements it
    would have quantized differently (`flips`, at most `max_step` apart) and
    how far its scales are from the recorded ones (`max_scale_rel`), then
    returns the recorded pair.  Records are CPU tensors (or numpy arrays).

        tape = ActivationTape()              # record
        with tape.active(): run_a()
        replay = ActivationTape(tape.records)
        with replay.active(): run_b()
        assert replay.calls == len(replay.records)
    """

    def __init__(self, records=None):
        self.replaying = records is not None
        self.records = list(records) if self.replaying else []
        self.calls = self.elements = self.flips = self.max_step = 0
        self.max_scale_rel = 0.0

    def _replay(self, q: torch.Tensor, s: torch.Tensor):
        if self.calls >= len(self.records):
            raise AssertionError(f"activation quantization {self.calls} was not recorded "
                                 f"({len(self.records)} were)")
        rq, rs = (torch.as_tensor(a).to(t.device) for a, t in zip(self.records[self.calls], (q, s)))
        if rq.shape != q.shape or rs.shape != s.shape:
            raise AssertionError(f"activation quantization {self.calls}: shapes {tuple(q.shape)} / "
                                 f"{tuple(s.shape)}, recorded {tuple(rq.shape)} / {tuple(rs.shape)}")
        step = (q.to(torch.int16) - rq.to(torch.int16)).abs()
        self.elements += q.numel()
        self.flips += int((step > 0).sum())
        self.max_step = max(self.max_step, int(step.max()) if step.numel() else 0)
        self.max_scale_rel = max(self.max_scale_rel, float(((s - rs).abs() / rs).max()))
        return rq, rs

    @contextlib.contextmanager
    def active(self):
        orig = quantize._quantize_activation

        def taped(x, reduce_axes, amax_hook=None):
            q, s = orig(x, reduce_axes, amax_hook)
            if self.replaying:
                q, s = self._replay(q, s)
            else:
                self.records.append((q.cpu(), s.cpu()))
            self.calls += 1
            return q, s

        quantize._quantize_activation = taped
        try:
            yield self
        finally:
            quantize._quantize_activation = orig


# ---------------------------------------------------------------------------
# synthetic diffusers checkpoint directories (the loader's tests and the
# on-card smoke run: no real checkpoint is needed)
# ---------------------------------------------------------------------------

# {folder: (weight file, stored dtype)}: fp16
# safetensors for the UNet and the image tower (the published checkpoint's
# variant files), fp32 safetensors for the VAE, a torch .bin for the text
# tower (the loader's other path)
CHECKPOINT_FILES = {
    "unet": ("diffusion_pytorch_model.fp16.safetensors", torch.float16),
    "vae": ("diffusion_pytorch_model.safetensors", torch.float32),
    "text_encoder": ("pytorch_model.bin", torch.float32),
    "image_encoder": ("model.fp16.safetensors", torch.float16),
}


def diffusers_configs(unet_cfg: UNetConfig, vae_cfg: VAEConfig, text_cfg: CLIPTextConfig,
                      vision_cfg: CLIPVisionConfig,
                      sched_cfg: Optional[SchedulerConfig] = None) -> dict:
    """{folder: config dict} in the published checkpoint's keys (diffusers
    for unet/ vae/ scheduler/, HF transformers for the CLIP towers), with
    some of the keys the loaders ignore, as the real files have them."""
    import dataclasses

    n = len(unet_cfg.block_out_channels)
    n_vae = len(vae_cfg.block_out_channels)
    sched = dataclasses.asdict(sched_cfg or SchedulerConfig())
    return {
        "unet": dict(_class_name="I2VGenXLUNet", _diffusers_version="0.25.0",
                     in_channels=unet_cfg.in_channels, out_channels=unet_cfg.out_channels,
                     block_out_channels=list(unet_cfg.block_out_channels),
                     layers_per_block=unet_cfg.layers_per_block,
                     norm_num_groups=unet_cfg.norm_num_groups,
                     cross_attention_dim=unet_cfg.cross_attention_dim,
                     attention_head_dim=unet_cfg.attention_head_dim, num_attention_heads=None,
                     down_block_types=["CrossAttnDownBlock3D"] * (n - 1) + ["DownBlock3D"],
                     up_block_types=["UpBlock3D"] + ["CrossAttnUpBlock3D"] * (n - 1),
                     sample_size=32),
        "vae": dict(_class_name="AutoencoderKL", _diffusers_version="0.25.0", act_fn="silu",
                    in_channels=vae_cfg.in_channels, out_channels=vae_cfg.out_channels,
                    block_out_channels=list(vae_cfg.block_out_channels),
                    layers_per_block=vae_cfg.layers_per_block,
                    latent_channels=vae_cfg.latent_channels,
                    norm_num_groups=vae_cfg.norm_num_groups,
                    scaling_factor=vae_cfg.scaling_factor,
                    down_block_types=["DownEncoderBlock2D"] * n_vae,
                    up_block_types=["UpDecoderBlock2D"] * n_vae, sample_size=768),
        "text_encoder": dict(dataclasses.asdict(text_cfg), architectures=["CLIPTextModel"],
                             model_type="clip_text_model", projection_dim=512,
                             torch_dtype="float32"),
        "image_encoder": dict(dataclasses.asdict(vision_cfg),
                              architectures=["CLIPVisionModelWithProjection"],
                              model_type="clip_vision_model", num_channels=3,
                              torch_dtype="float16"),
        "scheduler": dict(sched, _class_name="DDIMScheduler", _diffusers_version="0.25.0",
                          thresholding=False, dynamic_thresholding_ratio=0.995),
    }


def learn_bpe_merges(corpus, n_merges: int) -> list[tuple[str, str]]:
    """Up to n_merges CLIP-style merges learned from `corpus` (texts): the
    most frequent adjacent symbol pair first, ties by the pair's text."""
    from collections import Counter

    from mvoc_tpu_torch.models.tokenizer import basic_clean, bytes_to_unicode, split_words

    enc = bytes_to_unicode()
    words = Counter()
    for text in corpus:
        for word in split_words(basic_clean(text)):
            mapped = "".join(enc[b] for b in word.encode("utf-8"))
            words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    merges = []
    while len(merges) < n_merges:
        pairs = Counter()
        for word, n in words.items():
            for pair in zip(word[:-1], word[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged = Counter()
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    return merges


def write_tokenizer(directory: str, corpus, n_merges: int = 200, pad_token: str = "!",
                    model_max_length: int = 77) -> int:
    """A CLIP tokenizer folder (vocab.json, merges.txt, tokenizer_config.json,
    special_tokens_map.json) whose merges are learned from `corpus`: CLIP's
    vocabulary layout (the 256 byte symbols, the same with "</w>", one
    entry per merge, then <|startoftext|> and <|endoftext|>), the special
    tokens as the published files give them (the pad token in
    special_tokens_map.json over the config's).  Returns the vocabulary
    size."""
    import json

    from mvoc_tpu_torch.models.tokenizer import bytes_to_unicode

    os.makedirs(directory, exist_ok=True)
    merges = learn_bpe_merges(corpus, n_merges)
    symbols = list(bytes_to_unicode().values())
    tokens = symbols + [s + "</w>" for s in symbols] + ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    vocab = {}
    for t in tokens:
        vocab.setdefault(t, len(vocab))
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))

    def added(content):
        return {"__type": "AddedToken", "content": content, "lstrip": False,
                "normalized": True, "rstrip": False, "single_word": False}

    special = {"bos_token": added("<|startoftext|>"), "eos_token": added("<|endoftext|>"),
               "unk_token": added("<|endoftext|>")}
    config = dict(special, pad_token="<|endoftext|>", model_max_length=model_max_length,
                  do_lower_case=True, errors="replace", add_prefix_space=False,
                  tokenizer_class="CLIPTokenizer")
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
        json.dump(config, f, indent=1)
    with open(os.path.join(directory, "special_tokens_map.json"), "w") as f:
        json.dump(dict(special, pad_token=pad_token), f, indent=1)
    return len(vocab)


def template_prompts() -> list[str]:
    """The non-empty prompts of the shipped templates and of their group
    examples (the synthetic tokenizers' corpus)."""
    import json

    from mvoc_tpu_torch import config as cfglib

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs")
    out = []

    def walk(node):
        for k in node:
            v = node[k]
            if hasattr(v, "keys"):
                walk(v)
            elif "prompt" in k and isinstance(v, str) and v not in ("", "ReplaceMe"):
                out.append(v)

    for kind in ("inversion", "composite"):
        walk(cfglib.load(os.path.join(root, f"group_{kind}", "template.yaml")))
        with open(os.path.join(root, f"group_{kind}", "group_config.example.json")) as f:
            for entry in json.load(f):
                walk(entry)
    return sorted(set(out))


def write_checkpoint_configs(root: str, configs: dict, corpus, n_merges: int) -> int:
    """The non-weight files of a diffusers checkpoint directory under
    `root`: each folder's config (`configs`, as diffusers_configs gives
    them) and a tokenizer folder learned from `corpus`, its vocabulary
    checked to fit the text tower's.  Returns the bytes written."""
    import json

    total = 0
    for folder, cfg in configs.items():
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        path = os.path.join(root, folder, "scheduler_config.json" if folder == "scheduler"
                            else "config.json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
        total += os.path.getsize(path)
    text = configs["text_encoder"]
    tok = os.path.join(root, "tokenizer")
    vocab = write_tokenizer(tok, corpus, n_merges,
                            model_max_length=text["max_position_embeddings"])
    if vocab > text["vocab_size"]:
        raise ValueError(f"synthetic vocabulary of {vocab} > the text tower's "
                         f"{text['vocab_size']}")
    return total + sum(os.path.getsize(os.path.join(tok, n)) for n in os.listdir(tok))


def write_checkpoint(root: str, pipe: I2VGenXLPipeline, corpus=(), n_merges: int = 200) -> int:
    """`pipe` as a diffusers I2VGen-XL checkpoint directory under `root`:
    write_checkpoint_configs' files, then each model folder's weight file
    as CHECKPOINT_FILES names and types it (safetensors written by
    io/safetensors.py, .bin by torch.save).  Returns the bytes written."""
    from mvoc_tpu_torch.io import safetensors

    configs = diffusers_configs(pipe.unet.config, pipe.vae.config, pipe.text_encoder.config,
                                pipe.image_encoder.config, pipe.scheduler_config)
    total = write_checkpoint_configs(root, configs, corpus, n_merges)
    for folder, (name, dtype) in CHECKPOINT_FILES.items():
        sd = {k: v.to(dtype) for k, v in getattr(pipe, folder).state_dict().items()}
        path = os.path.join(root, folder, name)
        if name.endswith(".safetensors"):
            safetensors.save_file(sd, path, metadata={"format": "pt"})
        else:
            torch.save({k: v.cpu() for k, v in sd.items()}, path)
        total += os.path.getsize(path)
    return total
