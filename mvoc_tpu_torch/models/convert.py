"""Weights into this package's modules: a diffusers I2VGen-XL checkpoint
directory (`load_pipeline`, the JAX loader's forward direction), and the
JAX package's flax params (the weight bridge the parity tests use).

**The checkpoint loader** (counterpart of mvoc_tpu/models/convert.py:
load_pipeline, load_torch_state_dict, infer_unet_geometry, verify_tree,
verify_activations, main).  The directory is the one the reference loads
(`I2VGenXLPipeline.from_pretrained`): unet/ vae/ text_encoder/
image_encoder/ with a config.json and a weight file each, scheduler/
scheduler_config.json, and optionally tokenizer/.  This package's module
names are the diffusers and HF keys, so every tensor loads under its own
key (the JAX package's key functions only rename them into flax's compound
names; `temp_convs.N.convK.0` / `.2` stay the GroupNorm / Conv3d, as
there).  Weight files are read by the package's own safetensors reader
(io/safetensors.py) or `torch.load(weights_only=True)`; the tokenizer is
models/tokenizer.py.  Neither `safetensors` nor `transformers` is needed.
Each module is built on the meta device, takes its state dict with
strict=True (a missing, extra or mis-shaped key raises first, in the JAX
loader's verify_tree format), and moves to the pipeline's dtype and device.

**The weight bridge**: the JAX package's flax params -> diffusers-keyed torch
state dicts for this package's modules.

The inverse of mvoc_tpu/models/convert.py (its key functions and
`_tensor_transform`): each function takes the flax params as nested dicts
of numpy arrays (with or without the top-level "params" collection) and
returns {diffusers key: torch tensor}.

Tensor transforms (flax -> torch):
  * Dense kernel [in, out]                  -> weight [out, in]
  * Conv kernel [kh, kw, I, O]              -> weight [O, I, kh, kw]
  * Conv3d kernel [kt, kh, kw, I, O]        -> weight [O, I, kt, kh, kw]
  * norm scale -> weight, Embed embedding -> weight, bias -> bias
Names: flax joins module indices into names ("down_blocks_0",
"to_out_0", VAE "down_blocks_0_resnets_1"); diffusers keys use dots.  The
temporal conv stages are "convN_norm"/"convN_conv" in flax and
"convN.0"/"convN.2" here; "linear_1"/"linear_2" keep their underscore.

Int8 kernels (a QuantizedTensor leaf of the JAX package's
`quantize_params`, arriving as a numpy (data, scale) pair) become the
buffers of ops/quantize.py's Quant modules:
  * "weight": int8 [N, K], dense [K, N] transposed, conv [*taps, C, O] as
    [O, taps*C] in (taps..., C) order;
  * "weight_scale": fp32 [N].
`load_unet_from_flax` swaps those layers for Quant modules before loading.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from mvoc_tpu_torch.io import safetensors
from mvoc_tpu_torch.ops.quantize import quantize_unet_

logger = logging.getLogger(__name__)

_KEEP = {"linear_1", "linear_2"}
_SPECIAL = {"mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}


def _segment(name: str) -> str:
    if name in _KEEP:
        return name
    if name in _SPECIAL:
        return _SPECIAL[name]
    m = re.fullmatch(r"(conv\d)_(norm|conv)", name)
    if m:
        return f"{m.group(1)}.{'0' if m.group(2) == 'norm' else '2'}"
    name = re.sub(r"_(\d+)_", r".\1.", name)
    return re.sub(r"_(\d+)$", r".\1", name)


def module_key(mods) -> str:
    """A flax module path -> the port's dotted module name."""
    return ".".join(_segment(m) for m in mods)


def _quantized(data: np.ndarray, scale: np.ndarray) -> dict:
    data, scale = np.asarray(data), np.asarray(scale)
    if data.ndim == 2:
        w = data.T
    elif data.ndim in (4, 5):
        w = np.moveaxis(data, -1, 0).reshape(data.shape[-1], -1)
    else:
        raise ValueError(f"cannot transform a rank-{data.ndim} int8 kernel")
    return {"weight": w.astype(np.int8), "weight_scale": scale.reshape(-1).astype(np.float32)}


def _tensor(leaf: str, value) -> dict:
    if isinstance(value, tuple):  # an int8 kernel as (data, scale)
        if leaf != "kernel" or len(value) != 2:
            raise ValueError(f"flax leaf {leaf!r}: only kernels quantize, as (data, scale)")
        return _quantized(*value)
    return dict([_float_tensor(leaf, np.asarray(value))])


def _float_tensor(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "bias":
        return "bias", value
    if leaf in ("scale", "embedding"):
        return "weight", value
    if leaf != "kernel":
        raise ValueError(f"unexpected flax leaf {leaf!r}")
    if value.ndim == 2:
        return "weight", value.T
    if value.ndim == 4:
        return "weight", value.transpose(3, 2, 0, 1)
    if value.ndim == 5:
        return "weight", value.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"cannot transform a rank-{value.ndim} kernel")


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unwrap(params: dict) -> dict:
    return params["params"] if set(params) == {"params"} else params


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """fp32 tensors; int8 weights stay int8."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v, dtype=np.int8 if v.dtype == np.int8 else np.float32)) for k, v in sd.items()}


def _generic(params: dict, prefix_fn=None) -> Dict[str, torch.Tensor]:
    out = {}
    for path, value in _flatten(_unwrap(params)):
        *mods, leaf = path
        key = module_key(mods)
        if prefix_fn is not None:
            key = prefix_fn(key)
        for name, tensor in _tensor(leaf, value).items():
            out[f"{key}.{name}" if key else name] = tensor
    return _to_torch(out)


def unet_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """mvoc_tpu I2VGenXLUNet params (float, or with int8 kernels) ->
    I2VGenXLUNet state dict."""
    return _generic(params)


def load_unet_from_flax(unet: nn.Module, params: dict) -> nn.Module:
    """Load the JAX UNet params into `unet` in place.  The layers whose
    kernels arrive int8 become Quant modules first, so a tree from
    `quantize_params` loads as it is."""
    sd = unet_state_dict_from_flax(params)
    suffix = ".weight_scale"
    quantized = {k[:-len(suffix)] for k in sd if k.endswith(suffix)}
    if quantized:
        quantize_unet_(unet, lambda names: ".".join(names[:-1]) in quantized)
    unet.load_state_dict(sd, strict=True)
    return unet


def vae_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """mvoc_tpu AutoencoderKL params -> AutoencoderKL state dict."""
    return _generic(params)


def _clip(params: dict, tower: str) -> Dict[str, torch.Tensor]:
    p = dict(_unwrap(params))
    raw = {}
    for name in ("position_embedding", "class_embedding"):
        if name in p and not isinstance(p[name], dict):
            raw[name] = np.asarray(p.pop(name))

    def prefix(key: str) -> str:
        if key == "visual_projection":
            return key
        if key in ("token_embedding", "patch_embedding", "position_embedding"):
            return f"{tower}.embeddings.{key}"
        if key.startswith("layers."):
            return f"{tower}.encoder.{key}"
        return f"{tower}.{key}"

    out = _generic(p, prefix)
    if "position_embedding" in raw:
        out[f"{tower}.embeddings.position_embedding.weight"] = torch.from_numpy(
            raw["position_embedding"].astype(np.float32))
    if "class_embedding" in raw:
        out[f"{tower}.embeddings.class_embedding"] = torch.from_numpy(
            raw["class_embedding"].astype(np.float32))
    return out


def clip_text_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """mvoc_tpu CLIPTextModel params -> CLIPTextModel (HF keys) state dict."""
    return _clip(params, "text_model")


def clip_vision_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """mvoc_tpu CLIPVisionModelWithProjection params -> HF-keyed state dict."""
    return _clip(params, "vision_model")


# ---------------------------------------------------------------------------
# the checkpoint loader: a diffusers directory -> this package's modules
# ---------------------------------------------------------------------------


def load_torch_state_dict(subdir: str) -> Dict[str, torch.Tensor]:
    """A model folder's weights in their stored dtype, on the CPU.  The JAX
    loader's choice of file: safetensors before .bin, then by name (so
    `*.fp16.safetensors` wins over `*.safetensors`); HF's `position_ids`
    buffers dropped."""
    candidates = sorted((n for n in os.listdir(subdir) if n.endswith((".safetensors", ".bin"))),
                        key=lambda n: (not n.endswith(".safetensors"), n))
    if not candidates:
        raise FileNotFoundError(f"no weight files in {subdir}")
    path = os.path.join(subdir, candidates[0])
    logger.info("loading %s", path)
    if path.endswith(".safetensors"):
        sd = safetensors.load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] != "position_ids"}


def verify_state_dict(sd: Dict[str, torch.Tensor], module: nn.Module, ctx: str = "") -> None:
    """Strict structural and shape comparison of a checkpoint's state dict
    with the module's own, in the JAX loader's verify_tree message format."""
    got = {k: tuple(v.shape) for k, v in sd.items()}
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad_shape = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    if missing or extra or bad_shape:
        msg = [f"checkpoint conversion mismatch ({ctx}):"]
        if missing:
            msg.append(f"  missing ({len(missing)}): {missing[:12]}")
        if extra:
            msg.append(f"  extra ({len(extra)}): {extra[:12]}")
        if bad_shape:
            msg.append("  shape mismatches: " + ", ".join(
                f"{k}: got {got[k]} want {want[k]}" for k in bad_shape[:12]))
        raise ValueError("\n".join(msg))


def infer_unet_geometry(sd: Dict[str, torch.Tensor], cfg):
    """Derive the attention geometry that config.json does not carry from
    the checkpoint's tensor shapes (diffusers hard-codes an 8-head
    transformer_in and a 2-head image-latents temporal encoder): their
    per-head dims from their to_q rows, each checked divisible by the head
    count; the heads = channels // attention_head_dim rule checked at every
    cross-attention block resolution.  Returns the config with those head
    dims filled in; raises where a shape contradicts the assumed heads."""

    def out_rows(key):
        if key not in sd:
            raise KeyError(f"geometry probe missing from checkpoint: {key}")
        return int(sd[key].shape[0])

    ti_inner = out_rows("transformer_in.transformer_blocks.0.attn1.to_q.weight")
    if ti_inner % cfg.transformer_in_heads != 0:
        raise ValueError(
            f"transformer_in inner dim {ti_inner} not divisible by the "
            f"assumed {cfg.transformer_in_heads} heads")
    enc_inner = out_rows("image_latents_temporal_encoder.attn1.to_q.weight")
    if enc_inner % cfg.img_temporal_encoder_heads != 0:
        raise ValueError(
            f"image_latents_temporal_encoder inner dim {enc_inner} not "
            f"divisible by the assumed {cfg.img_temporal_encoder_heads} heads")
    for blk, ch in (("down_blocks.0.attentions.0", cfg.block_out_channels[0]),
                    ("down_blocks.1.attentions.0", cfg.block_out_channels[1]),
                    ("mid_block.attentions.0", cfg.block_out_channels[-1])):
        key = f"{blk}.transformer_blocks.0.attn1.to_q.weight"
        if key in sd:
            inner = int(sd[key].shape[0])
            if inner != ch:
                raise ValueError(
                    f"{blk}: attention inner dim {inner} != block channels "
                    f"{ch} — the heads = channels//attention_head_dim rule "
                    f"does not hold for this checkpoint")
            if ch % cfg.attention_head_dim != 0:
                raise ValueError(
                    f"{blk}: channels {ch} not divisible by "
                    f"attention_head_dim {cfg.attention_head_dim}")
    cfg = dataclasses.replace(
        cfg, transformer_in_head_dim=ti_inner // cfg.transformer_in_heads,
        img_temporal_encoder_head_dim=enc_inner // cfg.img_temporal_encoder_heads)
    logger.info("unet geometry from checkpoint shapes: transformer_in %dx%d, temporal encoder "
                "%dx%d", cfg.transformer_in_heads, cfg.transformer_in_head_dim,
                cfg.img_temporal_encoder_heads, cfg.img_temporal_encoder_head_dim)
    return cfg


def _load_module(build, sd: Dict[str, torch.Tensor], ctx: str) -> nn.Module:
    """`build()` on the meta device, then its checkpoint tensors, verified
    first: the module's parameters are the loaded tensors until the
    pipeline moves them to its dtype and device."""
    with torch.device("meta"):
        module = build()
    verify_state_dict(sd, module, ctx)
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def load_pipeline(checkpoint_dir: str, dtype: torch.dtype = torch.bfloat16, device=None):
    """An I2VGenXLPipeline from a diffusers I2VGen-XL checkpoint directory,
    in `dtype` on `device` (CUDA unless asked otherwise).  The tokenizer is
    optional: without tokenizer/ the pipeline needs prompt embeddings."""
    from mvoc_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel, CLIPVisionConfig,
                                            CLIPVisionModelWithProjection)
    from mvoc_tpu_torch.models.tokenizer import CLIPTokenizer
    from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
    from mvoc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from mvoc_tpu_torch.ops.ddim import SchedulerConfig
    from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline

    def sub(name):
        return os.path.join(checkpoint_dir, name)

    unet_sd = load_torch_state_dict(sub("unet"))
    unet_cfg = infer_unet_geometry(unet_sd, UNetConfig.from_pretrained(checkpoint_dir))
    vae_cfg = VAEConfig.from_pretrained(checkpoint_dir)
    text_cfg = CLIPTextConfig.from_json(os.path.join(sub("text_encoder"), "config.json"))
    vision_cfg = CLIPVisionConfig.from_json(os.path.join(sub("image_encoder"), "config.json"))
    unet = _load_module(lambda: I2VGenXLUNet(unet_cfg), unet_sd, "unet")
    del unet_sd
    vae = _load_module(lambda: AutoencoderKL(vae_cfg), load_torch_state_dict(sub("vae")), "vae")
    text = _load_module(lambda: CLIPTextModel(text_cfg),
                        load_torch_state_dict(sub("text_encoder")), "text_encoder")
    vision = _load_module(lambda: CLIPVisionModelWithProjection(vision_cfg),
                          load_torch_state_dict(sub("image_encoder")), "image_encoder")
    tokenizer = (CLIPTokenizer.from_pretrained(sub("tokenizer"))
                 if os.path.isdir(sub("tokenizer")) else None)
    return I2VGenXLPipeline(unet, vae, text, vision,
                            scheduler_config=SchedulerConfig.from_pretrained(checkpoint_dir),
                            tokenizer=tokenizer, dtype=dtype, device=device)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


@torch.inference_mode()
def verify_activations(pipe, seed: int = 0) -> dict:
    """Run every loaded model once on deterministic inputs and check, with a
    forward hook on each module, that every floating output is finite
    (raises on the first that is not); modules whose output has zero
    variance are logged as suspects.  The JAX function's checks, with
    forward hooks in place of flax's captured intermediates.  Returns
    {model/module: (mean, std)}."""
    rng = np.random.default_rng(seed)
    stats: dict = {}
    suspects: list = []
    dev, dt = pipe.device, pipe.dtype

    def mk(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev).to(dt)

    def run(tag, model, fn):
        def hook(name):
            def check(_module, _inputs, out):
                arrs = [t for t in _tensors(out) if t.is_floating_point()]
                if not arrs:
                    return
                for t in arrs:
                    if not bool(torch.isfinite(t).all()):
                        raise ValueError(f"non-finite activation at {tag}/{name} — checkpoint "
                                         f"conversion produced a broken module")
                x = arrs[0].float()
                mean, std = float(x.mean()), float(x.std()) if x.numel() > 1 else 0.0
                stats[f"{tag}/{name}"] = (mean, std)
                if std == 0.0 and x.numel() > 1:
                    suspects.append(f"{tag}/{name}")
            return check

        handles = [m.register_forward_hook(hook(name or tag))
                   for name, m in model.named_modules()]
        try:
            fn()
        finally:
            for h in handles:
                h.remove()

    ucfg = pipe.unet.config
    f, lat, d, c = 2, 8, ucfg.cross_attention_dim, ucfg.in_channels
    run("unet", pipe.unet, lambda: pipe.unet(
        mk(1, f, lat, lat, c), torch.tensor([501], device=dev), torch.tensor([8], device=dev),
        mk(1, f, lat, lat, c), mk(1, f, lat, lat, c), mk(1, f, d), mk(1, 77, d)))
    hw = 8 * pipe.vae_scale_factor
    run("vae", pipe.vae, lambda: pipe.vae.decode(pipe.vae.encode(mk(1, hw, hw, 3))[0]))
    vocab = pipe.text_encoder.config.vocab_size
    ids = torch.as_tensor(rng.integers(0, vocab, (1, 7)), device=dev)
    run("text_encoder", pipe.text_encoder, lambda: pipe.text_encoder(ids))
    sz = pipe.clip_image_size
    run("image_encoder", pipe.image_encoder, lambda: pipe.image_encoder(mk(1, sz, sz, 3)))
    if suspects:
        logger.warning("zero-variance activations (check wiring): %s", suspects[:20])
    logger.info("activation verify OK: %d modules finite", len(stats))
    return stats


def main(argv=None) -> None:
    """Load (convert) and check a checkpoint without running a pipeline job:

      python -m mvoc_tpu_torch.models.convert <checkpoint_dir | tiny> [--verify]

    --verify also runs every module on deterministic inputs and checks its
    activations (verify_activations).  Runs on CUDA unless --device cpu."""
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--verify", action="store_true",
                    help="run per-module activation statistics")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.checkpoint_dir == "tiny":
        from mvoc_tpu_torch.utils.testing import build_tiny_pipeline

        print("tiny mode: random-weight pipeline (no checkpoint conversion)")
        pipe = build_tiny_pipeline(device=args.device)
    else:
        pipe = load_pipeline(args.checkpoint_dir, dtype=getattr(torch, args.dtype),
                             device=args.device)
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder,
                                       pipe.image_encoder) for p in m.parameters())
    cfg = pipe.unet.config
    print(f"conversion OK: {n_params / 1e9:.3f}B parameters "
          f"(unet geometry: transformer_in {cfg.transformer_in_heads}x"
          f"{cfg.transformer_in_head_dim}, temporal encoder "
          f"{cfg.img_temporal_encoder_heads}x{cfg.img_temporal_encoder_head_dim})")
    if args.verify:
        stats = verify_activations(pipe)
        worst = sorted(stats.items(), key=lambda kv: -abs(kv[1][0]))[:10]
        for name, (m, sd) in worst:
            print(f"  {name}: mean {m:+.4f} std {sd:.4f}")
        print(f"activation verify OK: {len(stats)} modules finite")


if __name__ == "__main__":
    main()
