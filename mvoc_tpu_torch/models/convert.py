"""Weight bridge: the JAX package's flax params -> diffusers-keyed torch
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

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from mvoc_tpu_torch.ops.quantize import quantize_unet_

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
