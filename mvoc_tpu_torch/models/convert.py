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
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

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


def _tensor(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    value = np.asarray(value)
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
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def _generic(params: dict, prefix_fn=None) -> Dict[str, torch.Tensor]:
    out = {}
    for path, value in _flatten(_unwrap(params)):
        *mods, leaf = path
        name, tensor = _tensor(leaf, value)
        key = ".".join(_segment(m) for m in mods)
        if prefix_fn is not None:
            key = prefix_fn(key)
        out[f"{key}.{name}" if key else name] = tensor
    return _to_torch(out)


def unet_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """mvoc_tpu I2VGenXLUNet params -> I2VGenXLUNet state dict."""
    return _generic(params)


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
