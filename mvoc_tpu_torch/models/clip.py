"""CLIP text and vision towers in PyTorch (counterpart of mvoc_tpu/models/clip.py).

Module names are the HF transformers keys (text_model.*, vision_model.*,
visual_projection).  CLIP's own attention is plain tensor math (matmul and
softmax), as in the JAX package: it runs once per prompt or frame, outside
the kernels' path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mvoc_tpu_torch.models.layers import Conv2d, LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              max_position_embeddings=12)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                                num_attention_heads=2, image_size=28, patch_size=14,
                                projection_dim=16)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new"):
        approx = "tanh" if name == "gelu_new" else "none"
        return lambda x: F.gelu(x, approximate=approx)
    raise ValueError(f"unknown activation {name}")


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, s, c = x.shape
        h = self.num_heads
        d = c // h

        def heads(t):
            return t.reshape(b, s, h, d).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
        if causal:
            mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, act: str):
        super().__init__()
        self.act = _act(act)
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, num_heads: int, act: str,
                 eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(hidden_size, num_heads)
        self.layer_norm1 = LayerNorm(hidden_size, eps=eps)
        self.mlp = _MLP(hidden_size, intermediate_size, act)
        self.layer_norm2 = LayerNorm(hidden_size, eps=eps)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal=causal)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads,
                             cfg.hidden_act, cfg.layer_norm_eps)
            for _ in range(cfg.num_hidden_layers)])


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """input_ids [B, S] -> last hidden states [B, S, D]; clip_skip picks the
    hidden state clip_skip layers before the end (then the final LN)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0) -> torch.Tensor:
        tm = self.text_model
        s = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :s]
        hidden_states = []
        for layer in tm.encoder.layers:
            x = layer(x, causal=True)
            hidden_states.append(x)
        if clip_skip > 0:
            x = hidden_states[-(clip_skip + 1)]
        return tm.final_layer_norm(x)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size,
                                      bias=False)
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModelWithProjection(nn.Module):
    """pixel_values [B, H, W, 3] (CLIP-normalised) -> image_embeds [B, P]."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm, cfg = self.vision_model, self.config
        emb = vm.embeddings
        dt = emb.class_embedding.dtype
        b = pixel_values.shape[0]
        patches = emb.patch_embedding(pixel_values.to(dt)).reshape(b, -1, cfg.hidden_size)
        cls = emb.class_embedding[None, None].expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


# CLIP preprocessing statistics (CLIPImageProcessor)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_clip_image(pixels01: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> CLIP-normalised."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=pixels01.dtype, device=pixels01.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=pixels01.dtype, device=pixels01.device)
    return (pixels01 - mean) / std
