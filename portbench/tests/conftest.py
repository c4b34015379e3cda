"""Fixtures of the benchmark's own tests: a tiny geometry for CPU runs of
the harness, and `card`, which skips a test where no CUDA card is (tests
that need one carry the repository's `cuda` marker)."""

import json

import pytest

TINY_CONFIG = {
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [8, 16, 32, 32],
             "layers_per_block": 2, "norm_num_groups": 4, "cross_attention_dim": 16,
             "attention_head_dim": 4, "transformer_in_heads": 2,
             "img_temporal_encoder_heads": 2, "norm_eps": 1e-5},
    "vae": {"in_channels": 3, "out_channels": 3, "block_out_channels": [8, 16],
            "layers_per_block": 1, "latent_channels": 4, "norm_num_groups": 4,
            "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 64, "hidden_size": 16, "intermediate_size": 32,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 12, "layer_norm_eps": 1e-5},
    "image_encoder": {"hidden_size": 16, "intermediate_size": 32, "num_hidden_layers": 2,
                      "num_attention_heads": 2, "image_size": 28, "patch_size": 14,
                      "projection_dim": 16, "layer_norm_eps": 1e-5},
}
TINY_CALL = {"width": 32, "height": 16, "frames": 4}
# the int8-mixed selection's threshold at the tiny widths (1280 at full width)
TINY_MIN_K = 32


def tiny_geometry(int8: bool, dtype: str = "float32", call=None, widen: int = 1):
    """The tiny geometry; widen multiplies the UNet's widths (4: 32 to 128
    channels, head dim 16, a 32-wide context), where bf16 rounding and the
    int8 path already stand to each other as at the published widths."""
    from portbench.run import Geometry

    cfg = json.loads(json.dumps(dict(TINY_CONFIG, dtype=dtype)))
    if widen > 1:
        ctx = 8 * widen
        cfg["unet"].update(block_out_channels=[8 * widen, 16 * widen, 32 * widen, 32 * widen],
                           cross_attention_dim=ctx, attention_head_dim=4 * widen)
        cfg["text_encoder"]["hidden_size"] = ctx
        cfg["image_encoder"]["projection_dim"] = ctx
    cfg["int8"] = {"mode": "mixed", "min_k": TINY_MIN_K * widen} if int8 else None
    return Geometry(config=cfg, call={**TINY_CALL, **(call or {})})


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
