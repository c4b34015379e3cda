"""Every layer mvoc_tpu_torch ports, against its flax counterpart, with the
flax params (every leaf replaced by seeded noise) carried across through
models/convert.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvoc_tpu.models import layers as jl
from mvoc_tpu_torch.models import layers as tl
from mvoc_tpu_torch.models.convert import unet_state_dict_from_flax
from torch_support import noisy_params
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)


ATOL = 2e-5


def _edit(q, k):  # a Q/K edit hook; the same arithmetic on jax and torch arrays
    return q * 1.5 + 0.1, k - 0.2


def _band(f, window):
    idx = np.arange(f)
    return np.abs(idx[:, None] - idx[None, :]) <= window // 2


# name -> (flax module, torch module, inputs (tuple of numpy arrays), jax kwargs,
#          torch kwargs).  Built inside the test, not at import: every xdist worker
#          imports every test file.
def _cases():
    r = np.random.default_rng(0)

    def mk(*s):
        return r.standard_normal(s).astype(np.float32)

    ctx = mk(2, 9, 12)
    return {
        "timestep_embedding_mlp": (jl.TimestepEmbedding(32), tl.TimestepEmbedding(8, 32),
                                   (mk(2, 8),), {}, {}),
        "groupnorm_4d": (jl.GroupNorm(4, epsilon=1e-6), tl.GroupNorm(4, 16, eps=1e-6),
                         (mk(2, 5, 6, 16) * 3 + 2,), {}, {}),
        "groupnorm_5d": (jl.GroupNorm(4), tl.GroupNorm(4, 16), (mk(2, 3, 5, 6, 16) + 4,), {}, {}),
        "layernorm": (jl.LayerNorm(), tl.LayerNorm(16), (mk(2, 7, 16) + 1,), {}, {}),
        "attention_self_qk_edit": (
            jl.Attention(query_dim=16, heads=2, dim_head=8), tl.Attention(16, 2, 8),
            (mk(3, 20, 16),), {"qk_edit": _edit}, {"qk_edit": _edit}),
        "attention_self_long": (jl.Attention(query_dim=16, heads=2, dim_head=8),
                                tl.Attention(16, 2, 8), (mk(2, 70, 16),), {}, {}),
        "attention_cross": (
            jl.Attention(query_dim=16, heads=2, dim_head=8),
            tl.Attention(16, 2, 8, cross_attention_dim=12), (mk(2, 70, 16),),
            {"encoder_hidden_states": jnp.asarray(ctx)},
            {"encoder_hidden_states": torch.from_numpy(ctx)}),
        "attention_frame_axis_band": (
            jl.Attention(query_dim=16, heads=2, dim_head=8, frame_axis=True),
            tl.Attention(16, 2, 8, frame_axis=True), (mk(2, 6, 10, 16),),
            {"attn_mask": jnp.asarray(_band(6, 2))},
            {"attn_mask": torch.from_numpy(_band(6, 2))}),
        "feedforward_geglu": (jl.FeedForward(16), tl.FeedForward(16), (mk(2, 9, 16),), {}, {}),
        "feedforward_gelu": (jl.FeedForward(4, inner_dim=16, activation="gelu"),
                             tl.FeedForward(4, inner_dim=16, activation="gelu"),
                             (mk(30, 16, 4),), {}, {}),
        "basic_transformer_block": (
            jl.BasicTransformerBlock(dim=16, heads=2, dim_head=8),
            tl.BasicTransformerBlock(16, 2, 8, cross_attention_dim=12), (mk(2, 70, 16),),
            {"encoder_hidden_states": jnp.asarray(ctx), "attn1_qk_edit": _edit},
            {"encoder_hidden_states": torch.from_numpy(ctx), "attn1_qk_edit": _edit}),
        "transformer_2d": (
            jl.Transformer2DModel(16, 2, 8, 12, norm_num_groups=4),
            tl.Transformer2DModel(16, 2, 8, 12, norm_num_groups=4), (mk(2, 6, 6, 16),),
            {"encoder_hidden_states": jnp.asarray(ctx)},
            {"encoder_hidden_states": torch.from_numpy(ctx)}),
        "transformer_temporal_standard": (
            jl.TransformerTemporalModel(16, 2, 8, norm_num_groups=4),
            tl.TransformerTemporalModel(16, 2, 8, norm_num_groups=4), (mk(6, 4, 4, 16),),
            {"num_frames": 3, "attn1_qk_edit": _edit},
            {"num_frames": 3, "attn1_qk_edit": _edit}),
        "transformer_temporal_natural": (
            jl.TransformerTemporalModel(16, 2, 8, norm_num_groups=4, natural_layout=True),
            tl.TransformerTemporalModel(16, 2, 8, norm_num_groups=4, natural_layout=True),
            (mk(6, 4, 4, 16),), {"num_frames": 3, "attn1_qk_edit": _edit},
            {"num_frames": 3, "attn1_qk_edit": _edit}),
        "transformer_temporal_window": (
            jl.TransformerTemporalModel(16, 2, 8, norm_num_groups=4, window=2),
            tl.TransformerTemporalModel(16, 2, 8, norm_num_groups=4, window=2),
            (mk(10, 3, 3, 16),), {"num_frames": 5}, {"num_frames": 5}),
        "resnet_block_2d": (
            jl.ResnetBlock2D(16, groups=4), tl.ResnetBlock2D(8, 16, 32, groups=4),
            (mk(4, 6, 6, 8), mk(4, 32)), {}, {}),
        "temporal_conv_layer": (jl.TemporalConvLayer(16, groups=4), tl.TemporalConvLayer(16, groups=4),
                                (mk(6, 4, 5, 16),), {"num_frames": 3}, {"num_frames": 3}),
        "downsample_2d": (jl.Downsample2D(12), tl.Downsample2D(16, 12), (mk(2, 7, 6, 16),), {}, {}),
        "upsample_2d": (jl.Upsample2D(12), tl.Upsample2D(16, 12), (mk(2, 3, 4, 16),),
                        {"output_size": (5, 7)}, {"output_size": (5, 7)}),
    }


CASE_NAMES = (
    "attention_cross", "attention_frame_axis_band", "attention_self_long",
    "attention_self_qk_edit", "basic_transformer_block", "downsample_2d", "feedforward_geglu",
    "feedforward_gelu", "groupnorm_4d", "groupnorm_5d", "layernorm", "resnet_block_2d",
    "temporal_conv_layer", "timestep_embedding_mlp", "transformer_2d",
    "transformer_temporal_natural", "transformer_temporal_standard",
    "transformer_temporal_window", "upsample_2d")


def test_timestep_embedding_function():
    t = np.array([0, 1, 500, 999])
    for dim in (8, 9):
        np.testing.assert_allclose(
            tl.timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jl.timestep_embedding(jnp.asarray(t), dim)), atol=1e-5)


@pytest.fixture(scope="module")
def cases():
    built = _cases()
    assert sorted(built) == list(CASE_NAMES)
    return built


@pytest.mark.parametrize("name", CASE_NAMES)
def test_layer_matches_flax(cases, name):
    jmod, tmod, inputs, jkw, tkw = cases[name]
    jin = [jnp.asarray(x) for x in inputs]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), *jin, **jkw))
    params = noisy_params(shapes["params"], np.random.default_rng(len(name)))
    want = np.asarray(jmod.apply({"params": params}, *jin, **jkw))
    tmod.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(x) for x in inputs), **tkw).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    print(f"{name}: max |err| {np.abs(got - want).max():.3g} of max |flax| {scale:.3g}")
    np.testing.assert_allclose(got, want, atol=ATOL * scale)
