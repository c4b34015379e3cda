"""K1 / K2 of mvoc_tpu_torch: the plain versions vs the JAX package's Pallas
kernels (interpret mode), and frame-axis attention over more than 64 frames
(K1 with the band as its bias) vs the JAX package's XLA attention.  The
CUDA kernels vs the plain versions are in test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvoc_tpu.models import layers as jl
from mvoc_tpu.models.layers import _block_diag_bias, _head_group_size
from mvoc_tpu.ops.attention import flash_attention as jax_flash
from mvoc_tpu.ops.attention import frame_attention as jax_frame
from mvoc_tpu_torch.models import layers as tl
from mvoc_tpu_torch.ops import attention as tattn
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)


ATOL = 2e-5  # fp32, as tests/test_attention.py


@pytest.mark.parametrize("sq,sk,d", [(256, 256, 8), (300, 300, 8), (130, 145, 8), (300, 300, 64),
                                     (130, 145, 64)])
def test_flash_plain_matches_jax_kernel(sq, sk, d):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (rng.standard_normal((2, 3, s, d)).astype(np.float32) for s in (sq, sk, sk))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=128, block_k=128, interpret=True))
    got = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _band(f, window):
    idx = np.arange(f)
    return np.abs(idx[:, None] - idx[None, :]) <= window // 2


@pytest.mark.parametrize("layout", ["natural", "sf"])
@pytest.mark.parametrize("heads,f,window", [(4, 16, None), (4, 16, 6), (2, 8, None), (3, 8, 4)])
def test_frame_plain_matches_jax_kernel(layout, heads, f, window):
    d, s = 8, 12
    rng = np.random.default_rng(heads * 100 + f)
    shape = (2, f, s, heads * d) if layout == "natural" else (s, f, heads * d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = None if window is None else _band(f, window)
    g = _head_group_size(heads, f)
    assert g > 1
    bias = _block_diag_bias(f, g, None if mask is None else jnp.asarray(mask))
    want = np.asarray(jax_frame(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), f, heads, bias,
                                sf_layout=layout == "sf", interpret=True))
    got = tattn.frame_attention(*(torch.from_numpy(a) for a in (q, k, v)), heads,
                                mask=None if mask is None else torch.from_numpy(mask),
                                layout=layout).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("fn", ["sdpa", "sdpa_frames"])
@pytest.mark.parametrize("f,window", [(65, None), (65, 8), (130, None), (130, 9)])
def test_frame_axis_over_64_frames_matches_jax(fn, f, window):
    """Past K2's 64 frames the port takes K1 (the band as its bias), the JAX
    package XLA attention with finfo.min: the same probabilities, since a
    band keeps its diagonal.  sdpa: pixel-major [S, F, H*D]; sdpa_frames:
    frame-major [B, F, S, H*D] with B = 2 (one K1 launch per entry)."""
    heads, d, s = 2, 8, 6
    rng = np.random.default_rng(f + (window or 0))
    shape = (s, f, heads * d) if fn == "sdpa" else (2, f, s, heads * d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = None if window is None else _band(f, window)
    want = np.asarray(getattr(jl, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                      mask=None if mask is None else jnp.asarray(mask)))
    got = getattr(tl, fn)(*(torch.from_numpy(a) for a in (q, k, v)), heads,
                          mask=None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_flash_plain_bias_masks_exactly():
    """The plain K1 adds the bias to the scaled logits (floored at -2e30, as
    the kernel does): each row is the softmax over its kept keys alone."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 70, 4)).astype(np.float32))
               for _ in range(3))
    band = torch.from_numpy(_band(70, 5))
    got = tattn.flash_attention(q, k, v, bias=tattn.band_bias(band))
    # each row over its kept keys only
    for i in (0, 35, 69):
        keep = band[i]
        want = tattn.flash_attention_plain(q[:, :, i:i + 1], k[:, :, keep], v[:, :, keep])
        torch.testing.assert_close(got[:, :, i:i + 1], want, rtol=0, atol=1e-6)


def test_flash_refuses_bias_row_without_key():
    """K1's designs disagree on a row whose keys are all masked, so the
    wrapper refuses such a bias, on either device."""
    x = torch.randn(1, 2, 6, 4)
    bias = tattn.band_bias(torch.from_numpy(_band(6, 3)))
    tattn.flash_attention(x, x, x, bias=bias)
    bad = bias.clone()
    bad[4] = tattn.NEG_BIG
    with pytest.raises(ValueError, match="every bias row must keep a key"):
        tattn.flash_attention(x, x, x, bias=bad)


def test_wrappers_count_no_launch_on_cpu():
    tattn.reset_launch_counts()
    x = torch.randn(1, 2, 70, 64)
    tattn.flash_attention(x, x, x)
    y = torch.randn(1, 4, 9, 16)
    tattn.frame_attention(y, y, y, heads=2)
    assert tattn.LAUNCHES == {"flash_attention": 0, "frame_attention": 0}


@pytest.mark.parametrize("dtype,d,want", [(torch.bfloat16, 64, "wgmma"),
                                          (torch.bfloat16, 512, "wgmma"),
                                          (torch.float32, 64, "simt"),
                                          (torch.float32, 512, "simt"),
                                          (torch.bfloat16, 4, "simt"),
                                          (torch.float32, 4, "simt")])
def test_flash_variant_follows_dtype_and_head_dim(dtype, d, want):
    """K1's design on the card is a function of (dtype, head dim) alone:
    bf16 on the tensor cores, fp32 and D = 4 on the SIMT kernel."""
    assert tattn.flash_variant(dtype, d) == want
    assert want in tattn.FLASH_VARIANTS


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.bfloat16, 128)])
def test_flash_variant_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="dtype|head dim"):
        tattn.flash_variant(dtype, d)


@pytest.mark.parametrize("shape,strides,ptr,itemsize,problem", [
    # the main path: [B, S, H, D] projections viewed as [B, H, S, D]
    ((16, 5, 4096, 64), (4096 * 320, 64, 320, 1), 0x7f0000000000, 2, None),
    # k / v halves of one [B, S, 2, H, D] projection: v starts H*D elements in
    ((2, 5, 145, 64), (145 * 640, 64, 640, 1), 0x7f0000000000 + 2 * 320, 2, None),
    ((1, 1, 145, 64), (145 * 325, 325, 325, 1), 0x7f0000000000, 2, "seq stride 325"),
    ((2, 5, 145, 64), (145 * 320, 64, 320, 1), 0x7f0000000002, 2, "not 16-byte aligned"),
    ((2, 1, 10, 64), (644, 644, 64, 1), 0x7f0000000000, 2, "batch stride 644"),
    ((1, 1, 10, 64), (644, 644, 64, 1), 0x7f0000000000, 2, None),  # size-1 axes never step
    ((1, 2, 1, 512), (1036, 518, 512, 1), 0x7f0000000000, 2, "head stride 518"),
    ((2, 3, 7, 64), (21 * 68, 7 * 68, 68, 1), 0x7f0000000000, 4, None),  # fp32: 4 elements
])
def test_flash_layout_error_is_a_pure_check(shape, strides, ptr, itemsize, problem):
    """The wgmma variant's layout condition, computed without a card: every
    row it copies in 16-byte pieces starts on a 16-byte boundary."""
    got = tattn.flash_layout_error("q", shape, strides, ptr, itemsize)
    if problem is None:
        assert got is None
    else:
        assert got is not None and problem in got


@pytest.mark.parametrize("dtype,d,want", [(torch.bfloat16, 64, "mma"),
                                          (torch.bfloat16, 4, "simt"),
                                          (torch.float32, 64, "simt"),
                                          (torch.float32, 4, "simt")])
def test_frame_variant_follows_dtype_and_head_dim(dtype, d, want):
    """K2's design on the card is a function of (dtype, head dim) alone:
    bf16 at D = 64 on the tensor cores (mma.sync), fp32 and D = 4 on the
    SIMT kernel."""
    assert tattn.frame_variant(dtype, d) == want
    assert want in tattn.FRAME_VARIANTS


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.bfloat16, 8),
                                     (torch.bfloat16, 128)])
def test_frame_variant_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="dtype|head dim"):
        tattn.frame_variant(dtype, d)


@pytest.mark.parametrize("shape,strides,ptr,problem", [
    # natural [B, F, S, H*D] at the main path's heaviest shape
    ((1, 16, 4096, 320), (16 * 4096 * 320, 4096 * 320, 320, 1), 0x7f0000000000, None),
    # pixel-major [S, F, H*D] viewed as [1, F, S, H*D]
    ((1, 16, 4096, 320), (16 * 4096 * 320, 320, 16 * 320, 1), 0x7f0000000000, None),
    # the k slice of a fused [.., 3 * H*D] projection
    ((2, 16, 300, 320), (16 * 300 * 960, 300 * 960, 960, 1), 0x7f0000000000 + 640, None),
    ((1, 16, 40, 320), (16 * 40 * 324, 40 * 324, 324, 1), 0x7f0000000000, "pixel stride 324"),
    ((1, 16, 1, 320), (16 * 324, 324, 324, 1), 0x7f0000000000, "frame stride 324"),
    ((1, 1, 1, 320), (324, 324, 324, 1), 0x7f0000000000, None),  # size-1 axes never step
    ((1, 16, 40, 320), (16 * 40 * 320, 40 * 320, 320, 1), 0x7f0000000008, "not 16-byte"),
])
def test_frame_layout_error_is_a_pure_check(shape, strides, ptr, problem):
    """The mma design's layout condition on the [B, F, S, H*D] view, computed
    without a card: every 128-byte (pixel, head) row starts on a 16-byte
    boundary."""
    got = tattn.flash_layout_error("q", shape, strides, ptr, 2, "frame_attention",
                                   ("batch", "frame", "pixel"))
    if problem is None:
        assert got is None
    else:
        assert got is not None and problem in got and got.startswith("frame_attention")
