"""K1 / K2 of mvoc_tpu_torch: the plain versions vs the JAX package's Pallas
kernels (interpret mode).  The CUDA kernels vs the plain versions are in
test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvoc_tpu.models.layers import _block_diag_bias, _head_group_size
from mvoc_tpu.ops.attention import flash_attention as jax_flash
from mvoc_tpu.ops.attention import frame_attention as jax_frame
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


def test_wrappers_count_no_launch_on_cpu():
    tattn.reset_launch_counts()
    x = torch.randn(1, 2, 70, 64)
    tattn.flash_attention(x, x, x)
    y = torch.randn(1, 4, 9, 16)
    tattn.frame_attention(y, y, y, heads=2)
    assert tattn.LAUNCHES == {"flash_attention": 0, "frame_attention": 0}
