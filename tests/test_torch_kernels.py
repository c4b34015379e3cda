"""The CUDA kernels K1 / K2 vs their plain PyTorch versions, on a card.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX:  python -m pytest --noconftest tests/test_torch_kernels.py
Without a card every kernel test here skips; the check of the bf16
tolerance itself runs on the CPU."""

import numpy as np
import pytest
import torch

from mvoc_tpu_torch.ops import attention as tattn

# bf16 kernel vs plain: |err| <= BF16_REL * max|plain|.  The roundings of the
# pre-scaled q, of p and of the output each cost up to 2^-9 of what they
# round, so the bound follows the output's scale (which falls as 1/sqrt(Sk))
BF16_REL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _band(f, window):
    idx = np.arange(f)
    return np.abs(idx[:, None] - idx[None, :]) <= window // 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 5, 300, 300, 64), (2, 5, 257, 145, 64),
                                         (1, 1, 300, 300, 512)])
def test_flash_kernel_matches_plain(cuda_device, dtype, b, h, sq, sk, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=cuda_device).to(dtype)
               for s in (sq, sk, sk))
    before = tattn.LAUNCHES["flash_attention"]
    got = tattn.flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    assert tattn.LAUNCHES["flash_attention"] == before + 1
    want = tattn.flash_attention_plain(q, k, v).float()
    tol = 2e-5 if dtype == torch.float32 else BF16_REL * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,heads,f,d,window", [("natural", 5, 16, 64, None),
                                                     ("sf", 2, 16, 4, None),
                                                     ("sf", 20, 64, 64, None),
                                                     ("natural", 8, 16, 64, 6)])
def test_frame_kernel_matches_plain(cuda_device, dtype, layout, heads, f, d, window):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    s = 77
    shape = (2, f, s, heads * d) if layout == "natural" else (s, f, heads * d)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    mask = None if window is None else torch.from_numpy(_band(f, window)).to(cuda_device)
    got = tattn.frame_attention(q, k, v, heads, mask=mask, layout=layout).float()
    want = tattn.frame_attention_plain(q, k, v, heads, mask=mask, layout=layout).float()
    tol = 2e-5 if dtype == torch.float32 else BF16_REL * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_bf16_tolerance_catches_a_dropped_key_tile():
    """At Sk = 14400 the plain version's own bf16 roundings stay inside the
    bound and an attention that drops one 64-key tile does not."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, s, 64, generator=g).bfloat16() for s in (256, 14400, 14400))
    want = tattn.flash_attention_plain(q.float(), k.float(), v.float())
    rounded = tattn.flash_attention_plain(q, k, v).float()
    dropped = tattn.flash_attention_plain(q, k[:, :, 64:], v[:, :, 64:]).float()
    tol = BF16_REL * want.abs().max().item()
    assert (rounded - want).abs().max().item() <= tol < (dropped - want).abs().max().item()


@pytest.mark.cuda
def test_unsupported_head_dim_raises_on_cuda(cuda_device):
    x = torch.zeros(1, 1, 70, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_attention(x, x, x)
