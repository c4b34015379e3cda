"""The CUDA kernels K1 / K2 / K3 vs their plain PyTorch versions, on a card.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX:  python -m pytest --noconftest tests/test_torch_kernels.py
Without a card every kernel test here skips; the check of the bf16
tolerance itself runs on the CPU."""

import functools

import numpy as np
import pytest
import torch

from mvoc_tpu_torch.ops import attention as tattn
from mvoc_tpu_torch.ops import s8gemm as ts8

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


def _frame_qkv(device, shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(3))


def _check_frame(got, q, k, v, heads, mask, layout):
    """Against the plain version in fp32 from the same inputs."""
    want = tattn.frame_attention_plain(q.float(), k.float(), v.float(), heads, mask=mask,
                                       layout=layout)
    assert got.dtype == q.dtype and got.shape == want.shape
    tol = 2e-5 if q.dtype == torch.float32 else BF16_REL * want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["natural", "sf"])
@pytest.mark.parametrize("d", [4, 64])
@pytest.mark.parametrize("f", [1, 2, 15, 16, 17, 33, 64])
def test_frame_bf16_at_frame_edges(cuda_device, f, d, layout, masked):
    """K2's bf16 design for the head dim (D = 64: mma.sync, F padded to 16,
    32, 48 or 64 rows; D = 4: SIMT) at frame counts around every 16-row
    tile, with and without the band, in both layouts."""
    s, heads = 45, 3
    shape = (2, f, s, heads * d) if layout == "natural" else (s, f, heads * d)
    q, k, v = _frame_qkv(cuda_device, shape, seed=f + d)
    mask = torch.from_numpy(_band(f, 5)).to(cuda_device) if masked else None
    before = dict(tattn.LAUNCH_VARIANTS["frame_attention"])
    got = tattn.frame_attention(q, k, v, heads, mask=mask, layout=layout)
    torch.cuda.synchronize()
    want_variant = "mma" if d == 64 else "simt"
    after = tattn.LAUNCH_VARIANTS["frame_attention"]
    assert after[want_variant] == before.get(want_variant, 0) + 1
    _check_frame(got, q, k, v, heads, mask, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("b,s,heads", [(1, 4097, 5), (3, 7, 1), (1, 1, 2)])
def test_frame_bf16_ragged_pixel_counts(cuda_device, variant, b, s, heads):
    """Unit counts (B * S * heads) that leave the last warps of the
    grid-stride loop, and the SIMT design's last pixel tile, ragged."""
    q, k, v = _frame_qkv(cuda_device, (b, 16, s, heads * 64), seed=s)
    got = tattn._frame_cuda(q, k, v, heads, None, "natural", variant)
    torch.cuda.synchronize()
    _check_frame(got, q, k, v, heads, None, "natural")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "simt"])
@pytest.mark.parametrize("layout", ["natural", "sf"])
def test_frame_bf16_reads_strided_projections(cuda_device, variant, layout):
    """q, k and v the three slices of one fused [.., 3 * H*D] projection
    (row stride 3 * H*D, k and v H*D and 2 * H*D elements in): read in
    place, and the output comes back dense."""
    heads, f, s = 5, 16, 300
    inner = heads * 64
    g = torch.Generator(device=cuda_device).manual_seed(3)
    lead = (2, f, s) if layout == "natural" else (s, f)
    qkv = torch.randn(*lead, 3 * inner, generator=g, device=cuda_device).bfloat16()
    q, k, v = qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]
    mask = torch.from_numpy(_band(f, 7)).to(cuda_device)
    got = tattn._frame_cuda(q, k, v, heads, mask, layout, variant)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    _check_frame(got, q, k, v, heads, mask, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,f,d", [("natural", 16, 64), ("sf", 33, 64), ("sf", 64, 4)])
def test_frame_fp32_takes_the_simt_kernel(cuda_device, layout, f, d):
    """fp32 stays on the exact-fp32 SIMT kernel (tensor cores would take it
    to TF32): 2e-5 of the plain version."""
    heads, s = 4, 50
    shape = (2, f, s, heads * d) if layout == "natural" else (s, f, heads * d)
    q, k, v = _frame_qkv(cuda_device, shape, dtype=torch.float32, seed=f)
    before = tattn.LAUNCH_VARIANTS["frame_attention"]["simt"]
    got = tattn.frame_attention(q, k, v, heads, layout=layout)
    torch.cuda.synchronize()
    assert tattn.LAUNCH_VARIANTS["frame_attention"]["simt"] == before + 1
    _check_frame(got, q, k, v, heads, None, layout)


@pytest.mark.cuda
def test_frame_bf16_d64_takes_the_mma_design(cuda_device):
    """The bf16 D = 64 call launches the mma.sync design, and its output is
    the named variant's bit for bit."""
    q, k, v = _frame_qkv(cuda_device, (1, 16, 256, 5 * 64), seed=9)
    before = dict(tattn.LAUNCH_VARIANTS["frame_attention"])
    got = tattn.frame_attention(q, k, v, 5)
    after = dict(tattn.LAUNCH_VARIANTS["frame_attention"])
    assert after.get("mma", 0) == before.get("mma", 0) + 1
    assert after.get("simt", 0) == before.get("simt", 0)
    assert torch.equal(got, tattn._frame_cuda(q, k, v, 5, None, "natural", "mma"))


@pytest.mark.cuda
def test_frame_tensor_core_path_refuses_misaligned_layouts(cuda_device):
    """A pixel stride that is not a multiple of 8 elements raises before any
    launch on the mma design; the SIMT design takes it."""
    wide = torch.randn(1, 16, 40, 5 * 64 + 4, device=cuda_device).bfloat16()[..., :5 * 64]
    before = tattn.LAUNCHES["frame_attention"]
    with pytest.raises(ValueError, match="pixel stride 324"):
        tattn.frame_attention(wide, wide, wide, 5)
    assert tattn.LAUNCHES["frame_attention"] == before
    got = tattn._frame_cuda(wide, wide, wide, 5, None, "natural", "simt")
    _check_frame(got, wide, wide, wide, 5, None, "natural")


EDGES = (1, 63, 64, 65, 127, 145, 4095)


def _bf16_qkv(device, b, h, sq, sk, d, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(b, h, s, d, generator=g, device=device).bfloat16()
                 for s in (sq, sk, sk))


def _check_bf16(got, q, k, v):
    want = tattn.flash_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= BF16_REL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "simt"])
@pytest.mark.parametrize("sk", EDGES)
@pytest.mark.parametrize("sq", EDGES)
def test_flash_bf16_variants_at_tile_edges(cuda_device, variant, sq, sk):
    """Both bf16 designs of K1 (D = 64: wgmma, and the SIMT kernel kept for
    timing) against the plain version in fp32 at ragged query and key
    lengths around the tiles (64 / 128 rows, 64 keys), Sk = 1 and 63 inside
    one key tile."""
    q, k, v = _bf16_qkv(cuda_device, 1, 2, sq, sk, 64)
    got = tattn._flash_cuda(q, k, v, variant)
    torch.cuda.synchronize()
    _check_bf16(got, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "simt"])
@pytest.mark.parametrize("b,sq,sk", [(1, 1, 1), (2, 65, 145), (1, 300, 33), (1, 4095, 300)])
def test_flash_bf16_d512_ragged(cuda_device, variant, b, sq, sk):
    """D = 512 (the VAE's single head) at ragged lengths: 64-row query and
    32-key tiles, q scaled and rounded before the product."""
    q, k, v = _bf16_qkv(cuda_device, b, 1, sq, sk, 512)
    got = tattn._flash_cuda(q, k, v, variant)
    torch.cuda.synchronize()
    _check_bf16(got, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [145, 4096])
def test_flash_bf16_reads_strided_projections(cuda_device, sk):
    """The main path's layout: q a [B, S, H, D] projection and k / v the two
    halves of one [B, S, 2, H, D] projection, all viewed as [B, H, S, D]
    (seq stride H*D or 2*H*D, v's base H*D elements in)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, h, sq, d = 2, 5, 1000, 64
    q = torch.randn(b, sq, h, d, generator=g, device=cuda_device).bfloat16().transpose(1, 2)
    kv = torch.randn(b, sk, 2, h, d, generator=g, device=cuda_device).bfloat16()
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    _check_bf16(got, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "simt"])
def test_flash_bf16_large_logits_rescale(cuda_device, variant):
    """q x 30: logits of magnitude ~30, so the running max moves from key
    tile to key tile and the accumulator is rescaled on the way."""
    q, k, v = _bf16_qkv(cuda_device, 2, 3, 777, 1500, 64, seed=2)
    q = (q.float() * 30).bfloat16()
    got = tattn._flash_cuda(q, k, v, variant)
    torch.cuda.synchronize()
    _check_bf16(got, q, k, v)


@pytest.mark.cuda
def test_flash_tensor_core_path_refuses_misaligned_layouts(cuda_device):
    """A seq stride that is not a multiple of 8 elements, or a pointer off
    a 16-byte boundary, raises before any launch; fp32 (SIMT) takes both."""
    base = torch.zeros(1, 2, 100, 72, device=cuda_device, dtype=torch.bfloat16)
    padded = base[..., :64]  # seq stride 72: a multiple of 8, taken
    tattn.flash_attention(padded, padded, padded)
    wide = torch.zeros(1, 2, 100, 68, device=cuda_device, dtype=torch.bfloat16)[..., :64]
    shifted = torch.zeros(1 * 2 * 100 * 64 + 1, device=cuda_device,
                          dtype=torch.bfloat16)[1:].view(1, 2, 100, 64)
    before = tattn.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="seq stride 68"):
        tattn.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        tattn.flash_attention(shifted, padded, padded)
    assert tattn.LAUNCHES["flash_attention"] == before
    wide32 = torch.ones(1, 2, 100, 67, device=cuda_device)[..., :64]  # 268-byte rows
    shifted32 = torch.ones(2 * 100 * 64 + 1, device=cuda_device)[1:].view(1, 2, 100, 64)
    got = tattn.flash_attention(wide32, wide32, shifted32)
    assert tattn.LAUNCHES["flash_attention"] == before + 1
    assert torch.equal(got, torch.ones_like(got))


def _band_bias(device, f, window):
    return tattn.band_bias(torch.from_numpy(_band(f, window)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dtype", [("wgmma", torch.bfloat16), ("simt", torch.bfloat16),
                                           ("simt", torch.float32)])
@pytest.mark.parametrize("f,window,d", [(65, None, 64), (65, 9, 64), (96, 9, 64), (96, 31, 64),
                                        (200, 17, 64), (96, 9, 512)])
def test_flash_bias_matches_plain(cuda_device, variant, dtype, f, window, d):
    """K1 with the [F, F] band as its fp32 bias (frame-axis attention past
    K2's 64 frames) against the plain version: the [B*S, H, F, D] view of
    pixel-major tokens, every design; F = 96 spans two 64-key tiles, so rows
    whose first key tile is all masked keep their running max at -1e30 (the
    D = 512 design, 32-key tiles, as well)."""
    g = torch.Generator(device=cuda_device).manual_seed(f)
    s, h = 37, 5
    q, k, v = (torch.randn(s, f, h * d, generator=g, device=cuda_device).to(dtype)
               .view(s, f, h, d).transpose(1, 2) for _ in range(3))
    bias = None if window is None else _band_bias(cuda_device, f, window)
    got = tattn._flash_cuda(q, k, v, variant, bias=bias)
    torch.cuda.synchronize()
    want = tattn.flash_attention_plain(q.float(), k.float(), v.float(), bias)
    tol = 2e-5 * want.abs().max().item() if dtype == torch.float32 \
        else BF16_REL * want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,layout", [("sdpa", "sf"), ("sdpa_frames", "natural")])
def test_frame_axis_over_64_frames_launches_k1(cuda_device, dtype, fn, layout):
    """layers.sdpa / frame_axis_attention (layout "natural", the JAX
    package's sdpa_frames) at F = 96 with a temporal window band: K1 with
    the bias (natural layout: one launch per batch entry, q/k/v read in
    place), D = 64 and the image-latents encoder's D = 4."""
    from mvoc_tpu_torch.models import layers as tl

    port = tl.sdpa if fn == "sdpa" else functools.partial(tattn.frame_axis_attention,
                                                          layout="natural")

    f, s, b = 96, 40, 2
    for heads, d in ((5, 64), (2, 4)):
        g = torch.Generator(device=cuda_device).manual_seed(heads)
        shape = (s, f, heads * d) if layout == "sf" else (b, f, s, heads * d)
        q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
                   for _ in range(3))
        mask = torch.from_numpy(_band(f, 9)).to(cuda_device)
        before = dict(tattn.LAUNCHES)
        got = port(q, k, v, heads, mask=mask)
        torch.cuda.synchronize()
        assert tattn.LAUNCHES["frame_attention"] == before["frame_attention"]
        assert tattn.LAUNCHES["flash_attention"] == before["flash_attention"] + (
            1 if layout == "sf" else b)
        want = port(q.float().cpu(), k.float().cpu(), v.float().cpu(), heads,
                    mask=mask.cpu())
        tol = (2e-5 if dtype == torch.float32 else BF16_REL) * want.abs().max().item()
        assert (got.float().cpu() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_safetensors_round_trip_from_cuda(cuda_device, tmp_path):
    """The port's safetensors writer takes CUDA tensors (copied to the host
    one at a time) and its reader puts them back on the card, bit for bit."""
    from mvoc_tpu_torch.io import safetensors as port_st

    g = torch.Generator(device=cuda_device).manual_seed(0)
    ts = {"w": torch.randn(64, 33, generator=g, device=cuda_device).bfloat16(),
          "b": torch.randn(33, generator=g, device=cuda_device).half(),
          "s": torch.randn(5, generator=g, device=cuda_device),
          "i": torch.arange(7, device=cuda_device)}
    path = str(tmp_path / "t.safetensors")
    port_st.save_file(ts, path)
    back = port_st.load_file(path, device=cuda_device)
    for k, v in ts.items():
        assert back[k].is_cuda and back[k].dtype == v.dtype and torch.equal(back[k], v), k


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


def _s8_operands(device, m, k, n, seed=0, weight_nk=True):
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    if weight_nk:  # the Quant modules' weight: the [K, N] view of [N, K] storage
        wq = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8).t()
    else:
        wq = torch.randint(-127, 128, (k, n), generator=g, device=device, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=device) * 0.1 + 1e-3
    sw = torch.rand(n, generator=g, device=device) * 0.1 + 1e-3
    return xq, wq, sx, sw


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 1280, 320), (17, 36, 9), (300, 2880, 200),
                                   (129, 1280, 257), (4096, 64, 128), (64, 23040, 64)])
def test_s8_kernel_matches_plain_bitwise(cuda_device, out_dtype, m, k, n):
    """Integer sums are exact and the epilogue is the same two fp32
    multiplies: the kernel equals the plain version bit for bit (ragged M,
    N and K tails, M = 1, K = 36 on the byte-wise load path)."""
    xq, wq, sx, sw = _s8_operands(cuda_device, m, k, n)
    before = ts8.LAUNCHES["s8_matmul"]
    got = ts8.s8_matmul(xq, wq, sx, sw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ts8.LAUNCHES["s8_matmul"] == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, ts8.s8_matmul_plain(xq, wq, sx, sw, out_dtype=out_dtype))


@pytest.mark.cuda
def test_s8_kernel_extremes_and_row_major_weight(cuda_device):
    """All operands at +-127 over the largest K of the int8 paths, and a
    row-major [K, N] weight (re-laid by the wrapper)."""
    m, k, n = 40, 23040, 24
    xq = torch.full((m, k), 127, dtype=torch.int8, device=cuda_device)
    xq[1::2] = -127
    wq = torch.full((n, k), 127, dtype=torch.int8, device=cuda_device).t()
    sx = torch.ones(m, device=cuda_device)
    sw = torch.ones(n, device=cuda_device)
    got = ts8.s8_matmul(xq, wq, sx, sw, out_dtype=torch.float32)
    assert torch.equal(got[0], torch.full((n,), float(k * 127 * 127), device=cuda_device))
    assert torch.equal(got, ts8.s8_matmul_plain(xq, wq, sx, sw, out_dtype=torch.float32))
    xq, wq, sx, sw = _s8_operands(cuda_device, 33, 96, 40, weight_nk=False)
    assert torch.equal(ts8.s8_matmul(xq, wq, sx, sw, out_dtype=torch.bfloat16),
                       ts8.s8_matmul_plain(xq, wq, sx, sw, out_dtype=torch.bfloat16))


S8_EDGES = (1, 63, 64, 65, 127, 128, 129, 255, 257)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "mma"])
@pytest.mark.parametrize("k", [16, 112, 128, 144, 1280, 23040])
def test_s8_designs_bitwise_at_tile_edges(cuda_device, variant, k):
    """Both K3 designs bit for bit their plain version at M and N around the
    128 x 128 output tile and its 64-row halves (the TMA boxes zero-fill past
    M, N and K) and K around the 128-deep K tile, both output dtypes."""
    for i, m in enumerate(S8_EDGES):
        for j, n in enumerate(S8_EDGES):
            out_dtype = torch.bfloat16 if (i + j) % 2 else torch.float32
            xq, wq, sx, sw = _s8_operands(cuda_device, m, k, n, seed=i * 16 + j)
            got = ts8._s8_cuda(xq, wq, sx, sw, out_dtype, variant)
            want = ts8.s8_matmul_plain(xq, wq, sx, sw, out_dtype=out_dtype)
            assert got.dtype == out_dtype and got.shape == (m, n)
            assert torch.equal(got, want), (m, k, n, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 1280, 320), (300, 23040, 320), (8192, 2560, 640),
                                   (4096, 1280, 10240)])
def test_s8_wgmma_at_main_path_widths(cuda_device, m, k, n):
    """N = 320 (a ragged last column tile), the main path's deep K, and its
    widest N."""
    xq, wq, sx, sw = _s8_operands(cuda_device, m, k, n, seed=m + n)
    got = ts8._s8_cuda(xq, wq, sx, sw, torch.bfloat16, "wgmma")
    assert torch.equal(got, ts8.s8_matmul_plain(xq, wq, sx, sw, out_dtype=torch.bfloat16))


@pytest.mark.cuda
def test_s8_wgmma_extremes_over_the_deepest_k(cuda_device):
    """All operands at +-127 over K = 23040: |acc| = 23040 * 127^2, exact."""
    m, k, n = 200, 23040, 320
    xq = torch.full((m, k), 127, dtype=torch.int8, device=cuda_device)
    xq[1::2] = -127
    wq = torch.full((n, k), 127, dtype=torch.int8, device=cuda_device)
    wq[::3] = -127
    wq = wq.t()
    sx = torch.ones(m, device=cuda_device)
    sw = torch.ones(n, device=cuda_device)
    got = ts8._s8_cuda(xq, wq, sx, sw, torch.float32, "wgmma")
    assert torch.equal(got[0, 1:3], torch.full((2,), float(k * 127 * 127), device=cuda_device))
    assert torch.equal(got, ts8.s8_matmul_plain(xq, wq, sx, sw, out_dtype=torch.float32))


@pytest.mark.cuda
def test_s8_layouts_pick_their_design(cuda_device):
    """The main path's operands take the wgmma design; K = 36 and a
    row-major [K, N] weight take PR 2's mma.sync design, still bitwise."""
    cases = [((4096, 1280, 1280), True, "wgmma"), ((17, 36, 9), True, "mma"),
             ((33, 96, 40), False, "mma")]
    for (m, k, n), weight_nk, want in cases:
        xq, wq, sx, sw = _s8_operands(cuda_device, m, k, n, weight_nk=weight_nk)
        before = ts8.LAUNCH_VARIANTS["s8_matmul"][want]
        got = ts8.s8_matmul(xq, wq, sx, sw, out_dtype=torch.bfloat16)
        assert ts8.LAUNCH_VARIANTS["s8_matmul"][want] == before + 1
        assert torch.equal(got, ts8.s8_matmul_plain(xq, wq, sx, sw, out_dtype=torch.bfloat16))
    xq, wq, sx, sw = _s8_operands(cuda_device, 17, 36, 9)
    with pytest.raises(ValueError, match="cannot take this layout"):
        ts8._s8_cuda(xq, wq, sx, sw, torch.bfloat16, "wgmma")


@pytest.mark.cuda
def test_s8_kernel_refuses_what_it_cannot_take(cuda_device):
    xq, wq, sx, sw = _s8_operands(cuda_device, 8, 32, 8)
    with pytest.raises(ValueError, match="out dtype"):
        ts8.s8_matmul(xq, wq, sx, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="int8"):
        ts8.s8_matmul(xq.to(torch.int16), wq, sx, sw, out_dtype=torch.float32)
    big = torch.zeros((2, ts8.MAX_K + 1), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="overflow"):
        ts8.s8_matmul(big, big.t(), sx[:2], sx[:2], out_dtype=torch.float32)


def test_s8_on_cpu_takes_the_plain_version_and_counts_nothing():
    xq, wq, sx, sw = _s8_operands(torch.device("cpu"), 17, 36, 9)
    before = ts8.LAUNCHES["s8_matmul"]
    got = ts8.s8_matmul(xq, wq, sx, sw, out_dtype=torch.float32)
    assert ts8.LAUNCHES["s8_matmul"] == before
    exact = (xq.long() @ wq.long()).float() * (sx[:, None] * sw[None, :])
    assert torch.equal(got, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "frame_attention", "s8_matmul"])
def test_counter_reads_the_same_operations_on_both_routes(cuda_device, kernel):
    """utils.flops books one call of each kernel at the same operations
    whether the card launches it or the CPU takes the plain version, and
    books nothing else on either route."""
    from mvoc_tpu_torch.utils import flops

    g = torch.Generator().manual_seed(0)
    if kernel == "flash_attention":
        args = [torch.randn(2, 5, s, 64, generator=g).to(torch.bfloat16) for s in (300, 145, 145)]
        fn, sig = tattn.flash_attention, (2, 5, 300, 145, 64)
    elif kernel == "frame_attention":
        args = [torch.randn(2, 16, 77, 5 * 64, generator=g).to(torch.bfloat16)
                for _ in range(3)] + [5]
        fn, sig = tattn.frame_attention, ("natural", 2, 16, 77, 5, 64)
    else:
        args = [torch.randint(-127, 128, (300, 1280), generator=g, dtype=torch.int8),
                torch.randint(-127, 128, (320, 1280), generator=g, dtype=torch.int8).t(),
                torch.rand(300, generator=g) + 0.01, torch.rand(320, generator=g) + 0.01]
        fn, sig = ts8.s8_matmul, (300, 1280, 320)
    counts = {}
    for dev in ("cpu", cuda_device):
        on = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
        with flops.FlopCounter() as counter:
            fn(*on)
        counts[str(dev)] = counter.by_class()
        assert counter.library_total() == 0
    want = flops.with_total({kernel: flops.kernel_flops(kernel, sig)})
    assert counts["cpu"] == counts["cuda"] == want


# ---------------------------------------------------------------------------
# the fused norms (csrc/norm.cu) against their plain versions
# ---------------------------------------------------------------------------

NORM_FP32_REL = 2e-5
UNET_CHANNELS = (320, 640, 960, 1280, 1920, 2560)
LN_WIDTHS = (4, 320, 512, 640, 1024, 1280)


def _norm_tol(dtype, want):
    return (NORM_FP32_REL if dtype == torch.float32 else BF16_REL) * want.abs().max().item()


def _norm_affine(device, n, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return ((1 + 0.3 * torch.randn(n, generator=g, device=device)).to(dtype),
            (0.2 * torch.randn(n, generator=g, device=device)).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("five_d", [False, True])
@pytest.mark.parametrize("c", UNET_CHANNELS)
def test_group_norm_kernel_matches_plain(cuda_device, c, five_d, eps, silu, dtype):
    """Every UNet width with 32 groups, per-frame (4-D) and joint (5-D)
    statistics, over a ragged last tile (9 x 16 pixels a frame)."""
    from mvoc_tpu_torch.ops import norm

    shape = (2, 3, 9, 16, c) if five_d else (3, 9, 16, c)
    g = torch.Generator(device=cuda_device).manual_seed(c)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    w, b = _norm_affine(cuda_device, c, dtype, c + 1)
    launches, plain = norm.LAUNCHES["group_norm"], norm.PLAIN_CALLS["group_norm"]
    got = norm.group_norm(x, w, b, 32, eps, silu=silu)
    torch.cuda.synchronize()
    assert norm.LAUNCHES["group_norm"] == launches + 1
    assert norm.PLAIN_CALLS["group_norm"] == plain
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    want = norm.group_norm_plain(x, w, b, 32, eps, silu=silu).float()
    assert (got.float() - want).abs().max().item() <= _norm_tol(dtype, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("d", LN_WIDTHS)
def test_layer_norm_kernel_matches_plain(cuda_device, d, eps, dtype):
    from mvoc_tpu_torch.ops import norm

    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = (torch.randn(3, 301, d, generator=g, device=cuda_device) + 1).to(dtype)
    w, b = _norm_affine(cuda_device, d, dtype, d + 1)
    launches = norm.LAUNCHES["layer_norm"]
    got = norm.layer_norm(x, w, b, eps)
    torch.cuda.synchronize()
    assert norm.LAUNCHES["layer_norm"] == launches + 1
    want = norm.layer_norm_plain(x, w, b, eps).float()
    assert (got.float() - want).abs().max().item() <= _norm_tol(dtype, want)


def _norm64(x, w, b, groups, eps):
    """GroupNorm (groups) or LayerNorm (groups None) in float64, and the same
    with the one-pass fp32 variance E[x^2] - E[x]^2 the kernels must not use."""
    b_, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b_, -1, groups, c // groups) if groups else x.reshape(-1, 1, 1, c)
    dims = (1, 3)
    out = []
    for xs, one_pass in ((xg.double(), False), (xg.float(), True)):
        mean = xs.mean(dims, keepdim=True)
        var = ((xs * xs).mean(dims, keepdim=True) - mean * mean if one_pass
               else ((xs - mean) ** 2).mean(dims, keepdim=True))
        y = ((xs - mean) / torch.sqrt(var.clamp_min(0) + eps)).reshape(x.shape)
        out.append((y * w.to(xs.dtype) + b.to(xs.dtype)).double())
    return out


@pytest.mark.cuda
def test_norms_hold_a_mean_far_above_the_spread(cuda_device):
    """fp32 input with |mean| = 100 x std: the one-pass variance misses the
    fp32 tolerance against float64; the kernels' centred moments hold it."""
    from mvoc_tpu_torch.ops import norm

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 3, 45, 80, 320, generator=g, device=cuda_device) + 100
    w, b = _norm_affine(cuda_device, 320, torch.float32, 1)
    cases = [(x, norm.group_norm(x, w, b, 32, 1e-6), 32, 1e-6)]
    xs = x.reshape(6, 45, 80, 320)
    cases.append((xs, norm.group_norm(xs, w, b, 32, 1e-6), 32, 1e-6))
    rows = x.reshape(-1, 320)[:20000]
    cases.append((rows, norm.layer_norm(rows, w, b, 1e-5), None, 1e-5))
    for inp, got, groups, eps in cases:
        want, one_pass = _norm64(inp, w, b, groups, eps)
        tol = NORM_FP32_REL * want.abs().max().item()
        assert (got.double() - want).abs().max().item() <= tol
        assert (one_pass - want).abs().max().item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gn4", "gn5", "ln"])
def test_norms_repeat_bit_for_bit(cuda_device, kind):
    """Fixed-order reductions, no atomics: the same bits every run, at the
    720p level's widths (many tiles a sample)."""
    from mvoc_tpu_torch.ops import norm

    g = torch.Generator(device=cuda_device).manual_seed(1)
    if kind == "ln":
        x = torch.randn(16 * 1440, 320, generator=g, device=cuda_device).bfloat16()
        w, b = _norm_affine(cuda_device, 320, torch.bfloat16, 2)
        run = lambda: norm.layer_norm(x, w, b, 1e-5)  # noqa: E731
    else:
        shape = (2, 90, 160, 320) if kind == "gn4" else (1, 16, 90, 160, 320)
        x = torch.randn(shape, generator=g, device=cuda_device).bfloat16()
        w, b = _norm_affine(cuda_device, 320, torch.bfloat16, 2)
        run = lambda: norm.group_norm(x, w, b, 32, 1e-6, silu=True)  # noqa: E731
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pieces", [2, 4])
def test_group_norm_kernels_over_split_frames(cuda_device, pieces, dtype):
    """A 16-frame 5-D x at the 720p level's widths split along its frames
    as the ranks of a "seq" axis hold it: each piece's stats launch, the
    partials of every piece handed to each in rank order, its finalize and
    apply.  The pieces together are the whole video's GroupNorm (within the
    plain tolerance of the unsplit kernel), every piece gets the same
    coefficients bit for bit (a second replay equals the first), and each
    piece on its own statistics is far off."""
    from mvoc_tpu_torch.ops import norm

    g = torch.Generator(device=cuda_device).manual_seed(pieces)
    x = (torch.randn(1, 16, 45, 80, 320, generator=g, device=cuda_device) + 0.5).to(dtype)
    x[:, :8] += 2
    w, b = _norm_affine(cuda_device, 320, dtype, 3)
    xs = x.chunk(pieces, dim=1)
    parts = [None] * pieces

    def piece(r, replay):
        def gather(part):
            if not replay:
                parts[r] = part.clone()
                return torch.stack([part] * pieces)
            assert torch.equal(part, parts[r])
            return torch.stack(parts)
        return norm.group_norm(xs[r], w, b, 32, 1e-6, silu=True, gather=gather)

    plain = norm.PLAIN_CALLS["group_norm"]
    for r in range(pieces):
        piece(r, False)
    got = torch.cat([piece(r, True) for r in range(pieces)], dim=1)
    again = torch.cat([piece(r, True) for r in range(pieces)], dim=1)
    torch.cuda.synchronize()
    assert norm.PLAIN_CALLS["group_norm"] == plain
    assert torch.equal(got, again)
    want = norm.group_norm(x, w, b, 32, 1e-6, silu=True).float()
    tol = _norm_tol(dtype, want)
    assert (got.float() - want).abs().max().item() <= tol
    local = torch.cat([norm.group_norm(t, w, b, 32, 1e-6, silu=True) for t in xs], dim=1)
    assert (local.float() - want).abs().max().item() > 10 * tol


@pytest.mark.cuda
def test_norms_refuse_on_cuda(cuda_device):
    from mvoc_tpu_torch.ops import norm

    x = torch.zeros(2, 4, 4, 64, device=cuda_device)
    w, b = torch.ones(64, device=cuda_device), torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        norm.group_norm(x.transpose(1, 2), w, b, 32, 1e-5)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        norm.group_norm(x.half(), w, b, 32, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        norm.layer_norm(x[:, :3], w, b, 1e-5)
