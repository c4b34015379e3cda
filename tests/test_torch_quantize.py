"""The int8 (w8a8) path of mvoc_tpu_torch against the JAX package on the CPU:
the quantizers, K3's plain version, int8_matmul / int8_tconv_stack3 /
int8_conv, the QuantConv dispatch, the layer selection at the full
I2VGen-XL geometry, and the bridge for int8 weights.

The JAX package runs its int8 code jitted (enable_int8 jits quantize_params;
the activation quantizers run inside the jitted UNet).  Inside jit XLA turns
`amax / 127` into a multiply by the fp32 reciprocal, which differs from the
division in the last bit of some scales; the port computes what the jitted
code computes, so the JAX side here is jitted too, and the quantizers agree
bit for bit.  The integer products are exact on both sides, so the GEMM and
the convolutions agree to rounding (REL), on identical int8 inputs.

The JAX selection at the full geometry and the JAX-quantized tiny kernels
come from tests/data/torch_parity_goldens.npz (a jax.eval_shape of the full
UNet and a jitted quantize_params of the tiny tree cost ~11 s and ~7 s here).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvoc_tpu.ops import quantize as JQ
from mvoc_tpu.ops import s8gemm as JS8
from mvoc_tpu_torch.models import convert, layers
from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
from mvoc_tpu_torch.ops import quantize as TQ
from mvoc_tpu_torch.ops import s8gemm as TS8
from mvoc_tpu_torch.utils import testing as tt
from torch_support import load_goldens, nest
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

REL = 1e-6  # max |port - JAX| <= REL * max |JAX| where only roundings differ


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_qt(qt) -> TQ.QuantizedTensor:
    return TQ.QuantizedTensor(torch.from_numpy(np.array(qt.data)),
                              torch.from_numpy(np.array(qt.scale)))


def _jit_quantize(w, axes):
    return jax.jit(lambda w: JQ.quantize_tensor(w, axes))(jnp.asarray(w))


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


# ---------------------------------------------------------------------------
# quantizers: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 48), (3, 3, 16, 32), (3, 1, 1, 40, 24)],
                         ids=["dense", "hwio", "dhwio"])
def test_quantize_tensor_bitwise(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    w[..., 5] = 0.0  # a zero output channel: scale 1, data 0
    axes = (len(shape) - 1,)
    want = _jit_quantize(w, axes)
    got = TQ.quantize_tensor(torch.from_numpy(w), axes)
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[..., 5].item() == 1.0 and not got.data[..., 5].any()


def _activation():
    """[4, 6, 40]: row (0, 0) and sample 3 all zero; sample 1 has max|x| =
    127 (scale exactly 1.0) and exact .5 ties in every row."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 6, 40)).astype(np.float32) * 3
    x[0, 0] = 0.0
    x[3] = 0.0
    x[1, :, 0] = 127.0
    x[1, :, 1:6] = [2.5, -3.5, 0.5, -0.5, 126.5]
    return x


@pytest.mark.parametrize("axes", [(2,), (1, 2)], ids=["rows", "per_sample"])
def test_quantize_activation_bitwise(axes):
    x = _activation()
    want_q, want_s = jax.jit(lambda x: JQ._quantize_activation(x, axes))(jnp.asarray(x))
    got_q, got_s = TQ._quantize_activation(torch.from_numpy(x), axes)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # half to even on the ties, 0 for the zero rows
    np.testing.assert_array_equal(got_q.numpy()[1, 0, :6], [127, 2, -4, 0, 0, 126])
    assert not got_q.numpy()[3].any()


def test_quantize_activation_of_bf16_matches():
    x = torch.from_numpy(_activation()).bfloat16()
    want_q, want_s = jax.jit(lambda x: JQ._quantize_activation(x, (2,)))(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    got_q, got_s = TQ._quantize_activation(x, (2,))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# K3's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,blocks", [
    (32, 64, 48, dict(bm=16, bn=16, bk=16)),
    (17, 33, 9, dict(bm=16, bn=16, bk=16)),
    (8, 16, 8, dict()),
])
def test_s8_matmul_plain_equals_pallas(monkeypatch, m, k, n, blocks, out_dtype):
    monkeypatch.setenv("MVOC_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(0)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = rng.uniform(0.01, 0.1, (m,)).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, (n,)).astype(np.float32)
    want = JS8.s8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx), jnp.asarray(sw),
                         out_dtype=getattr(jnp, out_dtype), **blocks)
    got = TS8.s8_matmul(*(torch.from_numpy(a) for a in (xq, wq, sx, sw)),
                        out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_s8_matmul_takes_the_strided_weight_view_and_column_scales():
    """The [K, N] view of [N, K] storage, [M, 1] / [1, N] scales."""
    rng = np.random.default_rng(2)
    xq = torch.from_numpy(rng.integers(-127, 128, (20, 36)).astype(np.int8))
    w_nk = torch.from_numpy(rng.integers(-127, 128, (12, 36)).astype(np.int8))
    sx = torch.from_numpy(rng.uniform(0.01, 0.1, (20, 1)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(0.01, 0.1, (1, 12)).astype(np.float32))
    got = TS8.s8_matmul(xq, w_nk.t(), sx, sw, out_dtype=torch.float32)
    want = TS8.s8_matmul(xq, w_nk.t().contiguous(), sx.reshape(-1), sw.reshape(-1),
                         out_dtype=torch.float32)
    assert torch.equal(got, want)
    exact = (xq.long() @ w_nk.t().long()).float() * (sx * sw)
    assert torch.equal(got, exact)


# ---------------------------------------------------------------------------
# int8 matmul / stacked temporal conv / im2col conv against JAX
# ---------------------------------------------------------------------------


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return w, b


def test_int8_matmul_matches_jax():
    x = np.random.default_rng(3).standard_normal((3, 8, 40)).astype(np.float32)
    jqt = _jit_quantize(_weights((40, 24), 4)[0], (1,))
    want = jax.jit(functools.partial(JQ.int8_matmul, out_dtype=jnp.float32))(jnp.asarray(x), jqt)
    got = TQ.int8_matmul(torch.from_numpy(x), _port_qt(jqt), out_dtype=torch.float32)
    assert _rel_err(got, want) <= REL


def test_int8_tconv_stack3_matches_jax():
    x5 = np.random.default_rng(5).standard_normal((2, 4, 3, 3, 16)).astype(np.float32)
    jqt = _jit_quantize(_weights((3, 1, 1, 16, 12), 6)[0], (4,))
    want = jax.jit(functools.partial(JQ.int8_tconv_stack3, out_dtype=jnp.float32))(
        jnp.asarray(x5), jqt)
    got = TQ.int8_tconv_stack3(torch.from_numpy(x5), _port_qt(jqt), out_dtype=torch.float32)
    assert _rel_err(got, want) <= REL


INT8_CONVS = {
    # name: (input shape, kernel shape, strides, padding)
    "3x3_s1": ((2, 8, 8, 16), (3, 3, 16, 12), (1, 1), ((1, 1), (1, 1))),
    "3x3_s2_odd": ((2, 9, 9, 8), (3, 3, 8, 16), (2, 2), ((1, 1), (1, 1))),
    "3x3_k36": ((1, 8, 8, 4), (3, 3, 4, 32), (1, 1), ((1, 1), (1, 1))),
    "1x1": ((2, 5, 5, 12), (1, 1, 12, 8), (1, 1), ((0, 0), (0, 0))),
    "311_8192_rows": ((2, 16, 16, 16, 4), (3, 1, 1, 4, 8), (1, 1, 1), ((1, 1), (0, 0), (0, 0))),
}


@pytest.mark.parametrize("name", sorted(INT8_CONVS))
def test_int8_conv_matches_jax(name):
    xshape, kshape, strides, padding = INT8_CONVS[name]
    x = np.random.default_rng(7).standard_normal(xshape).astype(np.float32)
    jqt = _jit_quantize(_weights(kshape, 8)[0], (len(kshape) - 1,))
    fn = functools.partial(JQ.int8_conv, strides=strides, padding=padding, out_dtype=jnp.float32)
    want = jax.jit(fn)(jnp.asarray(x), jqt)
    got = TQ.int8_conv(torch.from_numpy(x), _port_qt(jqt), strides=strides, padding=padding,
                       out_dtype=torch.float32)
    assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("xshape,stack3", [
    ((1, 16, 16, 16, 8), True),    # 4096 rows: the stacked GEMM
    ((2, 16, 16, 16, 8), False),   # 8192 rows: int8_conv
    ((1, 16, 2, 2, 8), True),
    ((1, 17, 2, 2, 8), False),     # 17 frames: int8_conv
], ids=["4096_rows", "8192_rows", "16_frames", "17_frames"])
def test_quantconv_dispatch_matches_jax(monkeypatch, xshape, stack3):
    """The port's QuantConv takes the form JAX's QuantConv takes on each side
    of the 4096-row and 16-frame limits: the two forms differ by int8 noise
    (per-row vs per-sample scales), far beyond REL."""
    monkeypatch.delenv("MVOC_TCONV_ROWS", raising=False)
    x = np.random.default_rng(9).standard_normal(xshape).astype(np.float32)
    w, b = _weights((3, 1, 1, 8, 8), 10)
    jqt = _jit_quantize(w, (4,))
    jconv = JQ.QuantConv(8, (3, 1, 1), padding=((1, 1), (0, 0), (0, 0)), dtype=jnp.float32)
    want = jax.jit(jconv.apply)({"params": {"kernel": jqt, "bias": jnp.asarray(b)}},
                                jnp.asarray(x))
    conv = layers.Conv3d(8, 8, (3, 1, 1), padding=(1, 0, 0))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2)))
        conv.bias.copy_(torch.from_numpy(b))
    qconv = TQ.QuantConv(conv)
    with torch.no_grad():
        got = qconv(torch.from_numpy(x))
    assert _rel_err(got, want) <= REL
    other_form = TQ.int8_conv if stack3 else TQ.int8_tconv_stack3
    kw = dict(strides=(1, 1, 1), padding=((1, 1), (0, 0), (0, 0))) if stack3 else {}
    other = other_form(torch.from_numpy(x), qconv.kernel(), out_dtype=torch.float32, **kw)
    assert _rel_err(other + torch.from_numpy(b), want) > 100 * REL


# ---------------------------------------------------------------------------
# selection, modules, weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["default", "mixed"])
def test_selection_at_full_geometry_matches_jax(goldens, mode):
    pred = TQ.default_unet_predicate if mode == "default" else TQ.mixed_unet_predicate
    with torch.device("meta"):
        unet = I2VGenXLUNet(UNetConfig())
    got = TQ.quantize_unet_(unet, pred)
    want = {convert.module_key(p.split("/")) for p in goldens[f"int8/selection/{mode}"]}
    assert len(got) == len(set(got)) and set(got) == want
    n_quant = sum(isinstance(m, (TQ.QuantLinear, TQ.QuantConv)) for m in unet.modules())
    assert n_quant == len(want)


def _tiny_unet(goldens):
    tu = I2VGenXLUNet(UNetConfig.tiny())
    tu.load_state_dict(convert.unet_state_dict_from_flax(nest(goldens, "params")), strict=True)
    return tu


def test_weight_bridge_carries_jax_int8_kernels_bitwise(goldens):
    """JAX's quantize_params on the tiny tree, carried across as (data, scale)
    pairs by convert.load_unet_from_flax, is bitwise the port's own
    quantization of the carried float weights."""
    tree = nest(goldens, "params")
    qtree = nest(goldens, "int8/params")
    n = 0

    def merge(node, qnode):
        nonlocal n
        for k, v in qnode.items():
            if set(v) == {"data", "scale"}:
                node[k] = (v["data"], v["scale"])
                n += 1
            else:
                merge(node[k], v)

    merge(tree, qtree)
    carried = convert.load_unet_from_flax(I2VGenXLUNet(UNetConfig.tiny()), tree)
    own = _tiny_unet(goldens)
    names = TQ.quantize_unet_(own, TQ.default_unet_predicate)
    assert n == len(names) > 0
    got, want = carried.state_dict(), own.state_dict()
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype and torch.equal(got[key], val), key


def test_quant_modules_keep_fp32_scales_through_dtype_moves():
    lin = torch.nn.Linear(16, 8)
    q = TQ.QuantLinear(lin.weight, lin.bias)
    scale = q.weight_scale.clone()
    q.to(torch.bfloat16)
    assert q.weight.dtype == torch.int8 and q.bias.dtype == torch.bfloat16
    assert q.weight_scale.dtype == torch.float32 and torch.equal(q.weight_scale, scale)
    x = torch.randn(3, 16).bfloat16()
    assert q(x).dtype == torch.bfloat16


def test_enable_int8_modes():
    pipe = tt.build_tiny_pipeline(device="cpu")
    with pytest.raises(ValueError, match="mode"):
        pipe.enable_int8(mode="half")
    assert pipe.enable_int8(mode="mixed") is pipe  # nothing is K >= 1280 at tiny widths
    assert not any(isinstance(m, (TQ.QuantLinear, TQ.QuantConv)) for m in pipe.unet.modules())
    pipe.enable_int8(mode="full")
    quant = [m for m in pipe.unet.modules() if isinstance(m, (TQ.QuantLinear, TQ.QuantConv))]
    assert quant and pipe.unet.conv_in.weight.dtype == torch.float32
    assert all(not isinstance(m, (TQ.QuantLinear, TQ.QuantConv)) for m in pipe.vae.modules())
    assert pipe.unet.dtype == torch.float32


def _s8_layout(m, k, n, weight_nk=True, x_offset=0, x_pitch=None):
    """int8 operands on the CPU in a given layout: x with a row pitch and a
    byte offset into its storage, w as [N, K] storage viewed [K, N] or as a
    row-major [K, N]."""
    pitch = x_pitch or k
    xs = torch.zeros(m * pitch + x_offset + 16, dtype=torch.int8)
    xq = xs[x_offset:x_offset + m * pitch].view(m, pitch)[:, :k]
    wq = torch.zeros((n, k), dtype=torch.int8).t() if weight_nk else torch.zeros(
        (k, n), dtype=torch.int8)
    return xq, wq


@pytest.mark.parametrize("layout,want", [
    (dict(m=4096, k=1280, n=1280), "wgmma"),                 # the main path
    (dict(m=1, k=23040, n=320), "wgmma"),                    # one row, deepest K
    (dict(m=17, k=36, n=9), "mma"),                          # K = 36: 36-byte rows
    (dict(m=33, k=96, n=40, weight_nk=False), "mma"),        # row-major weight: N-contiguous
    (dict(m=64, k=128, n=64, x_pitch=144), "wgmma"),         # padded rows, 144 bytes
    (dict(m=64, k=128, n=64, x_pitch=132), "mma"),           # 132-byte rows
    (dict(m=64, k=128, n=64, x_offset=8), "mma"),            # base off 16 bytes
])
def test_s8_variant_follows_the_layout(layout, want):
    """K3's design on the card is a function of the operands' layout alone:
    TMA (wgmma) where both are K-contiguous with 16-byte rows and bases,
    PR 2's mma.sync kernel elsewhere."""
    xq, wq = _s8_layout(**layout)
    if layout.get("x_offset", 0) == 0:
        assert xq.data_ptr() % 16 == 0
    assert TS8.s8_variant(xq, wq, torch.bfloat16) == want
    assert want in TS8.S8_VARIANTS


@pytest.mark.parametrize("xshape,wshape,dtype,out_dtype,match", [
    ((8, 32), (32, 8), torch.int16, torch.float32, "int8"),
    ((8, 32), (32, 8), torch.int8, torch.float16, "out dtype"),
    ((8, 32), (16, 8), torch.int8, torch.float32, "do not chain"),
    ((2, TS8.MAX_K + 1), (TS8.MAX_K + 1, 2), torch.int8, torch.float32, "overflow"),
    ((0, 32), (32, 8), torch.int8, torch.float32, "empty"),
])
def test_s8_variant_refuses_what_no_design_takes(xshape, wshape, dtype, out_dtype, match):
    xq = torch.zeros(xshape, dtype=dtype)
    wq = torch.zeros(wshape, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        TS8.s8_variant(xq, wq, out_dtype)


def test_s8_on_cpu_counts_no_launch_of_any_design():
    xq, wq = _s8_layout(64, 128, 64)
    TS8.reset_launch_counts()
    TS8.s8_matmul(xq, wq, torch.ones(64), torch.ones(64), out_dtype=torch.float32)
    assert TS8.LAUNCHES["s8_matmul"] == 0 and not TS8.LAUNCH_VARIANTS["s8_matmul"]
