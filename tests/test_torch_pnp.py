"""mvoc_tpu_torch.pnp: the injection semantics tests/test_pnp.py pins, and
parity of every injection / capture / consume function with the JAX
package on the same tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvoc_tpu import pnp as jp
from mvoc_tpu_torch import pnp as tp
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)


N, F, H, W, C = 2, 3, 4, 4, 5
ATOL = 1e-6


def _masks(seed):
    r = np.random.default_rng(seed)
    binary = (r.random((N, F, H, W)) > 0.5).astype(np.float32)
    soft = r.random((N, F, H, W)).astype(np.float32)
    return binary, soft


def _states(inject_background=True, gates=(True, True, True)):
    binary, soft = _masks(0)
    res = (H, W)
    js = jp.PnPState(masks={res: jnp.asarray(binary)}, masks_soft={res: jnp.asarray(soft)},
                     gate_spatial=jnp.asarray(gates[0]), gate_temporal=jnp.asarray(gates[1]),
                     gate_conv=jnp.asarray(gates[2]), inject_background=inject_background)
    ts = tp.PnPState(masks={res: torch.from_numpy(binary)}, masks_soft={res: torch.from_numpy(soft)},
                     gate_spatial=gates[0], gate_temporal=gates[1], gate_conv=gates[2],
                     inject_background=inject_background)
    return js, ts


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j):
    if isinstance(t, tuple):
        for a, b in zip(t, j):
            _close(a, b)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


# -- semantics ----------------------------------------------------------------


def test_later_object_wins_and_only_edit_chunks_change():
    B = N + 3
    x = np.stack([np.full((F, H * W, C), float(i), np.float32) for i in range(B)])
    x = x.reshape(B * F, H * W, C)
    ones = torch.ones(N, F, H, W)
    ts = tp.PnPState(masks={(H, W): ones}, gate_spatial=True, gate_temporal=True, gate_conv=True)
    q, k = tp.inject_spatial_qk(torch.from_numpy(x), torch.from_numpy(x), ts, H, W)
    qb = q.reshape(B, F, H * W, C)
    assert torch.equal(qb[: N + 1], torch.from_numpy(x).reshape(B, F, H * W, C)[: N + 1])
    assert (qb[N + 1:] == float(N)).all()  # object N (the last) wins everywhere
    assert torch.equal(q, k)


def test_base_is_bg_or_cond_chunk():
    B = N + 3
    x = torch.arange(B, dtype=torch.float32).repeat_interleave(F)[:, None, None].expand(
        B * F, H * W, C).contiguous()
    zeros = torch.zeros(N, F, H, W)
    for inject_background, base in ((True, 0.0), (False, float(B - 1))):
        ts = tp.PnPState(masks={(H, W): zeros}, gate_spatial=True, gate_temporal=True,
                         gate_conv=True, inject_background=inject_background)
        q, _ = tp.inject_spatial_qk(x, x, ts, H, W)
        assert (q.reshape(B, F, H * W, C)[N + 1:] == base).all()
        # conv sites always take the bg base
        y = tp.inject_conv_features(x.reshape(B * F, H, W, C), ts, H, W)
        assert (y.reshape(B, F, H, W, C)[N + 1:] == 0.0).all()


def test_temporal_sites_take_soft_masks_spatial_binary():
    _, ts = _states()
    x = _x(1, (N + 3) * F, H * W, C)
    soft_only = tp.PnPState(masks=ts.masks, masks_soft=ts.masks_soft, gate_spatial=True,
                            gate_temporal=True, gate_conv=True)
    q_sp, _ = tp.inject_spatial_qk(torch.from_numpy(x), torch.from_numpy(x), soft_only, H, W)
    q_soft, _ = tp.inject_spatial_qk(torch.from_numpy(x), torch.from_numpy(x), soft_only, H, W,
                                     soft=True)
    assert not torch.allclose(q_sp, q_soft)
    assert torch.equal(ts.mask_at(H, W, soft=True), torch.from_numpy(_masks(0)[1]))


def test_gates_off_is_identity():
    _, ts = _states(gates=(False, False, False))
    x = torch.from_numpy(_x(2, (N + 3) * F, H * W, C))
    assert tp.inject_spatial_qk(x, x, ts, H, W)[0] is x
    xt = torch.from_numpy(_x(3, (N + 3) * H * W, F, C))
    assert tp.inject_temporal_qk(xt, xt, ts, H, W)[0] is xt
    xc = torch.from_numpy(_x(4, (N + 3) * F, H, W, C))
    assert tp.inject_conv_features(xc, ts, H, W) is xc


def test_injection_gates_match_jax_including_t1000():
    full = np.array([1000, 981, 961, 941, 921])
    run = full[1:]
    want = jp.injection_gates(full, run, 5, 0.4, 0.8, 0.2)
    got = tp.injection_gates(full, run, 5, 0.4, 0.8, 0.2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    got = tp.injection_gates(full, full, 5, 0.0, 0.0, 0.0)
    assert got["conv"].tolist() == [True, False, False, False, False]


def test_mask_pyramid_matches_jax():
    binary, _ = _masks(5)
    res = [(4, 4), (2, 2), (3, 2)]
    want = jp.build_mask_pyramid(binary, res)
    got = tp.build_mask_pyramid(binary, res)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- parity with the JAX package -----------------------------------------------


@pytest.mark.parametrize("inject_background", [True, False])
def test_fused_injection_matches_jax(inject_background):
    js, ts = _states(inject_background)
    q, k = _x(10, (N + 3) * F, H * W, C), _x(11, (N + 3) * F, H * W, C)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    _close(tp.inject_spatial_qk(tq, tk, ts, H, W), jp.inject_spatial_qk(q, k, js, H, W))
    _close(tp.inject_spatial_qk(tq, tk, ts, H, W, soft=True, gate=True),
           jp.inject_spatial_qk(q, k, js, H, W, soft=True, gate=jnp.asarray(True)))
    qt, kt = _x(12, (N + 3) * H * W, F, C), _x(13, (N + 3) * H * W, F, C)
    _close(tp.inject_temporal_qk(torch.from_numpy(qt), torch.from_numpy(kt), ts, H, W),
           jp.inject_temporal_qk(qt, kt, js, H, W))
    xc = _x(14, (N + 3) * F, H, W, C)
    _close(tp.inject_conv_features(torch.from_numpy(xc), ts, H, W),
           jp.inject_conv_features(xc, js, H, W))


@pytest.mark.parametrize("inject_background", [True, False])
def test_precomposite_and_consume_match_jax(inject_background):
    js, ts = _states(inject_background)
    sq, sk = _x(20, (N + 1) * F, H * W, C), _x(21, (N + 1) * F, H * W, C)
    s_t = tp.precomposite_spatial(torch.from_numpy(sq), torch.from_numpy(sk), ts, H, W, soft=True)
    s_j = jp.precomposite_spatial(sq, sk, js, H, W, soft=True)
    _close(s_t, s_j)
    eq, ek = _x(22, 2 * F, H * W, C), _x(23, 2 * F, H * W, C)
    _close(tp.consume_spatial_precomposited(torch.from_numpy(eq), torch.from_numpy(ek), *s_t,
                                            ts, H, W, soft=True),
           jp.consume_spatial_precomposited(eq, ek, *s_j, js, H, W, soft=True))
    tq, tk = _x(24, (N + 1) * H * W, F, C), _x(25, (N + 1) * H * W, F, C)
    st_t = tp.precomposite_temporal(torch.from_numpy(tq), torch.from_numpy(tk), ts, H, W)
    st_j = jp.precomposite_temporal(tq, tk, js, H, W)
    _close(st_t, st_j)
    etq, etk = _x(26, 2 * H * W, F, C), _x(27, 2 * H * W, F, C)
    _close(tp.consume_temporal_precomposited(torch.from_numpy(etq), torch.from_numpy(etk),
                                             *st_t, ts, H, W),
           jp.consume_temporal_precomposited(etq, etk, *st_j, js, H, W))
    xc = _x(28, (N + 1) * F, H, W, C)
    sc_t = tp.precomposite_conv(torch.from_numpy(xc), ts, H, W)
    sc_j = jp.precomposite_conv(xc, js, H, W)
    _close(sc_t, sc_j)
    ec = _x(29, 2 * F, H, W, C)
    _close(tp.consume_conv_precomposited(torch.from_numpy(ec), sc_t, ts, H, W),
           jp.consume_conv_precomposited(ec, sc_j, js, H, W))


@pytest.mark.parametrize("inject_background", [True, False])
def test_stream_capture_terms_sum_to_precomposite(inject_background):
    js, ts = _states(inject_background)
    binary, soft = _masks(0)
    res = (H, W)
    cw_t = tp.build_capture_weights({res: torch.from_numpy(binary)},
                                    {res: torch.from_numpy(soft)}, inject_background)
    cw_j = jp.build_capture_weights({res: jnp.asarray(binary)}, {res: jnp.asarray(soft)},
                                    inject_background)
    for kind in cw_j:
        _close(cw_t[kind][res], cw_j[kind][res])
    sq = torch.from_numpy(_x(30, (N + 1) * F, H * W, C))
    xc = torch.from_numpy(_x(31, (N + 1) * F, H, W, C))
    tq = torch.from_numpy(_x(32, (N + 1) * H * W, F, C))
    acc = {"sp": 0, "nat": 0, "tm": 0, "conv": 0}
    for b in range(N + 1):
        st = tp.PnPState(masks=ts.masks, masks_soft=ts.masks_soft, gate_spatial=True,
                         gate_temporal=True, gate_conv=True, inject_background=inject_background,
                         capture_weight={k: {res: v[res][b]} for k, v in cw_t.items()})
        qb = sq.reshape(N + 1, F, H * W, C)[b]
        acc["sp"] = acc["sp"] + tp.stream_capture_spatial(qb, qb, st, H, W)[0]
        acc["nat"] = acc["nat"] + tp.stream_capture_temporal_natural(qb, qb, st, H, W)[0]
        tb = tq.reshape(N + 1, H * W, F, C)[b]
        acc["tm"] = acc["tm"] + tp.stream_capture_temporal(tb, tb, st, H, W)[0]
        acc["conv"] = acc["conv"] + tp.stream_capture_conv(
            xc.reshape(N + 1, F, H, W, C)[b], st, H, W)
    torch.testing.assert_close(acc["sp"], tp.precomposite_spatial(sq, sq, ts, H, W)[0])
    torch.testing.assert_close(acc["nat"], tp.precomposite_spatial(sq, sq, ts, H, W, soft=True)[0])
    torch.testing.assert_close(acc["tm"], tp.precomposite_temporal(tq, tq, ts, H, W)[0])
    torch.testing.assert_close(acc["conv"], tp.precomposite_conv(xc, ts, H, W))
