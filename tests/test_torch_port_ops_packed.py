"""The packed (one-matrix) forms of the channelwise TP, its invariants and
its mix (``uniform_tp_packed``, ``packed_scalar_part``,
``tp_mix_apply_packed``) and ``masked_mean`` of the PyTorch port against
the JAX package's at f64 (``pair_allegro_tpu/ops/tp.py:189, 210, 278``,
``ops/scatter.py:166``); no model path calls them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.ops.scatter as j_sc
import pair_allegro_tpu.ops.tp as j_tp
import pair_allegro_tpu_torch.ops.scatter as t_sc
import pair_allegro_tpu_torch.ops.tp as t_tp

torch.set_num_threads(2)
TOL = dict(atol=1e-12, rtol=1e-12)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _case(lmax, parity, seed, c=5, batch=(7,), per_channel_y=True):
    rng = np.random.RandomState(seed)
    d = (lmax + 1) ** 2
    x = rng.randn(*batch, c, d)
    y = rng.randn(*batch, c, d) if per_channel_y else rng.randn(*batch, d)
    P = j_tp.num_paths_per_l(lmax, lmax, lmax, parity)
    ws = {f"l{l3}": rng.randn(c * P[l3], 3) for l3 in range(lmax + 1)}
    return x, y, ws


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("lmax", [1, 2])
@pytest.mark.parametrize("per_channel_y", [True, False])
def test_uniform_tp_packed(lmax, parity, per_channel_y):
    x, y, _ = _case(lmax, parity, 10 * lmax + parity, per_channel_y=per_channel_y)
    got = t_tp.uniform_tp_packed(_t(x), _t(y), lmax, parity)
    want = j_tp.uniform_tp_packed(jnp.asarray(x), jnp.asarray(y), lmax, parity)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same numbers as the per-path TP, stacked in the packed layout
    per = t_tp.uniform_tp(_t(x), _t(y), lmax, parity)
    flat = torch.cat([t.reshape(*t.shape[:-2], -1) for t in per if t is not None], dim=-1)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), **TOL)


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("lmax", [1, 2])
def test_packed_scalar_part_and_mix(lmax, parity):
    x, y, ws = _case(lmax, parity, 20 + 10 * lmax + parity, batch=(3, 4))
    T = j_tp.uniform_tp_packed(jnp.asarray(x), jnp.asarray(y), lmax, parity)
    inv = t_tp.packed_scalar_part(_t(T), lmax, lmax, lmax, parity)
    np.testing.assert_allclose(inv.numpy(),
                               np.asarray(j_tp.packed_scalar_part(T, lmax, lmax, lmax, parity)),
                               **TOL)
    mixed = t_tp.tp_mix_apply_packed({k: _t(v) for k, v in ws.items()}, _t(T), lmax, lmax, lmax,
                                     parity)
    want = j_tp.tp_mix_apply_packed({k: jnp.asarray(v) for k, v in ws.items()}, T, lmax, lmax,
                                    lmax, parity)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(want), **TOL)
    # against the unpacked forms
    per = t_tp.uniform_tp(_t(x), _t(y), lmax, parity)
    np.testing.assert_allclose(inv.numpy(), t_tp.scalar_part(per).numpy(), **TOL)
    np.testing.assert_allclose(mixed.numpy(),
                               t_tp.tp_mix_apply({k: _t(v) for k, v in ws.items()}, per).numpy(),
                               **TOL)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_masked_mean(axis):
    rng = np.random.RandomState(3)
    x = rng.randn(6, 5)
    mask = rng.rand(6, 5) > 0.4
    mask[2] = False  # a row with nothing to average: eps keeps it finite
    got = t_sc.masked_mean(_t(x), torch.as_tensor(mask), axis=axis)
    want = j_sc.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=axis)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
