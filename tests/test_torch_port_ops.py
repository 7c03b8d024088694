"""Small ops of the PyTorch port against the JAX package at f64: spherical
harmonics, Wigner-3j blocks, the TP path and 3j-entry tables, the channelwise
TP and its mix, Bessel basis, polynomial cutoff, MLPs and cell algebra."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.ops.geometry as j_geom
import pair_allegro_tpu.ops.mlp as j_mlp
import pair_allegro_tpu.ops.pallas_tp as j_ptp
import pair_allegro_tpu.ops.radial as j_rad
import pair_allegro_tpu.ops.so3 as j_so3
import pair_allegro_tpu.ops.tp as j_tp
import pair_allegro_tpu_torch.ops.geometry as t_geom
import pair_allegro_tpu_torch.ops.mlp as t_mlp
import pair_allegro_tpu_torch.ops.radial as t_rad
import pair_allegro_tpu_torch.ops.so3 as t_so3
import pair_allegro_tpu_torch.ops.tp as t_tp

torch.set_num_threads(2)
TOL = dict(atol=1e-12, rtol=1e-12)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("lmax", [1, 2, 3])
def test_spherical_harmonics(lmax):
    rng = np.random.RandomState(lmax)
    v = rng.randn(64, 3)
    v[0] = 0.0  # a padded self-edge: r = 0 must stay finite
    np.testing.assert_allclose(t_so3.spherical_harmonics(_t(v), lmax).numpy(),
                               np.asarray(j_so3.spherical_harmonics(jnp.asarray(v), lmax)), **TOL)
    vt = _t(v).requires_grad_(True)
    (g,) = torch.autograd.grad(t_so3.spherical_harmonics(vt, lmax).sum(), vt)
    assert torch.isfinite(g).all()
    assert t_so3.sh_dim(lmax) == j_so3.sh_dim(lmax)
    assert t_so3.sh_slice(lmax) == j_so3.sh_slice(lmax)


def test_wigner_3j_blocks():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(5):
                np.testing.assert_allclose(t_so3.real_wigner_3j(l1, l2, l3),
                                           j_so3.real_wigner_3j(l1, l2, l3), **TOL)


@pytest.mark.parametrize("parity", [True, False])
def test_path_and_entry_tables(parity):
    assert t_tp.tp_paths(2, 2, 2, parity) == j_tp.tp_paths(2, 2, 2, parity)
    for l3 in range(3):
        assert t_tp.paths_to_l(2, 2, l3, parity) == j_tp.paths_to_l(2, 2, l3, parity)
    assert t_tp.num_paths_per_l(2, 2, 2, parity) == j_tp.num_paths_per_l(2, 2, 2, parity)
    a, b = t_tp._nonzeros(2, parity), j_ptp._nonzeros(2, parity)
    assert a.keys() == b.keys()
    for l3 in a:
        assert [e[:4] for e in a[l3]] == [e[:4] for e in b[l3]]
        np.testing.assert_allclose([e[4] for e in a[l3]], [e[4] for e in b[l3]], **TOL)
    if parity:  # l_max=2 with parity: 9 + 28 + 46 = 83 entries
        assert [len(a[l3]) for l3 in range(3)] == [9, 28, 46]


@pytest.mark.parametrize("parity", [True, False])
def test_uniform_tp_mix_and_scalar_part(parity):
    rng = np.random.RandomState(7)
    c, d = 4, 9
    x, y = rng.randn(5, c, d), rng.randn(5, c, d)
    P = j_tp.num_paths_per_l(2, 2, 2, parity)
    ws = {f"l{l3}": rng.randn(c * P[l3], c) for l3 in range(3)}
    Tj = j_tp.uniform_tp(jnp.asarray(x), jnp.asarray(y), 2, parity)
    Tt = t_tp.uniform_tp(_t(x), _t(y), 2, parity)
    for a, b in zip(Tt, Tj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(
        t_tp.tp_mix_apply({k: _t(v) for k, v in ws.items()}, Tt).numpy(),
        np.asarray(j_tp.tp_mix_apply({k: jnp.asarray(v) for k, v in ws.items()}, Tj)), **TOL)
    np.testing.assert_allclose(t_tp.scalar_part(Tt).numpy(), np.asarray(j_tp.scalar_part(Tj)),
                               **TOL)


def test_bessel_and_cutoff():
    r = np.concatenate([[0.0, 1e-9], np.linspace(0.1, 5.5, 50)])
    np.testing.assert_allclose(t_rad.bessel_basis(_t(r), 4.5, 8).numpy(),
                               np.asarray(j_rad.bessel_basis(jnp.asarray(r), 4.5, 8)), **TOL)
    for rc in (4.5, np.full(r.shape, 4.0)):
        np.testing.assert_allclose(
            t_rad.polynomial_cutoff(_t(r), rc if np.isscalar(rc) else _t(rc), 6).numpy(),
            np.asarray(j_rad.polynomial_cutoff(jnp.asarray(r), rc, 6)), **TOL)


def test_mlps():
    rng = np.random.RandomState(3)
    dims = j_mlp.mlp_dims(12, 16, 2, 8)
    assert t_mlp.mlp_dims(12, 16, 2, 8) == dims
    ws = [rng.randn(a, b) for a, b in zip(dims[:-1], dims[1:])]
    x = rng.randn(10, 12)
    want = np.asarray(j_mlp.mlp_apply({"w": [jnp.asarray(w) for w in ws]}, jnp.asarray(x)))
    tw = {"w": [_t(w) for w in ws]}
    np.testing.assert_allclose(t_mlp.mlp_apply(tw, _t(x)).numpy(), want, **TOL)
    np.testing.assert_allclose(t_mlp.mlp_apply_t(tw, _t(x.T)).numpy(), want.T, **TOL)
    assert t_mlp.silu_norm_const() == j_mlp.silu_norm_const()


def test_cell_algebra():
    cell = np.array([[5.0, 0.0, 0.0], [1.2, 4.5, 0.0], [0.7, -0.4, 6.1]])
    np.testing.assert_allclose(t_geom.inv3x3(_t(cell)).numpy(),
                               np.asarray(j_geom.inv3x3(jnp.asarray(cell))), **TOL)
    np.testing.assert_allclose(float(t_geom.volume(_t(cell))),
                               float(j_geom.volume(jnp.asarray(cell))), **TOL)
