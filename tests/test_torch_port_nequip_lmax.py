"""NequIP at l_max >= 3 in the port against the JAX package at f64 on the
CPU: l_max 3 (the channels-last entry-table message, held against JAX's
generic channels-first path, ``PAT_NEQUIP_GENERIC=1``) and l_max 4 (the
port's generic path against JAX's), one and two tracks, energy, per-atom
energy, forces, virial and the captured node features; the channels-last
paths against the port's own generic path (``tests/test_nequip_fused.py:146``);
the parity tracks under inversion (``tests/test_nequip.py:295``); the
routes (K3 refuses l_max >= 3) and the refusal of l_max 0.  Tolerance
1e-10 relative to the largest value (the JAX differential tests' 1e-10);
the inversion test 1e-12 absolute, as in JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.models.nequip import NequIPConfig as JaxConfig
from pair_allegro_tpu.models.nequip import nequip_energy as j_energy
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.neighbors.naive import neighbor_list_np
from pair_allegro_tpu.potential import make_potential as j_potential
from pair_allegro_tpu_torch.models.nequip import (
    NequIPConfig,
    conv_route,
    generic_path,
    nequip_energy,
    nequip_init_numpy,
    nequip_params_from_numpy,
)
from pair_allegro_tpu_torch.ops.nequip_conv import kernel_takes
from pair_allegro_tpu_torch.ops.tp import tp_num_paths
from pair_allegro_tpu_torch.potential import make_potential
from test_torch_port_nequip_conv import _table

torch.set_num_threads(2)


def _pair(lmax, parity, species=2, seed=0, **kw):
    fields = dict(r_max=3.0, l_max=lmax, num_layers=2, num_features=4, radial_mlp_width=8,
                  avg_num_neighbors=6.0, parity=parity,
                  type_names=("A", "B")[:species], remat=False)
    fields.update(kw)
    jcfg = JaxConfig(**fields)
    jp = nequip_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    jp["per_type_scale"] = jnp.linspace(0.8, 1.3, species)
    jp["per_type_shift"] = jnp.linspace(-0.2, 0.4, species)
    tcfg = NequIPConfig(**fields)
    tp = nequip_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                                  dtype=torch.float64)
    return jcfg, jp, tcfg, tp


def _close(a, b, name, tol=1e-10):
    b = np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(np.asarray(a) - b).max()) / scale
    assert err <= tol, f"{name}: relative error {err:.3e}"


def _inputs():
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    types = np.arange(len(pos)) % 2
    jargs = (jnp.asarray(types, jnp.int32), jnp.asarray(j_tab))
    jkw = dict(cell=jnp.asarray(cell), edge_shifts=jnp.asarray(s_tab),
               edge_mask=jnp.asarray(m_tab), edge_rev=jnp.asarray(rev))
    targs = (torch.tensor(types, dtype=torch.int64), torch.tensor(j_tab, dtype=torch.int64))
    tkw = dict(cell=torch.tensor(cell), edge_shifts=torch.tensor(s_tab),
               edge_mask=torch.tensor(m_tab), edge_rev=torch.tensor(rev, dtype=torch.int64))
    return pos, jargs, jkw, targs, tkw


def _port(tp, cfg, pos, targs, tkw):
    out = make_potential(lambda *a, **k: nequip_energy(tp, cfg, *a, **k))(
        torch.tensor(pos), *targs, **tkw)
    cap = {}
    with torch.no_grad():
        nequip_energy(tp, cfg, torch.tensor(pos), *targs, capture=cap, **tkw)
    return out, cap["node_features"]


@pytest.mark.parametrize("lmax", [3, 4])
@pytest.mark.parametrize("parity", [False, True])
def test_high_lmax_matches_jax(lmax, parity, monkeypatch):
    """The port's default path at l_max 3 (channels-last) and 4 (generic)
    against JAX's generic channels-first path, with and without remat."""
    pos, jargs, jkw, targs, tkw = _inputs()
    jcfg, jp, tcfg, tp = _pair(lmax, parity)
    monkeypatch.setenv("PAT_NEQUIP_GENERIC", "1")
    jo = jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))(
        jnp.asarray(pos), *jargs, **jkw)

    def captured(p):
        cap = {}
        j_energy(jp, jcfg, p, *jargs, capture=cap, **jkw)
        return cap["node_features"]

    j_nodes = np.asarray(jax.jit(captured)(jnp.asarray(pos)))
    monkeypatch.delenv("PAT_NEQUIP_GENERIC")
    assert generic_path(tcfg) == (lmax > 3)
    assert not conv_route(tcfg, False, card=False)
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        to, t_nodes = _port(tp, cfg, pos, targs, tkw)
        tag = f"l_max={lmax} parity={parity} remat={remat}"
        _close(float(to.total_energy), float(jo.total_energy), f"{tag} total_energy")
        _close(to.atomic_energy.numpy(), jo.atomic_energy, f"{tag} atomic_energy")
        _close(to.forces.numpy(), jo.forces, f"{tag} forces")
        _close(to.virial.numpy(), jo.virial, f"{tag} virial")
        assert t_nodes.shape == j_nodes.shape
        _close(t_nodes.numpy(), j_nodes, f"{tag} node_features")


@pytest.mark.parametrize("lmax", [2, 3])
@pytest.mark.parametrize("parity", [False, True])
def test_channels_last_paths_match_the_generic_path(lmax, parity, monkeypatch):
    """``tests/test_nequip_fused.py:146`` for the port: the channels-last
    message (plain, ``fused_conv=False``, and at l_max 2 K3's plain
    version) against the port's generic path (``PAT_NEQUIP_GENERIC=1``),
    energy and forces on the table with its reverse table."""
    pos, _, _, targs, tkw = _inputs()
    _, _, tcfg, tp = _pair(lmax, parity, seed=5)
    monkeypatch.setenv("PAT_NEQUIP_GENERIC", "1")
    assert generic_path(tcfg) and not conv_route(tcfg, False, card=False)
    ref, ref_nodes = _port(tp, tcfg, pos, targs, tkw)
    monkeypatch.delenv("PAT_NEQUIP_GENERIC")
    for fused in (False, True):
        cfg = dataclasses.replace(tcfg, fused_conv=fused)
        assert conv_route(cfg, False, card=False) == (fused and lmax == 2)
        out, nodes = _port(tp, cfg, pos, targs, tkw)
        _close(float(out.total_energy), float(ref.total_energy), "total_energy")
        _close(out.forces.numpy(), ref.forces.numpy(), "forces")
        _close(nodes.numpy(), ref_nodes.numpy(), "node_features")


@pytest.mark.parametrize("lmax", [1, 3, 4])
def test_parity_odd_channels_are_pseudotensors(lmax):
    """``tests/test_nequip.py:295`` for the port: under x -> -x the even
    track is invariant at every l and the odd track flips at every l (the
    pi XOR (l2 mod 2) routing), on the FLAT layout of a cluster; the odd
    track is alive."""
    rng = np.random.RandomState(4)
    pos = rng.randn(12, 3) * 2.5
    types = rng.randint(0, 2, 12)
    cfg = NequIPConfig(type_names=("A", "B"), r_max=3.0, l_max=lmax, num_layers=3,
                       num_features=8, avg_num_neighbors=4.0, parity=True)
    params = nequip_params_from_numpy(nequip_init_numpy(cfg, 3), cfg, device="cpu",
                                      dtype=torch.float64)

    def nodes(p):
        ei, sh = neighbor_list_np(p, None, (False,) * 3, cfg.r_max)
        cap = {}
        with torch.no_grad():
            nequip_energy(params, cfg, torch.tensor(p), torch.tensor(types),
                          torch.tensor(ei, dtype=torch.int64),
                          edge_shifts=torch.tensor(sh, dtype=torch.float64), capture=cap)
        return cap["node_features"].numpy()  # (N, C, D, 2)

    h0, h1 = nodes(pos), nodes(-pos)
    np.testing.assert_allclose(h1[..., 0], h0[..., 0], atol=1e-12)
    np.testing.assert_allclose(h1[..., 1], -h0[..., 1], atol=1e-12)
    assert np.max(np.abs(h0[..., 1])) > 1e-3


def test_routes_and_refusals(monkeypatch):
    """K3 takes l_max 1 and 2 only, so l_max 3 and 4 route to the plain
    message on the card too; l_max 0 stays refused (the reference fails
    there); remat=True runs."""
    for lmax in (3, 4):
        for T in (1, 2):
            dims = (8, 32, 32, T * tp_num_paths(lmax) * 8)
            assert not kernel_takes(8, T, lmax, dims)
        cfg = NequIPConfig(type_names=("A",), r_max=3.0, l_max=lmax, num_features=8)
        assert not conv_route(cfg, False, card=True)
    cfg = NequIPConfig(type_names=("A",), r_max=3.0, l_max=2, num_features=8)
    assert conv_route(cfg, False, card=True)
    monkeypatch.setenv("PAT_NEQUIP_GENERIC", "1")
    assert not conv_route(cfg, False, card=True)
    with pytest.raises(NotImplementedError, match="l_max=0"):
        nequip_params_from_numpy(nequip_init_numpy(dataclasses.replace(cfg, l_max=0)),
                                 dataclasses.replace(cfg, l_max=0), device="cpu")
    nequip_params_from_numpy(nequip_init_numpy(cfg), dataclasses.replace(cfg, remat=True),
                             device="cpu")
