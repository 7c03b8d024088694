"""The port's NequIP model, engine and NVE run against the JAX package at
f64: energy, per-atom energy, forces, virial and the captured node features
on a 40-atom neighbor table for l_max 1 and 2, one and two tracks, one and
two species, through the K3 path and the plain message path; a 500-atom
engine; ten NVE steps from the same numpy velocities; the engine's device
and locality refusals; the per-model device-memory estimate of a regrow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.engine import NequIPEngine as JaxEngine
from pair_allegro_tpu.md.integrate import Simulation as JaxSimulation
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxConfig
from pair_allegro_tpu.models.nequip import nequip_energy as j_energy
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.potential import make_potential as j_potential
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch.engine import NequIPEngine, _check_memory, regrow_bytes
from pair_allegro_tpu_torch.md.integrate import Simulation
from pair_allegro_tpu_torch.models.allegro import AllegroConfig
from pair_allegro_tpu_torch.models.nequip import (
    NequIPConfig,
    nequip_energy,
    nequip_init_numpy,
    nequip_params_from_numpy,
)
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import System, Units, fcc_lattice
from test_torch_port_nequip_conv import _table

torch.set_num_threads(2)

# (l_max, parity, species, JAX leg through its fused kernel in interpret mode)
CASES = [
    (1, False, 1, True), (1, False, 2, False), (1, True, 1, False), (1, True, 2, True),
    (2, False, 1, False), (2, False, 2, True), (2, True, 1, True), (2, True, 2, False),
]


def _kw(lmax, parity, species, **kw):
    # one layer at l_max=2 keeps the JAX side's f64 compile short; two
    # layers at l_max=1 carry messages over two hops
    base = dict(r_max=3.0, l_max=lmax, num_layers=3 - lmax, num_features=8,
                avg_num_neighbors=6.0, parity=parity)
    if species == 1:
        base["type_names"] = ("A",)
    else:
        base.update(type_names=("A", "B"), per_edge_type_cutoff=((3.0, 2.8), (2.8, 2.6)))
    base.update(kw)
    return base


def _params(kw, seed=0):
    jcfg = JaxConfig(remat=False, **kw)
    jp = nequip_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    nt = jcfg.num_types
    jp["per_type_scale"] = jnp.linspace(0.8, 1.3, nt)
    jp["per_type_shift"] = jnp.linspace(-0.2, 0.4, nt)
    tp = nequip_params_from_numpy(jax.tree.map(np.asarray, jp), NequIPConfig(**kw), device="cpu",
                                  dtype=torch.float64)
    return jcfg, jp, tp


def _close(a, b, name, tol=1e-10):
    b = np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(np.asarray(a) - b).max()) / scale
    assert err <= tol, f"{name}: relative error {err:.3e}"


@pytest.mark.parametrize("lmax,parity,species,jax_fused", CASES)
def test_model_matches_jax(lmax, parity, species, jax_fused, monkeypatch):
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    types = (np.arange(len(pos)) % 2) if species == 2 else np.zeros(len(pos), np.int64)
    kw = _kw(lmax, parity, species)
    jcfg, jp, tp = _params(kw)
    if jax_fused:
        monkeypatch.setenv("PAT_FORCE_NEQUIP_FUSED", "1")
    else:
        monkeypatch.delenv("PAT_FORCE_NEQUIP_FUSED", raising=False)
    jargs = (jnp.asarray(types, jnp.int32), jnp.asarray(j_tab))
    jkw = dict(cell=jnp.asarray(cell), edge_shifts=jnp.asarray(s_tab), edge_mask=jnp.asarray(m_tab),
               edge_rev=jnp.asarray(rev))
    pot = jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))
    jo = pot(jnp.asarray(pos), *jargs, **jkw)

    def captured(p):
        cap = {}
        j_energy(jp, jcfg, p, *jargs, capture=cap, **jkw)
        return cap["node_features"]

    j_nodes = np.asarray(jax.jit(captured)(jnp.asarray(pos)))

    targs = (torch.tensor(types, dtype=torch.int64), torch.tensor(j_tab, dtype=torch.int64))
    tkw = dict(cell=torch.tensor(cell), edge_shifts=torch.tensor(s_tab),
               edge_mask=torch.tensor(m_tab), edge_rev=torch.tensor(rev, dtype=torch.int64))
    for fused in (True, False):
        cfg = dataclasses.replace(NequIPConfig(**kw), fused_conv=fused)
        to = make_potential(lambda *a, **k: nequip_energy(tp, cfg, *a, **k))(
            torch.tensor(pos), *targs, **tkw)
        tag = f"fused_conv={fused}"
        _close(float(to.total_energy), float(jo.total_energy), f"{tag} total_energy")
        _close(to.atomic_energy.numpy(), jo.atomic_energy, f"{tag} atomic_energy")
        _close(to.forces.numpy(), jo.forces, f"{tag} forces")
        _close(to.virial.numpy(), jo.virial, f"{tag} virial")
        tcap = {}
        with torch.no_grad():
            nequip_energy(tp, cfg, torch.tensor(pos), *targs, capture=tcap, **tkw)
        assert tcap["node_features"].shape == j_nodes.shape
        _close(tcap["node_features"].numpy(), j_nodes, f"{tag} node_features")


@pytest.mark.parametrize("lmax,parity,species", [(1, True, 2), (2, False, 1)])
def test_weight_gradients_and_updates_match_jax(lmax, parity, species, monkeypatch):
    """f64.  The gradient of the energy with respect to every leaf of the
    JAX-layout tree (radial and gate weights included) equals JAX's on the
    plain (``for_training()``) path; on the K3 path the radial weights'
    gradients are NaN, as JAX's are, and every other leaf's equals the plain
    path's.  An in-place update of the radial and gate leaves moves the
    energy of both paths to JAX's energy for the updated tree."""
    monkeypatch.delenv("PAT_FORCE_NEQUIP_FUSED", raising=False)
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    types = (np.arange(len(pos)) % 2) if species == 2 else np.zeros(len(pos), np.int64)
    kw = _kw(lmax, parity, species)
    jcfg, jp, tp = _params(kw)
    jcfg = dataclasses.replace(jcfg, fused_conv=False)
    jargs = (jnp.asarray(pos), jnp.asarray(types, jnp.int32), jnp.asarray(j_tab))
    jkw = dict(cell=jnp.asarray(cell), edge_shifts=jnp.asarray(s_tab), edge_mask=jnp.asarray(m_tab),
               edge_rev=jnp.asarray(rev))
    j_total = jax.jit(lambda p: j_energy(p, jcfg, *jargs, **jkw)["total_energy"])
    jg = jax.tree_util.tree_leaves_with_path(jax.grad(j_total)(jp))
    targs = (torch.tensor(pos), torch.tensor(types, dtype=torch.int64),
             torch.tensor(j_tab, dtype=torch.int64))
    tkw = dict(cell=torch.tensor(cell), edge_shifts=torch.tensor(s_tab),
               edge_mask=torch.tensor(m_tab), edge_rev=torch.tensor(rev, dtype=torch.int64))
    named = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in named] == [jax.tree_util.keystr(p) for p, _ in jg]
    leaves = [t.requires_grad_(True) for _, t in named]
    cfgs = {f: dataclasses.replace(NequIPConfig(**kw), fused_conv=f) for f in (False, True)}

    def total(fused):
        return nequip_energy(tp, cfgs[fused], *targs, **tkw)["total_energy"]

    plain = torch.autograd.grad(total(False), leaves)
    fused = torch.autograd.grad(total(True), leaves)
    for (path, _), (_, want), gp, gf in zip(named, jg, plain, fused):
        name = jax.tree_util.keystr(path)
        _close(gp.numpy(), want, f"plain d/d{name}")
        if "radial_mlp" in name:
            assert torch.isnan(gf).all(), name
        else:
            _close(gf.numpy(), gp.numpy(), f"fused d/d{name}")

    for layer, jlayer in zip(tp["layers"], jp["layers"]):
        with torch.no_grad():
            layer["radial_mlp"]["w"][-1].mul_(0.5)
            layer["gate_w"].mul_(-1.0)
        jlayer["radial_mlp"]["w"][-1] = jlayer["radial_mlp"]["w"][-1] * 0.5
        jlayer["gate_w"] = -jlayer["gate_w"]
    want = float(j_total(jp))
    for f in (False, True):
        with torch.no_grad():
            _close(float(total(f)), want, f"fused_conv={f} energy after the update")


def _fcc_pair(kw, jitter, seed, velocities=None, skin=0.0):
    jcfg, jp, tp = _params(kw, seed=3)
    pos, cell = fcc_lattice(5, jitter=jitter, seed=seed)
    n = pos.shape[0]
    types = np.random.RandomState(2).randint(0, jcfg.num_types, n)
    masses = np.where(types == 0, 63.546, 107.87)
    js = JaxSystem.create(pos, types.astype(np.int32), cell=cell, masses=masses,
                          velocities=velocities, dtype=jnp.float64)
    ts = System.create(pos, types, cell=cell, masses=masses, velocities=velocities,
                       dtype=torch.float64, device="cpu")
    je = JaxEngine(jcfg, jp, js, skin=skin)
    te = NequIPEngine(NequIPConfig(**kw), tp, ts, device="cpu", skin=skin)
    return js, je, ts, te


def test_engine_500_atoms_matches_jax():
    kw = _kw(1, True, 2, r_max=4.5, avg_num_neighbors=12.0,
             per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)))
    js, je, ts, te = _fcc_pair(kw, 0.08, 11)
    assert te.spec.max_neighbors == je.spec.max_neighbors
    assert (te.spec.cutoff_table is None) == (je.spec.cutoff_table is None)
    jo = je.force_fn(js, je.rebuild_fn(js, None))
    to = te.force_fn(ts, te.rebuild_fn(ts, None))
    _close(float(to.total_energy), float(jo.total_energy), "total_energy")
    _close(to.atomic_energy.numpy(), jo.atomic_energy, "atomic_energy")
    _close(to.forces.numpy(), jo.forces, "forces")
    _close(to.virial.numpy(), jo.virial, "virial")


def test_nve_trajectory_matches_jax():
    """Ten 2 fs steps in two chunks with Verlet-skin rebuilds, from the same
    numpy velocities."""
    kw = _kw(1, True, 1, r_max=4.5, avg_num_neighbors=12.0)
    n = 500
    rng = np.random.RandomState(6)
    vel = rng.randn(n, 3) * np.sqrt(Units.kB * 600.0 / (63.546 * Units.mvv2e))
    vel -= vel.mean(0)
    js, je, ts, te = _fcc_pair(kw, 0.05, 5, velocities=vel, skin=0.05)
    dt = 2.0 * Units.fs
    jsim = JaxSimulation(js, je.force_fn, je.rebuild_fn, dt=dt, grow_fn=je.grow)
    tsim = Simulation(ts, te.force_fn, te.rebuild_fn, dt=dt, grow_fn=te.grow)
    jrows = jsim.run(10, log_every=5)
    trows = tsim.run(10, log_every=5)
    jsys, tsys = jsim.state.system, tsim.state.system
    np.testing.assert_allclose(tsys.positions.numpy(), np.asarray(jsys.positions), atol=1e-8)
    np.testing.assert_allclose(tsys.velocities.numpy(), np.asarray(jsys.velocities), atol=1e-8)
    for jr, tr in zip(jrows, trows):
        assert int(jr["step"]) == tr["step"]
        np.testing.assert_allclose(tr["etotal"], float(jr["etotal"]), rtol=1e-10)
        assert tr["n_edges"] == int(jr["n_edges"])


def test_engine_refuses_cpu_fallback_and_row_chunk():
    kw = _kw(1, True, 1, r_max=4.5)
    cfg = NequIPConfig(**kw)
    tp = nequip_params_from_numpy(nequip_init_numpy(cfg, 0), cfg, device="cpu")
    pos, cell = fcc_lattice(5)
    ts = System.create(pos, np.zeros(len(pos), np.int64), cell=cell, device="cpu")
    with pytest.raises(ValueError, match="row_chunk"):
        NequIPEngine(cfg, tp, ts, device="cpu", row_chunk=128)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        NequIPEngine(cfg, tp, ts)
    with pytest.raises(NotImplementedError):
        nequip_params_from_numpy(nequip_init_numpy(cfg, 0), dataclasses.replace(cfg, l_max=0),
                                 device="cpu")


def test_regrow_memory_estimate_is_per_model():
    """The regrow check reads each model's own per-edge estimate: Allegro's
    formula is unchanged, NequIP counts its gathered rows."""
    pos, cell = fcc_lattice(5)
    ts = System.create(pos, np.zeros(len(pos), np.int64), cell=cell, device="cpu")
    acfg = AllegroConfig(type_names=("Cu",), r_max=4.5)
    ncfg = NequIPConfig(type_names=("Cu",), r_max=4.5, parity=True, num_features=64)
    tp = nequip_params_from_numpy(nequip_init_numpy(ncfg, 0), ncfg, device="cpu")
    spec = NequIPEngine(ncfg, tp, ts, device="cpu", skin=0.4).spec
    e = 500 * spec.max_neighbors
    d, c, ns = 9, 32, 64
    assert regrow_bytes(spec, ts, acfg) == e * 4 * (2 * d * c * 3 + 6 * ns + 64)
    df = 4 * 2 * 64  # D * T * C at the NequIP bench
    assert regrow_bytes(spec, ts, ncfg) == e * 4 * (df * (3 + 2) + 8 + 4 + 1 + 64)
    plain = regrow_bytes(spec, ts, ncfg.for_training())
    assert plain == e * 4 * (df * 5 + 77 + 3 * (2 * 640 + 6 * df))
    for cfg in (acfg, ncfg):
        assert _check_memory(spec, ts, cfg) is None  # CPU system: nothing to check
