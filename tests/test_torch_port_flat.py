"""The FLAT edge layout of the PyTorch port against the JAX package at f64:
the dense neighbor build (same edges, shifts, mask and order, same
overflow flag) on full-PBC, many-image, slab, cluster, typed and masked,
too-small and contracted geometries, in one pass and in several; the
engine's dense capacity spec and its regrow; Allegro (both tiers, charges,
capture, one and two species) and NequIP (l_max 1 and 2, both parities,
one and two species) on the FLAT layout; the FLAT layout against the
port's own TABLE layout; a ten-step NVE run of the dense engine with a
forced regrow; the regrow memory check by strategy; the routing of TABLE
models too wide for the env-fused kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.engine as j_engine
import pair_allegro_tpu.neighbors.device as j_dev
from pair_allegro_tpu.engine import AllegroEngine as JaxAllegroEngine
from pair_allegro_tpu.md.integrate import Simulation as JaxSimulation
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_energy as j_energy
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxNequIPConfig
from pair_allegro_tpu.models.nequip import nequip_energy as j_nequip_energy
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.potential import make_potential as j_potential
from pair_allegro_tpu.system import System as JaxSystem
import pair_allegro_tpu_torch.engine as t_engine
import pair_allegro_tpu_torch.neighbors.device as t_dev
from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine, regrow_bytes
from pair_allegro_tpu_torch.md.integrate import Simulation
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_energy,
    allegro_params_from_numpy,
    env_fused_viable,
    layer_tier,
)
from pair_allegro_tpu_torch.models.nequip import (
    NequIPConfig,
    nequip_energy,
    nequip_params_from_numpy,
)
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import System, Units, fcc_lattice
from test_torch_port_nequip_conv import _table

torch.set_num_threads(2)
CUT_TABLE = np.array([[4.9, 4.4], [4.4, 4.0]])


def _close(a, b, name, tol=1e-10):
    b = np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(np.asarray(a) - b).max()) / scale
    assert err <= tol, f"{name}: relative error {err:.3e}"


def _geometry(name):
    """(positions, cell, pbc, cutoff, max_edges, extra) of a named case."""
    if name in ("fcc108", "typed_masked", "small_cap", "passes"):
        pos, cell = fcc_lattice(3, jitter=0.08, seed=3)
        cap = {"small_cap": 2000}.get(name, 12000)
        return pos, cell, (True,) * 3, 4.9, cap
    if name == "cu4_rmax15":  # cutoff beyond the box: many images
        pos, cell = fcc_lattice(1, jitter=0.05, seed=1)
        return pos, cell, (True,) * 3, 15.0, 6000
    if name == "slab":  # 20 A of vacuum along z, non-periodic there
        pos, cell = fcc_lattice(3, jitter=0.08, seed=4)
        cell = cell.copy()
        cell[2, 2] += 20.0
        return pos, cell, (True, True, False), 4.9, 12000
    if name == "cluster":  # a molecule-like cluster: no cell at all
        pos, _ = fcc_lattice(2, jitter=0.1, seed=5)
        return pos, np.zeros((3, 3)), (False,) * 3, 4.9, 2048
    raise KeyError(name)


@pytest.mark.parametrize("name", ["fcc108", "cu4_rmax15", "slab", "cluster", "typed_masked",
                                  "small_cap", "passes", "contracted"])
def test_dense_neighbors_match_jax(name):
    """Exact equality of every output slot, the flag, and the shift table;
    'passes' takes the build through 40-row windows, 'contracted' builds
    with the shift table of a cell 1/0.6 times larger."""
    if name == "contracted":
        pos, cell = fcc_lattice(2, jitter=0.05, seed=6)
        pbc, rc, cap = (True,) * 3, 4.9, 4000
        shifts = j_dev.static_image_shifts(cell, pbc, rc)
        pos, cell = pos * 0.6, cell * 0.6
    else:
        pos, cell, pbc, rc, cap = _geometry(name)
        shifts = j_dev.static_image_shifts(cell, pbc, rc)
    np.testing.assert_array_equal(t_dev.static_image_shifts(
        cell if name != "contracted" else cell / 0.6, pbc, rc), shifts)
    n = len(pos)
    types = mask = ct = None
    if name == "typed_masked":
        types = np.random.RandomState(7).randint(0, 2, n)
        mask = np.arange(n) < n - 8
        ct = CUT_TABLE
    j = j_dev.dense_neighbors(
        jnp.asarray(pos), jnp.asarray(cell), shifts, rc, cap, pbc=pbc,
        atom_mask=None if mask is None else jnp.asarray(mask),
        types=None if types is None else jnp.asarray(types, jnp.int32), cutoff_table=ct)
    t = t_dev.dense_neighbors(
        torch.tensor(pos), torch.tensor(cell), shifts, rc, cap, pbc=pbc,
        atom_mask=None if mask is None else torch.tensor(mask),
        types=None if types is None else torch.tensor(types), cutoff_table=ct,
        chunk=40 * n if name == "passes" else t_dev.DENSE_CHUNK)
    want_overflow = name in ("small_cap", "contracted")
    assert bool(j.overflow) == bool(t.overflow) == want_overflow
    assert t.edge_index.shape == (2, cap) and t.edge_rev is None
    np.testing.assert_array_equal(t.edge_index.numpy(), np.asarray(j.edge_index))
    np.testing.assert_array_equal(t.edge_shifts.numpy(), np.asarray(j.edge_shifts))
    np.testing.assert_array_equal(t.edge_mask.numpy(), np.asarray(j.edge_mask))
    if not want_overflow:
        assert 0 < int(t.edge_mask.sum()) < cap


def _systems(name, dtype=torch.float64, velocities=None):
    pos, cell, pbc, _, _ = _geometry(name)
    n = len(pos)
    types = np.random.RandomState(2).randint(0, 2, n)
    masses = np.where(types == 0, 63.546, 107.87)
    jcell = None if name == "cluster" else cell
    js = JaxSystem.create(pos, types.astype(np.int32), cell=jcell, masses=masses, pbc=pbc,
                          velocities=velocities, dtype=jnp.float64)
    ts = System.create(pos, types, cell=jcell, masses=masses, pbc=pbc, velocities=velocities,
                       dtype=dtype, device="cpu")
    return js, ts


@pytest.mark.parametrize("name", ["fcc108", "slab", "cluster"])
def test_dense_spec_and_regrow_spec_match_jax(name):
    """The strategy, shift table and max_edges of the engine's estimate and
    of a regrow from a changed geometry; typed build cutoffs included."""
    js, ts = _systems(name)
    ct = CUT_TABLE + 0.4
    for table in (None, ct):
        j = j_engine._estimate_capacities(js, 4.5, 0.4, 1.25, cutoff_table=table)
        t = t_engine._estimate_capacities(ts, 4.5, 0.4, 1.25, cutoff_table=table)
        assert t.strategy == j.strategy == "dense"
        np.testing.assert_array_equal(t.shifts_table, j.shifts_table)
        assert (t.max_edges, t.cutoff) == (j.max_edges, j.cutoff)
        js2 = dataclasses.replace(js, positions=js.positions * 0.97, cell=js.cell * 0.97)
        ts2 = ts.replace(positions=ts.positions * 0.97, cell=ts.cell * 0.97)
        jr, tr = j_engine.reestimate_spec(j, js2), t_engine.reestimate_spec(t, ts2)
        np.testing.assert_array_equal(tr.shifts_table, jr.shifts_table)
        assert (tr.strategy, tr.max_edges) == (jr.strategy, jr.max_edges)


def _allegro_kw(species, **kw):
    base = dict(r_max=4.5, l_max=2, num_layers=2, num_scalar_features=16, num_tensor_features=8,
                avg_num_neighbors=12.0, output_charges=True)
    if species == 1:
        base["type_names"] = ("Cu",)
    else:
        base.update(type_names=("Cu", "Ag"), per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)))
    base.update(kw)
    return base


def _allegro_params(kw, seed=0):
    jcfg = JaxConfig(remat=False, **kw)
    jp = allegro_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    nt = jcfg.num_types
    jp["per_type_scale"] = jnp.linspace(0.8, 1.3, nt)
    jp["per_type_shift"] = jnp.linspace(-0.2, 0.4, nt)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), AllegroConfig(**kw), device="cpu",
                                   dtype=torch.float64)
    return jcfg, jp, tp


def _flat_case(name, species, rc=4.9):
    """A dense FLAT edge list of a named geometry (JAX's build), with the
    inputs of both packages."""
    pos, cell, pbc, _, cap = _geometry(name)
    types = (np.arange(len(pos)) % 2) if species == 2 else np.zeros(len(pos), np.int64)
    shifts = j_dev.static_image_shifts(cell, pbc, rc)
    nd = j_dev.dense_neighbors(jnp.asarray(pos), jnp.asarray(cell), shifts, rc, cap, pbc=pbc)
    assert not bool(nd.overflow)
    jargs = (jnp.asarray(pos), jnp.asarray(types, jnp.int32), nd.edge_index)
    jkw = dict(cell=jnp.asarray(cell), edge_shifts=nd.edge_shifts, edge_mask=nd.edge_mask)
    targs = (torch.tensor(pos), torch.tensor(types, dtype=torch.int64),
             torch.tensor(np.asarray(nd.edge_index), dtype=torch.int64))
    tkw = dict(cell=torch.tensor(cell), edge_shifts=torch.tensor(np.asarray(nd.edge_shifts)),
               edge_mask=torch.tensor(np.asarray(nd.edge_mask)))
    return jargs, jkw, targs, tkw


def _outputs(o, charges=True):
    out = {"total_energy": float(o.total_energy), "atomic_energy": np.asarray(o.atomic_energy),
           "forces": np.asarray(o.forces), "virial": np.asarray(o.virial)}
    if charges:
        out.update(charges=np.asarray(o.extras["charges"]), dipole=np.asarray(o.extras["dipole"]))
    return out


@pytest.mark.parametrize("species", [1, 2])
@pytest.mark.parametrize("fused_tp", [True, False])
def test_allegro_flat_matches_jax(species, fused_tp):
    """f64, 1e-10 relative: energy, per-atom energies, forces, virial,
    charges and dipole on the slab's FLAT list; fused_tp=True is the K4
    tier (its plain version on the CPU), False the plain tier."""
    kw = _allegro_kw(species)
    jcfg, jp, tp = _allegro_params(kw)
    jargs, jkw, targs, tkw = _flat_case("slab", species)
    jcfg = dataclasses.replace(jcfg, fused_tp=fused_tp)
    want = _outputs(jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))(*jargs, **jkw))
    cfg = AllegroConfig(**kw, fused_tp=fused_tp)
    assert layer_tier(cfg, flat=True) == ("k4" if fused_tp else "plain")
    got = _outputs(make_potential(lambda *a, **k: allegro_energy(tp, cfg, *a, **k))(*targs, **tkw))
    for name in want:
        _close(got[name], want[name], f"fused_tp={fused_tp} {name}")


def test_allegro_flat_capture_matches_jax():
    kw = _allegro_kw(2)
    jcfg, jp, tp = _allegro_params(kw)
    jargs, jkw, targs, tkw = _flat_case("cluster", 2)
    jcap, tcap = {}, {}
    j_energy(jp, jcfg, *jargs, capture=jcap, **jkw)
    with torch.no_grad():
        allegro_energy(tp, AllegroConfig(**kw), *targs, capture=tcap, **tkw)
    assert sorted(tcap) == sorted(jcap)
    for key in jcap:
        assert tuple(tcap[key].shape) == tuple(jcap[key].shape), key
        _close(tcap[key].numpy(), jcap[key], f"capture {key}")


def _as_flat(j_tab, s_tab, m_tab):
    n, k = j_tab.shape
    ei = np.stack([np.repeat(np.arange(n), k), j_tab.reshape(-1)])
    return ei, s_tab.reshape(-1, 3), m_tab.reshape(-1)


@pytest.mark.parametrize("tier", [dict(), dict(layer_fused=False)])
def test_flat_equals_table_500_atoms(tier):
    """The port's FLAT (dense build) and TABLE (cell list) layouts give the
    same energies, forces, virial and charges on a 500-atom box: the same
    edges summed in another order."""
    kw = _allegro_kw(2, **tier)
    _, _, tp = _allegro_params(kw)
    cfg = AllegroConfig(**kw)
    pos, cell = fcc_lattice(5, jitter=0.08, seed=8)
    n = len(pos)
    types = torch.tensor(np.random.RandomState(9).randint(0, 2, n))
    p, c = torch.tensor(pos), torch.tensor(cell)
    rc = 4.9
    tab = t_dev.cell_list_neighbors(p, c, rc, t_dev.choose_grid(cell, rc), 40, 64)
    rev = t_dev.reverse_table(tab.edge_index, tab.edge_shifts)
    shifts = t_dev.static_image_shifts(cell, (True,) * 3, rc)
    fl = t_dev.dense_neighbors(p, c, shifts, rc, 30000, pbc=(True,) * 3, chunk=1 << 20)
    assert not bool(tab.overflow) and not bool(fl.overflow)
    assert int(tab.edge_mask.sum()) == int(fl.edge_mask.sum())
    pot = make_potential(lambda *a, **k: allegro_energy(tp, cfg, *a, **k))
    o_tab = _outputs(pot(p, types, tab.edge_index, cell=c, edge_shifts=tab.edge_shifts,
                         edge_mask=tab.edge_mask, edge_rev=rev))
    o_flat = _outputs(pot(p, types, fl.edge_index, cell=c, edge_shifts=fl.edge_shifts,
                          edge_mask=fl.edge_mask))
    for name in o_tab:
        _close(o_flat[name], o_tab[name], name)


def _nequip_kw(lmax, parity, species):
    base = dict(r_max=4.5, l_max=lmax, num_layers=3 - lmax, num_features=8,
                avg_num_neighbors=12.0, parity=parity)
    if species == 1:
        base["type_names"] = ("Cu",)
    else:
        base.update(type_names=("Cu", "Ag"), per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)))
    return base


@pytest.mark.parametrize("lmax,parity,species", [(1, False, 2), (1, True, 1), (2, False, 1),
                                                 (2, True, 2)])
def test_nequip_flat_matches_jax(lmax, parity, species):
    """f64, 1e-10 relative, on the cluster's FLAT list: energy, per-atom
    energies, forces, virial; K3 serves only the TABLE layout, so
    fused_conv=True takes the plain message path here as in JAX."""
    kw = _nequip_kw(lmax, parity, species)
    jcfg = JaxNequIPConfig(remat=False, **kw)
    jp = nequip_init(jax.random.PRNGKey(1), jcfg, dtype=jnp.float64)
    jp["per_type_scale"] = jnp.linspace(0.8, 1.3, jcfg.num_types)
    tp = nequip_params_from_numpy(jax.tree.map(np.asarray, jp), NequIPConfig(**kw), device="cpu",
                                  dtype=torch.float64)
    jargs, jkw, targs, tkw = _flat_case("cluster", species)
    want = _outputs(jax.jit(j_potential(lambda *a, **k: j_nequip_energy(jp, jcfg, *a, **k)))(
        *jargs, **jkw), charges=False)
    for fused in (True, False):
        cfg = dataclasses.replace(NequIPConfig(**kw), fused_conv=fused)
        got = _outputs(make_potential(lambda *a, **k: nequip_energy(tp, cfg, *a, **k))(
            *targs, **tkw), charges=False)
        for name in want:
            _close(got[name], want[name], f"fused_conv={fused} {name}")


def test_dense_engine_nve_with_forced_regrow_matches_jax():
    """Ten 2 fs steps of the dense engine on 108 atoms (two chunks, Verlet
    skin) from the same numpy velocities, both engines started at a
    max_edges too small for the system, so both overflow and regrow."""
    kw = _allegro_kw(2, output_charges=False)
    jcfg, jp, tp = _allegro_params(kw, seed=3)
    n = 108
    rng = np.random.RandomState(6)
    vel = rng.randn(n, 3) * np.sqrt(Units.kB * 600.0 / (63.546 * Units.mvv2e))
    vel -= vel.mean(0)
    js, ts = _systems("fcc108", velocities=vel)
    je = JaxAllegroEngine(jcfg, jp, js, skin=0.1)
    te = AllegroEngine(AllegroConfig(**kw), tp, ts, device="cpu", skin=0.1)
    assert te.spec.strategy == je.spec.strategy == "dense"
    small = je.spec.max_edges // 2
    je.spec = dataclasses.replace(je.spec, max_edges=small)
    je.rebuild_fn = jax.jit(j_engine.make_rebuild_fn(je.spec, 0.1))
    te.spec = dataclasses.replace(te.spec, max_edges=small)
    te.rebuild_fn = t_engine.make_rebuild_fn(te.spec, 0.1)
    dt = 2.0 * Units.fs
    jsim = JaxSimulation(js, je.force_fn, je.rebuild_fn, dt=dt, grow_fn=je.grow)
    tsim = Simulation(ts, te.force_fn, te.rebuild_fn, dt=dt, grow_fn=te.grow)
    jrows = jsim.run(10, log_every=5)
    trows = tsim.run(10, log_every=5)
    assert tsim.regrows >= 1
    assert te.spec.max_edges == je.spec.max_edges
    jsys, tsys = jsim.state.system, tsim.state.system
    np.testing.assert_allclose(tsys.positions.numpy(), np.asarray(jsys.positions), atol=1e-8)
    np.testing.assert_allclose(tsys.velocities.numpy(), np.asarray(jsys.velocities), atol=1e-8)
    for jr, tr in zip(jrows, trows):
        assert int(jr["step"]) == tr["step"]
        np.testing.assert_allclose(tr["etotal"], float(jr["etotal"]), rtol=1e-10)
        assert tr["n_edges"] == int(jr["n_edges"])


@pytest.mark.parametrize("name", ["fcc108", "slab", "cluster"])
def test_engines_take_dense_systems(name):
    """Small, slab and cluster systems build, and give finite forces, on
    both engines (f32, as on the card)."""
    _, ts = _systems(name, dtype=torch.float32)
    acfg = AllegroConfig(**_allegro_kw(2))
    ncfg = NequIPConfig(**_nequip_kw(1, True, 2))
    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy
    from pair_allegro_tpu_torch.models.nequip import nequip_init_numpy

    engines = [
        AllegroEngine(acfg, allegro_params_from_numpy(allegro_init_numpy(acfg, 0), acfg,
                                                      device="cpu"), ts, device="cpu", skin=0.4),
        NequIPEngine(ncfg, nequip_params_from_numpy(nequip_init_numpy(ncfg, 0), ncfg,
                                                    device="cpu"), ts, device="cpu", skin=0.4),
    ]
    for eng in engines:
        assert eng.spec.strategy == "dense"
        nb = eng.rebuild_fn(ts, None)
        assert nb.edge_index.shape == (2, eng.spec.max_edges) and not bool(nb.overflow)
        o = eng.force_fn(ts, nb)
        assert o.forces.shape == (ts.n_atoms, 3) and bool(torch.isfinite(o.forces).all())
        # Newton's third law holds on the full (both-direction) edge list
        assert float(o.forces.sum(0).abs().max()) < 1e-3 * float(o.forces.abs().max()) + 1e-4


def test_regrow_bytes_by_strategy():
    """A cell-list spec counts N*K slots at the TABLE estimate; a dense spec
    counts max_edges at the FLAT estimate plus its build (one pass of
    candidate pairs and the compacted outputs), never 0."""
    _, ts = _systems("slab", dtype=torch.float32)
    cfg = AllegroConfig(**_allegro_kw(1))
    cl = t_engine.NeighborSpec(strategy="cell_list", cutoff=4.9, max_edges=108 * 48,
                               max_neighbors=48)
    assert regrow_bytes(cl, ts, cfg) == 108 * 48 * cfg.live_bytes_per_edge()
    shifts = t_dev.static_image_shifts(ts.cell.double().numpy(), ts.pbc, 4.9)
    dn = t_engine.NeighborSpec(strategy="dense", cutoff=4.9, max_edges=5120, shifts_table=shifts)
    build = t_dev.dense_build_bytes(108, len(shifts), 5120, 4)
    # one pass holds all 9 * 108^2 candidates here: 5 f32 words + 51 bytes
    # each, and the outputs 8 + 33 + 12 bytes per slot
    assert build == 9 * 108 * 108 * (5 * 4 + 51) + (5120 + 1024) * (8 + 33 + 12)
    assert regrow_bytes(dn, ts, cfg) == 5120 * cfg.live_bytes_per_edge(flat=True) + build
    assert cfg.live_bytes_per_edge(flat=True) > cfg.live_bytes_per_edge()
    ncfg = NequIPConfig(**_nequip_kw(1, True, 1))
    assert ncfg.live_bytes_per_edge(flat=True) == ncfg.for_training().live_bytes_per_edge()
    # a large slab is held in passes of at most DENSE_CHUNK candidates
    big = t_dev.dense_build_bytes(5324, 9, 300000, 4)
    assert big < t_dev.DENSE_CHUNK * (5 * 4 + 51) + 301024 * 53


def test_too_wide_table_model_runs_k4_and_matches_jax(monkeypatch):
    """env_fused_viable is True at flagship widths on every env-fused tier
    and False where the kernels' shared memory cannot hold the model; such
    a TABLE model runs the K4 tier and gives JAX's energy and forces."""
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    flag = AllegroConfig(type_names=("Cu",), r_max=4.5)
    for tier in (dict(), dict(layer_fused=False), dict(layer_fused=False, tp_mode="mxu_highest"),
                 dict(layer_fused=False, tp_mode="mxu_bf16x3")):
        assert env_fused_viable(dataclasses.replace(flag, **tier)), tier
    wide = dict(type_names=("A", "B"), r_max=3.0, l_max=2, num_layers=2, num_scalar_features=16,
                num_tensor_features=64, avg_num_neighbors=6.0, output_charges=True,
                per_edge_type_cutoff=((3.0, 2.8), (2.8, 2.6)))
    assert not env_fused_viable(AllegroConfig(**wide))
    assert layer_tier(AllegroConfig(**wide), flat=False) == "k4"
    assert not env_fused_viable(AllegroConfig(**{**wide, "l_max": 3, "layer_fused": False}))
    jcfg, jp, tp = _allegro_params(wide)
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    types = np.arange(len(pos)) % 2
    want = _outputs(jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))(
        jnp.asarray(pos), jnp.asarray(types, jnp.int32), jnp.asarray(j_tab), cell=jnp.asarray(cell),
        edge_shifts=jnp.asarray(s_tab), edge_mask=jnp.asarray(m_tab), edge_rev=jnp.asarray(rev)))
    got = _outputs(make_potential(lambda *a, **k: allegro_energy(tp, AllegroConfig(**wide), *a, **k))(
        torch.tensor(pos), torch.tensor(types), torch.tensor(j_tab, dtype=torch.int64),
        cell=torch.tensor(cell), edge_shifts=torch.tensor(s_tab), edge_mask=torch.tensor(m_tab),
        edge_rev=torch.tensor(rev, dtype=torch.int64)))
    for name in want:
        _close(got[name], want[name], f"K4 on TABLE {name}")


def test_k4_tier_hands_the_kernel_contiguous_operands(monkeypatch):
    """The CUDA kernel takes contiguous (D, C, E) operands only: the K4
    tier builds V0 and env contiguous on both layouts (the plain version
    on the CPU does not need it, so this is checked here)."""
    import pair_allegro_tpu_torch.models.allegro as t_allegro

    seen = []
    real = t_allegro.tp_mix_fused_t

    def probe(Vt, envt, w):
        seen.append(Vt.is_contiguous() and envt.is_contiguous())
        return real(Vt, envt, w)

    monkeypatch.setattr(t_allegro, "tp_mix_fused_t", probe)
    kw = _allegro_kw(2)
    _, _, tp = _allegro_params(kw)
    _, _, targs, tkw = _flat_case("cluster", 2)
    make_potential(lambda *a, **k: allegro_energy(tp, AllegroConfig(**kw), *a, **k))(*targs, **tkw)
    wide = {**kw, "num_tensor_features": 64}
    _, _, tpw = _allegro_params(wide)
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    allegro_energy(tpw, AllegroConfig(**wide), torch.tensor(pos), torch.tensor(np.arange(40) % 2),
                   torch.tensor(j_tab, dtype=torch.int64), cell=torch.tensor(cell),
                   edge_shifts=torch.tensor(s_tab), edge_mask=torch.tensor(m_tab))
    assert len(seen) == 4 and all(seen)
