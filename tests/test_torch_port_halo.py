"""The port's halo-sharded Allegro engine (``parallel/halo.py``,
``neighbors/device.halo_cell_list_neighbors``) and ``Simulation``'s
migration (``migrate_fn``, ``atom_perm``) against the JAX package's on its
8 virtual CPU devices, at f64 on the CPU, all of the port's shards on the
CPU.  Counterparts of the ten tests of ``tests/test_halo.py``.

Tolerances: energy 1e-12 relative, per-atom energies and charges 1e-12,
forces 1e-11, virial and dipole 1e-10 (``tests/test_halo.py``'s); the
prepared permutation, the decomposition (hops, coverage, capacities), the
edge arrays and the migration's permutations exact; trajectories 1e-9."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.md.integrate import Simulation as JaxSimulation
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.parallel import HaloShardedAllegroEngine as JaxHalo
from pair_allegro_tpu.parallel import make_mesh as jax_make_mesh
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch.checkpoint import params_from_numpy
from pair_allegro_tpu_torch.engine import AllegroEngine
from pair_allegro_tpu_torch.md.integrate import Simulation
from pair_allegro_tpu_torch.models.allegro import AllegroConfig
from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np
from pair_allegro_tpu_torch.parallel import HaloShardedAllegroEngine, make_mesh
from pair_allegro_tpu_torch.system import System, Units, fcc_lattice

torch.set_num_threads(2)
F64 = torch.float64
N_DEV = 8
KW = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=2, num_scalar_features=8,
          num_tensor_features=4, avg_num_neighbors=12.0)


def _close(a, b, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _check(out, ref, extras=False):
    _close(float(out.total_energy), float(ref.total_energy), rtol=1e-12)
    _close(out.atomic_energy, ref.atomic_energy, atol=1e-12)
    _close(out.forces, ref.forces, atol=1e-11)
    _close(out.virial, ref.virial, atol=1e-10)
    if extras:
        _close(out.extras["charges"], ref.extras["charges"], atol=1e-12)
        _close(out.extras["dipole"], ref.extras["dipole"], atol=1e-10)


def _models(seed=0, **over):
    kw = {**KW, **over}
    jcfg, cfg = JaxConfig(**kw), AllegroConfig(**kw)
    jp = allegro_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                                            dtype=F64)


def _prepared(pos, cell, velocities=None):
    """(JAX system, port system), each prepared for the N_DEV-shard mesh;
    the permutations must agree exactly."""
    n = len(pos)
    kw = dict(cell=cell, masses=np.full(n, 63.546), velocities=velocities)
    js, jperm = JaxHalo.prepare_system(
        JaxSystem.create(pos, np.zeros(n, np.int32), dtype=jnp.float64, **kw), N_DEV)
    ts, perm = HaloShardedAllegroEngine.prepare_system(
        System.create(pos, np.zeros(n, np.int64), dtype=F64, device="cpu", **kw), N_DEV)
    np.testing.assert_array_equal(perm, jperm)
    _close(ts.positions, js.positions)
    return js, ts


@pytest.fixture(scope="module")
def case():
    jcfg, jp, cfg, tp = _models()
    pos, cell = fcc_lattice(5, jitter=0.05, seed=0)
    js, ts = _prepared(pos, cell)
    return jcfg, jp, cfg, tp, js, ts


def _engines(case, **kw):
    jcfg, jp, cfg, tp, js, ts = case
    return (JaxHalo(jcfg, jp, js, jax_make_mesh(N_DEV), **kw),
            HaloShardedAllegroEngine(cfg, tp, ts, make_mesh(N_DEV, devices="cpu"), **kw))


@pytest.fixture(scope="module")
def engines(case):
    """JAX's and the port's halo engines on ``case``, built once (the tests
    that change an engine's decomposition build their own)."""
    return _engines(case)


def test_halo_matches_jax(case, engines):
    """The decomposition (hops, coverage, capacities) and the edge arrays
    (ext-frame j, shifts, mask) exactly JAX's; energy, per-atom energies,
    forces and virial against JAX's halo engine and the port's single
    engine."""
    jcfg, jp, cfg, tp, js, ts = case
    jeng, eng = engines
    for name in ("hops", "n_ext", "cov_min", "max_neighbors", "cell_capacity", "gz_cap",
                 "grid_xy", "hop_offsets"):
        assert getattr(eng, name) == getattr(jeng, name), name
    jnb, nb = jeng.rebuild_fn(js, None), eng.rebuild_fn(ts, None)
    assert not bool(nb.overflow) and not bool(jnb.overflow)
    g = nb.gathered()
    for name in ("edge_index", "edge_shifts", "edge_mask"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jnb, name)))
    out = eng.force_fn(ts, nb)
    _check(out, jeng.force_fn(js, jnb))
    single = AllegroEngine(cfg, tp, ts, device="cpu")
    assert int(nb.count()) == int(single.rebuild_fn(ts, None).count())
    _check(out, single.force_fn(ts, single.rebuild_fn(ts, None)))


def test_halo_edge_multiset_exact():
    """(i, j_global, shift) of every edge, through the ext -> global map,
    equal the exact host list's (``tests/test_halo.py``'s oracle check)."""
    jcfg, jp, cfg, tp = _models()
    pos, cell = fcc_lattice(4, jitter=0.05, seed=1)
    _, ts = _prepared(pos, cell)
    eng = HaloShardedAllegroEngine(cfg, tp, ts, make_mesh(N_DEV, devices="cpu"))
    nb = eng.rebuild_fn(ts, None)
    nl, s = eng.n_local, eng.n_shards
    p, c = ts.positions.numpy(), ts.cell.numpy()
    edges = set()
    for r in range(s):
        ei, em = nb.edge_index[r].numpy(), nb.edge_mask[r].numpy()
        sh = nb.edge_shifts[r].numpy()
        for a, k in zip(*np.nonzero(em)):
            i, jext = r * nl + a, ei[a, k]
            hop = eng.hop_offsets[jext // nl]
            jg = ((r + hop) % s) * nl + jext % nl
            shift = sh[a, k] + np.array([0, 0, (r + hop) // s])
            assert np.linalg.norm(p[jg] + shift @ c - p[i]) <= eng.rc + 1e-9
            edges.add((i, jg, *(int(round(x)) for x in shift)))
    ei_ref, sh_ref = neighbor_list_np(p[: s * nl], c, (True,) * 3, eng.rc)
    assert edges == {(int(ei_ref[0, k]), int(ei_ref[1, k]), *(int(x) for x in sh_ref[k]))
                     for k in range(ei_ref.shape[1])}


def test_halo_per_device_memory_is_local(case, engines):
    """Each shard's arrays are O(n_local * (2h + 1)), not O(N): its table
    has n_local rows and its extended frame n_ext < N."""
    jcfg, jp, cfg, tp, js, ts = case
    _, eng = engines
    assert eng.n_ext == (2 * eng.hops + 1) * eng.n_local < ts.n_atoms
    nb = eng.rebuild_fn(ts, None)
    assert all(t.shape == (eng.n_local, eng.max_neighbors) for t in nb.edge_index)
    assert int(max(int(t.max()) for t in nb.edge_index)) < eng.n_ext
    blocks = ts.positions.split(eng.n_local)
    assert eng._halo_exchange(blocks, ts.cell, 0, ts.device).shape == (eng.n_ext, 3)
    out = eng.force_fn(ts, nb)
    assert out.forces.shape == (ts.n_atoms, 3) and out.atomic_energy.shape == (ts.n_atoms,)


def test_halo_md_trajectory_matches(case):
    """10 NVE steps with a Verlet skin: positions and energy against JAX's
    halo run."""
    jcfg, jp, cfg, tp, js, ts = case
    vel = np.random.RandomState(3).randn(ts.n_atoms, 3) * 3.0 * ts.valid.numpy()[:, None]
    # JAX's Simulation donates its state: a copy of the shared system
    js = dataclasses.replace(jax.tree.map(jnp.copy, js), velocities=jnp.asarray(vel))
    ts = ts.replace(velocities=torch.as_tensor(vel))
    jeng, eng = _engines((jcfg, jp, cfg, tp, js, ts), skin=0.3)
    jsim = JaxSimulation(js, jeng.force_fn, jeng.rebuild_fn, dt=1.0 * Units.fs)
    sim = Simulation(ts, eng.force_fn, eng.rebuild_fn, dt=1.0 * Units.fs)
    jsim.run(10, log_every=5)
    sim.run(10, log_every=5)
    _close(sim.state.system.positions, jsim.state.system.positions, atol=1e-10)
    _close(float(sim.state.potential_energy), float(jsim.state.potential_energy), rtol=1e-11)


def test_halo_row_chunk_matches(case, engines):
    """row_chunk windows within each shard equal no windows and JAX."""
    jcfg, jp, cfg, tp, js, ts = case
    jeng, _ = engines
    eng_c = HaloShardedAllegroEngine(cfg, tp, ts, make_mesh(N_DEV, devices="cpu"), row_chunk=21)
    out = eng_c.force_fn(ts, eng_c.rebuild_fn(ts, None))
    _check(out, jeng.force_fn(js, jeng.rebuild_fn(js, None)))


def test_halo_drift_guard_flags_stale_decomposition(case):
    """An atom moved past the coverage margin flags the build (overflow),
    and grow() refuses with a re-sort message."""
    jcfg, jp, cfg, tp, js, ts = case
    eng = HaloShardedAllegroEngine(cfg, tp, ts, make_mesh(N_DEV, devices="cpu"))
    margin = eng.cov_min - eng.rc
    pos = ts.positions.clone()
    pos[5] += torch.tensor([0.0, 0.0, margin * 0.75], dtype=F64)
    bad = ts.replace(positions=pos)
    assert bool(eng.rebuild_fn(bad, None).overflow)
    with pytest.raises(RuntimeError, match="re-sort"):
        eng.grow(system=bad)
    # re-run from a state within the margin after a chunk that crossed it:
    # no regrow can help, so it refuses instead of growing without end
    with pytest.raises(RuntimeError, match="within one chunk"):
        eng.grow(system=ts)


def test_halo_thin_slabs_rejected():
    """Slabs thinner than the cutoff (2h + 1 > S) are refused, pointing at
    the replicated engine; so is a box without full PBC."""
    jcfg, jp, cfg, tp = _models()
    pos, cell = fcc_lattice(3, jitter=0.05, seed=0)
    _, ts = _prepared(pos, cell)
    mesh = make_mesh(N_DEV, devices="cpu")
    with pytest.raises(ValueError, match="replicated"):
        HaloShardedAllegroEngine(cfg, tp, ts, mesh)
    with pytest.raises(ValueError, match="full PBC"):
        HaloShardedAllegroEngine(cfg, tp, ts.replace(pbc=(True, True, False)), mesh)


def test_halo_triclinic_and_extras():
    """A triclinic cell (tilted c: the slab normal is not z) with the charge
    head: charges per shard, the dipole summed, all against JAX's halo
    engine and the port's single engine."""
    rng = np.random.RandomState(2)
    n_rep, a0 = 5, 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac = np.concatenate([base / n_rep + np.array([i, j, k]) / n_rep for i in range(n_rep)
                           for j in range(n_rep) for k in range(n_rep)])
    cell = np.array([[a0 * n_rep, 0.0, 0.0], [1.5, a0 * n_rep, 0.0], [2.0, -1.0, a0 * n_rep]])
    pos = frac @ cell + 0.04 * rng.randn(len(frac), 3)
    jcfg, jp, cfg, tp = _models(seed=1, output_charges=True)
    js, ts = _prepared(pos, cell)
    jeng, eng = _engines((jcfg, jp, cfg, tp, js, ts))
    nb, jnb = eng.rebuild_fn(ts, None), jeng.rebuild_fn(js, None)
    assert not bool(nb.overflow) and int(nb.count()) == int(jnb.count())
    out = eng.force_fn(ts, nb)
    _check(out, jeng.force_fn(js, jnb), extras=True)
    single = AllegroEngine(cfg, tp, ts, device="cpu")
    _check(out, single.force_fn(ts, single.rebuild_fn(ts, None)), extras=True)


def test_halo_migration_exactness(case):
    """A rigid +z translation past half the margin: maybe_migrate's re-sort
    equals JAX's (permutation, positions, velocities), keeps the exchange
    pattern (no new rebuild_fn), and the forces are the originals permuted;
    under the threshold nothing is proposed."""
    jcfg, jp, cfg, tp, js, ts = case
    jeng, eng = _engines(case)
    rebuild_before = eng.rebuild_fn
    f0 = eng.force_fn(ts, eng.rebuild_fn(ts, None)).forces.numpy()
    shift = np.array([0.0, 0.0, 0.3 * (eng.cov_min - eng.rc)])
    pos = ts.positions.numpy() + shift
    new_sys, perm, new_rebuild = eng.maybe_migrate(ts.replace(positions=torch.as_tensor(pos)))
    jnew, jperm, jrebuild = jeng.maybe_migrate(
        dataclasses.replace(js, positions=jnp.asarray(pos)))
    assert new_sys is not None and new_rebuild is None and jrebuild is None
    assert eng.rebuild_fn is rebuild_before
    np.testing.assert_array_equal(perm, jperm)
    assert sorted(perm) == list(range(ts.n_atoms))
    _close(new_sys.positions, jnew.positions)
    _close(new_sys.velocities, jnew.velocities)
    assert eng.cov_min == jeng.cov_min
    mask = new_sys.valid_mask().numpy()
    nb = eng.rebuild_fn(new_sys, None)
    assert not bool(nb.overflow)
    out = eng.force_fn(new_sys, nb)
    _check(out, jeng.force_fn(jnew, jeng.rebuild_fn(jnew, None)))
    _close(out.forces.numpy()[mask], f0[perm][mask], atol=1e-9)
    assert eng.maybe_migrate(new_sys) == (None, None, None)


def test_halo_migration_continuation():
    """NVE with a rigid +z drift sized to trip a re-sort at the second
    chunk boundary, ``migrate_fn`` wired in: the run crosses the migration
    and goes on, and its positions, velocities, energy and ``atom_perm``
    follow JAX's run over the same steps."""
    jcfg, jp, cfg, tp = _models()
    pos, cell = fcc_lattice(5, jitter=0.05, seed=0)
    js, ts = _prepared(pos, cell)
    jeng, eng = _engines((jcfg, jp, cfg, tp, js, ts), skin=0.3)
    dt_fs = 2.0
    # 0.03 of the margin a step: the proactive re-sort (at a quarter of the
    # margin) comes at the step-10 chunk boundary, the guard never trips
    vz = 0.03 * (eng.cov_min - eng.rc) / dt_fs * 1e3  # A/ps
    vel = np.random.RandomState(7).randn(ts.n_atoms, 3) * 2.0 + np.array([0.0, 0.0, vz])
    vel *= ts.valid.numpy()[:, None]
    js = dataclasses.replace(js, velocities=jnp.asarray(vel))
    ts = ts.replace(velocities=torch.as_tensor(vel))
    jsim = JaxSimulation(js, jeng.force_fn, jeng.rebuild_fn, dt=dt_fs * Units.fs,
                         grow_fn=jeng.grow, migrate_fn=jeng.maybe_migrate)
    sim = Simulation(ts, eng.force_fn, eng.rebuild_fn, dt=dt_fs * Units.fs, grow_fn=eng.grow,
                     migrate_fn=eng.maybe_migrate)
    jsim.run(15, log_every=5)
    rows = sim.run(15, log_every=5)
    assert sim.migrations >= 1 and sim.atom_perm is not None
    assert not rows[-1]["overflow"]
    np.testing.assert_array_equal(sim.atom_perm, jsim.atom_perm)
    assert sorted(sim.atom_perm) == list(range(ts.n_atoms))
    _close(sim.state.system.positions, jsim.state.system.positions, atol=1e-9)
    _close(sim.state.system.velocities, jsim.state.system.velocities, atol=1e-9)
    _close(float(sim.state.potential_energy), float(jsim.state.potential_energy), rtol=1e-9)
    assert sim.state.step == jsim.state.step == 15
