"""The port's integrators against the JAX package's at f64 (positions,
velocities, cell and thermostat after 10 steps of nvt, npt, npt_berendsen
and zero-temperature langevin from the same state, to 1e-9 relative), the
physics checks of ``tests/test_md.py`` on the port alone (target
temperature, thermalization, conserved quantities, pressure control,
contraction detection), and the capacity shrink of
``tests/test_typed_build.py`` against the JAX engine's capacities."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.engine import AllegroEngine as JaxEngine
from pair_allegro_tpu.md.integrate import Simulation as JaxSimulation
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch.engine import AllegroEngine, make_rebuild_fn
from pair_allegro_tpu_torch.md.integrate import Simulation
from pair_allegro_tpu_torch.md.thermo import nose_hoover_conserved, npt_mtk_conserved
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_params_from_numpy
from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np
from pair_allegro_tpu_torch.system import System, Units

torch.set_num_threads(2)
# the model of tests/test_md.py:_engine
KW = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=1, num_scalar_features=8,
          num_tensor_features=4, avg_num_neighbors=12.0)
A0 = 3.61


def _fcc(n_rep, jitter=0.02, seed=0):
    rng = np.random.RandomState(seed)
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * A0
    pos = np.concatenate([base + np.array([i, j, k]) * A0 for i in range(n_rep)
                          for j in range(n_rep) for k in range(n_rep)])
    return pos + jitter * rng.randn(*pos.shape), np.eye(3) * A0 * n_rep


def _params(dtype=jnp.float64, key=0):
    jp = allegro_init(jax.random.PRNGKey(key), JaxConfig(**KW), dtype=dtype)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), AllegroConfig(**KW),
                                   device="cpu", dtype=torch.float64)
    return jp, tp


def _port(n_rep=3, skin=0.0, **sim_kw):
    pos, cell = _fcc(n_rep)
    n = pos.shape[0]
    _, tp = _params()
    ts = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=np.full(n, 63.546),
                       dtype=torch.float64, device="cpu")
    eng = AllegroEngine(AllegroConfig(**KW), tp, ts, device="cpu", skin=skin)
    return eng, Simulation(ts, eng.force_fn, eng.rebuild_fn, grow_fn=eng.grow, **sim_kw)


CASES = {
    "nvt": dict(temp_K=150.0, tdamp=0.05),
    "npt": dict(temp_K=100.0, tdamp=0.1, press_bar=0.0, pdamp=1.0),
    "npt_berendsen": dict(temp_K=50.0, tdamp=0.05, press_bar=0.0, pdamp=0.5,
                          bulk_modulus_bar=1.4e6),
    "langevin": dict(temp_K=0.0, damp=0.05),  # no noise: the two streams differ
}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / scale


@pytest.mark.parametrize("integrator", sorted(CASES))
def test_trajectory_matches_jax(integrator):
    kw = CASES[integrator]
    pos, cell = _fcc(3)
    n = pos.shape[0]
    masses = np.full(n, 63.546)
    rng = np.random.RandomState(6)
    vel = rng.randn(n, 3) * np.sqrt(Units.kB * 300.0 / (masses[:, None] * Units.mvv2e))
    vel -= vel.mean(0)
    jp, tp = _params()
    js = JaxSystem.create(pos, np.zeros(n, np.int32), cell=cell, masses=masses, velocities=vel,
                          dtype=jnp.float64)
    je = JaxEngine(JaxConfig(**KW), jp, js, skin=0.3)
    jsim = JaxSimulation(js, je.force_fn, je.rebuild_fn, dt=2.0 * Units.fs,
                         integrator=integrator, grow_fn=je.grow, **kw)
    ts = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=masses, velocities=vel,
                       dtype=torch.float64, device="cpu")
    te = AllegroEngine(AllegroConfig(**KW), tp, ts, device="cpu", skin=0.3)
    tsim = Simulation(ts, te.force_fn, te.rebuild_fn, dt=2.0 * Units.fs, integrator=integrator,
                      grow_fn=te.grow, **kw)
    jsim.run(10, log_every=10)
    tsim.run(10, log_every=10)
    jst, tst = jsim.state, tsim.state
    assert tst.step == int(jst.step) == 10
    for name in ("positions", "velocities", "cell"):
        assert _rel(getattr(tst.system, name).numpy(), getattr(jst.system, name)) < 1e-9, name
    assert sorted(tst.thermostat) == sorted(jst.thermostat)
    for k, v in tst.thermostat.items():
        np.testing.assert_allclose(float(v), float(jst.thermostat[k]), rtol=1e-9, atol=1e-15)
    assert _rel(tst.forces.numpy(), jst.forces) < 1e-9
    if integrator != "langevin":  # the cell moved under both barostats
        moved = float(np.max(np.abs(tst.system.cell.numpy() - cell)))
        assert (moved > 1e-8) == integrator.startswith("npt")


def test_nvt_reaches_target_temperature():
    _, sim = _port(dt=2.0 * Units.fs, integrator="nvt", temp_K=150.0, tdamp=0.05)
    sim.init_velocities(40.0)
    sim.run(150, log_every=150)
    t_avg = np.mean([r["temp"] for r in sim.run(100, log_every=20)])
    assert 100.0 < t_avg < 200.0, f"NVT average T {t_avg} K, target 150"


def test_langevin_thermalizes():
    """The random model's energy release heats this box to ~760 K first; in
    steps 160-320 both packages still read 162-174 K (three noise seeds
    each), near 125-135 K only past step 320, so the average is taken
    there (the JAX suite's own window, steps 150-250, passes on its
    stream alone)."""
    _, sim = _port(dt=2.0 * Units.fs, integrator="langevin", temp_K=120.0, damp=0.05)
    sim.run(350, log_every=350)
    t_avg = np.mean([r["temp"] for r in sim.run(100, log_every=20)])
    assert 70.0 < t_avg < 180.0, f"Langevin average T {t_avg} K, target 120"


def test_nvt_conserved_quantity():
    """The Nosé-Hoover extended Hamiltonian holds to splitting order (the
    JAX package measured 3.0e-5 eV/atom at f64 / 1 fs; same bound)."""
    temp_K, tdamp = 150.0, 0.05
    _, sim = _port(dt=1.0 * Units.fs, integrator="nvt", temp_K=temp_K, tdamp=tdamp)
    sim.init_velocities(100.0)
    vals = []
    sim.run(200, log_every=10, callback=lambda st, row: vals.append(
        float(nose_hoover_conserved(st, temp_K, tdamp))))
    drift = (max(vals) - min(vals)) / sim.state.system.n_atoms
    assert drift < 1.5e-4, f"NH conserved-quantity drift {drift} eV/atom"


def test_npt_mtk_conserved_quantity():
    temp_K, tdamp, press_bar, pdamp = 100.0, 0.1, 0.0, 1.0
    _, sim = _port(n_rep=2, skin=0.3, dt=1.0 * Units.fs, integrator="npt", temp_K=temp_K,
                   tdamp=tdamp, press_bar=press_bar, pdamp=pdamp)
    sim.init_velocities(100.0)
    vals = []
    sim.run(200, log_every=10, callback=lambda st, row: vals.append(
        float(npt_mtk_conserved(st, temp_K, tdamp, press_bar, pdamp))))
    drift = (max(vals) - min(vals)) / sim.state.system.n_atoms
    assert drift < 2e-4, f"MTK conserved-quantity drift {drift} eV/atom"


def _volume(sim):
    return float(np.linalg.det(sim.state.system.cell.numpy()))


def test_npt_berendsen_relaxes_pressure():
    _, sim = _port(n_rep=2, dt=1.0 * Units.fs, integrator="npt_berendsen", temp_K=50.0,
                   tdamp=0.05, press_bar=0.0, pdamp=0.5, bulk_modulus_bar=1.4e6)
    sim.init_velocities(50.0)
    p0 = sim.run(5, log_every=5)[-1]["press"]
    v0 = _volume(sim)
    p1 = sim.run(200, log_every=200)[-1]["press"]
    v1 = _volume(sim)
    assert np.isfinite(p1)
    assert abs(p1) < abs(p0) or abs(v1 - v0) / v0 > 1e-5


def test_npt_mtk_controls_pressure_and_temperature():
    _, sim = _port(n_rep=2, skin=0.3, dt=2.0 * Units.fs, integrator="npt", temp_K=100.0,
                   tdamp=0.1, press_bar=0.0, pdamp=1.0)
    sim.init_velocities(100.0)
    p0 = sim.run(5, log_every=5)[-1]["press"]
    v0 = _volume(sim)
    sim.run(150, log_every=150)
    rows = sim.run(100, log_every=20)
    p1 = np.mean([r["press"] for r in rows])
    t1 = np.mean([r["temp"] for r in rows])
    v1 = _volume(sim)
    assert np.isfinite(p1) and np.isfinite(t1)
    assert 50.0 < t1 < 200.0, f"NPT/MTK average T {t1} K, target 100"
    assert abs(p1) < abs(p0) or abs(v1 - v0) / v0 > 1e-4


@pytest.mark.parametrize("n_rep,scale", [(3, 0.55), (5, 0.7)])
def test_contracting_cell_is_detected_not_silent(n_rep, scale):
    """A contraction past the built capacity sets the overflow flag (the
    dense build's image shifts at 108 atoms, the cell list's bins at 500),
    and a regrow from the current system finds every oracle edge."""
    eng, sim = _port(n_rep=n_rep)
    assert eng.spec.strategy == ("cell_list" if n_rep == 5 else "dense")
    system = sim.state.system
    assert not bool(eng.rebuild_fn(system, None).overflow)
    small = system.replace(positions=system.positions * scale, cell=system.cell * scale)
    assert bool(eng.rebuild_fn(small, None).overflow), "contraction must flag overflow"
    nb = eng.grow(system=small)(small, None)
    assert not bool(nb.overflow)
    ei, _ = neighbor_list_np(small.positions.numpy(), small.cell.numpy(), (True,) * 3,
                             eng.spec.cutoff)
    assert int(nb.count()) == ei.shape[1]


# the typed model of tests/test_typed_build.py
TYPED = dict(type_names=("Cu", "Ag"), r_max=3.5, l_max=1, num_layers=1, num_scalar_features=8,
             num_tensor_features=4, two_body_mlp_width=8, allegro_mlp_hidden_layers_width=8,
             readout_mlp_hidden_layers_width=8, avg_num_neighbors=10.0,
             per_edge_type_cutoff=((2.0, 3.5), (3.0, 1.8)))


def _typed_pair():
    rng = np.random.RandomState(0)
    pos, cell = _fcc(5, jitter=0.0)
    pos = pos + rng.randn(*pos.shape) * 0.05
    types = rng.randint(0, 2, size=len(pos))
    n = len(pos)
    jp = allegro_init(jax.random.PRNGKey(0), JaxConfig(**TYPED), dtype=jnp.float64)
    js = JaxSystem.create(pos, types.astype(np.int32), cell=cell, masses=np.full(n, 63.5),
                          dtype=jnp.float64)
    tcfg = AllegroConfig(**TYPED)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                                   dtype=torch.float64)
    ts = System.create(pos, types, cell=cell, masses=np.full(n, 63.5), dtype=torch.float64,
                       device="cpu")
    return (JaxEngine(JaxConfig(**TYPED), jp, js, skin=0.3), js,
            AllegroEngine(tcfg, tp, ts, device="cpu", skin=0.3), ts)


def test_capacity_shrink_hysteresis():
    """After a spike-grow, maybe_shrink returns K to the fresh estimate, as
    the JAX engine's does, with the same forces; then nothing is left."""
    je, js, te, system = _typed_pair()
    k0 = te.spec.max_neighbors
    assert k0 == je.spec.max_neighbors and te.spec.strategy == "cell_list"
    f0 = te.force_fn(system, te.rebuild_fn(system, None)).forces
    je.grow(2.0)
    te.grow(2.0)
    assert te.spec.max_neighbors == je.spec.max_neighbors > k0
    rb = te.maybe_shrink(system)
    assert je.maybe_shrink(js) is not None and je.spec.max_neighbors == k0
    assert rb is not None and te.spec.max_neighbors == k0
    f1 = te.force_fn(system, rb(system, None)).forces
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=1e-11)
    assert te.maybe_shrink(system) is None


def test_simulation_shrink_hook():
    """Simulation's shrink_fn adopts the smaller capacity at a chunk end and
    keeps integrating."""
    _, _, eng, system = _typed_pair()
    k0 = eng.spec.max_neighbors
    eng.grow(2.0)
    assert eng.spec.max_neighbors > k0
    sim = Simulation(system, eng.force_fn, eng.rebuild_fn, dt=0.5 * Units.fs,
                     grow_fn=eng.grow, shrink_fn=eng.maybe_shrink, shrink_every=1)
    sim.init_velocities(50.0)
    rows = sim.run(4, log_every=2)
    assert eng.spec.max_neighbors == k0 and sim.shrinks == 1 and len(rows) == 2
    assert sim.state.neighbors.edge_index.shape[1] == k0
    assert all(np.isfinite(r["etotal"]) for r in rows)


def test_overflow_regrows_through_a_grow_fn_without_system():
    """A grow_fn that takes no system (capacity growth alone) still regrows
    an undersized capacity and re-runs the chunk."""
    eng, sim0 = _port()
    system = sim0.state.system
    eng.spec = dataclasses.replace(eng.spec, max_edges=64)
    eng.rebuild_fn = make_rebuild_fn(eng.spec)
    sim = Simulation(system, eng.force_fn, eng.rebuild_fn, dt=1.0 * Units.fs,
                     grow_fn=lambda: eng.grow())
    sim.init_velocities(20.0)
    rows = sim.run(4, log_every=4)
    assert sim.regrows >= 1 and eng.spec.max_edges > 64
    assert not rows[-1]["overflow"] and np.isfinite(rows[-1]["etotal"])
    assert rows[-1]["n_edges"] == int(eng.rebuild_fn(system, None).count())
