"""The port's NVE Simulation against the JAX package's at f64: the same
numpy velocities, ten 2 fs steps in two chunks with Verlet-skin rebuilds,
positions and velocities to 1e-8; a forced small K that regrows in both;
and entry points that refuse to fall back to the CPU silently."""

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
from pair_allegro_tpu_torch.md.integrate import Simulation, create_velocities
from pair_allegro_tpu_torch.md.thermo import temperature
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_params_from_numpy
from pair_allegro_tpu_torch.system import System, Units, fcc_lattice

torch.set_num_threads(2)
KW = dict(type_names=("Cu",), r_max=4.5, l_max=2, num_layers=2, num_scalar_features=16,
          num_tensor_features=8, avg_num_neighbors=12.0)
SKIN, DT = 0.05, 2.0 * Units.fs


def _pair(k_max=None):
    jcfg, tcfg = JaxConfig(**KW), AllegroConfig(**KW)
    jp = allegro_init(jax.random.PRNGKey(3), jcfg, dtype=jnp.float64)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                                   dtype=torch.float64)
    pos, cell = fcc_lattice(5, jitter=0.05, seed=5)
    n = pos.shape[0]
    masses = np.full(n, 63.546)
    rng = np.random.RandomState(6)
    vel = rng.randn(n, 3) * np.sqrt(Units.kB * 600.0 / (masses[:, None] * Units.mvv2e))
    vel -= vel.mean(0)

    js = JaxSystem.create(pos, np.zeros(n, np.int32), cell=cell, masses=masses,
                          velocities=vel, dtype=jnp.float64)
    je = JaxEngine(jcfg, jp, js, skin=SKIN)
    ts = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=masses, velocities=vel,
                       dtype=torch.float64, device="cpu")
    te = AllegroEngine(tcfg, tp, ts, device="cpu", skin=SKIN)
    if k_max is not None:
        te.spec = dataclasses.replace(te.spec, max_neighbors=k_max, max_edges=n * k_max)
        te.rebuild_fn = make_rebuild_fn(te.spec, SKIN)
    jsim = JaxSimulation(js, je.force_fn, je.rebuild_fn, dt=DT, grow_fn=je.grow)
    tsim = Simulation(ts, te.force_fn, te.rebuild_fn, dt=DT, grow_fn=te.grow)
    return je, jsim, te, tsim


def _run_and_compare(jsim, tsim):
    jrows = jsim.run(10, log_every=5)
    trows = tsim.run(10, log_every=5)
    jsys, tsys = jsim.state.system, tsim.state.system
    np.testing.assert_allclose(tsys.positions.numpy(), np.asarray(jsys.positions), atol=1e-8)
    np.testing.assert_allclose(tsys.velocities.numpy(), np.asarray(jsys.velocities), atol=1e-8)
    for jr, tr in zip(jrows, trows):
        assert int(jr["step"]) == tr["step"]
        np.testing.assert_allclose(tr["etotal"], float(jr["etotal"]), rtol=1e-10)
        np.testing.assert_allclose(tr["temp"], float(jr["temp"]), rtol=1e-10)
        assert tr["n_edges"] == int(jr["n_edges"])
    return trows


def test_nve_trajectory_matches_jax():
    _, jsim, _, tsim = _pair()
    rows = _run_and_compare(jsim, tsim)
    assert tsim.regrows == 0
    assert abs(rows[-1]["etotal"] - rows[0]["etotal"]) < 1e-3 * abs(rows[0]["etotal"])


def test_forced_small_k_regrows_and_still_matches(monkeypatch):
    monkeypatch.setenv("PAT_K_MAX", "16")
    je, jsim, te, tsim = _pair(k_max=16)
    assert je.spec.max_neighbors == te.spec.max_neighbors == 16
    _run_and_compare(jsim, tsim)
    assert tsim.regrows >= 1
    assert te.spec.max_neighbors == je.spec.max_neighbors > 16


def test_create_velocities_hits_target_temperature():
    masses = torch.full((500,), 63.546, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    v = create_velocities(masses, 300.0, gen)
    s = System(positions=torch.zeros(500, 3, dtype=torch.float64), velocities=v,
               types=torch.zeros(500, dtype=torch.int64), masses=masses,
               cell=torch.eye(3, dtype=torch.float64))
    np.testing.assert_allclose(float(temperature(s)), 300.0, rtol=1e-12)
    np.testing.assert_allclose((masses[:, None] * v).sum(0).numpy(), 0.0, atol=1e-9)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        System.create(pos, np.zeros(n, np.int64), cell=cell)
    tcfg = AllegroConfig(**KW)
    jp = allegro_init(jax.random.PRNGKey(3), JaxConfig(**KW), dtype=jnp.float32)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ts = System.create(pos, np.zeros(n, np.int64), cell=cell, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        AllegroEngine(tcfg, tp, ts)
