"""The port's CLI, calculator and edge dump, driven in-process on the CPU:
``cli run`` with a JAX-written checkpoint and state prints the JAX CLI's
thermo columns at f64 (to 1e-8 relative); every example config runs with
``--device cpu`` (steps cut to 5 in a copy); ``info``; restarts resume bit
for bit (nvt, langevin); computes columns; ``sharding:`` is refused in
``run`` and ``train``; without a GPU ``run`` raises unless told ``--device cpu``; the
calculator and the edge set agree with the JAX package's."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pair_allegro_tpu import checkpoint as jax_ckpt
from pair_allegro_tpu.calculator import Calculator as JaxCalculator
from pair_allegro_tpu.cli import main as jax_main
from pair_allegro_tpu.debug import edge_set as jax_edge_set
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.neighbors.device import cell_list_neighbors as jax_cell_list
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch import checkpoint as ckpt
from pair_allegro_tpu_torch.calculator import Calculator
from pair_allegro_tpu_torch.cli import main
from pair_allegro_tpu_torch.debug import edge_set
from pair_allegro_tpu_torch.io.extxyz import read_extxyz, write_extxyz
from pair_allegro_tpu_torch.md import integrate
from pair_allegro_tpu_torch.models.allegro import AllegroConfig
from pair_allegro_tpu_torch.neighbors.device import (
    cell_list_neighbors,
    choose_grid,
    dense_neighbors,
    static_image_shifts,
)
from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np
from pair_allegro_tpu_torch.system import Units, fcc_lattice

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "examples" / "cu_fcc_108.xyz")
KW = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=1, num_scalar_features=8,
          num_tensor_features=4, avg_num_neighbors=12.0)


def _checkpoint(tmp_path, dtype=jnp.float64, **over):
    cfg = JaxConfig(**{**KW, **over})
    path = str(tmp_path / "model.npz")
    jax_ckpt.save_params(path, allegro_init(jax.random.PRNGKey(0), cfg, dtype=dtype), cfg,
                         family="allegro")
    return path


def _write(tmp_path, name, conf):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        yaml.dump(conf, f)
    return path


def _rows(out):
    """(header, numeric rows) of a run's thermo output."""
    lines = [ln for ln in out.splitlines() if ln.strip() and not ln.startswith("#")]
    return lines[0].split(), np.array([[float(x) for x in ln.split()] for ln in lines[1:]])


def test_thermo_matches_the_jax_cli(tmp_path, capsys):
    """The same checkpoint and start state (a JAX state file: the two
    packages draw velocities differently) through both CLIs at f64."""
    fixture = read_extxyz(FIXTURE, index=0)
    n = len(fixture["positions"])
    masses = np.full(n, 63.546)
    rng = np.random.RandomState(3)
    vel = rng.randn(n, 3) * np.sqrt(Units.kB * 200.0 / (masses[:, None] * Units.mvv2e))
    js = JaxSystem.create(fixture["positions"], np.zeros(n, np.int32), cell=fixture["cell"],
                          velocities=vel - vel.mean(0), masses=masses, dtype=jnp.float64)
    state = str(tmp_path / "start.npz")
    jax_ckpt.save_state(state, js, step=0)
    conf = {"model": {"checkpoint": _checkpoint(tmp_path, output_charges=True)},
            "restart_from": state, "integrator": "nvt", "temp_K": 100.0, "tdamp_ps": 0.05,
            "dt_fs": 2.0, "steps": 6, "log_every": 2, "skin": 0.3, "dtype": "float64",
            "computes": [{"name": "dip", "quantity": "dipole", "style": "global", "length": 3}]}
    path = _write(tmp_path, "run.yaml", conf)
    assert jax_main(["run", path]) == 0
    jhead, jrows = _rows(capsys.readouterr().out)
    assert main(["run", path, "--device", "cpu"]) == 0
    thead, trows = _rows(capsys.readouterr().out)
    assert thead == jhead and thead[-1] == "c_dip[3]" and trows.shape == jrows.shape == (3, 10)
    np.testing.assert_allclose(trows, jrows, rtol=1e-8, atol=1e-12)


def _example_copy(tmp_path, name):
    text = (ROOT / "examples" / name).read_text()
    text = re.sub(r"(?m)^steps: \d+", "steps: 5", text).replace("/tmp/", f"{tmp_path}/")
    text = text.replace("data: examples/", f"data: {ROOT}/examples/")
    return _write_text(tmp_path, name, text)


def _write_text(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("name", sorted(p.name for p in ROOT.glob("examples/*.yaml")
                                        if p.name != "train_cupd.yaml"))
def test_every_example_runs_on_the_cpu(tmp_path, capsys, name):
    path = _example_copy(tmp_path, name)
    assert main(["run", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    head, rows = _rows(out)
    assert head[:4] == ["step", "pe", "ke", "etotal"] and rows[-1, 0] == 5
    assert np.all(np.isfinite(rows)) and "steps/s" in out
    conf = yaml.safe_load(Path(path).read_text())
    if "restart" in conf:
        _, step, _, _ = ckpt.load_state(conf["restart"]["path"], device="cpu")
        assert step == 5


def test_info_prints_what_the_jax_cli_prints(tmp_path, capsys):
    model = _checkpoint(tmp_path)
    assert jax_main(["info", model]) == 0
    want = capsys.readouterr().out
    assert main(["info", model]) == 0
    got = capsys.readouterr().out
    assert got == want and "family: allegro" in got and "r_max" in got


@pytest.mark.parametrize("integrator", ["nvt", "langevin"])
def test_restart_resumes_bitwise(tmp_path, capsys, integrator):
    """Stopping at step 4 and resuming for 4 steps gives the uninterrupted
    8-step f64 run bit for bit: positions, velocities, thermostat and, for
    langevin, the noise generator's state."""
    common = {"data": FIXTURE, "model": {"checkpoint": _checkpoint(tmp_path)},
              "type_names": ["Cu"], "masses": {"Cu": 63.546}, "integrator": integrator,
              "tdamp_ps": 0.05, "damp_ps": 0.05, "dt_fs": 1.0, "temp_K": 50.0,
              "log_every": 4, "dtype": "float64"}

    def run(name, **over):
        assert main(["run", _write(tmp_path, name, {**common, **over}), "--device", "cpu"]) == 0

    run("a.yaml", steps=8, restart={"path": str(tmp_path / "a.npz")})
    run("b.yaml", steps=4, restart={"path": str(tmp_path / "b.npz")})
    run("c.yaml", steps=4, restart_from=str(tmp_path / "b.npz"),
        restart={"path": str(tmp_path / "c.npz")})
    assert "# resuming from" in capsys.readouterr().out
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "c.npz") as c:
        assert sorted(a.files) == sorted(c.files) and int(a["step"]) == int(c["step"]) == 8
        for k in a.files:
            assert np.array_equal(a[k], c[k]), k
        assert "torch_rng_state" in a.files
        assert ("thermostat/xi" in a.files) == (integrator == "nvt")


def test_computes_columns(tmp_path, capsys):
    """A global compute becomes thermo columns and a per-atom one dump
    columns; the printed dipole is sum q_i r_i of the dumped frame."""
    conf = {"data": FIXTURE, "model": {"checkpoint": _checkpoint(tmp_path, output_charges=True)},
            "type_names": ["Cu"], "masses": {"Cu": 63.546}, "integrator": "nve", "dt_fs": 1.0,
            "steps": 2, "log_every": 2, "dtype": "float64",
            "computes": [{"name": "dip", "quantity": "dipole", "style": "global", "length": 3},
                         {"name": "q", "quantity": "charges", "style": "atom", "ncols": 1}],
            "dump": {"path": str(tmp_path / "traj.dump"), "every": 2}}
    assert main(["run", _write(tmp_path, "run.yaml", conf), "--device", "cpu"]) == 0
    head, rows = _rows(capsys.readouterr().out)
    assert head[-3:] == ["c_dip[1]", "c_dip[2]", "c_dip[3]"]
    lines = (tmp_path / "traj.dump").read_text().splitlines()
    assert lines[8] == "ITEM: ATOMS id type x y z fx fy fz c_pe c_q"
    frame = np.array([[float(x) for x in ln.split()] for ln in lines[9:]])
    dip = (frame[:, -1:] * frame[:, 2:5]).sum(0)
    np.testing.assert_allclose(rows[-1, -3:], dip, rtol=2e-5)


@pytest.mark.parametrize("argv,item", [
    (["run", "CONF"], "item 9"),
    (["train", "CONF"], "item 9"),
])
def test_unported_keys_and_commands_are_refused(tmp_path, argv, item):
    conf = _write(tmp_path, "run.yaml", {"data": FIXTURE, "sharding": {"n_devices": 8}})
    with pytest.raises(NotImplementedError, match=item):
        main([conf if a == "CONF" else a for a in argv] + ["--device", "cpu"])


def test_run_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    conf = _write(tmp_path, "run.yaml", {"data": FIXTURE, "model": {"family": "allegro",
                                                                    "config": {**KW, "type_names": ["Cu"]}}})
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["run", conf])


def test_debug_dump_and_trace(tmp_path, capsys, monkeypatch):
    """PAT_LOG_LEVEL=DEBUG prints the first build's edges; profile writes
    phase times and a torch.profiler trace; compile_cache is accepted."""
    monkeypatch.setenv("PAT_LOG_LEVEL", "DEBUG")
    conf = {"data": FIXTURE, "model": {"checkpoint": _checkpoint(tmp_path)},
            "type_names": ["Cu"], "steps": 1, "compile_cache": str(tmp_path / "cache"),
            "profile": {"phases": True, "trace_dir": str(tmp_path / "trace")}}
    assert main(["run", _write(tmp_path, "run.yaml", conf), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    total = int(re.search(r"EDGES TOTAL (\d+)", out).group(1))
    assert total == out.count("\nEDGE ") + out.startswith("EDGE ") > 0
    assert "# phase force_eval_ms" in out and "# compile_cache" in out
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cli_run_shrinks_spiked_capacity(tmp_path, capsys, monkeypatch):
    """The CLI wires Simulation's shrink_fn: a K inflated by a spike-grow
    returns to the fresh estimate during ``cli run`` (500 atoms: the
    cell-list regime)."""
    pos, cell = fcc_lattice(5, a0=3.61, jitter=0.02)
    xyz = str(tmp_path / "cu500.xyz")
    write_extxyz(xyz, {"symbols": np.array(["Cu"] * len(pos)), "positions": pos, "cell": cell,
                       "pbc": (True,) * 3})
    captured = {}

    class SpikeSim(integrate.Simulation):
        def __init__(self, system, force_fn, rebuild_fn, **kw):
            eng = kw["shrink_fn"].__self__
            captured.update(eng=eng, k0=eng.spec.max_neighbors)
            rebuild_fn = kw["grow_fn"](2.0)
            captured["k_spiked"] = eng.spec.max_neighbors
            super().__init__(system, force_fn, rebuild_fn, **{**kw, "shrink_every": 1})

    monkeypatch.setattr(integrate, "Simulation", SpikeSim)
    conf = {"data": xyz, "model": {"checkpoint": _checkpoint(tmp_path, jnp.float32)},
            "type_names": ["Cu"], "masses": {"Cu": 63.546}, "steps": 2, "log_every": 1,
            "temp_K": 20.0}
    assert main(["run", _write(tmp_path, "run.yaml", conf), "--device", "cpu"]) == 0
    capsys.readouterr()
    eng = captured["eng"]
    assert eng.spec.strategy == "cell_list" and captured["k_spiked"] > captured["k0"]
    assert eng.spec.max_neighbors == captured["k0"]


def _cu(n_rep, seed=0):
    rng = np.random.RandomState(seed)
    a0 = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a0
    pos = np.concatenate([base + np.array([i, j, k]) * a0 for i in range(n_rep)
                          for j in range(n_rep) for k in range(n_rep)])
    return pos + 0.02 * rng.randn(*pos.shape), np.eye(3) * a0 * n_rep


def test_calculator_matches_jax():
    jcfg = JaxConfig(**{**KW, "num_layers": 2})
    params = allegro_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float64)
    tparams = ckpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     AllegroConfig(**{**KW, "num_layers": 2}), "cpu",
                                     torch.float64)
    calc = Calculator(AllegroConfig(**{**KW, "num_layers": 2}), tparams, dtype=torch.float64,
                      device="cpu")
    jcalc = JaxCalculator(jcfg, params, dtype=jnp.float64)
    pos, cell = _cu(2)
    out, ref = (c.calculate(pos, symbols=["Cu"] * 32, cell=cell) for c in (calc, jcalc))
    np.testing.assert_allclose(out["energy"], ref["energy"], rtol=1e-10)
    for k in ("energies", "forces", "virial", "stress"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-10, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(out["pressure_bar"], ref["pressure_bar"], rtol=1e-10)
    np.testing.assert_allclose(out["energy"], out["energies"].sum(), rtol=1e-12)
    np.testing.assert_allclose(out["forces"].sum(0), 0.0, atol=1e-9)
    with pytest.raises(KeyError, match="Zr"):
        calc.calculate(pos, symbols=["Zr"] * 32, cell=cell)


def test_calculator_cell_change_rebinds_engine():
    """A 20% compression re-bins the box: a fresh engine, whose results
    equal a cold calculator's; going back reproduces the first answer."""
    cfg = AllegroConfig(**{**KW, "num_layers": 2})
    jp = allegro_init(jax.random.PRNGKey(0), JaxConfig(**{**KW, "num_layers": 2}),
                      dtype=jnp.float64)
    params = ckpt.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float64)
    pos, cell = _cu(4)
    n = len(pos)
    calc = Calculator(cfg, params, dtype=torch.float64, device="cpu")
    out_a = calc.calculate(pos, symbols=["Cu"] * n, cell=cell)
    eng_a = calc._engine
    out_b = calc.calculate(pos * 0.8, symbols=["Cu"] * n, cell=cell * 0.8)
    assert calc._engine is not eng_a
    ref_b = Calculator(cfg, params, dtype=torch.float64, device="cpu").calculate(
        pos * 0.8, symbols=["Cu"] * n, cell=cell * 0.8)
    np.testing.assert_allclose(out_b["energy"], ref_b["energy"], rtol=1e-12)
    np.testing.assert_allclose(out_b["forces"], ref_b["forces"], atol=1e-12)
    out_a2 = calc.calculate(pos, symbols=["Cu"] * n, cell=cell)
    np.testing.assert_allclose(out_a2["energy"], out_a["energy"], rtol=1e-12)


def test_debug_edge_set_matches_jax_and_the_oracle():
    """The edge set of the port's TABLE (cell list) and FLAT (dense) builds,
    the JAX package's and the host oracle's are one set."""
    rng = np.random.RandomState(0)
    cell = np.diag([13.0, 14.0, 15.0])
    pos = rng.rand(250, 3) @ cell
    rc = 4.0
    grid = choose_grid(cell, rc)
    tpos, tcell = torch.as_tensor(pos), torch.as_tensor(cell)
    s_tab = edge_set(cell_list_neighbors(tpos, tcell, rc, grid, 64, 64))
    s_flat = edge_set(dense_neighbors(tpos, tcell, static_image_shifts(cell, (True,) * 3, rc),
                                      rc, 16384, pbc=(True,) * 3))
    s_jax = jax_edge_set(jax_cell_list(jnp.asarray(pos), jnp.asarray(cell), rc, grid, 64, 64,
                                       flatten=False))
    ei, sh = neighbor_list_np(pos, cell, (True,) * 3, rc)
    ref = {(int(ei[0, k]), int(ei[1, k]), *(int(x) for x in sh[k])) for k in range(ei.shape[1])}
    assert s_tab == s_flat == s_jax == ref
    with_r = edge_set(cell_list_neighbors(tpos, tcell, rc, grid, 64, 64), tpos, tcell)
    assert len(with_r) == len(ref) and max(e[-1] for e in with_r) <= rc
