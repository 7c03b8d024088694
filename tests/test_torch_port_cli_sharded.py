"""The port's CLI with ``sharding:`` against the JAX CLI on its 8 virtual
CPU devices, in-process at f64 on the CPU (``--device cpu``: the port's
shards share the CPU): counterparts of ``tests/test_cli_calculator.py:182,
236, 264`` (``run`` replicated, halo and sharded NequIP), each started from
one JAX-written state so that both CLIs integrate the same system, and
``cli train`` data-parallel.

Thermo rows and trained trees equal JAX's to 1e-8 / 1e-9 relative.  The
JAX CLI writes a sharded run's dumps and restarts in the sorted order; the
port writes them with the atoms in their original order (the halo mode's
positions wrapped into the box), so they are held to an unsharded run of
the port: every column to 1e-9, positions modulo the cell."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pair_allegro_tpu import checkpoint as jax_ckpt
from pair_allegro_tpu.cli import main as jax_main
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxNequIPConfig
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch import checkpoint as ckpt
from pair_allegro_tpu_torch.cli import main
from pair_allegro_tpu_torch.system import Units, fcc_lattice
from test_torch_port_cli_train import _dataset, _numbers
from test_torch_port_cli_train import KW as TRAIN_KW

torch.set_num_threads(2)
KW = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=1, num_scalar_features=8,
          num_tensor_features=4, avg_num_neighbors=12.0)


def _write(tmp_path, name, conf):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        yaml.dump(conf, f)
    return path


def _rows(out):
    lines = [ln for ln in out.splitlines() if ln.strip() and not ln.startswith("#")]
    return lines[0].split(), np.array([[float(x) for x in ln.split()] for ln in lines[1:]])


def _start(tmp_path, n_rep, family="allegro", **over):
    """(model checkpoint, state file) written by the JAX package: n_rep^3
    FCC cells of Cu at 200 K."""
    pos, cell = fcc_lattice(n_rep, jitter=0.02, seed=0)
    n = len(pos)
    masses = np.full(n, 63.546)
    vel = np.random.RandomState(3).randn(n, 3) * np.sqrt(
        Units.kB * 200.0 / (masses[:, None] * Units.mvv2e))
    js = JaxSystem.create(pos, np.zeros(n, np.int32), cell=cell, velocities=vel - vel.mean(0),
                          masses=masses, dtype=jnp.float64)
    state = str(tmp_path / "start.npz")
    jax_ckpt.save_state(state, js, step=0)
    model = str(tmp_path / "model.npz")
    if family == "nequip":
        cfg = JaxNequIPConfig(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=2,
                              num_features=8, avg_num_neighbors=12.0, **over)
        jax_ckpt.save_params(model, nequip_init(jax.random.PRNGKey(0), cfg, dtype=jnp.float64),
                             cfg, family="nequip")
    else:
        cfg = JaxConfig(**{**KW, **over})
        jax_ckpt.save_params(model, allegro_init(jax.random.PRNGKey(0), cfg, dtype=jnp.float64),
                             cfg, family="allegro")
    return model, state


def _both(tmp_path, capsys, conf):
    """Run one config through the JAX CLI and the port's; their thermo."""
    path = _write(tmp_path, "run.yaml", conf)
    assert jax_main(["run", path]) == 0
    want = _rows(capsys.readouterr().out)
    assert main(["run", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    return want, _rows(out), out


def _read_dump(path):
    """{step: (N, columns) array sorted by id} of a dump file."""
    lines = open(path).read().splitlines()
    frames, k = {}, 0
    while k < len(lines):
        step = int(lines[k + 1])
        n = int(lines[k + 3])
        body = k + 9 if lines[k + 4].startswith("ITEM: BOX BOUNDS") else k + 8
        rows = np.array([[float(x) for x in ln.split()] for ln in lines[body:body + n]])
        frames[step] = rows[np.argsort(rows[:, 0])]
        k = body + n
    return frames


def _mod_cell(d, cell):
    """Displacements d (N, 3) with whole lattice vectors taken out."""
    frac = d @ np.linalg.inv(cell)
    return (frac - np.round(frac)) @ cell


def test_cli_sharded_run(tmp_path, capsys):
    """``sharding: {n_devices: 8}`` (replicated, the dense strategy at 108
    atoms): thermo equal to the JAX CLI's; the dump and the restart carry
    the atoms in their original order, equal to an unsharded run's."""
    model, state = _start(tmp_path, 3, output_charges=True)
    conf = {"model": {"checkpoint": model}, "restart_from": state, "integrator": "nvt",
            "temp_K": 100.0, "tdamp_ps": 0.05, "dt_fs": 2.0, "steps": 4, "log_every": 2,
            "skin": 0.3, "dtype": "float64", "sharding": {"n_devices": 8},
            "dump": {"path": str(tmp_path / "s.dump"), "every": 2},
            "restart": {"path": str(tmp_path / "s.npz")},
            "computes": [{"name": "q", "quantity": "charges", "style": "atom", "ncols": 1}]}
    (jhead, jrows), (head, rows), out = _both(tmp_path, capsys, conf)
    assert head == jhead and rows.shape == jrows.shape == (2, 7)
    np.testing.assert_allclose(rows, jrows, rtol=1e-8, atol=1e-12)
    assert "# sharding: replicated, 8 shards" in out
    plain = dict(conf, dump={"path": str(tmp_path / "p.dump"), "every": 2},
                 restart={"path": str(tmp_path / "p.npz")})
    del plain["sharding"]
    assert main(["run", _write(tmp_path, "plain.yaml", plain), "--device", "cpu"]) == 0
    capsys.readouterr()
    sd, pd = _read_dump(tmp_path / "s.dump"), _read_dump(tmp_path / "p.dump")
    assert sorted(sd) == sorted(pd) == [2, 4]
    for step in sd:
        np.testing.assert_allclose(sd[step], pd[step], rtol=1e-9, atol=1e-9)
    (ss, s_step, s_th, _), (ps, p_step, p_th, _) = (
        ckpt.load_state(str(tmp_path / f), device="cpu") for f in ("s.npz", "p.npz"))
    assert s_step == p_step == 4 and ss.n_atoms == ps.n_atoms == 108
    for name in ("positions", "velocities", "types", "masses"):
        np.testing.assert_allclose(getattr(ss, name).numpy(), getattr(ps, name).numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    for k in p_th:
        np.testing.assert_allclose(float(s_th[k]), float(p_th[k]), rtol=1e-9)


def test_cli_halo_sharded_run(tmp_path, capsys):
    """``sharding: {n_devices: 8, mode: halo}`` on 500 atoms: thermo equal
    to the JAX CLI's; the restart in the original order, its positions the
    unsharded run's modulo the cell (the halo mode wraps them)."""
    model, state = _start(tmp_path, 5)
    conf = {"model": {"checkpoint": model}, "restart_from": state, "integrator": "nve",
            "dt_fs": 2.0, "steps": 4, "log_every": 2, "skin": 0.3, "dtype": "float64",
            "sharding": {"n_devices": 8, "mode": "halo"},
            "restart": {"path": str(tmp_path / "h.npz")}}
    (jhead, jrows), (head, rows), out = _both(tmp_path, capsys, conf)
    assert head == jhead and rows.shape == jrows.shape == (2, 7)
    np.testing.assert_allclose(rows, jrows, rtol=1e-8, atol=1e-12)
    assert "# sharding: halo, 8 shards" in out
    plain = dict(conf, restart={"path": str(tmp_path / "p.npz")})
    del plain["sharding"]
    assert main(["run", _write(tmp_path, "plain.yaml", plain), "--device", "cpu"]) == 0
    capsys.readouterr()
    hs, _, _, _ = ckpt.load_state(str(tmp_path / "h.npz"), device="cpu")
    ps, _, _, _ = ckpt.load_state(str(tmp_path / "p.npz"), device="cpu")
    cell = ps.cell.numpy()
    np.testing.assert_allclose(_mod_cell(hs.positions.numpy() - ps.positions.numpy(), cell), 0.0,
                               atol=1e-9)
    np.testing.assert_allclose(hs.velocities.numpy(), ps.velocities.numpy(), atol=1e-9)


def test_cli_sharded_nequip_run(tmp_path, capsys):
    """Sharded NequIP through the CLI (which the upstream pair style refuses
    on more than one rank): thermo equal to the JAX CLI's; halo on NequIP
    is refused as JAX refuses it."""
    model, state = _start(tmp_path, 5, family="nequip")
    conf = {"model": {"checkpoint": model}, "restart_from": state, "integrator": "nve",
            "dt_fs": 2.0, "steps": 2, "log_every": 2, "dtype": "float64",
            "sharding": {"n_devices": 8}}
    (jhead, jrows), (head, rows), _ = _both(tmp_path, capsys, conf)
    assert head == jhead and rows.shape == jrows.shape == (1, 7)
    np.testing.assert_allclose(rows, jrows, rtol=1e-8, atol=1e-12)
    halo = _write(tmp_path, "halo.yaml", dict(conf, sharding={"n_devices": 8, "mode": "halo"}))
    with pytest.raises(SystemExit, match="strict locality"):
        main(["run", halo, "--device", "cpu"])


def test_cli_train_data_parallel_follows_jax(tmp_path, capsys):
    """``cli train`` with ``sharding: {n_devices: 2}`` (each batch's frames
    split over 2 devices): its epoch numbers and trained tree equal the JAX
    CLI's with the same key, and the unsharded port run's."""
    model = str(tmp_path / "start.npz")
    jcfg = JaxConfig(**TRAIN_KW)
    student = jax.tree.map(lambda x: x * 1.05, allegro_init(jax.random.PRNGKey(9), jcfg,
                                                            dtype=jnp.float64))
    jax_ckpt.save_params(model, student, jcfg, family="allegro")
    base = {"model": {"checkpoint": model}, "dataset": _dataset(tmp_path, n=6),
            "val_fraction": 0.34, "optimizer": {"name": "adam", "lr": 0.01}, "batch_size": 2,
            "epochs": 2, "log_every": 1, "seed": 3, "dtype": "float64"}
    runs = (("jax", jax_main, [], {"n_devices": 2}), ("port", main, ["--device", "cpu"],
                                                      {"n_devices": 2}),
            ("plain", main, ["--device", "cpu"], None))
    texts, trees = [], []
    for name, run, extra, sharding in runs:
        conf = dict(base, out=str(tmp_path / f"{name}.npz"))
        if sharding:
            conf["sharding"] = sharding
        assert run(["train", _write(tmp_path, f"{name}.yaml", conf), *extra]) == 0
        texts.append(capsys.readouterr().out)
        trees.append(str(tmp_path / f"{name}.npz"))
    want, got, plain = (_numbers(t) for t in texts)
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(got, plain, rtol=1e-9)
    assert "DP over 2 devices" in texts[1]
    ref = jax_ckpt._flatten(jax_ckpt.load_params(trees[0])[0])
    for path in trees[1:]:
        tree = ckpt.flatten(ckpt.load_params(path)[0])
        assert set(tree) == set(ref)
        for k in ref:
            np.testing.assert_allclose(tree[k], ref[k], rtol=1e-9, atol=1e-12, err_msg=k)
    bad = _write(tmp_path, "bad.yaml", dict(base, batch_size=3, sharding={"n_devices": 2}))
    with pytest.raises(SystemExit, match="must divide"):
        main(["train", bad, "--device", "cpu"])
    assert re.search(r"training allegro: \d+ train", texts[1])
