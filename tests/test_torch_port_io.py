"""The port's structure I/O, dump writer and config reader against the JAX
package's: extxyz and LAMMPS-data round trips, files crossing both ways
(the same text written, the same arrays read), the dump's text identical
byte for byte, and the YAML-subset reader equal to ``yaml.safe_load``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pair_allegro_tpu.io import dump as jax_dump
from pair_allegro_tpu.io import extxyz as jax_xyz
from pair_allegro_tpu.io import lammps_data as jax_lmp
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch.io.config import load_config, parse_config
from pair_allegro_tpu_torch.io.dump import DumpWriter
from pair_allegro_tpu_torch.io.extxyz import read_extxyz, write_extxyz
from pair_allegro_tpu_torch.io.lammps_data import read_lammps_data, write_lammps_data
from pair_allegro_tpu_torch.system import System

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(ROOT.glob("examples/*.yaml"))


def _frame(rng, n=7):
    cell = np.diag([5.0, 6.0, 7.0])
    cell[1, 0] = 0.3
    return {
        "symbols": np.asarray(["Cu", "O", "Cu", "H", "H", "O", "Cu"][:n]),
        "positions": rng.rand(n, 3) * 5,
        "cell": cell,
        "pbc": (True, True, False),
        "forces": rng.randn(n, 3),
        "charges": rng.randn(n),
        "info": {"energy": "-1.25"},
    }


def _same_frame(a, b):
    assert list(a["symbols"]) == list(b["symbols"]) and a["pbc"] == b["pbc"]
    assert a["info"] == b["info"]
    for k in ("positions", "cell", "forces", "charges"):
        if k in a or k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_extxyz_roundtrip(tmp_path):
    frame = _frame(np.random.RandomState(0))
    p = str(tmp_path / "t.xyz")
    write_extxyz(p, [frame, frame])
    frames = read_extxyz(p)
    assert len(frames) == 2
    back = frames[1]
    for k in ("positions", "cell", "forces", "charges"):
        np.testing.assert_allclose(back[k], frame[k], atol=1e-10)
    assert back["pbc"] == (True, True, False) and float(back["info"]["energy"]) == -1.25
    assert list(back["symbols"]) == list(frame["symbols"])


@pytest.mark.parametrize("name", ["cu_fcc_108.xyz", "ho_box.xyz", "made"])
def test_extxyz_crosses_both_ways(tmp_path, name):
    """The port reads what JAX reads, writes the same text, and each reads
    the other's file to the same arrays."""
    if name == "made":
        src = str(tmp_path / "made.xyz")
        jax_xyz.write_extxyz(src, _frame(np.random.RandomState(1)))
    else:
        src = str(ROOT / "examples" / name)
    fr_t, fr_j = read_extxyz(src, index=0), jax_xyz.read_extxyz(src, index=0)
    _same_frame(fr_t, fr_j)
    pt, pj = tmp_path / "port.xyz", tmp_path / "jax.xyz"
    write_extxyz(str(pt), fr_t)
    jax_xyz.write_extxyz(str(pj), fr_j)
    assert pt.read_text() == pj.read_text()
    _same_frame(jax_xyz.read_extxyz(str(pt), index=0), fr_j)
    _same_frame(read_extxyz(str(pj), index=0), fr_t)


def test_lammps_data_crosses_both_ways(tmp_path):
    rng = np.random.RandomState(2)
    pos = rng.rand(9, 3) * 4
    types = rng.randint(0, 3, 9)
    cell = np.array([[4.0, 0, 0], [0.5, 5.0, 0], [-0.25, 0.1, 6.0]])
    vel = rng.randn(9, 3)
    masses = {0: 1.0, 1: 12.0, 2: 63.5}
    pt, pj = str(tmp_path / "port.lmp"), str(tmp_path / "jax.lmp")
    write_lammps_data(pt, pos, types, cell, masses_by_type=masses, velocities=vel)
    jax_lmp.write_lammps_data(pj, pos, types, cell, masses_by_type=masses, velocities=vel)
    back = read_lammps_data(pt)
    np.testing.assert_allclose(back["positions"], pos, atol=1e-10)
    np.testing.assert_array_equal(back["types"], types)
    np.testing.assert_allclose(back["cell"], cell, atol=1e-10)
    np.testing.assert_allclose(back["velocities"], vel, atol=1e-10)
    assert back["masses_by_type"][2] == 63.5 and back["n_types"] == 3
    for port_file in (pt, pj):  # each package reads either file to the same arrays
        a, b = read_lammps_data(port_file), jax_lmp.read_lammps_data(port_file)
        for k in ("positions", "types", "cell", "origin", "velocities"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["masses_by_type"] == b["masses_by_type"] and a["n_types"] == b["n_types"]
    # the texts differ only in the title line
    assert Path(pt).read_text().splitlines()[1:] == Path(pj).read_text().splitlines()[1:]
    with pytest.raises(ValueError, match="LAMMPS-form"):
        write_lammps_data(pt, pos, types, cell.T)


@pytest.mark.parametrize("triclinic", [False, True])
def test_dump_text_identical_to_jax(tmp_path, triclinic):
    rng = np.random.RandomState(3)
    n = 6
    pos = rng.rand(n, 3) * 4
    cell = np.eye(3) * 4.0
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = 0.4, -0.3, 0.25
    types = rng.randint(0, 2, n)
    forces, pe = rng.randn(n, 3), rng.randn(n)
    extras = {"q": rng.randn(n), "mu": rng.randn(n, 3)}
    ts = System.create(pos, types, cell=cell, dtype=torch.float64, device="cpu")
    js = JaxSystem.create(pos, types.astype(np.int32), cell=cell, dtype=jnp.float64)
    pt, pj = tmp_path / "port.dump", tmp_path / "jax.dump"
    with DumpWriter(str(pt)) as dw:
        dw.write_frame(0, ts, forces=torch.as_tensor(forces), atomic_energy=torch.as_tensor(pe),
                       extras={k: torch.as_tensor(v) for k, v in extras.items()})
        dw.write_frame(20, ts)
    with jax_dump.DumpWriter(str(pj)) as dw:
        dw.write_frame(0, js, forces=forces, atomic_energy=pe, extras=extras)
        dw.write_frame(20, js)
    text = pt.read_text()
    assert text == pj.read_text()
    assert ("xy xz yz" in text) == triclinic
    assert "fx fy fz c_pe c_q c_mu[1] c_mu[2] c_mu[3]" in text


def _gen_configs():
    """Configs as the tests of this suite write them (yaml.dump, block
    style, keys sorted) and with the keys in written order."""
    conf = {
        "data": "/tmp/some dir/cu.xyz", "model": {"checkpoint": "/tmp/m.npz"},
        "type_names": ["Cu"], "masses": {"Cu": 63.546}, "integrator": "nvt",
        "tdamp_ps": 0.05, "dt_fs": 1.0, "steps": 8, "temp_K": 50.0, "log_every": 4,
        "dtype": "float64", "bulk_modulus_bar": 1.4e6, "skin": 0, "on": "yes",
        "computes": [{"name": "dip", "quantity": "dipole", "style": "global", "length": 3},
                     {"name": "q", "quantity": "charges", "style": "atom", "ncols": 1}],
        "dump": {"path": "traj.dump", "every": 2}, "restart": {"path": "s.npz", "every": 0},
        "profile": {"phases": True, "trace_dir": None}, "label": "it's #1: a test",
        "nested": [[1, 2.5], [], {}, [{"a": [None, True, -3]}]],
    }
    return [yaml.dump(conf), yaml.safe_dump(conf, sort_keys=False),
            yaml.dump(conf, default_flow_style=None)]


@pytest.mark.parametrize("which", [p.name for p in EXAMPLES] + ["gen0", "gen1", "gen2"])
def test_config_reader_equals_safe_load(which):
    if which.startswith("gen"):
        text = _gen_configs()[int(which[3:])]
    else:
        text = (ROOT / "examples" / which).read_text()
        assert load_config(str(ROOT / "examples" / which)) == yaml.safe_load(text)
    assert parse_config(text) == yaml.safe_load(text)


SCALARS = """
a: 0x1F
b: 017
c: 1_000
d: .5
e: 1e3
f: 1.0e+3
g: -.inf
h: 1:30
i: 'single ''q'''
j: "esc \\t \\u00e9"
k: [1, 'two', "three", {x: 1, y: [a, b], z: }]
l:
  - - 1
    - 2
  - k: v
    k2:
      - z
m: ~
n:
o: Off
p: http://x.org/a#b  # a comment
"""


def test_config_scalars_and_nesting():
    assert parse_config(SCALARS) == yaml.safe_load(SCALARS)
    assert parse_config("") is None and parse_config("# only a comment\n") is None


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 2\nc: *x\n", 2),
    ("a: |\n  text\n", 1),
    ("a: 1\n---\nb: 2\n", 2),
    ("a: !!str 1\n", 1),
    ("a:\n  b: 1\n c: 2\n", 3),
    ("a: [1,\n  2]\n", 1),
    ("a: 2001-12-14\n", 1),
    ("a: -\n", 1),
    ("a: - 1\n", 1),
    ("a: ? b\n", 1),
    ("a: ?\n", 1),
    ("a:\n  - b: - 1\n", 2),
    ("a: [- 1]\n", 1),
    ("a: {b: - 1}\n", 1),
    ("a: =\n", 1),
    ("type_names: - Cu\n", 1),
])
def test_config_refuses_constructs_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f"config line {line}:"):
        parse_config(text)
    if text in YAML_REFUSES:  # outside YAML itself, not only outside the subset
        with pytest.raises(yaml.YAMLError):
            yaml.safe_load(text)


# the cases above that PyYAML refuses too (the others are YAML the subset omits)
YAML_REFUSES = {"a: -\n", "a: - 1\n", "a: ? b\n", "a: ?\n", "a:\n  - b: - 1\n", "a: [- 1]\n",
                "a: {b: - 1}\n", "a: =\n", "type_names: - Cu\n"}


def test_cli_run_refuses_a_config_the_jax_cli_refuses(tmp_path):
    """examples/cu_nve.yaml with ``type_names: - Cu``: both CLIs refuse it
    while reading the config, before any model runs."""
    from pair_allegro_tpu.cli import main as jax_main
    from pair_allegro_tpu_torch.cli import main as torch_main

    text = (ROOT / "examples" / "cu_nve.yaml").read_text()
    bad = [ln if not ln.startswith("type_names:") else "type_names: - Cu" for ln in text.splitlines()]
    assert bad != text.splitlines()
    path = tmp_path / "bad.yaml"
    path.write_text("\n".join(bad) + "\n")
    with pytest.raises(yaml.YAMLError, match="sequence entries are not allowed here"):
        jax_main(["run", str(path)])
    with pytest.raises(ValueError, match="config line [0-9]+: '- Cu'"):
        torch_main(["run", str(path), "--device", "cpu"])
