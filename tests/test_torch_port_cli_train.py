"""The port's ``cli train`` and ``cli import`` against the JAX package's, in
process on the CPU: ``train`` at f64 with SGD, an EMA and a virial term,
from the same JAX-written checkpoint and a generated dataset, writes JAX's
.npz to 1e-9 and prints JAX's epoch lines (numbers to 1e-9); ``import`` of
the torch twin's Lightning checkpoint, of a TorchScript package whose
metadata fills the config, and ``--lenient`` with a missing key write JAX's
keys, dtypes and values; the imported .npz runs under ``cli run``;
``sharding:`` and a missing GPU are refused."""

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
from pair_allegro_tpu.torch_ref import build_torch_allegro, save_lightning_checkpoint
from pair_allegro_tpu_torch import checkpoint as ckpt
from pair_allegro_tpu_torch.cli import main
from pair_allegro_tpu_torch.io.extxyz import write_extxyz
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_energy
from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import fcc_lattice
from test_torch_port_import import _canonical_pth, _torchscript

torch.set_num_threads(2)
KW = dict(type_names=("Cu", "Ag"), r_max=3.5, l_max=1, num_layers=2, num_scalar_features=8,
          num_tensor_features=4, two_body_mlp_width=8, allegro_mlp_hidden_layers_width=8,
          readout_mlp_hidden_layers_width=8, avg_num_neighbors=10.0, remat=False)


def _write(tmp_path, name, conf):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path


def _dataset(tmp_path, n=10):
    """``n`` 32-atom frames labelled by a teacher (the port's plain path at
    f64), energy, forces and a quoted virial."""
    cfg = AllegroConfig(**KW).for_training()
    tree = jax.tree.map(np.asarray, allegro_init(jax.random.PRNGKey(9), JaxConfig(**KW),
                                                  dtype=jnp.float64))
    params = ckpt.params_from_numpy(tree, cfg, device="cpu", dtype=torch.float64)
    pot = make_potential(lambda *a, **k: allegro_energy(params, cfg, *a, **k))
    rng = np.random.RandomState(0)
    frames = []
    for i in range(n):
        pos, cell = fcc_lattice(2, jitter=0.1, seed=i)
        types = rng.randint(0, 2, len(pos))
        ei, sh = neighbor_list_np(pos, cell, (True,) * 3, cfg.r_max)
        out = pot(torch.tensor(pos), torch.tensor(types), torch.tensor(ei, dtype=torch.int64),
                  cell=torch.tensor(cell), edge_shifts=torch.tensor(sh))
        virial = " ".join(f"{x:.17g}" for x in out.virial.numpy().reshape(-1))
        frames.append({"symbols": np.asarray(cfg.type_names)[types], "positions": pos,
                       "cell": cell, "pbc": (True,) * 3, "forces": out.forces.numpy(),
                       "info": {"energy": f"{float(out.total_energy):.17g}",
                                "virial": f'"{virial}"'}})
    path = str(tmp_path / "frames.xyz")
    write_extxyz(path, frames)
    return path


def _numbers(text):
    return [[float(x) for x in re.findall(r"[-+]?\d\.\d+e[-+]\d+", line)]
            for line in text.splitlines() if line.startswith("epoch")]


def test_cli_train_follows_jax(tmp_path, capsys):
    model = str(tmp_path / "start.npz")
    jcfg = JaxConfig(**KW)
    student = jax.tree.map(lambda x: x * 1.05, allegro_init(jax.random.PRNGKey(9), jcfg,
                                                            dtype=jnp.float64))
    jax_ckpt.save_params(model, student, jcfg, family="allegro")
    base = {"model": {"checkpoint": model}, "dataset": _dataset(tmp_path), "val_fraction": 0.2,
            "loss": {"energy": 1.0, "force": 1.0, "virial": 0.5},
            "optimizer": {"name": "sgd", "lr": 0.05}, "ema_decay": 0.5, "batch_size": 4,
            "epochs": 3, "log_every": 1, "seed": 3, "dtype": "float64"}
    texts, outs = [], []
    for name, run, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.npz")
        conf = _write(tmp_path, f"{name}.yaml", dict(base, out=out))
        assert run(["train", conf, *extra]) == 0
        texts.append(capsys.readouterr().out)
        outs.append(out)
    want, got = _numbers(texts[0]), _numbers(texts[1])
    assert len(got) == 3 and len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert "# training allegro: 8 train / 2 val frames, batch 4, 3 epochs" in texts[1]
    (wp, wcfg, wfam), (gp, gcfg, gfam) = jax_ckpt.load_params(outs[0]), ckpt.load_params(outs[1])
    assert gcfg == wcfg and gfam == wfam == "allegro"
    want, got = jax_ckpt._flatten(wp), ckpt.flatten(gp)
    assert set(got) == set(want)
    moved = False
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12, err_msg=k)
        moved |= not np.allclose(got[k], jax_ckpt._flatten(student)[k], rtol=1e-6)
    assert moved


def _twin_ckpt(tmp_path):
    cfg = JaxConfig(type_names=("Cu", "O"), r_max=3.8, l_max=2, num_layers=2,
                    num_scalar_features=8, num_tensor_features=8, two_body_mlp_width=8,
                    allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
                    avg_num_neighbors=9.0)
    path = str(tmp_path / "last.ckpt")
    save_lightning_checkpoint(build_torch_allegro(cfg, dtype=torch.float64, seed=3), path)
    conf = {k: getattr(cfg, k) for k in ("r_max", "l_max", "num_layers", "num_scalar_features",
                                         "num_tensor_features", "two_body_mlp_width",
                                         "allegro_mlp_hidden_layers_width",
                                         "readout_mlp_hidden_layers_width", "avg_num_neighbors")}
    return path, {"family": "allegro", "config": dict(conf, type_names=["Cu", "O"])}


def _small_conf(key_map, **drop):
    conf = {"l_max": 1, "num_layers": 2, "num_scalar_features": 8, "num_tensor_features": 4,
            "r_max": 3.5, "type_names": ["A", "B"]}
    return {"family": "allegro", "config": {k: v for k, v in conf.items() if k not in drop},
            "key_map": key_map}


SOURCES = {
    "lightning-upstream": lambda tmp_path: (*_twin_ckpt(tmp_path), []),
    "torchscript-metadata": lambda tmp_path: (
        _torchscript(tmp_path)[0], _small_conf(None, r_max=0, type_names=0), []),
    "lenient-missing-key": lambda tmp_path: (
        _canonical_pth(tmp_path, drop=("per_type_scale",))[0], _small_conf(None), ["--lenient"]),
}


@pytest.mark.parametrize("source", list(SOURCES))
def test_cli_import_equals_jax(tmp_path, source, capsys):
    path, mconf, extra = SOURCES[source](tmp_path)
    mpath = _write(tmp_path, "model.yaml", mconf)
    outs, texts = [], []
    for name, run in (("jax", jax_main), ("port", main)):
        out = str(tmp_path / f"{name}.npz")
        assert run(["import", path, mpath, out, *extra]) == 0
        texts.append(capsys.readouterr().out)
        outs.append(out)
    with np.load(outs[0]) as w, np.load(outs[1]) as g:
        assert sorted(w.files) == sorted(g.files)
        for k in w.files:  # the config's JSON and the family too
            assert g[k].dtype == w[k].dtype, k
            if k != "per_type_scale" or not extra:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    gcfg = ckpt.load_params(outs[1])[1]
    assert texts[1].splitlines()[:-1] == texts[0].splitlines()[:-1]  # the last names the path
    if extra:
        assert "#   missing: per_type_scale" in texts[1]
    if source == "torchscript-metadata":
        assert gcfg["r_max"] == 3.5 and tuple(gcfg["per_edge_type_cutoff"][0]) == (3.5, 3.0)


def test_cli_imported_checkpoint_runs(tmp_path, capsys):
    """tests/test_torch_parity.py's ``import`` then ``run`` (3 NVE steps at
    f64), both through the port's CLI on the CPU."""
    path, mconf = _twin_ckpt(tmp_path)
    npz = str(tmp_path / "model.npz")
    assert main(["import", path, _write(tmp_path, "model.yaml", mconf), npz]) == 0
    pos, cell = fcc_lattice(2, a0=4.0, jitter=0.1)
    xyz = str(tmp_path / "s.xyz")
    write_extxyz(xyz, {"positions": pos, "symbols": np.asarray(["Cu", "O"] * 16), "cell": cell,
                       "pbc": (True,) * 3})
    conf = {"data": xyz, "model": {"checkpoint": npz}, "type_names": ["Cu", "O"],
            "masses": {"Cu": 63.5, "O": 16.0}, "integrator": "nve", "dt_fs": 0.5, "steps": 3,
            "log_every": 1, "dtype": "float64", "temp_K": 10.0}
    assert main(["run", _write(tmp_path, "run.yaml", conf), "--device", "cpu"]) == 0
    assert "steps/s" in capsys.readouterr().out


def test_cli_train_refuses_sharding_and_a_missing_gpu(tmp_path):
    """A data-parallel batch the devices do not divide is refused before
    anything is loaded (``sharding:`` itself runs since it was ported); so
    is the default device without a GPU."""
    conf = _write(tmp_path, "train.yaml", {"model": {"checkpoint": "x.npz"}, "dataset": "x.xyz",
                                           "batch_size": 4, "sharding": {"n_devices": 8}})
    with pytest.raises(SystemExit, match="must divide n_devices 8"):
        main(["train", conf, "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    conf = _write(tmp_path, "train2.yaml", {"model": {"checkpoint": "x.npz"}, "dataset": "x.xyz"})
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", conf])
