"""The port's checkpoint import (``pair_allegro_tpu_torch.import_torch``)
against the JAX package's: checkpoints written by the JAX package's torch
twin (``torch_ref``) and by hand (canonical names, Lightning-style with
``model.`` prefixes, dotted names and (out, in) weights, the ``upstream``
and ``e3nn`` presets for Allegro and NequIP, a TorchScript package with
metadata) import to JAX's tree exactly, as float32, key for key; strict
mode raises on a missing key and ``--lenient`` lists it; the key-map
proposal and the ``--inspect`` report give JAX's text; the imported models'
energies and forces match the torch twin's at f64 to the tolerances of the
JAX package's own tests, also through the engine."""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pair_allegro_tpu.checkpoint import _flatten as jax_flatten
from pair_allegro_tpu.cli import main as jax_main
from pair_allegro_tpu.import_torch import import_allegro_checkpoint as jax_import_allegro
from pair_allegro_tpu.import_torch import import_nequip_checkpoint as jax_import_nequip
from pair_allegro_tpu.import_torch import inspect_state_dict as jax_inspect
from pair_allegro_tpu.import_torch import propose_key_map as jax_propose
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxAllegroConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxNequIPConfig
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.torch_ref import (
    build_torch_allegro,
    build_torch_nequip,
    save_e3nn_style_checkpoint,
    save_e3nn_style_nequip_checkpoint,
    save_lightning_checkpoint,
    torch_forces,
)
from pair_allegro_tpu_torch import checkpoint as ckpt
from pair_allegro_tpu_torch import import_torch as imp
from pair_allegro_tpu_torch.cli import main
from pair_allegro_tpu_torch.engine import AllegroEngine
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_energy
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, nequip_energy
from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import System

torch.set_num_threads(2)

# tests/test_torch_parity.py's configs: every Linear square somewhere
AKW = dict(type_names=("Cu", "O"), r_max=3.8, l_max=2, num_layers=2, num_scalar_features=8,
           num_tensor_features=8, two_body_mlp_width=8, allegro_mlp_hidden_layers_width=8,
           readout_mlp_hidden_layers_width=8, avg_num_neighbors=9.0)
NKW = dict(type_names=("Cu", "O"), r_max=3.8, l_max=1, num_layers=2, num_features=8,
           radial_mlp_width=8, avg_num_neighbors=9.0)
SMALL = dict(type_names=("A", "B"), r_max=3.5, l_max=1, num_layers=2, num_scalar_features=8,
             num_tensor_features=4)  # tests/test_import.py's


def _structure(rng, n=12, a=5.5):
    return rng.rand(n, 3) * a, rng.randint(0, 2, n), np.eye(3) * a


def _twin(family, parity, seed=3):
    """(JAX cfg, port cfg, torch twin at f64 with non-trivial shifts and scales)."""
    if family == "allegro":
        jcfg, cfg = JaxAllegroConfig(**AKW), AllegroConfig(**AKW)
        model = build_torch_allegro(jcfg, dtype=torch.float64, seed=seed)
    else:
        kw = dict(NKW, parity=parity)
        jcfg, cfg = JaxNequIPConfig(**kw), NequIPConfig(**kw)
        model = build_torch_nequip(jcfg, dtype=torch.float64, seed=seed)
    with torch.no_grad():
        model.per_type_energy_shifts.copy_(torch.tensor([-3.1, 0.7], dtype=torch.float64))
        model.per_type_energy_scales.copy_(torch.tensor([1.3, 0.8], dtype=torch.float64))
    return jcfg, cfg, model


def _canonical_pth(tmp_path, drop=()):
    """tests/test_import.py: a .pth of the canonical flat names."""
    jcfg = JaxAllegroConfig(**SMALL)
    flat = jax_flatten(jax.tree.map(np.asarray, allegro_init(jax.random.PRNGKey(4), jcfg)))
    path = str(tmp_path / "weights.pth")
    torch.save({k: torch.tensor(v) for k, v in flat.items() if k not in drop}, path)
    return path, jcfg, AllegroConfig(**SMALL), None


def _lightning_renamed(tmp_path):
    """tests/test_import.py: {'state_dict': {'model.' + foreign}}, 2-D
    weights in (out, in), and a key_map of the renames."""
    jcfg = JaxAllegroConfig(**SMALL)
    flat = jax_flatten(jax.tree.map(np.asarray, allegro_init(jax.random.PRNGKey(5), jcfg)))
    sd, key_map = {}, {}
    for k, v in flat.items():
        foreign = "net." + k.replace("/", ".")
        key_map[k] = foreign
        sd["model." + foreign] = torch.tensor(v.T if v.ndim == 2 else v)
    path = str(tmp_path / "last.ckpt")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    return path, jcfg, AllegroConfig(**SMALL), key_map


def _twin_ckpt(family, parity, e3nn):
    def make(tmp_path):
        jcfg, cfg, model = _twin(family, parity)
        path = str(tmp_path / "last.ckpt")
        if not e3nn:
            save_lightning_checkpoint(model, path)
        elif family == "allegro":
            save_e3nn_style_checkpoint(model, jcfg, path)
        else:
            save_e3nn_style_nequip_checkpoint(model, jcfg, path)
        return path, jcfg, cfg, "e3nn" if e3nn else "upstream"

    return make


def _ts_container(flat_named: dict):
    """A scriptable module tree holding the dotted-name parameters (a
    stand-in for a compiled model archive, as tests/test_import.py's)."""
    root = torch.nn.Module()
    for name, arr in flat_named.items():
        parts = name.split(".")
        mod = root
        for p in parts[:-1]:
            if not hasattr(mod, p):
                setattr(mod, p, torch.nn.Module())
            mod = getattr(mod, p)
        mod.register_parameter(parts[-1],
                               torch.nn.Parameter(torch.tensor(np.ascontiguousarray(arr))))
    root.forward = lambda: torch.zeros(1)
    return root


def _torchscript(tmp_path):
    jcfg = JaxAllegroConfig(**SMALL)
    flat = jax_flatten(jax.tree.map(np.asarray, allegro_init(jax.random.PRNGKey(7), jcfg)))
    scripted = torch.jit.trace(_ts_container(
        {"model." + k.replace("/", "."): v for k, v in flat.items()}), ())
    path = str(tmp_path / "model.nequip.pth")
    torch.jit.save(scripted, path, _extra_files={
        "r_max": "3.5", "type_names": "A B", "num_types": "2",
        "per_edge_type_cutoff": "3.5 3.0 3.0 2.5"})
    return path, jcfg, AllegroConfig(**SMALL), None


SOURCES = {
    "canonical": _canonical_pth,
    "lightning-renamed": _lightning_renamed,
    "allegro-upstream": _twin_ckpt("allegro", False, False),
    "allegro-e3nn": _twin_ckpt("allegro", False, True),
    "nequip-upstream": _twin_ckpt("nequip", False, False),
    "nequip-parity-upstream": _twin_ckpt("nequip", True, False),
    "nequip-e3nn": _twin_ckpt("nequip", False, True),
    "nequip-parity-e3nn": _twin_ckpt("nequip", True, True),
    "torchscript": _torchscript,
}


def _imports(cfg):
    if isinstance(cfg, NequIPConfig):
        return jax_import_nequip, imp.import_nequip_checkpoint
    return jax_import_allegro, imp.import_allegro_checkpoint


@pytest.mark.parametrize("source", list(SOURCES))
def test_import_equals_jax(tmp_path, source):
    path, jcfg, cfg, key_map = SOURCES[source](tmp_path)
    jax_import, port_import = _imports(cfg)
    want, jmissing = jax_import(path, jcfg, key_map=key_map)
    got, missing = port_import(path, cfg, key_map=key_map)
    assert missing == jmissing == []
    want, got = jax_flatten(want), ckpt.flatten(got)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_strict_raises_and_lenient_lists_the_missing_key(tmp_path):
    path, jcfg, cfg, _ = _canonical_pth(tmp_path, drop=("per_type_shift",))
    with pytest.raises(KeyError, match="per_type_shift"):
        imp.import_allegro_checkpoint(path, cfg, strict=True)
    got, missing = imp.import_allegro_checkpoint(path, cfg, strict=False)
    want, jmissing = jax_import_allegro(path, jcfg, strict=False)
    assert missing == jmissing == ["per_type_shift"]
    want, got = jax_flatten(want), ckpt.flatten(got)
    for k in want:
        if k != "per_type_shift":  # the init value: numpy's draw, not jax.random's
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torchscript_metadata(tmp_path):
    path, _, _, _ = _torchscript(tmp_path)
    assert imp._is_torchscript(path)
    sd, meta = imp.load_torchscript_artifact(path)
    assert meta["r_max"] == "3.5" and "per_type_shift" in sd
    kw = imp.config_kwargs_from_metadata(meta)
    assert kw == {"r_max": 3.5, "type_names": ("A", "B"),
                  "per_edge_type_cutoff": ((3.5, 3.0), (3.0, 2.5))}
    assert not imp._is_torchscript(_canonical_pth(tmp_path)[0])


def _energy_forces(family, cfg, tree, pos, types, cell):
    """Energy and forces of the port's plain path at f64 on the CPU."""
    params = ckpt.params_from_numpy(tree, cfg, device="cpu", dtype=torch.float64)
    energy = allegro_energy if family == "allegro" else nequip_energy
    ei, sh = neighbor_list_np(pos, cell, (True,) * 3, cfg.r_max)
    out = make_potential(lambda *a, **k: energy(params, cfg, *a, **k))(
        torch.tensor(pos), torch.tensor(types), torch.tensor(ei, dtype=torch.int64),
        cell=torch.tensor(cell), edge_shifts=torch.tensor(sh))
    return float(out.total_energy), out.forces.numpy()


def _twin_forces(model, pos, types, cell, r_max):
    ei, sh = neighbor_list_np(pos, cell, (True,) * 3, r_max)
    e, f = torch_forces(model, torch.tensor(pos), torch.tensor(types, dtype=torch.long),
                        torch.tensor(ei, dtype=torch.long), cell=torch.tensor(cell),
                        edge_shifts=torch.tensor(sh, dtype=torch.float64))
    return float(e), f.numpy()


@pytest.mark.parametrize("source", ["allegro-upstream", "allegro-e3nn", "nequip-upstream",
                                    "nequip-parity-upstream", "nequip-parity-e3nn"])
def test_imported_forces_match_the_torch_twin(tmp_path, source, rng):
    """f64 import: energy to 1e-10 and forces to 1e-8 (Allegro) or 1e-9
    (NequIP), tests/test_torch_parity.py's tolerances."""
    family = source.split("-")[0]
    path, jcfg, cfg, key_map = SOURCES[source](tmp_path)
    tree, missing = _imports(cfg)[1](path, cfg, key_map=key_map, dtype=np.float64)
    assert not missing
    _, _, model = _twin(family, cfg.parity)
    pos, types, cell = _structure(rng, n=10)
    e, f = _energy_forces(family, cfg, tree, pos, types, cell)
    e_t, f_t = _twin_forces(model, pos, types, cell, cfg.r_max)
    np.testing.assert_allclose(e, e_t, atol=1e-10)
    np.testing.assert_allclose(f, f_t, atol=1e-8 if family == "allegro" else 1e-9)


def test_imported_checkpoint_runs_in_the_engine(tmp_path, rng):
    """tests/test_torch_parity.py's engine leg: the imported tree saved as
    .npz, loaded by the port and run by AllegroEngine on the CPU at f64."""
    path, jcfg, cfg, key_map = SOURCES["allegro-upstream"](tmp_path)
    tree, _ = imp.import_allegro_checkpoint(path, cfg, key_map=key_map, dtype=np.float64)
    npz = str(tmp_path / "model.npz")
    ckpt.save_params(npz, tree, cfg, family="allegro")
    cfg2, params, family = ckpt.load_model(npz, "cpu", torch.float64)
    assert cfg2 == cfg and family == "allegro"
    pos, types, cell = _structure(rng, n=16)
    system = System.create(pos, types, cell=cell, dtype=torch.float64, device="cpu")
    eng = AllegroEngine(cfg2, params, system, device="cpu")
    out = eng.force_fn(system, eng.rebuild_fn(system, None))
    e_t, f_t = _twin_forces(_twin("allegro", False)[2], pos, types, cell, cfg.r_max)
    np.testing.assert_allclose(float(out.total_energy), e_t, atol=1e-9)
    np.testing.assert_allclose(out.forces.numpy()[:len(pos)], f_t, atol=1e-8)


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_proposal_and_inspect_equal_jax(tmp_path, family, capsys):
    """propose_key_map and inspect_state_dict give JAX's results on the
    twin's Lightning checkpoint, and ``import --inspect`` prints JAX's text
    and writes nothing."""
    jcfg, cfg, model = _twin(family, family == "nequip")
    path = str(tmp_path / "last.ckpt")
    save_lightning_checkpoint(model, path)
    sd = imp.load_torch_state_dict(path)
    if family == "allegro":
        jtemplate = allegro_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        template = imp.template(cfg)
    else:
        jtemplate = nequip_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        template = imp.template(cfg)
    assert imp.propose_key_map(sd, template) == jax_propose(sd, jtemplate)
    assert imp.inspect_state_dict(sd, template) == jax_inspect(sd, jtemplate)
    report = imp.inspect_state_dict(sd, template)
    assert "proposed key map" in report and ("tp_mix" in report or "self_interaction" in report)
    mconf = {"family": family, "config": {k: list(v) if isinstance(v, tuple) else v
                                          for k, v in (AKW if family == "allegro" else
                                                       dict(NKW, parity=True)).items()}}
    mpath = str(tmp_path / "model.yaml")
    with open(mpath, "w") as f:
        yaml.safe_dump(mconf, f)
    texts = []
    for run in (jax_main, main):
        assert run(["import", path, mpath, "--inspect"]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and "source checkpoint:" in texts[1]
    assert not list(tmp_path.glob("*.npz"))
