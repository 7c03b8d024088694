"""The port's ``AllegroConfig`` against the JAX package's: every field of
the JAX config, with its default, so that the config dict a JAX checkpoint
carries (``checkpoint.save_params`` writes ``dataclasses.asdict(cfg)``)
builds the port's config, ``interior="bf16"`` included."""

import dataclasses
import json

import numpy as np
import pytest

from pair_allegro_tpu.checkpoint import load_params, save_params
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_init_numpy,
    allegro_params_from_numpy,
    check_supported,
)


def test_fields_and_defaults_match_jax():
    want = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(AllegroConfig)}
    assert got == want


def test_jax_checkpoint_config_builds_the_port_config(tmp_path):
    """A config written by JAX's save_params and read back by its
    load_params builds the port's config, whose params convert."""
    jcfg = JaxConfig(type_names=("Cu", "O"), r_max=4.0, l_max=1, num_layers=2,
                     num_scalar_features=8, num_tensor_features=4,
                     per_edge_type_cutoff=((4.0, 3.5), (3.5, 3.0)))
    path = str(tmp_path / "model.npz")
    save_params(path, {"w": np.zeros(2)}, jcfg)
    _, cfg_dict, family = load_params(path)
    assert family == "AllegroConfig" and cfg_dict["interior"] == "working"
    cfg = AllegroConfig(**cfg_dict)
    # JSON keeps the nested cutoff tuples as lists: compare in that form
    assert json.dumps(dataclasses.asdict(cfg), sort_keys=True) == json.dumps(
        dataclasses.asdict(jcfg), sort_keys=True)
    check_supported(cfg)
    params = allegro_params_from_numpy(allegro_init_numpy(cfg), cfg, device="cpu")
    assert len(params["layers"]) == 2


def test_interior_bf16_is_not_ported():
    """interior="bf16" (refused until the bf16 tier was ported; the name is
    kept) builds, converts a tree and runs on the CPU: a 32-atom box on
    every tier gives finite f32 energies and forces."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.system import System, fcc_lattice

    pos, cell = fcc_lattice(2)
    for tier in (dict(), dict(layer_fused=False), dict(fused_tp=False), dict(fused_stack=True)):
        cfg = AllegroConfig(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=2,
                            num_scalar_features=8, num_tensor_features=8, interior="bf16", **tier)
        check_supported(cfg)
        params = allegro_params_from_numpy(allegro_init_numpy(cfg), cfg, device="cpu")
        assert all(t.dtype == torch.float32 for t in params["per_type_scale"].reshape(1))
        system = System.create(pos, np.zeros(len(pos), np.int64), cell=cell, device="cpu")
        eng = AllegroEngine(cfg, params, system, device="cpu")
        out = eng.force_fn(system, eng.rebuild_fn(system, None))
        assert out.forces.dtype == torch.float32 and out.total_energy.dtype == torch.float32
        assert torch.isfinite(out.forces).all() and torch.isfinite(out.total_energy)


def test_unknown_interior_is_refused():
    with pytest.raises(ValueError, match="interior"):
        check_supported(AllegroConfig(type_names=("Cu",), r_max=4.5, interior="fp8"))


def test_remat_true_names_its_roadmap_item():
    """remat (ROADMAP queue 1, item 2) is ported: True is taken, and an
    unresolved "auto" means on in the model, as in JAX."""
    from pair_allegro_tpu_torch.models.allegro import remat_on

    for remat in (True, False, "auto"):
        cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, remat=remat)
        check_supported(cfg)
        assert remat_on(cfg) == (remat is not False)
