"""Checkpoints and state files cross between the packages at f64: a JAX
``save_params`` (Allegro with charges, NequIP) loads in the port and gives
the JAX energy and forces to 1e-10 relative, a port ``save_params`` does
the same in JAX, an Allegro checkpoint without ``parity`` gets it from its
mix rows, and state files read back in both directions."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu import checkpoint as jax_ckpt
from pair_allegro_tpu.engine import AllegroEngine as JaxAllegroEngine
from pair_allegro_tpu.engine import NequIPEngine as JaxNequIPEngine
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxAllegroConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxNequIPConfig
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch import checkpoint as ckpt
from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine
from pair_allegro_tpu_torch.io.extxyz import read_extxyz
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_init_numpy
from pair_allegro_tpu_torch.system import System

torch.set_num_threads(2)
ALLEGRO = dict(type_names=("Cu",), r_max=4.0, l_max=2, num_layers=2, num_scalar_features=16,
               num_tensor_features=8, avg_num_neighbors=12.0, output_charges=True)
NEQUIP = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=2, num_features=8,
              avg_num_neighbors=12.0, parity=True)


def _fixture():
    fr = read_extxyz("examples/cu_fcc_108.xyz", index=0)
    return fr["positions"], fr["cell"]


def _jax_out(family, cfg, params):
    pos, cell = _fixture()
    n = len(pos)
    js = JaxSystem.create(pos, np.zeros(n, np.int32), cell=cell, dtype=jnp.float64)
    eng = (JaxAllegroEngine if family == "allegro" else JaxNequIPEngine)(cfg, params, js)
    o = eng.force_fn(js, eng.rebuild_fn(js, None))
    return float(o.total_energy), np.asarray(o.forces)


def _port_out(family, cfg, params):
    pos, cell = _fixture()
    ts = System.create(pos, np.zeros(len(pos), np.int64), cell=cell, dtype=torch.float64,
                       device="cpu")
    eng = (AllegroEngine if family == "allegro" else NequIPEngine)(cfg, params, ts, device="cpu")
    o = eng.force_fn(ts, eng.rebuild_fn(ts, None))
    return float(o.total_energy), o.forces.numpy(), o.extras


def _agree(a, b):
    np.testing.assert_allclose(a[0], b[0], rtol=1e-10)
    f_ref = np.asarray(b[1])
    assert np.max(np.abs(a[1] - f_ref)) <= 1e-10 * np.max(np.abs(f_ref))


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, family):
    if family == "allegro":
        cfg = JaxAllegroConfig(**ALLEGRO)
        params = allegro_init(jax.random.PRNGKey(1), cfg, dtype=jnp.float64)
    else:
        cfg = JaxNequIPConfig(**NEQUIP)
        params = nequip_init(jax.random.PRNGKey(1), cfg, dtype=jnp.float64)
    path = str(tmp_path / "model.npz")
    jax_ckpt.save_params(path, params, cfg, family=family)
    tcfg, tparams, tfamily = ckpt.load_model(path, device="cpu", dtype=torch.float64)
    assert tfamily == family and dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    got = _port_out(family, tcfg, tparams)
    _agree(got, _jax_out(family, cfg, params))
    if family == "allegro":
        assert "charges" in got[2] and "dipole" in got[2]


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = AllegroConfig(**ALLEGRO)
    params = ckpt.params_from_numpy(allegro_init_numpy(cfg, 4), cfg, "cpu", torch.float64)
    path = str(tmp_path / "model.npz")
    ckpt.save_params(path, params, cfg, family="allegro")
    tree, cfg_dict, family = jax_ckpt.load_params(path)
    jcfg = jax_ckpt.make_config(cfg_dict, family, params=tree)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
    _agree(_port_out("allegro", cfg, params), _jax_out("allegro", jcfg, jparams))
    # the same keys and config JSON as the JAX package writes for this tree
    jpath = str(tmp_path / "jax.npz")
    jax_ckpt.save_params(jpath, tree, jcfg, family="allegro")
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(str(a["__config_json__"])) == json.loads(str(b["__config_json__"]))


@pytest.mark.parametrize("parity", [True, False])
def test_parity_inferred_from_mix_rows(tmp_path, parity):
    cfg = AllegroConfig(**{**ALLEGRO, "parity": parity})
    cfg_dict = dataclasses.asdict(cfg)
    del cfg_dict["parity"]
    path = str(tmp_path / "old.npz")
    np.savez(path, **ckpt.flatten(allegro_init_numpy(cfg)),
             __config_json__=np.asarray(json.dumps(cfg_dict)), __family__=np.asarray("allegro"))
    tree, loaded, family = ckpt.load_params(path)
    assert "parity" not in loaded
    assert ckpt.make_config(loaded, family, params=tree).parity is parity
    assert jax_ckpt.make_config(dict(loaded), family, params=tree).parity is parity


def _state_system(rng):
    pos, cell = _fixture()
    n = len(pos)
    return pos, cell, rng.randn(n, 3), np.full(n, 63.546)


def test_state_files_cross_both_ways(tmp_path):
    rng = np.random.RandomState(5)
    pos, cell, vel, masses = _state_system(rng)
    n = len(pos)
    thermo = {"xi": 0.25, "xi_int": -1.5}
    # port -> JAX: no rng_key, so JAX keeps its own key
    ts = System.create(pos, np.zeros(n, np.int64), cell=cell, velocities=vel, masses=masses,
                       dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(7)
    p_port = str(tmp_path / "port.npz")
    ckpt.save_state(p_port, ts, step=12, rng_state=gen.get_state(),
                    thermostat={k: torch.tensor(v, dtype=torch.float64) for k, v in thermo.items()})
    js, step, th, key = jax_ckpt.load_state(p_port, dtype=jnp.float64)
    assert step == 12 and key is None
    np.testing.assert_array_equal(np.asarray(js.positions), pos)
    np.testing.assert_array_equal(np.asarray(js.velocities), vel)
    np.testing.assert_array_equal(np.asarray(js.types), 0)
    assert {k: float(v) for k, v in th.items()} == thermo and js.pbc == (True,) * 3
    # the port continues its own generator exactly
    _, _, _, rng_state = ckpt.load_state(p_port, device="cpu")
    cont, from_jax = ckpt.generator_from_rng(rng_state, "cpu")
    assert not from_jax
    assert torch.equal(torch.randn(5, generator=cont), torch.randn(5, generator=gen))
    # JAX -> port: the key seeds the port's generator, the same way every time
    jsys = JaxSystem.create(pos, np.zeros(n, np.int32), cell=cell, velocities=vel,
                            masses=masses, dtype=jnp.float64)
    p_jax = str(tmp_path / "jax.npz")
    jax_ckpt.save_state(p_jax, jsys, step=3, thermostat={"xi": np.float64(0.5)},
                        rng_key=np.asarray(jax.random.PRNGKey(9)))
    sys_t, step, th, rng_key = ckpt.load_state(p_jax, device="cpu")
    assert step == 3 and float(th["xi"]) == 0.5 and isinstance(rng_key, np.ndarray)
    np.testing.assert_array_equal(sys_t.positions.numpy(), pos)
    np.testing.assert_array_equal(sys_t.masses.numpy(), masses)
    assert sys_t.types.dtype == torch.int64 and bool(sys_t.valid_mask().all())
    (g1, f1), (g2, _) = (ckpt.generator_from_rng(rng_key, "cpu") for _ in range(2))
    assert f1 and torch.equal(torch.randn(4, generator=g1), torch.randn(4, generator=g2))
    other, _ = ckpt.generator_from_rng(np.asarray(jax.random.PRNGKey(10)), "cpu")
    assert not torch.equal(torch.randn(4, generator=other),
                           torch.randn(4, generator=ckpt.generator_from_rng(rng_key, "cpu")[0]))


def test_generator_state_of_another_device_type_is_refused():
    with pytest.raises(ValueError, match="device type"):
        ckpt.generator_from_rng(torch.zeros(16, dtype=torch.uint8), "cpu")
