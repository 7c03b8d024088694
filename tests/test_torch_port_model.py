"""The port's Allegro model + potential against the JAX package at f64 on a
500-atom FCC cell (the cell list needs N > 256): total and per-atom energy,
forces, virial, charges and dipole, with one species and with two (the
typed build and envelope), through each package's own engine.  The JAX side
runs its plain CPU path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.engine import AllegroEngine as JaxEngine
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch.engine import AllegroEngine
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_params_from_numpy
from pair_allegro_tpu_torch.potential import virial_to_voigt
from pair_allegro_tpu_torch.system import System, fcc_lattice

torch.set_num_threads(2)

CASES = {
    "one_species": dict(type_names=("Cu",), num_layers=3),
    "two_species": dict(type_names=("Cu", "Ag"), num_layers=2,
                        per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0))),
}


def _setup(case):
    kw = dict(r_max=4.5, l_max=2, num_scalar_features=16, num_tensor_features=8,
              avg_num_neighbors=12.0, output_charges=True, **CASES[case])
    jcfg, tcfg = JaxConfig(**kw), AllegroConfig(**kw)
    jp = allegro_init(jax.random.PRNGKey(1), jcfg, dtype=jnp.float64)
    # non-trivial per-type scale/shift
    nt = jcfg.num_types
    jp["per_type_scale"] = jnp.linspace(0.8, 1.3, nt)
    jp["per_type_shift"] = jnp.linspace(-0.2, 0.4, nt)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                                   dtype=torch.float64)
    pos, cell = fcc_lattice(5, jitter=0.08, seed=11)
    n = pos.shape[0]
    types = np.random.RandomState(2).randint(0, nt, n)
    masses = np.where(types == 0, 63.546, 107.87)
    return jcfg, jp, tcfg, tp, pos, cell, types, masses


@pytest.mark.parametrize("case", list(CASES))
def test_energy_forces_virial_charges_match_jax(case):
    jcfg, jp, tcfg, tp, pos, cell, types, masses = _setup(case)
    js = JaxSystem.create(pos, types, cell=cell, masses=masses, dtype=jnp.float64)
    je = JaxEngine(jcfg, jp, js)
    jo = je.force_fn(js, je.rebuild_fn(js, None))

    ts = System.create(pos, types, cell=cell, masses=masses, dtype=torch.float64, device="cpu")
    te = AllegroEngine(tcfg, tp, ts, device="cpu")
    assert te.spec.max_neighbors == je.spec.max_neighbors
    assert (te.spec.cutoff_table is None) == (je.spec.cutoff_table is None)
    to = te.force_fn(ts, te.rebuild_fn(ts, None))

    def close(a, b, name):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(np.asarray(a) - b).max()) / scale
        assert err <= 1e-10, f"{name}: relative error {err:.3e}"

    close(float(to.total_energy), float(jo.total_energy), "total_energy")
    close(to.atomic_energy.numpy(), jo.atomic_energy, "atomic_energy")
    close(to.forces.numpy(), jo.forces, "forces")
    close(to.virial.numpy(), jo.virial, "virial")
    close(virial_to_voigt(to.virial).numpy(), np.asarray(jo.virial)[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]],
          "voigt")
    close(to.extras["charges"].numpy(), jo.extras["charges"], "charges")
    close(to.extras["dipole"].numpy(), jo.extras["dipole"], "dipole")


def test_engine_helpers_match_jax():
    import pair_allegro_tpu.engine as je
    import pair_allegro_tpu_torch.engine as te

    assert [te._round_k(k) for k in range(1, 600)] == [je._round_k(k) for k in range(1, 600)]
    for case in CASES.values():
        kw = dict(r_max=4.5, **case)
        a = te.typed_cutoff_table(AllegroConfig(**kw), 0.4)
        b = je.typed_cutoff_table(JaxConfig(**kw), 0.4)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    tm, jm = te.TypeMapper(("Cu", "Ag")), je.TypeMapper(("Cu", "Ag"))
    np.testing.assert_array_equal(tm.map_names(["Ag", "Cu", "Ag"]), jm.map_names(["Ag", "Cu", "Ag"]))
    with pytest.raises(KeyError):
        tm.map_names(["Au"])
