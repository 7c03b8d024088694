"""The plain reference against the port's plain path on the CPU at f64,
both families, at a small size: the same weights tree, the reference on
its own neighbor list, the port on its engine's."""

import numpy as np
import pytest
import torch

from cells import small_cell


@pytest.mark.parametrize("family", ["allegro", "nequip"])
@pytest.mark.parametrize("n_rep", [3, 5])
def test_gpubench_reference_matches_the_port_at_f64(family, n_rep):
    import importlib

    from pair_allegro_tpu_torch.system import System

    from gpubench import harness

    wl, cf = small_cell(family, n_rep=n_rep)
    fam = importlib.import_module(f"gpubench.families.{family}")
    ref = importlib.import_module(f"gpubench.reference.{family}")
    pos, cell, types, masses, pbc = harness.lattice(wl, cf["model"]["type_names"], 11)
    system = System.create(pos, types, cell=cell, masses=masses, pbc=pbc, dtype=torch.float64,
                           device="cpu")
    tree = fam.make_tree(cf["model"], 3, "cpu", torch.float64)
    eng = fam.make_engine(fam.model_config(cf["model"]), tree, system, 0.4, "cpu")
    got = eng.force_fn(system, eng.rebuild_fn(system, None))
    want = ref.energy_forces(tree, cf["model"], system.positions, system.types, system.cell)
    scale = float(want["forces"].abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.forces.numpy(), want["forces"].numpy(), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(got.atomic_energy.numpy(), want["atomic_energy"].numpy(), rtol=0,
                               atol=1e-10 * float(want["atomic_energy"].abs().max()))


def test_gpubench_reference_neighbors_are_the_pairs_within_the_cutoff():
    from gpubench import harness
    from gpubench.reference.neighbors import pairs

    wl, cf = small_cell("allegro", n_rep=3)
    pos, cell, _, _, _ = harness.lattice(wl, cf["model"]["type_names"], 4)
    L = np.diag(cell)
    d = pos[None] - pos[:, None]
    d -= L * np.round(d / L)
    r = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(r, np.inf)
    want = np.argwhere(r < 4.5)
    i, j, image = pairs(torch.tensor(pos), torch.tensor(cell), 4.5, block=50)
    got = np.stack([i.numpy(), j.numpy()], 1)
    assert sorted(map(tuple, got)) == sorted(map(tuple, want))
    vec = pos[j.numpy()] - pos[i.numpy()] - image.numpy() * L
    assert np.linalg.norm(vec, axis=-1).max() < 4.5


def test_gpubench_reference_neighbors_leave_an_open_side_unwrapped():
    """Along a side that pbc leaves open no image is taken: a slab of 3 x 3
    x 4 cells with 8 A of vacuum above it."""
    from gpubench import harness
    from gpubench.reference.neighbors import pairs

    wl, cf = small_cell("allegro", n_rep=[3, 3, 4], pbc=[True, True, False], vacuum=8.0)
    pos, cell, _, _, pbc = harness.lattice(wl, cf["model"]["type_names"], 4)
    assert pbc == (True, True, False) and cell[2, 2] == 4 * wl["a0"] + 8.0
    L = np.diag(cell)
    d = pos[None] - pos[:, None]
    d[..., :2] -= L[:2] * np.round(d[..., :2] / L[:2])
    r = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(r, np.inf)
    want = np.argwhere(r < 4.5)
    i, j, image = pairs(torch.tensor(pos), torch.tensor(cell), 4.5, pbc, block=50)
    assert sorted(map(tuple, np.stack([i.numpy(), j.numpy()], 1))) == sorted(map(tuple, want))
    assert not image[:, 2].any()
    with pytest.raises(ValueError):  # 2 cells, periodic, are shorter than twice the cutoff
        pairs(torch.tensor(pos), torch.tensor(np.diag([2 * wl["a0"], 20.0, 20.0])), 4.5)


def test_gpubench_lattice_follows_the_cell_file():
    """One species gives every atom its type and mass; two give the exact
    counts of the composition, placed by the seed, on the same positions."""
    from gpubench import harness

    wl, _ = small_cell("allegro", n_rep=[2, 3, 4])
    pos, cell, types, masses, pbc = harness.lattice(wl, ("Cu",), 9)
    assert pos.shape == (4 * 2 * 3 * 4, 3) and pbc == (True, True, True)
    np.testing.assert_allclose(np.diag(cell), np.array([2, 3, 4]) * wl["a0"])
    assert not types.any() and (masses == wl["masses"]["Cu"]).all()
    wl.update(composition={"Cu": 3, "Ag": 1}, masses={"Cu": 63.546, "Ag": 107.8682})
    pos2, _, types2, masses2, _ = harness.lattice(wl, ("Ag", "Cu"), 9)
    np.testing.assert_array_equal(pos2, pos)
    assert (types2 == 0).sum() == 24 and (types2 == 1).sum() == 72
    np.testing.assert_array_equal(masses2, np.where(types2 == 0, 107.8682, 63.546))
    _, _, types3, _, _ = harness.lattice(wl, ("Ag", "Cu"), 10)
    assert (types3 != types2).any()
