"""The port's million-atom mode against the JAX package at f64 on the CPU:
``cell_list_neighbors`` center windows, ``AllegroEngine(row_chunk=...)``
against the unchunked engine and JAX's chunked engine (one species and
typed; the charge head with ``row_chunk=3``), the window contract of
``allegro_energy`` on every TABLE tier (two windows summed against the
full table), the engine's refusals, carried ``row_chunk`` and window
overflow, ``regrow_bytes`` under windows, ``PAT_K_MAX`` and
``System.create(pad_to=...)``.

Tolerances: the chunked engine against the unchunked one and JAX's, energy
1e-12 relative, per-atom energies 1e-12, forces 1e-11, virial 1e-10 (what
``tests/test_md.py:196, 310`` hold JAX to); the window contract 1e-10; the
neighbor windows exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.engine import AllegroEngine as JaxEngine
from pair_allegro_tpu.engine import _estimate_capacities as jax_estimate
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_energy as jax_allegro_energy
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.neighbors import device as jdev
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch import engine as teng
from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine, make_rebuild_fn
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_energy,
    allegro_params_from_numpy,
    layer_tier,
)
from pair_allegro_tpu_torch.models.nequip import (
    NequIPConfig,
    nequip_init_numpy,
    nequip_params_from_numpy,
)
from pair_allegro_tpu_torch.neighbors import device as tdev
from pair_allegro_tpu_torch.system import System, fcc_lattice

torch.set_num_threads(2)
F64 = torch.float64


def _pair(names=("Cu",), seed=0, **kw):
    """One parameter set in both packages (JAX's init, carried across)."""
    fields = dict(type_names=names, r_max=4.0, l_max=1, num_layers=1, num_scalar_features=8,
                  num_tensor_features=4, avg_num_neighbors=12.0)
    fields.update(kw)
    jcfg, tcfg = JaxConfig(**fields), AllegroConfig(**fields)
    jp = allegro_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu", dtype=F64)
    return jcfg, jp, tcfg, tp


def _systems(n_rep=5, species=1, pad_to=None, seed=1):
    pos, cell = fcc_lattice(n_rep, jitter=0.05, seed=seed)
    n = pos.shape[0]
    types = np.arange(n) % species
    masses = np.full(n, 63.546)
    js = JaxSystem.create(pos, types.astype(np.int32), cell=cell, masses=masses,
                          dtype=jnp.float64, pad_to=pad_to)
    ts = System.create(pos, types, cell=cell, masses=masses, dtype=F64, device="cpu",
                       pad_to=pad_to)
    return js, ts


def _close(a, b, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _check_outputs(out, ref):
    _close(float(out.total_energy), float(ref.total_energy), rtol=1e-12)
    _close(out.atomic_energy, ref.atomic_energy, atol=1e-12)
    _close(out.forces, ref.forces, atol=1e-11)
    _close(out.virial, ref.virial, atol=1e-10)


@pytest.mark.parametrize("typed", [False, True])
def test_cell_list_windows_equal_full_rows(typed):
    """Windows [q0, q0 + nq) of the build over one binning are the rows of
    the full build, exactly, and equal JAX's windows; a window flags
    overflow only for its own rows."""
    rng = np.random.RandomState(3)
    cell = np.diag([13.0, 14.0, 15.0])
    pos = rng.rand(300, 3) @ cell
    types = (np.arange(300) % 2).astype(np.int64)
    rc, cap, k = 4.0, 48, 64
    ct = np.array([[3.5, 4.0], [4.0, 3.0]]) if typed else None
    grid = tdev.choose_grid(cell, rc)
    p, c = torch.as_tensor(pos), torch.as_tensor(cell)
    t = torch.as_tensor(types) if typed else None
    full = tdev.cell_list_neighbors(p, c, rc, grid, cap, k, types=t, cutoff_table=ct)
    bins = tdev.build_cell_bins(p, c, rc, grid, cap, types=t)
    jargs = (jnp.asarray(pos), jnp.asarray(cell), rc, grid, cap, k)
    jkw = dict(types=jnp.asarray(types, jnp.int32), cutoff_table=ct) if typed else {}
    for q0, nq in ((0, 100), (100, 75), (175, 125)):
        win = tdev.cell_list_neighbors(p, c, rc, grid, cap, k, types=t, cutoff_table=ct,
                                       query_start=q0, n_query=nq, bins_data=bins)
        for name in ("edge_index", "edge_shifts", "edge_mask"):
            assert torch.equal(getattr(win, name), getattr(full, name)[q0:q0 + nq]), name
        jw = jdev.cell_list_neighbors(*jargs, query_start=q0, n_query=nq, flatten=False, **jkw)
        np.testing.assert_array_equal(win.edge_index.numpy(), np.asarray(jw.edge_index))
        np.testing.assert_array_equal(win.edge_shifts.numpy(), np.asarray(jw.edge_shifts))
    counts = full.edge_mask.sum(1)
    k_small = int(counts.max()) - 1
    over = [bool(tdev.cell_list_neighbors(p, c, rc, grid, cap, k_small, types=t,
                                          cutoff_table=ct, query_start=q0, n_query=25,
                                          bins_data=bins).overflow)
            for q0 in range(0, 300, 25)]
    assert over == [bool((counts[q0:q0 + 25] > k_small).any()) for q0 in range(0, 300, 25)]
    assert any(over) and not all(over)


@pytest.mark.parametrize("species", [1, 2])
def test_row_chunked_engine_matches_unchunked_and_jax(species):
    """500 atoms, row_chunk=125 (``tests/test_md.py:196, 310``): the chunked
    engine's energy, per-atom energies, forces and virial equal the
    unchunked engine's and JAX's chunked engine's; the neighbor tables are
    the same, the reverse table included."""
    names = ("Cu",) if species == 1 else ("Cu", "Ag")
    kw = dict(l_max=2, num_layers=2, num_scalar_features=16, num_tensor_features=8)
    jcfg, jp, tcfg, tp = _pair(names, **(kw if species == 1 else {}))
    js, ts = _systems(species=species)
    t0 = AllegroEngine(tcfg, tp, ts, device="cpu")
    t1 = AllegroEngine(tcfg, tp, ts, device="cpu", row_chunk=125)
    j1 = JaxEngine(jcfg, jp, js, row_chunk=125)
    assert t1.spec.strategy == "cell_list" and t1.row_chunk == 125
    n0, n1, nj = t0.rebuild_fn(ts, None), t1.rebuild_fn(ts, None), j1.rebuild_fn(js, None)
    for name in ("edge_index", "edge_shifts", "edge_mask", "edge_rev"):
        assert torch.equal(getattr(n0, name), getattr(n1, name)), name
    np.testing.assert_array_equal(n1.edge_rev.numpy(), np.asarray(nj.edge_rev))
    assert not bool(n1.overflow)
    out0, out1, outj = t0.force_fn(ts, n0), t1.force_fn(ts, n1), j1.force_fn(js, nj)
    _check_outputs(out1, out0)
    _check_outputs(out1, outj)
    _close(out1.extras["edge_energy"], out0.extras["edge_energy"], atol=1e-12)


def test_row_chunk_of_three_with_the_charge_head():
    """row_chunk=3 with the charge head: the (3,) dipole is summed over the
    windows, not stacked as per-center rows (the reference's misfire
    case); 500 atoms padded to 501 with ``pad_to`` so that 3 divides N."""
    jcfg, jp, tcfg, tp = _pair(output_charges=True)
    js, ts = _systems(pad_to=501)
    assert ts.n_atoms == 501 and int(ts.n_valid) == 500
    t0 = AllegroEngine(tcfg, tp, ts, device="cpu")
    t1 = AllegroEngine(tcfg, tp, ts, device="cpu", row_chunk=3)
    j1 = JaxEngine(jcfg, jp, js, row_chunk=3)
    out0 = t0.force_fn(ts, t0.rebuild_fn(ts, None))
    out1 = t1.force_fn(ts, t1.rebuild_fn(ts, None))
    outj = j1.force_fn(js, j1.rebuild_fn(js, None))
    _check_outputs(out1, out0)
    _check_outputs(out1, outj)
    assert out1.extras["dipole"].shape == (3,) and out1.extras["charges"].shape == (501,)
    for o in (out0, outj):
        _close(out1.extras["dipole"], o.extras["dipole"], atol=1e-10)
        _close(out1.extras["charges"], o.extras["charges"], atol=1e-12)
    assert float(out1.extras["charges"][500]) == 0.0 and float(out1.atomic_energy[500]) == 0.0


TIERS = {
    "k1": ({}, {}),
    "k1-embed": ({}, {"PAT_L1_EMBED": "1"}),
    "k1-nopos": ({}, {"PAT_L1_POSITIONAL": "0"}),
    "perlayer": (dict(layer_fused=False), {}),
    "perlayer-mxu_highest": (dict(layer_fused=False, tp_mode="mxu_highest"), {}),
    "stack": (dict(fused_stack=True), {}),
    "plain": (dict(fused_tp=False), {}),
    "k4": (dict(num_tensor_features=4), {}),  # too narrow for K1: K4 on the table
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_window_contract_on_every_table_tier(tier, monkeypatch):
    """``allegro_energy`` on two windows of centers (``center_offset``,
    ``num_centers``, the window's atom_mask), summed, against the full
    table and against JAX's two windows (``tests/test_stack_fused.py:670``'s
    contract), energy and forces, with the charge head; per-center outputs
    have the window's rows."""
    fields, env = TIERS[tier]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    fields = dict(num_scalar_features=16, num_tensor_features=8) | fields
    jcfg, jp, tcfg, tp = _pair(("Cu", "Ag"), l_max=2, num_layers=3, output_charges=True,
                               **fields)
    js, ts = _systems(species=2)
    eng = AllegroEngine(tcfg, tp, ts, device="cpu")
    nb = eng.rebuild_fn(ts, None)
    want = tier.split("-")[0] if tier.startswith("perlayer") else tier
    assert layer_tier(tcfg, False, dtype=F64, card=False) == want
    n = ts.n_atoms
    windows = ((0, 200), (200, n - 200))
    am = ts.valid_mask()

    def run(pos, whole):
        if whole:
            return allegro_energy(tp, tcfg, pos, ts.types, nb.edge_index, cell=ts.cell,
                                  edge_shifts=nb.edge_shifts, atom_mask=am,
                                  edge_mask=nb.edge_mask)
        outs = [allegro_energy(tp, tcfg, pos, ts.types, nb.edge_index[q0:q0 + nq],
                               cell=ts.cell, edge_shifts=nb.edge_shifts[q0:q0 + nq],
                               atom_mask=am[q0:q0 + nq], edge_mask=nb.edge_mask[q0:q0 + nq],
                               center_offset=q0, num_centers=nq) for q0, nq in windows]
        for (q0, nq), o in zip(windows, outs):
            assert o["atomic_energy"].shape == (nq,) and o["edge_energy"].shape[0] == nq
        return {"total_energy": sum(o["total_energy"] for o in outs),
                "atomic_energy": torch.cat([o["atomic_energy"] for o in outs]),
                "charges": torch.cat([o["charges"] for o in outs]),
                "dipole": sum(o["dipole"] for o in outs)}

    res = {}
    for whole in (True, False):
        pos = ts.positions.clone().requires_grad_(True)
        out = run(pos, whole)
        (g,) = torch.autograd.grad(out["total_energy"], pos)
        res[whole] = {k: v.detach() for k, v in out.items()} | {"grad": g}
    for key in ("total_energy", "atomic_energy", "charges", "dipole", "grad"):
        _close(res[False][key], res[True][key], atol=1e-10)

    def jax_windows(p):
        tot, outs = 0.0, []
        for q0, nq in windows:
            o = jax_allegro_energy(
                jp, jcfg, p, js.types, jnp.asarray(nb.edge_index[q0:q0 + nq].numpy()),
                cell=js.cell, edge_shifts=jnp.asarray(nb.edge_shifts[q0:q0 + nq].numpy()),
                atom_mask=jnp.asarray(am[q0:q0 + nq].numpy()),
                edge_mask=jnp.asarray(nb.edge_mask[q0:q0 + nq].numpy()),
                center_offset=q0, num_centers=nq)
            tot = tot + o["total_energy"]
            outs.append(o)
        return tot, outs

    (e_j, outs_j), g_j = jax.value_and_grad(jax_windows, has_aux=True)(js.positions)
    _close(float(res[False]["total_energy"]), float(e_j), rtol=1e-10)
    _close(res[False]["grad"], g_j, atol=1e-10)
    _close(res[False]["charges"], np.concatenate([np.asarray(o["charges"]) for o in outs_j]),
           atol=1e-10)


def test_engine_refusals_and_carried_row_chunk():
    """row_chunk needs the cell-list strategy and a divisor of N; NequIP
    refuses it; grow and maybe_shrink keep the windows."""
    jcfg, jp, tcfg, tp = _pair()
    _, small = _systems(n_rep=3)  # 108 atoms: the dense strategy
    with pytest.raises(ValueError, match="cell-list"):
        AllegroEngine(tcfg, tp, small, device="cpu", row_chunk=54)
    _, ts = _systems()
    with pytest.raises(ValueError, match="not divisible"):
        AllegroEngine(tcfg, tp, ts, device="cpu", row_chunk=300)
    ncfg = NequIPConfig(type_names=("Cu",), r_max=4.0, num_layers=1, num_features=8)
    npar = nequip_params_from_numpy(nequip_init_numpy(ncfg), ncfg, device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="locality"):
        NequIPEngine(ncfg, npar, ts, device="cpu", row_chunk=125)
    eng = AllegroEngine(tcfg, tp, ts, device="cpu", row_chunk=125)
    ref = AllegroEngine(tcfg, tp, ts, device="cpu")
    for e in (eng, ref):
        e.grow(system=ts)
    assert eng.spec == ref.spec and eng.row_chunk == 125
    n1, n0 = eng.rebuild_fn(ts, None), ref.rebuild_fn(ts, None)
    assert torch.equal(n1.edge_index, n0.edge_index) and torch.equal(n1.edge_rev, n0.edge_rev)
    _check_outputs(eng.force_fn(ts, n1), ref.force_fn(ts, n0))
    assert eng.maybe_shrink(ts) is not None and eng.row_chunk == 125
    n1 = eng.rebuild_fn(ts, None)
    assert n1.edge_index.shape == (500, eng.spec.max_neighbors)


def test_overflow_of_one_window_reaches_the_table():
    """A capacity that only some windows exceed flags the whole table, so a
    Simulation regrows."""
    _, _, tcfg, tp = _pair()
    rng = np.random.RandomState(2)
    cell = np.eye(3) * 17.0
    ts = System.create(rng.rand(500, 3) @ cell, np.zeros(500), cell=cell, dtype=F64,
                       device="cpu")  # a gas: the per-row counts spread
    eng = AllegroEngine(tcfg, tp, ts, device="cpu", row_chunk=25)
    full = eng.rebuild_fn(ts, None)
    counts = full.edge_mask.sum(1)
    k_small = int(counts.max()) - 1
    per_window = [(counts[q0:q0 + 25] > k_small).any() for q0 in range(0, 500, 25)]
    assert any(per_window) and not all(per_window)
    spec = dataclasses.replace(eng.spec, max_neighbors=k_small, max_edges=500 * k_small)
    assert bool(make_rebuild_fn(spec, 0.0, 25)(ts, None).overflow)


def test_regrow_bytes_count_one_window_and_the_full_tables():
    """Under row_chunk the model's per-edge estimate covers one window's
    slots; the full-size tables are counted besides (index, reverse table,
    mask, shifts, the edge vectors and their cotangent, and the typed
    model's neighbor-type column)."""
    for names in (("Cu",), ("Cu", "Ag")):
        _, _, tcfg, _ = _pair(names)
        _, ts = _systems()
        spec = teng.NeighborSpec(strategy="cell_list", cutoff=4.0, max_edges=500 * 48,
                                 grid=(4, 4, 4), cell_capacity=20, max_neighbors=48)
        per = tcfg.live_bytes_per_edge(dtype=F64)
        tables = 8 + 8 + 1 + 9 * 8 + (8 if len(names) > 1 else 0)
        assert teng.regrow_bytes(spec, ts, tcfg, 125) == 125 * 48 * per + 500 * 48 * tables
        assert teng.regrow_bytes(spec, ts, tcfg) == 500 * 48 * per


def test_k_max_from_the_environment(monkeypatch):
    """PAT_K_MAX forces the cell list's K, as in the JAX engine."""
    js, ts = _systems()
    default = teng._estimate_capacities(ts, 4.0, 0.0, 1.25).max_neighbors
    assert default == jax_estimate(js, 4.0, 0.0, 1.25).max_neighbors != 40
    monkeypatch.setenv("PAT_K_MAX", "40")
    spec = teng._estimate_capacities(ts, 4.0, 0.0, 1.25)
    jspec = jax_estimate(js, 4.0, 0.0, 1.25)
    assert spec.max_neighbors == jspec.max_neighbors == 40
    assert spec.max_edges == jspec.max_edges == 500 * 40


def test_pad_to_pads_with_masked_atoms():
    """``tests/test_computes.py:153``'s case: six atoms padded to eight are
    the JAX package's padding (parked far away, masked, type 0, unit mass,
    at rest), and a per-atom compute zeroes the padded rows."""
    from pair_allegro_tpu_torch.computes import PerAtomCompute
    from pair_allegro_tpu_torch.potential import ModelOutputs

    rng = np.random.RandomState(0)
    pos = rng.rand(6, 3) * 4
    ts = System.create(pos, np.zeros(6, np.int64), cell=np.eye(3) * 4, dtype=F64,
                       device="cpu", pad_to=8)
    js = JaxSystem.create(pos, np.zeros(6, np.int32), cell=np.eye(3) * 4, dtype=jnp.float64,
                          pad_to=8)
    for name in ("positions", "velocities", "types", "masses", "cell", "valid"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    assert ts.n_atoms == 8 and int(ts.n_valid) == 6
    q = ts.positions[:, 0] * 0.1
    out = ModelOutputs(total_energy=torch.zeros((), dtype=F64),
                       atomic_energy=torch.zeros(8, dtype=F64),
                       forces=torch.zeros(8, 3, dtype=F64), virial=torch.zeros(3, 3, dtype=F64),
                       extras={"dipole": ts.positions * q[:, None]})
    arr = PerAtomCompute("dipole", 3)(out, ts).numpy()
    assert arr.shape == (8, 3) and np.all(arr[6:] == 0.0)
    np.testing.assert_allclose(arr[:6], pos * (pos[:, [0]] * 0.1), rtol=1e-12)
    assert System.create(pos, np.zeros(6), device="cpu", pad_to=4).n_atoms == 6
