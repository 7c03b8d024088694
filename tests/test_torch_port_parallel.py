"""The port's replicated multi-device engines (``parallel/mesh.py``,
``parallel/sharded.py``), ``nequip_energy(mesh=)`` and data-parallel
training (``data.shard_batch``) against the JAX package's on its 8 virtual
CPU devices, at f64 on the CPU: the port's meshes put all shards on the
CPU (``make_mesh(devices="cpu")``), as JAX's virtual devices share it.

Counterparts of ``tests/test_sharded.py`` (replicated Allegro on the
dense and cell-list strategies, S = 2 and 8, with and without
``row_chunk``, skin > 0; extras; NVE steps; the prepared permutation;
sharded NequIP) and ``tests/test_training.py:263`` (data-parallel
gradients), on frames this file writes.

Tolerances: energy 1e-12 relative, per-atom energies and charges 1e-12,
forces 1e-11, virial and dipole 1e-10 (what ``tests/test_sharded.py``
holds JAX to); the permutation and the edge sets exact; gradients 1e-10
relative to each leaf's largest entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.data import load_frames as jax_load_frames
from pair_allegro_tpu.data import shard_batch as jax_shard_batch
from pair_allegro_tpu.data import stack_frames as jax_stack_frames
from pair_allegro_tpu.debug import edge_set as jax_edge_set
from pair_allegro_tpu.engine import NequIPEngine as JaxNequIPEngine
from pair_allegro_tpu.md.integrate import Simulation as JaxSimulation
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_energy as jax_allegro_energy
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxNequIPConfig
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.parallel import ShardedAllegroEngine as JaxSharded
from pair_allegro_tpu.parallel import ShardedNequIPEngine as JaxShardedNequIP
from pair_allegro_tpu.parallel import make_mesh as jax_make_mesh
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu.train import make_batched_loss_fn as jax_batched
from pair_allegro_tpu.train import make_loss_fn as jax_loss_fn
from pair_allegro_tpu_torch.checkpoint import flatten, params_from_numpy
from pair_allegro_tpu_torch.data import ShardedBatch, load_frames, shard_batch, stack_frames
from pair_allegro_tpu_torch.debug import edge_set
from pair_allegro_tpu_torch.engine import NequIPEngine
from pair_allegro_tpu_torch.io.extxyz import write_extxyz
from pair_allegro_tpu_torch.md.integrate import Simulation
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_energy
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, conv_route
from pair_allegro_tpu_torch.parallel import (
    ShardedAllegroEngine,
    ShardedNequIPEngine,
    make_mesh,
)
from pair_allegro_tpu_torch.parallel.mesh import Mesh
from pair_allegro_tpu_torch.parallel.sharded import spatial_sort
from pair_allegro_tpu_torch.system import System, Units, fcc_lattice
from pair_allegro_tpu_torch.train import leaves, make_batched_loss_fn, make_loss_fn

torch.set_num_threads(2)
F64 = torch.float64
KW = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=2, num_scalar_features=8,
          num_tensor_features=4, avg_num_neighbors=12.0, output_charges=True)


def _close(a, b, atol=0.0, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def _check(out, ref, extras=("charges", "dipole")):
    _close(float(out.total_energy), float(ref.total_energy), rtol=1e-12)
    _close(out.atomic_energy, ref.atomic_energy, atol=1e-12)
    _close(out.forces, ref.forces, atol=1e-11)
    _close(out.virial, ref.virial, atol=1e-10)
    if "charges" in extras:
        _close(out.extras["charges"], ref.extras["charges"], atol=1e-12)
    if "dipole" in extras:
        _close(out.extras["dipole"], ref.extras["dipole"], atol=1e-10)


def _systems(n_rep, seed=0):
    pos, cell = fcc_lattice(n_rep, jitter=0.05, seed=seed)
    n = len(pos)
    vel = np.random.RandomState(seed + 7).randn(n, 3) * 5.0
    kw = dict(cell=cell, velocities=vel, masses=np.full(n, 63.546))
    return (JaxSystem.create(pos, np.zeros(n, np.int32), dtype=jnp.float64, **kw),
            System.create(pos, np.zeros(n, np.int64), dtype=F64, device="cpu", **kw))


def _models(seed=0, **over):
    kw = {**KW, **over}
    jcfg, cfg = JaxConfig(**kw), AllegroConfig(**kw)
    jp = allegro_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                                            dtype=F64)


@pytest.fixture(scope="module")
def allegro_models():
    return _models()


# (n_shards, n_rep, row_chunk, skin): 32 and 108 atoms take the dense
# strategy, 500 (padded to 504) the cell list
CASES = [(2, 2, None, 0.0), (8, 3, None, 0.4), (8, 5, None, 0.4), (8, 5, 21, 0.4),
         (2, 5, 50, 0.0)]


@pytest.mark.parametrize("n_shards,n_rep,row_chunk,skin", CASES)
def test_sharded_allegro_matches_jax(allegro_models, n_shards, n_rep, row_chunk, skin):
    """The prepared permutation exactly, the edge set exactly, and energy,
    per-atom energies, forces, virial, charges (sharded) and dipole
    (summed) against JAX's sharded engine on n_shards virtual devices."""
    jcfg, jp, cfg, tp = allegro_models
    js, ts = _systems(n_rep)
    js, jperm = JaxSharded.prepare_system(js, n_shards)
    ts, perm = ShardedAllegroEngine.prepare_system(ts, n_shards)
    np.testing.assert_array_equal(perm, jperm)
    _close(ts.positions, js.positions)
    assert torch.equal(ts.valid_mask(), torch.as_tensor(np.array(js.valid_mask())))
    jeng = JaxSharded(jcfg, jp, js, jax_make_mesh(n_shards), skin=skin, row_chunk=row_chunk)
    eng = ShardedAllegroEngine(cfg, tp, ts, make_mesh(n_shards, devices="cpu"), skin=skin,
                               row_chunk=row_chunk)
    assert eng.spec.strategy == jeng.spec.strategy == ("dense" if n_rep < 5 else "cell_list")
    jnb, nb = jeng.rebuild_fn(js, None), eng.rebuild_fn(ts, None)
    assert not bool(nb.overflow) and not bool(jnb.overflow)
    assert [tuple(a.shape) for a in nb.edge_index] == [
        (nb.edge_index[0].shape[0], eng.spec.max_neighbors) if eng.spec.strategy == "cell_list"
        else (2, eng._dense_cap_local)] * n_shards
    pos, cell = np.asarray(js.positions), np.asarray(js.cell)
    assert edge_set(nb, pos, cell) == jax_edge_set(jnb, pos, cell)
    assert int(nb.count()) == int(jnb.count())
    out, jout = eng.force_fn(ts, nb), jeng.force_fn(js, jnb)
    _check(out, jout)
    _close(out.extras["edge_energy"], jout.extras["edge_energy"], atol=1e-12)


def test_sharded_nve_steps_match_jax(allegro_models):
    """Three NVE steps through Simulation with the skin's rebuild check on
    the cell list (JAX's jitted-step test): positions, velocities and the
    potential energy against JAX's sharded run."""
    jcfg, jp, cfg, tp = allegro_models
    js, ts = _systems(5)
    js, _ = JaxSharded.prepare_system(js, 8)
    ts, _ = ShardedAllegroEngine.prepare_system(ts, 8)
    jeng = JaxSharded(jcfg, jp, js, jax_make_mesh(8), skin=0.4)
    eng = ShardedAllegroEngine(cfg, tp, ts, make_mesh(8, devices="cpu"), skin=0.4)
    jsim = JaxSimulation(js, jeng.force_fn, jeng.rebuild_fn, dt=1.0 * Units.fs)
    sim = Simulation(ts, eng.force_fn, eng.rebuild_fn, dt=1.0 * Units.fs)
    jsim.run(3, log_every=3)
    rows = sim.run(3, log_every=3)
    assert np.isfinite(rows[-1]["etotal"])
    _close(sim.state.system.positions, jsim.state.system.positions, atol=1e-10)
    _close(sim.state.system.velocities, jsim.state.system.velocities, atol=1e-9)
    _close(float(sim.state.potential_energy), float(jsim.state.potential_energy), rtol=1e-11)


def test_prepare_system_permutation_roundtrip():
    """The sorted system is the original under perm, padded rows masked;
    the numpy sort keys equal the native ones."""
    _, ts = _systems(3)
    prepared, perm = ShardedAllegroEngine.prepare_system(ts, 8)
    n = ts.n_atoms
    assert prepared.n_atoms % 8 == 0 and prepared.n_atoms > n
    _close(prepared.positions[:n], ts.positions.numpy()[perm])
    assert not prepared.valid[n:].any() and prepared.valid[:n].all()
    assert sorted(perm) == list(range(n))
    cell = ts.cell.numpy()
    frac = ts.positions.numpy() @ np.linalg.inv(cell)
    b = np.clip(((frac - np.floor(frac)) * 8).astype(np.int64), 0, 7)
    key = (b[:, 2] * 8 + b[:, 1]) * 8 + b[:, 0]
    np.testing.assert_array_equal(spatial_sort(ts.positions.numpy(), cell, ts.pbc),
                                  np.argsort(key, kind="stable"))


@pytest.fixture(scope="module")
def nequip_case():
    kw = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=3, num_features=8,
              avg_num_neighbors=12.0)
    jcfg, cfg = JaxNequIPConfig(**kw), NequIPConfig(**kw)
    jp = nequip_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float64)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu", dtype=F64)
    js, ts = _systems(5)
    js, _ = JaxSharded.prepare_system(js, 8)
    ts, _ = ShardedAllegroEngine.prepare_system(ts, 8)
    return jcfg, jp, cfg, tp, js, ts


def test_sharded_nequip_matches_jax(nequip_case):
    """Sharded NequIP (per-layer gather of the node windows) against JAX's
    sharded engine and the port's single-device engine; the messages cross
    the shards (num_layers * r_max exceeds a window's extent), and the
    sharded call is routed off K3 as JAX routes it."""
    jcfg, jp, cfg, tp, js, ts = nequip_case
    jeng = JaxShardedNequIP(jcfg, jp, js, jax_make_mesh(8))
    eng = ShardedNequIPEngine(cfg, tp, ts, make_mesh(8, devices="cpu"))
    single = NequIPEngine(cfg, tp, ts, device="cpu")
    jnb, nb, nb0 = jeng.rebuild_fn(js, None), eng.rebuild_fn(ts, None), single.rebuild_fn(ts, None)
    assert int(nb.count()) == int(jnb.count()) == int(nb0.count())
    out = eng.force_fn(ts, nb)
    _check(out, jeng.force_fn(js, jnb), extras=())
    _check(out, single.force_fn(ts, nb0), extras=())
    assert cfg.num_layers * cfg.r_max > float(ts.cell[2, 2]) / 8
    assert conv_route(cfg, False, card=False) and not conv_route(cfg, False, card=False,
                                                                  sharded=True)


def test_sharded_nequip_matches_jax_nequip_engine(nequip_case):
    """The same system through JAX's single-device NequIP engine: the
    sharded port equals it too (one more independent reference)."""
    jcfg, jp, cfg, tp, js, ts = nequip_case
    jeng = JaxNequIPEngine(jcfg, jp, js)
    eng = ShardedNequIPEngine(cfg, tp, ts, make_mesh(4, devices="cpu"))
    _check(eng.force_fn(ts, eng.rebuild_fn(ts, None)), jeng.force_fn(js, jeng.rebuild_fn(js, None)),
           extras=())


def test_refusals(allegro_models, nequip_case):
    """JAX's refusals: an atom count the mesh does not divide, a row_chunk
    the shard does not divide or on the dense strategy, NequIP with
    row_chunk or on the dense strategy; a system off the mesh's home
    device; more devices than the list holds."""
    jcfg, jp, cfg, tp = allegro_models
    _, ts = _systems(5)
    mesh = make_mesh(8, devices="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ShardedAllegroEngine(cfg, tp, ts, mesh)
    ts8, _ = ShardedAllegroEngine.prepare_system(ts, 8)
    with pytest.raises(ValueError, match="row_chunk"):
        ShardedAllegroEngine(cfg, tp, ts8, mesh, row_chunk=20)
    _, small = _systems(2)
    small, _ = ShardedAllegroEngine.prepare_system(small, 8)
    with pytest.raises(ValueError, match="cell-list"):
        ShardedAllegroEngine(cfg, tp, small, mesh, row_chunk=2)
    ncfg, ntp = nequip_case[2], nequip_case[3]
    with pytest.raises(ValueError, match="strict locality"):
        ShardedNequIPEngine(ncfg, ntp, ts8, mesh, row_chunk=21)
    with pytest.raises(ValueError, match="dense"):
        ShardedNequIPEngine(ncfg, ntp, small, mesh)
    with pytest.raises(ValueError, match="home device"):
        ShardedAllegroEngine(cfg, tp, ts8, Mesh((torch.device("meta"),) * 8))
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_mesh(3, devices=["cpu", "cpu"])


def test_make_mesh():
    """Repeated devices, the axis name, JAX's ``shape``; without a GPU the
    default (CUDA) mesh raises the port's missing-device error."""
    mesh = make_mesh(4, devices="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.shape == {"atoms": 4}
    assert make_mesh(devices="cpu").size == 1
    dp = make_mesh(2, axis_name="dp", devices=["cpu", "cpu", "cpu"])
    assert dp.shape == {"dp": 2} and dp.home == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)


def _frames_file(tmp_path, cfg, tree, n=8):
    """``n`` 32-atom two-species frames labelled by the port's plain path."""
    from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np
    from pair_allegro_tpu_torch.potential import make_potential

    tcfg = cfg.for_training()
    params = params_from_numpy(tree, cfg, device="cpu", dtype=F64)
    pot = make_potential(lambda *a, **k: allegro_energy(params, tcfg, *a, **k))
    rng = np.random.RandomState(0)
    recs = []
    for i in range(n):
        pos, cell = fcc_lattice(2, jitter=0.1, seed=i)
        types = rng.randint(0, 2, len(pos))
        ei, sh = neighbor_list_np(pos, cell, (True,) * 3, cfg.r_max)
        out = pot(torch.tensor(pos), torch.tensor(types), torch.tensor(ei, dtype=torch.int64),
                  cell=torch.tensor(cell), edge_shifts=torch.tensor(sh))
        recs.append({"symbols": np.asarray(cfg.type_names)[types], "positions": pos,
                     "cell": cell, "pbc": (True,) * 3, "forces": out.forces.numpy(),
                     "info": {"energy": f"{float(out.total_energy):.17g}"}})
    path = str(tmp_path / "frames.xyz")
    write_extxyz(path, recs)
    return path


def test_data_parallel_grads_match_jax(tmp_path):
    """A batch of 4 frames split over 4 devices (each shard's gradient on
    its device, summed into the parameters) against the unsharded batch
    and JAX's batch sharded over 4 of its virtual devices, every leaf."""
    kw = dict(type_names=("Cu", "Ag"), r_max=3.0, l_max=1, num_layers=2,
              num_scalar_features=8, num_tensor_features=4, avg_num_neighbors=10.0,
              remat=False)
    jcfg, cfg = JaxConfig(**kw), AllegroConfig(**kw)
    tree = jax.tree.map(np.asarray, allegro_init(jax.random.PRNGKey(1), jcfg, dtype=jnp.float64))
    path = _frames_file(tmp_path, cfg, tree, n=4)
    frames = load_frames(path, cfg.type_names, cfg.r_max, dtype=F64, device="cpu")
    batch = stack_frames(frames)
    student = jax.tree.map(lambda a: a * (1.0 + 0.05 * np.cos(np.arange(a.size))
                                          .reshape(a.shape)), tree)
    loss = make_batched_loss_fn(make_loss_fn(allegro_energy, cfg.for_training()))

    def grads(b):
        params = params_from_numpy(student, cfg, device="cpu", dtype=F64)
        tensors = leaves(params)
        for t in tensors:
            t.requires_grad_(True)
        value = loss(params, b)[0]
        gs = torch.autograd.grad(value, tensors, allow_unused=True)
        return float(value.detach()), {k: np.zeros(t.shape) if g is None else g.numpy()
                              for (k, t), g in zip(zip(flatten(params), leaves(params)), gs)}

    sharded = shard_batch(batch, make_mesh(4, axis_name="dp", devices="cpu"), "dp")
    assert isinstance(sharded, ShardedBatch) and len(sharded.shards) == 4
    l_dp, g_dp = grads(sharded)
    l_1, g_1 = grads(batch)
    jframes = jax_load_frames(path, cfg.type_names, cfg.r_max, dtype=jnp.float64)
    jbatch = jax_shard_batch(jax_stack_frames(jframes), jax_make_mesh(4, axis_name="dp"), "dp")
    jfn = jax_batched(jax_loss_fn(jax_allegro_energy, jcfg.for_training()))
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jfn(p, b)[0]))(
        jax.tree.map(jnp.asarray, student), jbatch)
    _close(l_dp, l_1, rtol=1e-12)
    _close(l_dp, float(jl), rtol=1e-10)
    from pair_allegro_tpu.checkpoint import _flatten as jax_flatten

    jflat = {k: np.asarray(v) for k, v in jax_flatten(jg).items()}
    assert set(jflat) == set(g_dp)
    for k, g in g_dp.items():
        scale = max(float(np.abs(jflat[k]).max()), 1e-30)
        assert float(np.abs(g - g_1[k]).max()) <= 1e-10 * scale, k
        assert float(np.abs(g - jflat[k]).max()) <= 1e-10 * scale, k
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, make_mesh(3, axis_name="dp", devices="cpu"), "dp")


def test_dataclass_views_of_sharded_neighbors(allegro_models):
    """``ShardedNeighbors.gathered`` joins the shards' tables in row order
    (the JAX engine's global (N, K) table, exactly)."""
    jcfg, jp, cfg, tp = allegro_models
    js, ts = _systems(5)
    js, _ = JaxSharded.prepare_system(js, 4)
    ts, _ = ShardedAllegroEngine.prepare_system(ts, 4)
    nb = ShardedAllegroEngine(cfg, tp, ts, make_mesh(4, devices="cpu")).rebuild_fn(ts, None)
    jnb = JaxSharded(jcfg, jp, js, jax_make_mesh(4)).rebuild_fn(js, None)
    g = nb.gathered()
    for name in ("edge_index", "edge_shifts", "edge_mask"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jnb, name)))
    assert dataclasses.is_dataclass(nb) and g.edge_index.shape == (ts.n_atoms,
                                                                   nb.edge_index[0].shape[1])
