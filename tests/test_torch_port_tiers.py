"""The port's Allegro tiers against the JAX package on the CPU: the per-layer
tier (``layer_fused=False``, K2 and K5's plain versions) against JAX's layer
math at f64, with one and two species; the ``mxu_bf16x3`` tier against
JAX's own env-fused tier with its Pallas kernels in interpret mode at f32;
the plain tier's weight gradients and ``capture`` at f64; the kernel tiers'
weight layouts following in-place updates of the tree; a 500-atom engine
and ten NVE steps of the per-layer tier; the config's tier fields and the
per-tier device-memory estimate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.engine import AllegroEngine as JaxEngine
from pair_allegro_tpu.md.integrate import Simulation as JaxSimulation
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_energy as j_energy
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.potential import make_potential as j_potential
from pair_allegro_tpu.system import System as JaxSystem
from pair_allegro_tpu_torch.engine import AllegroEngine, NeighborSpec, regrow_bytes
from pair_allegro_tpu_torch.md.integrate import Simulation
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_energy,
    allegro_params_from_numpy,
)
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import System, Units, fcc_lattice
from test_torch_port_nequip_conv import _table

torch.set_num_threads(2)


def _kw(species, **kw):
    base = dict(r_max=3.0, l_max=2, num_layers=2, num_scalar_features=16, num_tensor_features=8,
                avg_num_neighbors=6.0, output_charges=True)
    if species == 1:
        base["type_names"] = ("A",)
    else:
        base.update(type_names=("A", "B"), per_edge_type_cutoff=((3.0, 2.8), (2.8, 2.6)))
    base.update(kw)
    return base


def _params(kw, dtype=torch.float64, seed=0):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jcfg = JaxConfig(remat=False, **kw)
    jp = allegro_init(jax.random.PRNGKey(seed), jcfg, dtype=jdt)
    nt = jcfg.num_types
    jp["per_type_scale"] = jnp.linspace(0.8, 1.3, nt, dtype=jdt)
    jp["per_type_shift"] = jnp.linspace(-0.2, 0.4, nt, dtype=jdt)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), AllegroConfig(**kw), device="cpu",
                                   dtype=dtype)
    return jcfg, jp, tp


def _case(species, dtype=torch.float64):
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    types = (np.arange(len(pos)) % 2) if species == 2 else np.zeros(len(pos), np.int64)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jargs = (jnp.asarray(pos, jdt), jnp.asarray(types, jnp.int32), jnp.asarray(j_tab))
    jkw = dict(cell=jnp.asarray(cell, jdt), edge_shifts=jnp.asarray(s_tab, jdt),
               edge_mask=jnp.asarray(m_tab), edge_rev=jnp.asarray(rev))
    targs = (torch.tensor(pos, dtype=dtype), torch.tensor(types, dtype=torch.int64),
             torch.tensor(j_tab, dtype=torch.int64))
    tkw = dict(cell=torch.tensor(cell, dtype=dtype), edge_shifts=torch.tensor(s_tab, dtype=dtype),
               edge_mask=torch.tensor(m_tab), edge_rev=torch.tensor(rev, dtype=torch.int64))
    return jargs, jkw, targs, tkw


def _close(a, b, name, tol=1e-10):
    b = np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(np.asarray(a) - b).max()) / scale
    assert err <= tol, f"{name}: relative error {err:.3e}"


def _outputs(o):
    return {"total_energy": float(o.total_energy), "atomic_energy": np.asarray(o.atomic_energy),
            "forces": np.asarray(o.forces), "virial": np.asarray(o.virial),
            "charges": np.asarray(o.extras["charges"])}


def _jax_outputs(jp, jcfg, jargs, jkw):
    pot = jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))
    return _outputs(pot(*jargs, **jkw))


def _port_outputs(tp, cfg, targs, tkw):
    return _outputs(make_potential(lambda *a, **k: allegro_energy(tp, cfg, *a, **k))(*targs, **tkw))


@pytest.mark.parametrize("species", [1, 2])
@pytest.mark.parametrize("tp_mode", ["paths", "mxu_highest", "mxu_bf16x3", "mxu_bf16"])
def test_perlayer_tier_matches_jax_f64(species, tp_mode, monkeypatch):
    """f64: energy, per-atom energy, forces, virial and charges of the
    per-layer tier against JAX's layer math (with layer_fused=False JAX on
    the CPU runs layer_fn), in every tp_mode: at f64 the rounding modes
    compute the exact function too, as JAX does at any dtype but f32."""
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    kw = _kw(species)
    jcfg, jp, tp = _params(kw)
    jargs, jkw, targs, tkw = _case(species)
    want = _jax_outputs(jp, dataclasses.replace(jcfg, layer_fused=False), jargs, jkw)
    cfg = AllegroConfig(**kw, layer_fused=False, tp_mode=tp_mode)
    assert cfg.tier == "perlayer"
    got = _port_outputs(tp, cfg, targs, tkw)
    for name in want:
        _close(got[name], want[name], f"{tp_mode} {name}")


def test_bf16x3_tier_matches_jax_env_fused_tier_interpret(monkeypatch):
    """f32: the port's mxu_bf16x3 tier (K5's plain version) against JAX's
    own env-fused tier (layer_fused=False, tp_mode=mxu_bf16x3) with its
    Pallas kernels in interpret mode: the feature-major glue, the padding
    hoist and the kernel's bf16 rounding.  Tolerances: f32 sums in another
    order, and the bf16 splits of O rounding the other way at a boundary
    (the remainder term keeps that at ~2^-16 of O)."""
    import pair_allegro_tpu.ops.pallas_stack as ps
    from pair_allegro_tpu.ops.prec import matmul_precision

    monkeypatch.setattr(ps, "_INTERPRET", True)
    monkeypatch.setenv("PAT_FORCE_ENV_FUSED", "1")
    monkeypatch.setenv("PAT_ENV_MM", "highest")
    seen = {}
    real_viable = ps.env_fused_viable

    def probe(*a):
        seen["viable"] = real_viable(*a)
        return seen["viable"]

    monkeypatch.setattr(ps, "env_fused_viable", probe)
    kw = _kw(2, layer_fused=False, tp_mode="mxu_bf16x3")
    jcfg, jp, tp = _params(kw, torch.float32)
    jargs, jkw, targs, tkw = _case(2, torch.float32)
    with matmul_precision("highest"):
        want = _jax_outputs(jp, jcfg, jargs, jkw)
    assert seen.get("viable") is True  # JAX's env-fused tier ran
    got = _port_outputs(tp, AllegroConfig(**kw), targs, tkw)
    np.testing.assert_allclose(got["total_energy"], want["total_energy"], rtol=2e-5)
    for name, atol in (("atomic_energy", 5e-5), ("charges", 5e-5), ("forces", 1e-4)):
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=1e-3, err_msg=name)


def test_plain_tier_gradients_and_capture_match_jax_f64(monkeypatch):
    """f64.  The plain tier's energy gradient with respect to every leaf of
    the tree equals JAX's for_training() gradient; its capture has JAX's
    keys and values.  On the per-layer tier the mix leaves' gradients are
    NaN (the kernels' contract) and every other leaf's equals the plain
    tier's."""
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    kw = _kw(2)
    jcfg, jp, tp = _params(kw)
    jargs, jkw, targs, tkw = _case(2)
    jtrain = jcfg.for_training()
    j_total = jax.jit(lambda p: j_energy(p, jtrain, *jargs, **jkw)["total_energy"])
    jg = jax.tree_util.tree_leaves_with_path(jax.grad(j_total)(jp))
    named = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in named] == [jax.tree_util.keystr(p) for p, _ in jg]
    leaves = [t.requires_grad_(True) for _, t in named]
    cfg = AllegroConfig(**kw)
    assert cfg.for_training().tier == "plain"

    def grads(c):  # the charge head does not enter the energy: its gradient is zero
        return torch.autograd.grad(allegro_energy(tp, c, *targs, **tkw)["total_energy"], leaves,
                                   allow_unused=True, materialize_grads=True)

    plain = grads(cfg.for_training())
    perlayer = grads(dataclasses.replace(cfg, layer_fused=False))
    for (path, _), (_, want), gp, gl in zip(named, jg, plain, perlayer):
        name = jax.tree_util.keystr(path)
        _close(gp.numpy(), want, f"plain d/d{name}")
        if "'mix'" in name:
            assert torch.isnan(gl).all(), name
        else:
            _close(gl.numpy(), gp.numpy(), f"per-layer d/d{name}")
    for t in leaves:
        t.requires_grad_(False)

    jcap, tcap = {}, {}
    j_energy(jp, jcfg, *jargs, capture=jcap, **jkw)
    with torch.no_grad():
        allegro_energy(tp, cfg, *targs, capture=tcap, **tkw)  # capture takes the plain tier
    assert sorted(tcap) == sorted(jcap)
    for key in jcap:
        assert tuple(tcap[key].shape) == tuple(jcap[key].shape), key
        _close(tcap[key].numpy(), jcap[key], f"capture {key}")


def _flat_of(targs, tkw):
    """The TABLE case as the same edges on the FLAT (2, E) layout."""
    pos, types, j_tab = targs
    n, k = j_tab.shape
    ei = torch.stack([torch.arange(n).repeat_interleave(k), j_tab.reshape(-1)])
    return (pos, types, ei), dict(cell=tkw["cell"], edge_shifts=tkw["edge_shifts"].reshape(-1, 3),
                                  edge_mask=tkw["edge_mask"].reshape(-1))


def test_kernel_layouts_follow_in_place_updates(monkeypatch):
    """After an in-place update of one layer's mix, latent_mlp and
    env_weight leaves, the K1, per-layer (paths and mxu_highest), K4 (the
    same edges on the FLAT layout) and plain tiers all give JAX's energy
    and forces for the updated tree (each tier ran once before the update,
    so its cached layouts are stale unless they follow the leaves)."""
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    kw = _kw(1)
    jcfg, jp, tp = _params(kw)
    jargs, jkw, targs, tkw = _case(1)
    base = AllegroConfig(**kw)
    cfgs = {"k1": base, "paths": dataclasses.replace(base, layer_fused=False),
            "mxu_highest": dataclasses.replace(base, layer_fused=False, tp_mode="mxu_highest"),
            "k4": base, "plain": base.for_training()}
    fargs, fkw = _flat_of(targs, tkw)

    def run(tier, cfg):
        args, kw = (fargs, fkw) if tier == "k4" else (targs, tkw)
        return _port_outputs(tp, cfg, args, kw)

    for tier, cfg in cfgs.items():
        run(tier, cfg)
    layer, jlayer = tp["layers"][1], jp["layers"][1]
    with torch.no_grad():
        layer["mix"]["l1"].mul_(-0.5)
        layer["latent_mlp"]["w"][0].mul_(1.5)
        layer["env_weight"].add_(0.25)
    jlayer["mix"]["l1"] = jlayer["mix"]["l1"] * -0.5
    jlayer["latent_mlp"]["w"][0] = jlayer["latent_mlp"]["w"][0] * 1.5
    jlayer["env_weight"] = jlayer["env_weight"] + 0.25
    want = _jax_outputs(jp, jcfg, jargs, jkw)
    for tier, cfg in cfgs.items():
        got = run(tier, cfg)
        for name in ("total_energy", "forces"):
            _close(got[name], want[name], f"{tier} {name} after the update")


def _fcc_pair(kw, jitter, seed, velocities=None, skin=0.0):
    jcfg, jp, tp = _params(kw, seed=3)
    pos, cell = fcc_lattice(5, jitter=jitter, seed=seed)
    n = pos.shape[0]
    types = np.random.RandomState(2).randint(0, jcfg.num_types, n)
    masses = np.where(types == 0, 63.546, 107.87)
    js = JaxSystem.create(pos, types.astype(np.int32), cell=cell, masses=masses,
                          velocities=velocities, dtype=jnp.float64)
    ts = System.create(pos, types, cell=cell, masses=masses, velocities=velocities,
                       dtype=torch.float64, device="cpu")
    je = JaxEngine(jcfg, jp, js, skin=skin)
    te = AllegroEngine(AllegroConfig(**kw), tp, ts, device="cpu", skin=skin)
    return js, je, ts, te


def test_perlayer_engine_500_atoms_matches_jax(monkeypatch):
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    kw = _kw(2, r_max=4.5, avg_num_neighbors=12.0, per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)),
             layer_fused=False)
    js, je, ts, te = _fcc_pair(kw, 0.08, 11)
    assert te.cfg.tier == "perlayer" and te.spec.max_neighbors == je.spec.max_neighbors
    jo = _outputs(je.force_fn(js, je.rebuild_fn(js, None)))
    to = _outputs(te.force_fn(ts, te.rebuild_fn(ts, None)))
    for name in jo:
        _close(to[name], jo[name], name)


def test_perlayer_nve_trajectory_matches_jax(monkeypatch):
    """Ten 2 fs steps in two chunks with Verlet-skin rebuilds, from the same
    numpy velocities."""
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    kw = _kw(1, r_max=4.5, avg_num_neighbors=12.0, output_charges=False, layer_fused=False)
    n = 500
    rng = np.random.RandomState(6)
    vel = rng.randn(n, 3) * np.sqrt(Units.kB * 600.0 / (63.546 * Units.mvv2e))
    vel -= vel.mean(0)
    js, je, ts, te = _fcc_pair(kw, 0.05, 5, velocities=vel, skin=0.05)
    dt = 2.0 * Units.fs
    jsim = JaxSimulation(js, je.force_fn, je.rebuild_fn, dt=dt, grow_fn=je.grow)
    tsim = Simulation(ts, te.force_fn, te.rebuild_fn, dt=dt, grow_fn=te.grow)
    jrows = jsim.run(10, log_every=5)
    trows = tsim.run(10, log_every=5)
    jsys, tsys = jsim.state.system, tsim.state.system
    np.testing.assert_allclose(tsys.positions.numpy(), np.asarray(jsys.positions), atol=1e-8)
    np.testing.assert_allclose(tsys.velocities.numpy(), np.asarray(jsys.velocities), atol=1e-8)
    for jr, tr in zip(jrows, trows):
        assert int(jr["step"]) == tr["step"]
        np.testing.assert_allclose(tr["etotal"], float(jr["etotal"]), rtol=1e-10)
        assert tr["n_edges"] == int(jr["n_edges"])


def test_config_tier_fields():
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5)
    assert (cfg.fused_tp, cfg.layer_fused, cfg.tp_mode, cfg.fused_stack) == (True, True, "paths", False)
    assert cfg.tier == "k1"
    train = dataclasses.replace(cfg, fused_stack="auto").for_training()
    assert (train.fused_tp, train.fused_stack, train.tier) == (False, False, "plain")
    tree = {"layers": []}
    for bad, err in ((dict(tp_mode="mxu_fp8"), ValueError),):
        with pytest.raises(err):
            allegro_params_from_numpy(tree, dataclasses.replace(cfg, num_layers=0, **bad),
                                      device="cpu")
    # the fused stack (K8), remat and the bf16 interior are ported: they are accepted
    for ok in (dict(fused_stack=True), dict(remat=True), dict(interior="bf16")):
        allegro_params_from_numpy(tree, dataclasses.replace(cfg, num_layers=0, **ok),
                                  device="cpu")


def test_regrow_memory_estimate_is_per_tier():
    """The regrow check reads the tier's own per-edge count: K1's formula
    is unchanged, the per-layer tier adds per layer wz, inv, x and the
    hidden activations, the plain tier the TP outputs and their cotangents
    instead of wz."""
    pos, cell = fcc_lattice(5)
    ts = System.create(pos, np.zeros(len(pos), np.int64), cell=cell, device="cpu")
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5)
    d, c, ns, L, hid = 9, 32, 64, 3, 2 * 2 * 64
    k1 = 2 * d * c * L + 6 * ns + 64
    assert cfg.live_bytes_per_edge() == 4 * k1
    perlayer = dataclasses.replace(cfg, layer_fused=False)
    assert perlayer.live_bytes_per_edge() == 4 * (k1 + L * (c + c * 3 + ns + hid))
    assert dataclasses.replace(perlayer, tp_mode="mxu_bf16").live_bytes_per_edge() == \
        perlayer.live_bytes_per_edge()
    n_t = c * (3 * 1 + 4 * 3 + 4 * 5)  # C * sum_l3 P_l3 * (2*l3 + 1) at l_max=2 with parity
    assert cfg.for_training().live_bytes_per_edge() == 4 * (k1 + L * (2 * n_t + c * 3 + ns + hid))

    spec = NeighborSpec(strategy="cell_list", cutoff=4.9, max_edges=500 * 64, max_neighbors=64)
    for c_ in (cfg, perlayer, cfg.for_training()):
        assert regrow_bytes(spec, ts, c_) == 500 * 64 * c_.live_bytes_per_edge()
