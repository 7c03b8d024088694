"""``remat`` in the port against the JAX package at f64 on the CPU: on every
tier (the K1 tier in its three forms, the per-layer tier with K2 and K5,
the plain tier, K4 on the TABLE and FLAT layouts, the stack, which takes no
remat, and NequIP with and without K3) ``remat=True`` gives the forces,
energies and virial of ``remat=False`` exactly and JAX's ``remat=True`` to
1e-10 relative; the layer steps really run under a checkpoint (the K1
plain version runs once more per layer); an unresolved "auto" means on, as
in JAX; and ``engine._resolve_remat`` makes JAX's decisions across sizes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu import engine as jeng
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxAllegroConfig
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxNequIPConfig
from pair_allegro_tpu_torch import engine as teng
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, layer_tier, remat_on
from pair_allegro_tpu_torch.models.nequip import NequIPConfig
from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.system import System, fcc_lattice
from test_torch_port_nequip_lmax import _inputs
from test_torch_port_nequip_lmax import _pair as _nequip_pair
from test_torch_port_nequip_lmax import _port as _nequip_port
from test_torch_port_tiers import (
    _case,
    _close,
    _flat_of,
    _jax_outputs,
    _kw,
    _outputs,
    _params,
    _port_outputs,
)

torch.set_num_threads(2)

TIERS = {
    "k1": ({}, {}, "k1"),
    "k1-embed": (dict(num_layers=3), {"PAT_L1_EMBED": "1"}, "k1-embed"),
    "k1-nopos": ({}, {"PAT_L1_POSITIONAL": "0"}, "k1-nopos"),
    "perlayer": (dict(layer_fused=False), {}, "perlayer"),
    "perlayer-mxu_highest": (dict(layer_fused=False, tp_mode="mxu_highest"), {}, "perlayer"),
    "plain": (dict(fused_tp=False), {}, "plain"),
    "k4-table": (dict(num_tensor_features=4), {}, "k4"),
    "k4-flat": ({}, {}, "k4"),
    "stack": (dict(fused_stack=True), {}, "stack"),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_remat_equals_no_remat_and_jax(tier, monkeypatch):
    fields, env, want = TIERS[tier]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    kw = _kw(2, **fields)
    jcfg, jp, tp = _params(kw)
    jargs, jkw, targs, tkw = _case(2)
    flat = tier == "k4-flat"
    if flat:
        targs, tkw = _flat_of(targs, tkw)
        jargs = (jargs[0], jargs[1], jnp.asarray(targs[2].numpy()))
        jkw = dict(cell=jkw["cell"], edge_shifts=jnp.asarray(tkw["edge_shifts"].numpy()),
                   edge_mask=jnp.asarray(tkw["edge_mask"].numpy()))
    cfg = AllegroConfig(**kw)
    assert layer_tier(cfg, flat, dtype=torch.float64, card=False) == want
    ref = _jax_outputs(jp, dataclasses.replace(jcfg, remat=True), jargs, jkw)
    outs = {r: _port_outputs(tp, dataclasses.replace(cfg, remat=r), targs, tkw)
            for r in (False, True)}
    for key in ref:
        np.testing.assert_array_equal(outs[True][key], outs[False][key], err_msg=key)
        _close(outs[True][key], ref[key], f"{tier} {key}")


def test_remat_runs_each_k1_layer_under_a_checkpoint(monkeypatch):
    """With remat every K1 layer's forward runs once more (the recompute in
    the backward) before its backward; an unresolved "auto" is on, as in
    JAX, and ``capture`` turns it off."""
    calls = []
    real = fl.fused_layer_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fl, "fused_layer_reference", counted)
    kw = _kw(1)
    _, _, tp = _params(kw)
    _, _, targs, tkw = _case(1)
    n_layers = kw["num_layers"]
    for remat, extra in ((False, 0), (True, n_layers), ("auto", n_layers)):
        calls.clear()
        _port_outputs(tp, AllegroConfig(**kw | {"remat": remat}), targs, tkw)
        # forward, the CPU backward's own recompute, and remat's
        assert len(calls) == 2 * n_layers + extra, remat
    assert remat_on(AllegroConfig(**kw)) and not remat_on(AllegroConfig(**kw), capture={})


@pytest.mark.parametrize("fused", [True, False])
def test_nequip_remat_equals_no_remat_and_jax(fused):
    """NequIP at l_max 2 with K3's plain version (``fused_conv=True``) and
    the plain message path: remat True and False agree exactly, and with
    JAX's remat=True (its channels-last CPU path) to 1e-10."""
    from pair_allegro_tpu.models.nequip import nequip_energy as j_energy
    from pair_allegro_tpu.potential import make_potential as j_potential

    pos, jargs, jkw, targs, tkw = _inputs()
    jcfg, jp, tcfg, tp = _nequip_pair(2, True, fused_conv=fused)
    jo = jax.jit(j_potential(lambda *a, **k: j_energy(
        jp, dataclasses.replace(jcfg, remat=True), *a, **k)))(jnp.asarray(pos), *jargs, **jkw)
    outs = {}
    for remat in (False, True, "auto"):
        out, _ = _nequip_port(tp, dataclasses.replace(tcfg, remat=remat), pos, targs, tkw)
        outs[remat] = out
    for key in ("total_energy", "atomic_energy", "forces", "virial"):
        for r in (True, "auto"):
            assert torch.equal(getattr(outs[r], key), getattr(outs[False], key)), key
        _close(getattr(outs[True], key).numpy(), getattr(jo, key), key)


def _specs(strategy, n, k_or_edges):
    kw = (dict(max_edges=n * k_or_edges, grid=(9, 9, 9), cell_capacity=20,
               max_neighbors=k_or_edges) if strategy == "cell_list"
          else dict(max_edges=k_or_edges, shifts_table=np.zeros((1, 3))))
    return (teng.NeighborSpec(strategy=strategy, cutoff=4.9, **kw),
            jeng.NeighborSpec(strategy=strategy, cutoff=4.9, **kw))


def test_resolve_remat_makes_the_reference_decisions():
    """Across sizes and both models: the main paths (5,324 atoms, K = 64)
    resolve to off, the 1,000,188-atom run to on; a bool passes through."""
    acfg = dict(type_names=("Cu",), r_max=4.5)
    ncfg = dict(type_names=("Cu",), r_max=4.5, l_max=1, parity=True, num_features=64)
    cases = [("cell_list", 5324, 64), ("cell_list", 1_000_188, 64), ("cell_list", 60_000, 64),
             ("cell_list", 20_000, 96), ("cell_list", 500, 48), ("dense", 256, 40_000),
             ("dense", 5324, 3_000_000)]
    seen = set()
    for strategy, n, size in cases:
        ts, js = _specs(strategy, n, size)
        for tc, jc in ((AllegroConfig(**acfg), JaxAllegroConfig(**acfg)),
                       (NequIPConfig(**ncfg), JaxNequIPConfig(**ncfg))):
            got = teng._resolve_remat(tc, ts, n).remat
            assert got == jeng._resolve_remat(jc, js, n).remat, (strategy, n, size, type(tc))
            seen.add(got)
            for fixed in (True, False):
                assert teng._resolve_remat(dataclasses.replace(tc, remat=fixed), ts, n).remat \
                    is fixed
    assert seen == {True, False}
    for tc in (AllegroConfig(**acfg), NequIPConfig(**ncfg)):
        assert teng._resolve_remat(tc, _specs("cell_list", 5324, 64)[0], 5324).remat is False
        assert teng._resolve_remat(tc, _specs("cell_list", 1_000_188, 64)[0], 1_000_188).remat


def test_engine_resolves_auto_after_the_capacity_estimate():
    pos, cell = fcc_lattice(5, jitter=0.05, seed=1)
    ts = System.create(pos, np.zeros(len(pos)), cell=cell, dtype=torch.float64, device="cpu")
    kw = _kw(1, r_max=4.0)
    _, _, tp = _params(kw)
    eng = teng.AllegroEngine(AllegroConfig(**kw), tp, ts, device="cpu")
    assert eng.cfg.remat is False
    eng = teng.AllegroEngine(AllegroConfig(**kw | {"remat": True}), tp, ts, device="cpu")
    assert eng.cfg.remat is True
    _outputs(eng.force_fn(ts, eng.rebuild_fn(ts, None)))
