"""The routes around the kernels on the CPU: on the card any dtype but f32
runs the plain path (the kernels take f32 only; JAX runs every other dtype
on its XLA path), while the CPU keeps each tier's plain versions at any
dtype; widths K4 or K3 refuse (``kernel_takes`` beside their wrappers)
route to the plain path instead of a launch that would fail; NequIP with
``capture`` runs the plain message path, as JAX does, so its radial weight
gradients are finite; the memory estimate follows the route.  The card
legs of the same routes are in tests/test_torch_cuda.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pair_allegro_tpu.models.allegro import allegro_energy as j_energy
from pair_allegro_tpu.models.nequip import nequip_energy as j_nequip_energy
from pair_allegro_tpu.potential import make_potential as j_potential
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_energy, layer_tier
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, conv_route, nequip_energy
from pair_allegro_tpu_torch.ops import nequip_conv, tp_mix_fused
from pair_allegro_tpu_torch.ops.tp import tp_num_paths
from pair_allegro_tpu_torch.potential import make_potential
from test_torch_port_nequip import _kw as _nequip_kw
from test_torch_port_nequip import _params as _nequip_params
from test_torch_port_nequip_conv import _table
from test_torch_port_tiers import _case, _close, _jax_outputs, _kw, _params, _port_outputs

torch.set_num_threads(2)

ENV = ("PAT_L1_EMBED", "PAT_L1_POSITIONAL", "PAT_FORCE_ENV_FUSED", "PAT_FORCE_NEQUIP_FUSED")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


# config fields, flat, environment -> the tier at f32 (the CPU keeps it at
# any dtype but for the per-layer rounding modes; the card runs 'plain' at
# any other dtype, but at bf16 the tiers of the bf16 builds: K1's (with
# K6's and K7's in the embed form), K8's and K2's)
TIERS = [
    ({}, False, {}, "k1"),
    ({}, False, {"PAT_L1_EMBED": "1"}, "k1-embed"),
    ({}, False, {"PAT_L1_POSITIONAL": "0"}, "k1-nopos"),
    (dict(layer_fused=False), False, {}, "perlayer"),
    (dict(layer_fused=False, tp_mode="mxu_bf16x3"), False, {}, "perlayer"),
    (dict(fused_stack=True), False, {}, "stack"),
    ({}, True, {}, "k4"),
    (dict(num_tensor_features=64), False, {}, "k4"),
]


@pytest.mark.parametrize("fields,flat,env,tier", TIERS)
def test_card_routes_every_dtype_but_f32_to_plain(fields, flat, env, tier, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, **fields)
    assert layer_tier(cfg, flat) == layer_tier(cfg, flat, dtype=torch.float32) == tier
    rounding = tier == "perlayer" and cfg.tp_mode in ("mxu_bf16", "mxu_bf16x3")
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        bf16_build = dtype == torch.bfloat16 and (
            tier in ("k1", "k1-nopos", "k1-embed", "stack")
            or (tier == "perlayer" and cfg.tp_mode == "paths"))
        assert layer_tier(cfg, flat, dtype=dtype) == (tier if bf16_build else "plain")
        assert layer_tier(cfg, flat, dtype=dtype, card=False) == ("plain" if rounding else tier)
    # the card's memory check counts the plain tier, in the dtype's bytes
    plain = dataclasses.replace(cfg, fused_tp=False, fused_stack=False)
    assert cfg.live_bytes_per_edge(flat, torch.float64) == 2 * plain.live_bytes_per_edge(flat)


def test_k4_kernel_takes_mirrors_its_launcher_conditions():
    """K4 refuses C or Cout not a multiple of 4, D above 16, 3j tables the
    Meta table cannot hold, and blocks above 227 KB at its narrowest tile."""
    assert tp_mix_fused.kernel_takes(32, 32, 9, 2, True)
    assert tp_mix_fused.kernel_takes(8, 8, 4, 1, True)
    assert tp_mix_fused.kernel_takes(128, 128, 9, 2, True)
    assert tp_mix_fused.kernel_takes(64, 64, 16, 3, True)
    assert not tp_mix_fused.kernel_takes(6, 6, 9, 2, True)
    assert not tp_mix_fused.kernel_takes(8, 6, 9, 2, True)
    assert not tp_mix_fused.kernel_takes(32, 32, 16, 3, False)  # > 512 3j entries
    assert not tp_mix_fused.kernel_takes(256, 256, 9, 2, True)  # shared memory
    assert not tp_mix_fused.kernel_takes(8, 8, 25, 4, True)  # D above 16


@pytest.mark.parametrize("flat", [False, True])
def test_widths_k4_refuses_route_to_plain(flat):
    """num_tensor_features=6: K1 and K8 refuse it, and K4 (the reference's
    fallback for such widths) does too, so the call runs the plain path on
    either layout; fused_tp=False and capture are plain already."""
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, num_tensor_features=6, fused_stack=True)
    assert layer_tier(cfg, flat) == "plain"
    assert layer_tier(dataclasses.replace(cfg, num_tensor_features=8), flat) == \
        ("k4" if flat else "stack")


def test_narrow_table_model_runs_plain_and_matches_jax(monkeypatch):
    """The num_tensor_features=6 TABLE model gives JAX's energy, forces,
    virial and charges at f64 with no K4 call."""
    import pair_allegro_tpu_torch.models.allegro as t_allegro

    kw = _kw(2, num_tensor_features=6)
    jcfg, jp, tp = _params(kw)
    jargs, jkw, targs, tkw = _case(2)
    monkeypatch.setattr(t_allegro, "tp_mix_fused_t",
                        lambda *a: pytest.fail("K4 called for widths it refuses"))
    got = _port_outputs(tp, AllegroConfig(**kw), targs, tkw)
    want = _jax_outputs(jp, jcfg, jargs, jkw)
    for name in want:
        _close(got[name], want[name], f"C=6 {name}")


def _radial_dims(cfg):
    return (cfg.num_bessels, *[cfg.radial_mlp_width] * cfg.radial_mlp_depth,
            cfg.n_tracks * tp_num_paths(cfg.l_max) * cfg.num_features)


@pytest.mark.parametrize("c,parity,takes", [
    (4, False, True), (8, True, True), (16, True, True), (32, False, True), (64, True, True),
    (96, True, True), (128, True, True), (6, True, False), (48, True, False), (256, True, False)])
def test_k3_kernel_takes_and_conv_route(c, parity, takes):
    """K3 takes C in 4, 8, 16 or a multiple of 32 up to 128; conv_route
    asks it, and sends capture, fused_conv=False, the FLAT layout and, on
    the card, every dtype but f32 to the plain message path."""
    cfg = NequIPConfig(type_names=("Cu",), r_max=4.5, num_features=c, parity=parity)
    assert nequip_conv.kernel_takes(c, cfg.n_tracks, cfg.l_max, _radial_dims(cfg)) == takes
    assert conv_route(cfg, False) == takes
    assert not conv_route(cfg, True)
    assert not conv_route(cfg, False, capture=True)
    assert not conv_route(dataclasses.replace(cfg, fused_conv=False), False)
    assert not conv_route(cfg, False, dtype=torch.float64)
    assert conv_route(cfg, False, dtype=torch.float64, card=False) == takes
    odd = dataclasses.replace(cfg, radial_mlp_width=30)  # the last radial input width
    assert not conv_route(odd, False)
    plain = cfg.for_training().live_bytes_per_edge()
    assert (cfg.live_bytes_per_edge() == plain) == (not takes)
    assert cfg.live_bytes_per_edge(dtype=torch.float64) == 2 * plain


def test_nequip_width_k3_refuses_runs_plain_and_matches_jax(monkeypatch):
    """num_features=12 (no width K3 takes): no K3 call, and JAX's energy,
    forces and virial at f64."""
    import pair_allegro_tpu_torch.models.nequip as t_nequip

    kw = _nequip_kw(1, True, 2, num_features=12)
    jcfg, jp, tp = _nequip_params(kw)
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    types = np.arange(len(pos)) % 2
    monkeypatch.setattr(t_nequip, "nequip_conv", lambda *a: pytest.fail("K3 called for C=12"))
    got = make_potential(lambda *a, **k: nequip_energy(tp, NequIPConfig(**kw), *a, **k))(
        torch.tensor(pos), torch.tensor(types), torch.tensor(j_tab, dtype=torch.int64),
        cell=torch.tensor(cell), edge_shifts=torch.tensor(s_tab), edge_mask=torch.tensor(m_tab),
        edge_rev=torch.tensor(rev, dtype=torch.int64))
    want = jax.jit(j_potential(lambda *a, **k: j_nequip_energy(jp, jcfg, *a, **k)))(
        np.asarray(pos), np.asarray(types, np.int32), np.asarray(j_tab), cell=np.asarray(cell),
        edge_shifts=np.asarray(s_tab), edge_mask=np.asarray(m_tab), edge_rev=np.asarray(rev))
    for name in ("total_energy", "atomic_energy", "forces", "virial"):
        _close(np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), f"C=12 {name}")


def test_nequip_capture_runs_plain_with_finite_radial_gradients():
    """With capture the K3 path is not taken, as in JAX
    (models/nequip.py:648): the radial weights' gradients are finite and
    equal the plain path's (for_training()) to 1e-10."""
    kw = _nequip_kw(1, True, 1)
    _, _, tp = _nequip_params(kw)
    cfg = NequIPConfig(**kw)
    assert conv_route(cfg, False) and not conv_route(cfg, False, capture=True)
    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    args = (torch.tensor(pos), torch.zeros(len(pos), dtype=torch.int64),
            torch.tensor(j_tab, dtype=torch.int64))
    kwargs = dict(cell=torch.tensor(cell), edge_shifts=torch.tensor(s_tab),
                  edge_mask=torch.tensor(m_tab), edge_rev=torch.tensor(rev, dtype=torch.int64))
    radial = [w.requires_grad_(True) for layer in tp["layers"] for w in layer["radial_mlp"]["w"]]
    cap = {}
    got = torch.autograd.grad(nequip_energy(tp, cfg, *args, capture=cap, **kwargs)["total_energy"],
                              radial)
    assert "node_features" in cap
    want = torch.autograd.grad(
        nequip_energy(tp, cfg.for_training(), *args, **kwargs)["total_energy"], radial)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g.numpy(), w.numpy(), "radial gradient under capture")
    without = torch.autograd.grad(nequip_energy(tp, cfg, *args, **kwargs)["total_energy"], radial)
    assert all(torch.isnan(g).all() for g in without)  # the K3 path's contract, unchanged


def test_cpu_f64_keeps_the_kernel_tiers(monkeypatch):
    """On the CPU an f64 call still runs its tier's plain versions (here the
    K1 tier's), so the f64 tests hold each tier's glue to JAX; the same
    config on the card at f64 would route to 'plain'."""
    import pair_allegro_tpu_torch.models.allegro as t_allegro

    kw = _kw(1)
    _, _, tp = _params(kw)
    _, _, targs, tkw = _case(1)
    calls = []
    real = t_allegro.fused_layer
    monkeypatch.setattr(t_allegro, "fused_layer", lambda *a, **k: calls.append(1) or real(*a, **k))
    allegro_energy(tp, AllegroConfig(**kw), *targs, **tkw)
    assert targs[0].dtype == torch.float64 and len(calls) == kw["num_layers"]


@pytest.mark.parametrize("tp_mode", ["mxu_bf16", "mxu_bf16x3"])
def test_cpu_rounding_modes_run_exact_off_f32(tp_mode, monkeypatch):
    """The per-layer rounding modes act at f32 only, as in JAX: an f64 call
    on the CPU routes to the exact plain path (no K5 call, whose plain
    version rounds O to bf16), while an f32 call on the CPU keeps the
    per-layer tier and its rounding; the exact modes keep 'perlayer' at
    f64; the regrow estimate follows the plain route."""
    import pair_allegro_tpu_torch.models.allegro as t_allegro

    cfg = AllegroConfig(**_kw(1), layer_fused=False, tp_mode=tp_mode)
    assert layer_tier(cfg, False, dtype=torch.float32, card=False) == "perlayer"
    assert layer_tier(cfg, False, dtype=torch.float64, card=False) == "plain"
    for mode in ("paths", "mxu_highest"):
        exact = dataclasses.replace(cfg, tp_mode=mode)
        assert layer_tier(exact, False, dtype=torch.float64, card=False) == "perlayer"
    plain = dataclasses.replace(cfg, fused_tp=False)
    assert cfg.live_bytes_per_edge(dtype=torch.float64) == plain.live_bytes_per_edge(
        dtype=torch.float64)
    calls = []
    real = t_allegro.env_layer_mxu
    monkeypatch.setattr(t_allegro, "env_layer_mxu", lambda *a, **k: calls.append(1) or real(*a, **k))
    for dtype, want in ((torch.float64, 0), (torch.float32, cfg.num_layers)):
        _, _, tp = _params(_kw(1), dtype=dtype)
        _, _, targs, tkw = _case(1, dtype)
        calls.clear()
        allegro_energy(tp, cfg, *targs, **tkw)
        assert len(calls) == want


def test_regrow_estimate_reads_the_system_dtype():
    """engine.regrow_bytes passes the system's dtype: an f64 system is
    counted on the plain tier at 8 bytes a number."""
    from pair_allegro_tpu_torch.engine import NeighborSpec, regrow_bytes
    from pair_allegro_tpu_torch.system import System, fcc_lattice

    pos, cell = fcc_lattice(5)
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5)
    spec = NeighborSpec(strategy="cell_list", cutoff=4.9, max_edges=500 * 64, max_neighbors=64)
    for dtype, want in ((torch.float32, cfg.live_bytes_per_edge()),
                        (torch.float64, 2 * cfg.for_training().live_bytes_per_edge())):
        s = System.create(pos, np.zeros(len(pos), np.int64), cell=cell, dtype=dtype, device="cpu")
        assert regrow_bytes(spec, s, cfg) == 500 * 64 * want
