"""``interior="bf16"`` (the layer stack on bf16 operands) of the port
against the JAX package on the CPU, at f32 positions.

* Models, on the ``_kw(2)`` / ``_case(2)`` fixture of
  tests/test_torch_port_tiers.py (2 layers, 16 / 8 features, l_max 2, two
  species, charges): the port's plain tier against JAX's default CPU path
  (``layer_fn`` at bf16); the port's K1 tier (``k1`` and ``k1-nopos``,
  K1's plain version at bf16) and its per-layer ``paths`` tier (K2's plain
  version) against JAX's env-fused tier with its Pallas kernels in
  interpret mode (``PAT_FORCE_ENV_FUSED=1``).  Both sides round at bf16 in
  places of their own (JAX's XLA fuses elementwise chains in f32, torch
  rounds each op), so the gates are model tolerances at bf16 scale, |dE| <=
  5e-3 max(1, |E|) and max|dF| <= 2e-2 max|F|, with JAX's own bf16-vs-f32
  distance printed for scale.
* The bf16 casts happen: the operands that reach K1's and K2's plain
  versions and the plain tier's layer math are bf16 (a missing cast moves
  the forces by less than the tolerance, so only this finds it).
* Kernels: K1's plain version (three forms) and K2's at bf16 against JAX's
  ``allegro_layer_fused_t`` / ``tp_mix_env_fused_t`` in interpret mode at
  bf16, forward and VJP.
* Routing on the card (``card=True``): K1 (its embed form too), the stack
  and the per-layer ``paths`` tier keep their kernels at bf16, the
  ``mxu_*`` modes and K4 run the plain path; ``kernel_takes`` at bf16; and
  the memory estimate at bf16.  The embed form and the stack at bf16 are
  held to JAX in tests/test_torch_port_embed_stack_bf16.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu_torch.models.allegro as t_allegro
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    env_fused_viable,
    layer_tier,
)
from pair_allegro_tpu_torch.ops import env_layer as k2
from pair_allegro_tpu_torch.ops import fused_layer as fl
from test_torch_port_tiers import _case, _jax_outputs, _kw, _params, _port_outputs

torch.set_num_threads(2)
BF16 = dict(interior="bf16")


def _model_gate(got, want, label, scale=None):
    de = abs(got["total_energy"] - want["total_energy"])
    df = float(np.abs(got["forces"] - want["forces"]).max())
    fmax = float(np.abs(want["forces"]).max())
    print(f"{label}: |dE| {de:.3e} (E {want['total_energy']:.4f}), max|dF| {df:.3e} "
          f"(max|F| {fmax:.3f})" + (f"; JAX bf16 vs f32: {scale}" if scale else ""))
    assert de <= 5e-3 * max(1.0, abs(want["total_energy"])), (label, de)
    assert df <= 2e-2 * fmax, (label, df, fmax)


def _distance(a, b):
    return (f"|dE| {abs(a['total_energy'] - b['total_energy']):.3e}, "
            f"max|dF| {float(np.abs(a['forces'] - b['forces']).max()):.3e}")


@pytest.fixture(scope="module")
def fixture32():
    kw = _kw(2)
    jcfg, jp, tp = _params(kw, torch.float32)
    return kw, jcfg, jp, tp, _case(2, torch.float32)


def test_plain_tier_matches_jax_default_path(fixture32, monkeypatch):
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    kw, jcfg, jp, tp, (jargs, jkw, targs, tkw) = fixture32
    want = _jax_outputs(jp, dataclasses.replace(jcfg, interior="bf16"), jargs, jkw)
    ref32 = _jax_outputs(jp, jcfg, jargs, jkw)
    cfg = AllegroConfig(**kw, **BF16, fused_tp=False)
    assert layer_tier(cfg, False, dtype=torch.bfloat16, card=False) == "plain"
    got = _port_outputs(tp, cfg, targs, tkw)
    assert got["forces"].dtype == np.float32
    _model_gate(got, want, "plain tier, interior bf16", _distance(want, ref32))


@pytest.mark.parametrize("form", ["k1", "k1-nopos", "perlayer"])
def test_kernel_tiers_match_jax_env_fused_interpret(fixture32, form, monkeypatch):
    import pair_allegro_tpu.ops.pallas_stack as ps

    monkeypatch.setattr(ps, "_INTERPRET", True)
    monkeypatch.setenv("PAT_FORCE_ENV_FUSED", "1")
    if form == "k1-nopos":
        monkeypatch.setenv("PAT_L1_POSITIONAL", "0")
    kw, jcfg, jp, tp, (jargs, jkw, targs, tkw) = fixture32
    fields = dict(layer_fused=False) if form == "perlayer" else {}
    seen = {}
    real_viable = ps.env_fused_viable

    def probe(*a):
        seen["viable"] = real_viable(*a)
        return seen["viable"]

    monkeypatch.setattr(ps, "env_fused_viable", probe)
    jbf = dataclasses.replace(jcfg, interior="bf16", **fields)
    want = _jax_outputs(jp, jbf, jargs, jkw)
    assert seen.get("viable") is True  # JAX's env-fused tier ran
    ref32 = _jax_outputs(jp, dataclasses.replace(jcfg, **fields), jargs, jkw)
    cfg = AllegroConfig(**kw, **BF16, **fields)
    assert layer_tier(cfg, False, dtype=torch.bfloat16, card=False) == form
    got = _port_outputs(tp, cfg, targs, tkw)
    _model_gate(got, want, f"{form} tier, interior bf16", _distance(want, ref32))


@pytest.mark.parametrize("form", ["k1", "k1-nopos", "perlayer", "plain"])
def test_bf16_casts_reach_the_layers(fixture32, form, monkeypatch):
    """The operands reaching K1's / K2's plain versions, or the plain tier's
    TP and latent MLP, are bf16; the energy and forces come back f32."""
    monkeypatch.delenv("PAT_FORCE_ENV_FUSED", raising=False)
    if form == "k1-nopos":
        monkeypatch.setenv("PAT_L1_POSITIONAL", "0")
    kw, _, _, tp, (_, _, targs, tkw) = fixture32
    seen = []

    def spy(mod, name):
        real = getattr(mod, name)

        def f(*a, **k):
            seen.append(tuple(t.dtype for t in a if isinstance(t, torch.Tensor)))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, f)

    fields = {"perlayer": dict(layer_fused=False), "plain": dict(fused_tp=False)}.get(form, {})
    if form in ("k1", "k1-nopos"):
        spy(fl, "fused_layer_reference")
    elif form == "perlayer":
        spy(k2, "env_layer_reference")
    else:
        spy(t_allegro, "uniform_tp")
        spy(t_allegro, "tp_mix_apply")
    cfg = AllegroConfig(**kw, **BF16, **fields)
    got = _port_outputs(tp, cfg, targs, tkw)
    assert seen and all(d == torch.bfloat16 for call in seen for d in call), seen
    assert got["forces"].dtype == np.float32 and np.isfinite(got["forces"]).all()
    assert len(seen) >= cfg.num_layers


# ---------------------------------------------------------------------------
# Kernels: the plain versions at bf16 against the Pallas kernels at bf16
# ---------------------------------------------------------------------------


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


# max|port - JAX| / max|JAX| at bf16 (both sides round to bf16, at places of
# their own): forward, backward
KERNEL_TOLS = (2e-2, 4e-2)


@pytest.mark.parametrize("first_v,last", [(True, False), (False, False), (False, True)])
def test_k1_plain_matches_jax_kernel_interpret_bf16(first_v, last, monkeypatch):
    import pair_allegro_tpu.ops.pallas_stack as ps
    from test_torch_port_layer import AVG, K, LMAX, PARITY, _inputs, _params, _to_t, _torch_layer

    monkeypatch.setattr(ps, "_INTERPRET", True)
    layer, w = _params(torch.float32)
    tin = [t.to(torch.bfloat16) for t in _to_t(*_inputs(3), first_v, torch.float32)]
    jin = tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tin)

    def kern(*a):
        out = ps.allegro_layer_fused_t(*a, layer, LMAX, K, AVG, parity=PARITY,
                                       first_v=first_v, last=last)
        return (out,) if last else out

    j_out = kern(*jin)
    assert all(o.dtype == jnp.bfloat16 for o in j_out)
    rng = np.random.RandomState(4)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in j_out]
    g_j = jax.grad(lambda *a: sum(jnp.sum(o.astype(jnp.float32) * c)
                                  for o, c in zip(kern(*a), cots)), (0, 1, 2, 3))(*jin)
    tin = [t.requires_grad_(True) for t in tin]
    t_out = _torch_layer(w, first_v, last)(*tin)
    errs = [_rel_err(a.detach().float().numpy(), np.asarray(b, np.float32))
            for a, b in zip(t_out, j_out)]
    g_t = torch.autograd.grad(t_out, tin, [torch.tensor(c).to(torch.bfloat16) for c in cots])
    gerrs = [_rel_err(a.float().numpy(), np.asarray(b, np.float32)) for a, b in zip(g_t, g_j)]
    # before the K1 body rounded its constants as JAX's weak typing does: f32 constants
    old = fl.fused_layer_reference(*[t.detach() for t in tin], w, K, 1.0 / math.sqrt(AVG),
                                   first_v, last, None, torch.float32)
    old_errs = [_rel_err(a.float().numpy(), np.asarray(b, np.float32))
                for a, b in zip((old,) if last else old, j_out)]
    print(f"K1 bf16 first_v={first_v} last={last}: fwd {errs}, bwd {gerrs}; fwd with f32 "
          f"constants (before) {old_errs}")
    assert all(t.dtype == torch.bfloat16 for t in (*t_out, *g_t))
    assert max(errs) <= KERNEL_TOLS[0] and max(gerrs) <= KERNEL_TOLS[1]


def test_k2_plain_matches_jax_kernel_interpret_bf16(monkeypatch):
    import pair_allegro_tpu.ops.pallas_stack as ps
    from test_torch_port_env_layer import AVG, K, LMAX, PARITY, _inputs, _mix

    monkeypatch.setattr(ps, "_INTERPRET", True)
    jmix, tmix = _mix(torch.float32)
    ins = [t.to(torch.bfloat16) for t in _inputs(3, torch.float32)]
    jin = tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ins)
    ws_flat = tuple(jmix[f"l{l3}"] for l3 in range(LMAX + 1))

    def kern(*a):
        return ps.tp_mix_env_fused_t(*a, ws_flat, LMAX, K, AVG, parity=PARITY, inv_t=True,
                                     mode="paths")

    j_out = kern(*jin)
    rng = np.random.RandomState(4)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in j_out]
    g_j = jax.grad(lambda *a: sum(jnp.sum(o.astype(jnp.float32) * c)
                                  for o, c in zip(kern(*a), cots)), (0, 1, 2))(*jin)
    ins = [t.requires_grad_(True) for t in ins]
    out = k2.env_layer(*ins, k2.k2_weights(tmix, LMAX, PARITY), K, AVG)
    errs = [_rel_err(a.detach().float().numpy(), np.asarray(b, np.float32))
            for a, b in zip(out, j_out)]
    g_t = torch.autograd.grad(out, ins, [torch.tensor(c).to(torch.bfloat16) for c in cots])
    gerrs = [_rel_err(a.float().numpy(), np.asarray(b, np.float32)) for a, b in zip(g_t, g_j)]
    print(f"K2 bf16: fwd {errs}, bwd {gerrs}")
    assert all(t.dtype == torch.bfloat16 for t in (*out, *g_t))
    assert max(errs) <= KERNEL_TOLS[0] and max(gerrs) <= KERNEL_TOLS[1]


# ---------------------------------------------------------------------------
# Routing and the memory estimate
# ---------------------------------------------------------------------------

ROUTES = [  # (config fields, environment, tier on the card at bf16, at f32)
    ({}, {}, "k1", "k1"),
    ({}, {"PAT_L1_POSITIONAL": "0"}, "k1-nopos", "k1-nopos"),
    ({}, {"PAT_L1_EMBED": "1"}, "k1-embed", "k1-embed"),
    (dict(fused_stack=True), {}, "stack", "stack"),
    (dict(layer_fused=False), {}, "perlayer", "perlayer"),
    (dict(layer_fused=False, tp_mode="mxu_highest"), {}, "plain", "perlayer"),
    (dict(layer_fused=False, tp_mode="mxu_bf16"), {}, "plain", "perlayer"),
    (dict(fused_tp=False), {}, "plain", "plain"),
]


@pytest.mark.parametrize("fields,env,bf16,f32", ROUTES)
def test_routes_on_the_card_at_bf16(fields, env, bf16, f32, monkeypatch):
    for name in ("PAT_L1_POSITIONAL", "PAT_L1_EMBED"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, **BF16, **fields)
    assert cfg.interior_dtype(torch.float32) == torch.bfloat16
    assert layer_tier(cfg, False, dtype=torch.bfloat16, card=True) == bf16
    assert layer_tier(cfg, False, dtype=torch.float32, card=True) == f32
    # the FLAT layout's K4 has no bf16 build
    assert layer_tier(cfg, True, dtype=torch.bfloat16, card=True) == "plain"
    if cfg.fused_tp and not cfg.fused_stack:
        assert layer_tier(cfg, True, dtype=torch.float32, card=True) == "k4"
    # any other interior dtype runs the plain path on the card
    assert layer_tier(cfg, False, dtype=torch.float16, card=True) == "plain"


def test_kernel_takes_at_bf16():
    """K1 and K2 take the flagship widths at f32 and bf16 (the same shared
    memory: the bf16 builds keep f32 tiles) and no other dtype; K5 has no
    bf16 build; a width K1 refuses at f32 it refuses at bf16, and the route
    then leaves the kernel."""
    from pair_allegro_tpu_torch.ops.mlp import mlp_dims
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    P = num_paths_per_l(2, 2, 2, True)
    latd = mlp_dims(64 + 32 * P[0], 64, 2, 64)
    for dt in (torch.float32, torch.bfloat16):
        assert fl.kernel_takes(64, 32, 32, 9, latd, 2, True, dt)
        assert k2.kernel_takes(32, 32, 9, 2, True, dt)
    for dt in (torch.float16, torch.float64):
        assert not fl.kernel_takes(64, 32, 32, 9, latd, 2, True, dt)
        assert not k2.kernel_takes(32, 32, 9, 2, True, dt)
    flagship = AllegroConfig(type_names=("Cu",), r_max=4.5, **BF16)
    assert env_fused_viable(flagship, torch.bfloat16)
    assert not env_fused_viable(dataclasses.replace(flagship, layer_fused=False,
                                                    tp_mode="mxu_highest"), torch.bfloat16)
    wide = dataclasses.replace(flagship, num_scalar_features=66)  # ns % 4: K1 refuses
    assert not env_fused_viable(wide, torch.bfloat16)
    assert layer_tier(wide, False, dtype=torch.bfloat16, card=True) == "plain"
    assert layer_tier(wide, False, dtype=torch.float32, card=True) == "k4"


def test_memory_estimate_at_bf16():
    """The bf16 estimate is the f32 one with the interior's share at 2 bytes
    a number: 2 * (per - 64) + 4 * 64 against 4 * per on the K1 tier."""
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5)
    bf = dataclasses.replace(cfg, interior="bf16")
    d, c, ns, L = 9, 32, 64, 3
    per = 2 * d * c * L + 6 * ns + 64
    assert cfg.live_bytes_per_edge() == 4 * per
    assert bf.live_bytes_per_edge() == 2 * (per - 64) + 4 * 64
    assert bf.live_bytes_per_edge() < cfg.live_bytes_per_edge()
    assert cfg.live_bytes_per_edge() - bf.live_bytes_per_edge() == 2 * (per - 64)
