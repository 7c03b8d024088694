"""K6, K7 and K8 at ``interior="bf16"`` against the JAX package on the CPU.

* Kernels: K6's and K7's plain versions (ops/embed_layer.py,
  ops/readout_layer.py) on bf16 operands against JAX's Pallas kernels
  ``allegro_layer_embed_fused_t`` / ``allegro_layer_readout_fused_t`` run
  in interpret mode at bf16, forward and VJP (K7 with and without the
  charge head), and so are the card's oracles of their bf16 builds (the
  plain versions at f32 on the same bf16 values with
  ``scalars=torch.bfloat16``); K8's plain version (ops/fused_stack.py), and
  ``stack_rounded_reference`` (the card's oracle of K8's bf16 build) at
  f32 on the same bf16 values, against JAX's ``allegro_stack_apply`` at
  bf16, which off the TPU is ``allegro_stack_ref``, at l_max 1 and 2 and
  1 to 3 layers.  Tolerances:
  tests/test_torch_port_interior_bf16.py's ``KERNEL_TOLS`` (both sides
  round at bf16, at places of their own).
* Models, on the ``_kw(3)`` / ``_case(3)`` fixture of
  tests/test_torch_port_tiers.py (two species in the config, every atom of
  type A, typed cutoffs, 16 / 8 features, l_max 2, charges) at 2 and 3
  layers: the port's ``k1-embed`` tier against JAX's embed tier (its K6 /
  K1 / K7 Pallas kernels in interpret mode, ``PAT_FORCE_ENV_FUSED=1``,
  ``PAT_L1_EMBED=1``) and the port's ``stack`` tier against JAX's stack,
  within the bf16 model gate of tests/test_torch_port_interior_bf16.py
  (|dE| <= 5e-3 max(1, |E|), max|dF| <= 2e-2 max|F|); the embed tier also
  against JAX's embed tier run eagerly, which differs from its jitted run
  (printed).  The embed case failed before the
  plain K6 / K7 rounded their prologue's and epilogue's constants to bf16
  as JAX does.
* The bf16 casts reach K6's, K7's and K8's plain versions; ``kernel_takes``
  at bf16; and JAX's K5 (``tp_mix_env_fused_t`` in an ``mxu_*`` mode)
  raising on bf16 operands, the reason the port has no K5 bf16 build."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.ops.pallas_stack import allegro_stack_apply
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    embed_readout_viable,
    layer_tier,
    stack_viable,
)
from pair_allegro_tpu_torch.ops import embed_layer as k6
from pair_allegro_tpu_torch.ops import fused_stack as k8
from pair_allegro_tpu_torch.ops import readout_layer as k7
from test_torch_port_embed_readout import ARGS, CASES, _inputs, _layer_params, _port_fn, _to_port
from test_torch_port_embed_readout import AVG as ER_AVG
from test_torch_port_embed_readout import K as ER_K
from test_torch_port_embed_readout import LMAX as ER_LMAX
from test_torch_port_embed_readout import PARITY as ER_PARITY
from test_torch_port_interior_bf16 import KERNEL_TOLS, _distance, _model_gate, _rel_err
from test_torch_port_stack import NC, _fm, _layers
from test_torch_port_stack import AVG as ST_AVG
from test_torch_port_stack import K as ST_K
from test_torch_port_tiers import _case, _jax_outputs, _kw, _params, _port_outputs

torch.set_num_threads(2)
BF = torch.bfloat16
ENV = ("PAT_L1_EMBED", "PAT_L1_POSITIONAL", "PAT_FORCE_ENV_FUSED")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _errors(t_out, j_out, g_t, g_j):
    fwd = [_rel_err(a.detach().float().numpy(), np.asarray(b, np.float32))
           for a, b in zip(t_out, j_out)]
    bwd = [_rel_err(a.float().numpy(), np.asarray(b, np.float32)) for a, b in zip(g_t, g_j)]
    return fwd, bwd


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("oracle", ["plain", "rounded"])
@pytest.mark.parametrize("kernel,charges", CASES)
def test_k6_k7_plain_match_jax_kernels_interpret_bf16(kernel, charges, oracle, monkeypatch):
    """K6's and K7's plain versions on bf16 operands ("plain"), and the
    card's oracles of their bf16 builds ("rounded": the plain versions at
    f32 on the same bf16 values, on the weights rounded to bf16, with
    ``scalars=torch.bfloat16``), against JAX's kernels in interpret mode at
    bf16, forward and VJP."""
    import pair_allegro_tpu.ops.pallas_stack as ps

    monkeypatch.setattr(ps, "_INTERPRET", True)
    tree, tp = _layer_params(torch.float32, charges)
    w = (k6.k6_weights(tp, ER_LMAX, ER_PARITY) if kernel == "k6"
         else k7.k7_weights(tp, ER_LMAX, ER_PARITY, charges))
    tin = _to_port(_inputs(3, 12), torch.float32)
    tin = [tin[key].to(BF) for key in ARGS[kernel]]
    dt = BF if oracle == "plain" else torch.float32
    jin = tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tin)
    la, lb = tree["layers"]

    def kern(*a):
        if kernel == "k6":
            return ps.allegro_layer_embed_fused_t(*a, la, tuple(tree["two_body_mlp"]["w"]),
                                                  tree["tensor_embed"], ER_LMAX, ER_K, ER_AVG,
                                                  parity=ER_PARITY)
        q = tuple(tree["charge_mlp"]["w"]) if charges else ()
        out = ps.allegro_layer_readout_fused_t(*a, lb, tuple(tree["readout_mlp"]["w"]), q,
                                               ER_LMAX, ER_K, ER_AVG, parity=ER_PARITY)
        return out if charges else (out,)

    j_out = kern(*jin)
    assert all(o.dtype == jnp.bfloat16 for o in j_out)
    rng = np.random.RandomState(4)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in j_out]
    g_j = jax.grad(lambda *a: sum(jnp.sum(o.astype(jnp.float32) * c)
                                  for o, c in zip(kern(*a), cots)), tuple(range(len(jin))))(*jin)
    tin = [t.to(dt).requires_grad_(True) for t in tin]
    if oracle == "plain":
        t_out = _port_fn(kernel, w)(*tin)
    else:
        tp_r = jax.tree.map(lambda t: t.to(BF).float(), tp)
        inv_avg = 1.0 / np.sqrt(ER_AVG)
        if kernel == "k6":
            w_r = k6.prepare_embed(tp_r, ER_LMAX, ER_PARITY)
            t_out = k6.embed_layer_reference(*tin, w_r, ER_K, inv_avg, scalars=BF)
        else:
            w_r = k7.prepare_readout(tp_r, ER_LMAX, ER_PARITY, charges)
            t_out = k7.readout_layer_reference(*tin, w_r, ER_K, inv_avg, scalars=BF)
            t_out = t_out if charges else (t_out,)
    g_t = torch.autograd.grad(t_out, tin, [torch.tensor(c).to(BF).to(dt) for c in cots])
    errs, gerrs = _errors(t_out, j_out, g_t, g_j)
    print(f"{kernel} bf16 ({oracle}) charges={charges}: fwd {errs}, bwd {gerrs}")
    assert all(t.dtype == dt for t in (*t_out, *g_t))
    assert max(errs) <= KERNEL_TOLS[0] and max(gerrs) <= KERNEL_TOLS[1]


@pytest.mark.parametrize("oracle", ["plain", "rounded"])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("lmax", [1, 2])
def test_k8_plain_matches_jax_stack_bf16(lmax, n_layers, oracle):
    """K8's plain version on bf16 operands ("plain"), and the card's oracle
    of K8's bf16 build, ``stack_rounded_reference`` at f32 on the same bf16
    values and on the weights rounded to bf16 ("rounded"), against JAX's
    allegro_stack_apply on those bf16 values (allegro_stack_ref off the
    TPU), x_final and the VJP (dx0, dp, dY, du)."""
    jl, tl = _layers(lmax, True, n_layers)
    jl = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jl)
    tl = jax.tree.map(lambda t: t.float(), tl)  # f32 weights, as the model's tree
    rng = np.random.RandomState(10 * lmax + n_layers)
    u = rng.rand(NC, ST_K)
    u[-1, -ST_K // 3:] = 0.0
    ops = {"x0": rng.randn(NC, ST_K, 16) * 0.3, "p": rng.randn(NC, ST_K, 8) * 0.3,
           "Y": rng.randn(NC, ST_K, (lmax + 1) ** 2), "u": u}
    ops = {k: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32) for k, v in ops.items()}

    def f(x0, p, Y, u):
        return allegro_stack_apply(x0, p, Y, u, jl, lmax, ST_AVG, parity=True)

    j_in = [jnp.asarray(ops[name], jnp.bfloat16) for name in ("x0", "p", "Y", "u")]
    out, vjp = jax.vjp(f, *j_in)
    assert out.dtype == jnp.bfloat16
    cot = np.random.RandomState(99).randn(*out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot, jnp.bfloat16))
    dt = BF if oracle == "plain" else torch.float32
    ins = [_fm(ops[name]).to(BF).to(dt).requires_grad_(True) for name in ("x0", "p", "Y", "u")]
    if oracle == "plain":
        got = k8.allegro_stack_reference(*ins, tl, ST_K, lmax, ST_AVG, True)
    else:
        tl_r = jax.tree.map(lambda t: t.to(BF).float(), tl)
        got = k8.stack_rounded_reference(*ins, tl_r, ST_K, lmax, ST_AVG, True)
    grads = torch.autograd.grad(got, ins, _fm(cot).to(BF).to(dt))
    errs, gerrs = _errors([got], [_fm(np.asarray(out, np.float32)).numpy()], grads,
                          [_fm(np.asarray(w, np.float32)).numpy() for w in want])
    print(f"K8 bf16 ({oracle}) l_max={lmax} {n_layers} layers: fwd {errs}, bwd {gerrs}")
    assert got.dtype == dt and all(g.dtype == dt for g in grads)
    assert max(errs) <= KERNEL_TOLS[0] and max(gerrs) <= KERNEL_TOLS[1]


# ---------------------------------------------------------------------------
# Models: the k1-embed and stack tiers against JAX's at bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 3], ids=["2 layers", "3 layers"])
def fixture_bf16(request):
    kw = _kw(3, num_layers=request.param)
    jcfg, jp, tp = _params(kw, torch.float32)
    return kw, jcfg, jp, tp, _case(3, torch.float32)


@pytest.mark.parametrize("tier", ["k1-embed", "stack"])
def test_embed_and_stack_tiers_match_jax_bf16(fixture_bf16, tier, monkeypatch):
    import pair_allegro_tpu.ops.pallas_stack as ps

    kw, jcfg, jp, tp, (jargs, jkw, targs, tkw) = fixture_bf16
    fields = dict(fused_stack=True) if tier == "stack" else {}
    calls = []
    if tier == "k1-embed":
        monkeypatch.setattr(ps, "_INTERPRET", True)
        monkeypatch.setenv("PAT_FORCE_ENV_FUSED", "1")
        monkeypatch.setenv("PAT_L1_EMBED", "1")
        real = ps.allegro_layer_embed_fused_t
        monkeypatch.setattr(ps, "allegro_layer_embed_fused_t",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    else:
        real = ps.allegro_stack_apply
        monkeypatch.setattr(ps, "allegro_stack_apply",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    jbf = dataclasses.replace(jcfg, interior="bf16", **fields)
    want = _jax_outputs(jp, jbf, jargs, jkw)
    assert calls  # JAX's embed/readout kernels or its stack ran
    ref32 = _jax_outputs(jp, dataclasses.replace(jcfg, **fields), jargs, jkw)
    cfg = AllegroConfig(**kw, interior="bf16", **fields)
    assert layer_tier(cfg, False, dtype=BF, card=False) == tier
    got = _port_outputs(tp, cfg, targs, tkw)
    assert got["forces"].dtype == np.float32
    _model_gate(got, want, f"{tier} tier, {cfg.num_layers} layers, interior bf16",
                _distance(want, ref32))


def test_embed_tier_matches_jax_eager_bf16(fixture_bf16, monkeypatch):
    """The reference's embed tier at bf16 moves with jit: run eagerly
    (its glue's f32 geometry in other roundings, which the bf16 casts of
    in_T and u can flip at a short edge) it gives other forces than under
    jit.  The port is held to the eager run too, within the same gate; both
    distances and JAX's own are printed."""
    import pair_allegro_tpu.ops.pallas_stack as ps
    from pair_allegro_tpu.models.allegro import allegro_energy as j_energy
    from pair_allegro_tpu.potential import make_potential as j_potential
    from test_torch_port_tiers import _outputs

    kw, jcfg, jp, tp, (jargs, jkw, targs, tkw) = fixture_bf16
    monkeypatch.setattr(ps, "_INTERPRET", True)
    monkeypatch.setenv("PAT_FORCE_ENV_FUSED", "1")
    monkeypatch.setenv("PAT_L1_EMBED", "1")
    jbf = dataclasses.replace(jcfg, interior="bf16")
    eager = _outputs(j_potential(lambda *a, **k: j_energy(jp, jbf, *a, **k))(*jargs, **jkw))
    jitted = _jax_outputs(jp, jbf, jargs, jkw)
    got = _port_outputs(tp, AllegroConfig(**kw, interior="bf16"), targs, tkw)
    print(f"JAX's embed tier at bf16, jit against eager: {_distance(jitted, eager)}; the port "
          f"against jit: {_distance(got, jitted)}")
    _model_gate(got, eager, f"k1-embed tier, {kw['num_layers']} layers, against JAX eager")


@pytest.mark.parametrize("tier", ["k1-embed", "stack"])
def test_bf16_casts_reach_k6_k7_k8(tier, monkeypatch):
    """The operands reaching K6's and K7's plain versions (the embed form)
    or K8's (the stack) are bf16; the energy and forces come back f32."""
    kw = _kw(2)
    _, _, tp = _params(kw, torch.float32)
    _, _, targs, tkw = _case(2, torch.float32)
    seen = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def f(*a, **k):
            seen.setdefault(name, []).append(tuple(t.dtype for t in a if torch.is_tensor(t)))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, f)

    if tier == "k1-embed":
        monkeypatch.setenv("PAT_L1_EMBED", "1")
        spy(k6, "embed_layer_reference")
        spy(k7, "readout_layer_reference")
        fields = {}
    else:
        spy(k8, "allegro_stack_reference")
        fields = dict(fused_stack=True)
    got = _port_outputs(tp, AllegroConfig(**kw, interior="bf16", **fields), targs, tkw)
    names = ("embed_layer_reference", "readout_layer_reference") if tier == "k1-embed" else (
        "allegro_stack_reference",)
    assert set(seen) == set(names), seen
    assert all(d == BF for calls in seen.values() for call in calls for d in call), seen
    assert got["forces"].dtype == np.float32 and np.isfinite(got["forces"]).all()


# ---------------------------------------------------------------------------
# kernel_takes at bf16, and JAX's K5 at bf16
# ---------------------------------------------------------------------------


def test_k6_k7_k8_kernel_takes_at_bf16():
    """K6, K7 and K8 take the flagship widths at f32 and bf16 (the bf16
    builds keep f32 tiles: the same shared memory) and no other dtype; the
    embed form and the stack keep their kernels on the card at bf16, and
    fall back as at f32 where a kernel refuses the widths."""
    from pair_allegro_tpu_torch.ops.mlp import mlp_dims
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    P = num_paths_per_l(2, 2, 2, True)
    latd = mlp_dims(64 + 32 * P[0], 64, 2, 64)
    tb, head = (10, 64, 64, 64), (64, 32, 1)
    for dt, takes in ((torch.float32, True), (BF, True), (torch.float16, False),
                      (torch.float64, False)):
        assert k6.kernel_takes(64, 32, 9, latd, 2, True, tb, dt) == takes
        assert k7.kernel_takes(64, 32, 9, latd, 2, True, (head, head), dt) == takes
        assert k8.kernel_takes(64, 32, 9, latd, 2, True, 3, dt) == takes
    flagship = AllegroConfig(type_names=("Cu",), r_max=4.5, interior="bf16")
    assert embed_readout_viable(flagship, BF) and stack_viable(flagship, BF)
    assert not embed_readout_viable(flagship, torch.float16)
    wide = dataclasses.replace(flagship, readout_mlp_hidden_layers_width=30)  # K7 refuses
    assert not embed_readout_viable(wide, BF)
    deep = dataclasses.replace(flagship, num_layers=9, fused_stack=True)  # K8 refuses
    assert not stack_viable(deep, BF)
    assert layer_tier(deep, False, dtype=BF, card=True) == "k1"


@pytest.mark.parametrize("mode", ["mxu_highest", "mxu_bf16x3", "mxu_bf16"])
def test_jax_k5_refuses_bf16_operands(mode, monkeypatch):
    """The reference's K5 (``tp_mix_env_fused_t`` in an ``mxu_*`` mode) in
    interpret mode raises on bf16 operands: its product leaves at f32
    (``preferred_element_type=float32``) and is stored into a bf16 output.
    So the reference's per-layer ``mxu_*`` tier at ``interior="bf16"`` has
    no kernel to port, and the port runs it on the plain path; ``paths``
    (K2) takes bf16 operands."""
    import pair_allegro_tpu.ops.pallas_stack as ps
    from test_torch_port_env_layer import AVG, K, LMAX, PARITY, _inputs, _mix

    monkeypatch.setattr(ps, "_INTERPRET", True)
    jmix, _ = _mix(torch.float32)
    jin = tuple(jnp.asarray(t.to(BF).float().numpy(), jnp.bfloat16)
                for t in _inputs(3, torch.float32))
    ws = tuple(jmix[f"l{l3}"] for l3 in range(LMAX + 1))
    out = ps.tp_mix_env_fused_t(*jin, ws, LMAX, K, AVG, parity=PARITY, inv_t=True, mode="paths")
    assert all(o.dtype == jnp.bfloat16 for o in out)
    with pytest.raises(ValueError, match="dtype"):
        ps.tp_mix_env_fused_t(*jin, ws, LMAX, K, AVG, parity=PARITY, inv_t=True, mode=mode)
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, interior="bf16", layer_fused=False,
                        tp_mode=mode)
    assert layer_tier(cfg, False, dtype=BF, card=True) == "plain"
