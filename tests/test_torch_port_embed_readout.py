"""K6 (ops/embed_layer.py) and K7 (ops/readout_layer.py), and the K1 tier's
forms that the reference selects from the environment (``PAT_L1_EMBED=1``,
``PAT_L1_POSITIONAL=0``), against the JAX package: the plain versions
against the JAX Pallas kernels (``allegro_layer_embed_fused_t``,
``allegro_layer_readout_fused_t``) in interpret mode at f32 and against the
JAX layer math at f64, forward and backward; the NaN weight-cotangent
contract; the model on the CPU against JAX's at f64 and against JAX's own
embed/readout tier in interpret mode at f32; the routing.  The CUDA
kernels' own legs are in tests/test_torch_cuda.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_energy as j_energy
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.ops.mlp import mlp_apply
from pair_allegro_tpu.ops.tp import scalar_part, tp_mix_apply, uniform_tp
from pair_allegro_tpu.potential import make_potential as j_potential
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_energy,
    allegro_params_from_numpy,
    layer_tier,
)
from pair_allegro_tpu_torch.ops import embed_layer as k6
from pair_allegro_tpu_torch.ops import readout_layer as k7
from pair_allegro_tpu_torch.potential import make_potential
from test_torch_port_tiers import _case, _close, _kw, _params

torch.set_num_threads(2)

LMAX, NS, C, K, NC, PARITY, AVG = 2, 16, 8, 32, 8, True, 5.0
D = (LMAX + 1) ** 2
E = NC * K
ENV = ("PAT_L1_EMBED", "PAT_L1_POSITIONAL", "PAT_FORCE_ENV_FUSED")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _layer_params(dtype, charges=True):
    """The JAX tree and the port's tree of a 2-layer model at the layer
    tests' widths (two species: 2*2 + 8 = 12 two-body input rows)."""
    kw = dict(type_names=("A", "B"), r_max=4.0, l_max=LMAX, num_layers=2, num_scalar_features=NS,
              num_tensor_features=C, avg_num_neighbors=AVG, output_charges=charges)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    tree = allegro_init(jax.random.PRNGKey(0), JaxConfig(**kw), dtype=jdt)
    return tree, allegro_params_from_numpy(jax.tree.map(np.asarray, tree), AllegroConfig(**kw),
                                           device="cpu", dtype=dtype)


def _inputs(seed, n_in):
    """(nc, k, ...) numpy operands: two-body input rows, x, p (V = p * Y
    plus noise, so V is not rank one), Y, u with padded slots."""
    rng = np.random.RandomState(seed)
    u = rng.rand(NC, K)
    u[-1, -K // 3:] = 0.0
    p = rng.randn(NC, K, C) * 0.3
    Y = rng.randn(NC, K, D)
    V = p[..., :, None] * Y[..., None, :] + rng.randn(NC, K, C, D) * 0.1
    return {"inp": rng.randn(NC, K, n_in) * 0.5, "x": rng.randn(NC, K, NS) * 0.3, "V": V, "Y": Y,
            "u": u}


def _fm(a):
    """(nc, k, ...) -> the port's feature-major (..., E)."""
    a = np.asarray(a).reshape(E, -1)
    return a.T if a.ndim == 2 else a


def _to_port(ops, dtype):
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype)

    V = np.transpose(np.asarray(ops["V"]).reshape(E, C, D), (2, 1, 0))
    return {"in": t(_fm(ops["inp"])), "x": t(_fm(ops["x"])), "V": t(V), "Y": t(_fm(ops["Y"])),
            "u": t(np.asarray(ops["u"]).reshape(1, E))}


def _tols_close(got, want, name, kind):
    """forward 1e-5 + 1e-4 max|ref|, backward 1e-4 + 1e-3 max|ref|: f32 sums
    of up to a few hundred terms in another order."""
    atol, rtol = (1e-5, 1e-4) if kind == "fwd" else (1e-4, 1e-3)
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= atol + rtol * float(np.abs(want).max()), f"{name} {kind}: {err:.3e}"


def _port_fn(kernel, w):
    if kernel == "k6":
        def f(in_t, Y, u):
            return k6.embed_layer(in_t, Y, u, w, K, AVG)
        return f

    def g(x, V, Y, u):
        out = k7.readout_layer(x, V, Y, u, w, K, AVG)
        return out if isinstance(out, tuple) else (out,)
    return g


CASES = [("k6", True), ("k7", False), ("k7", True)]
ARGS = {"k6": ("in", "Y", "u"), "k7": ("x", "V", "Y", "u")}


def _weights(kernel, tp, charges):
    if kernel == "k6":
        return k6.k6_weights(tp, LMAX, PARITY)
    return k7.k7_weights(tp, LMAX, PARITY, charges)


@pytest.mark.parametrize("kernel,charges", CASES)
def test_plain_matches_jax_kernel_interpret_f32(kernel, charges, monkeypatch):
    """f32: K6's / K7's plain versions against the JAX Pallas kernels run in
    interpret mode at exact-f32 dots (PAT_EMBED_PREC=highest, PAT_ENV_MM=
    highest), forward and VJP."""
    import pair_allegro_tpu.ops.pallas_stack as ps
    from pair_allegro_tpu.ops.prec import matmul_precision

    monkeypatch.setenv("PAT_ENV_MM", "highest")
    monkeypatch.setenv("PAT_EMBED_PREC", "highest")
    monkeypatch.setattr(ps, "_INTERPRET", True)
    tree, tp = _layer_params(torch.float32, charges)
    w = _weights(kernel, tp, charges)
    tin = _to_port(_inputs(3, 12), torch.float32)
    tin = [tin[key] for key in ARGS[kernel]]
    jin = tuple(jnp.asarray(a.numpy()) for a in tin)
    la, lb = tree["layers"]

    def kern(*a):
        if kernel == "k6":
            return ps.allegro_layer_embed_fused_t(*a, la, tuple(tree["two_body_mlp"]["w"]),
                                                  tree["tensor_embed"], LMAX, K, AVG, parity=PARITY)
        q = tuple(tree["charge_mlp"]["w"]) if charges else ()
        out = ps.allegro_layer_readout_fused_t(*a, lb, tuple(tree["readout_mlp"]["w"]), q, LMAX, K,
                                               AVG, parity=PARITY)
        return out if charges else (out,)

    with matmul_precision("highest"):
        j_out = kern(*jin)
        rng = np.random.RandomState(4)
        cots = [rng.randn(*o.shape).astype(np.float32) for o in j_out]
        g_j = jax.grad(lambda *a: sum(jnp.sum(o * ct) for o, ct in zip(kern(*a), cots)),
                       tuple(range(len(jin))))(*jin)
    tin = [a.requires_grad_(True) for a in tin]
    t_out = _port_fn(kernel, w)(*tin)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        _tols_close(a.detach().numpy(), b, f"{kernel} output {i}", "fwd")
    loss = sum((o * torch.tensor(ct)).sum() for o, ct in zip(t_out, cots))
    for name, a, b in zip(ARGS[kernel], torch.autograd.grad(loss, tin), g_j):
        _tols_close(a.numpy(), b, f"{kernel} d{name}", "bwd")


@pytest.mark.parametrize("kernel,charges", CASES)
def test_plain_matches_jax_layer_math_f64(kernel, charges):
    """f64: the plain versions (through their autograd Functions) against
    the JAX layer math of tests/test_stack_fused.py (two-body MLP, embed,
    layer, heads), forward and VJP, to 1e-10."""
    tree, tp = _layer_params(torch.float64, charges)
    w = _weights(kernel, tp, charges)
    ops = _inputs(5, 12)
    la, lb = tree["layers"]
    cns = 1.0 / math.sqrt(NS)

    def layer(lay, x, V, Y, u, last):
        w_env = jnp.einsum("nks,sc->nkc", x, lay["env_weight"]) * cns * u[..., None]
        env = jnp.einsum("nkc,nkd->ncd", w_env, Y) / math.sqrt(AVG)
        T = uniform_tp(V, jnp.broadcast_to(env[:, None], V.shape), LMAX, PARITY)
        x1 = (x + mlp_apply(lay["latent_mlp"], jnp.concatenate([x, scalar_part(T)], -1))
              * u[..., None]) / math.sqrt(2.0)
        return x1, (None if last else tp_mix_apply(lay["mix"], T))

    def ref(*a):  # to the port's layout: x (ns, E), V (D, C, E), rows (1, E)
        if kernel == "k6":
            inp, Y, u = a
            x0 = mlp_apply(tree["two_body_mlp"], inp) * u[..., None]
            p = jnp.einsum("nks,sc->nkc", x0, tree["tensor_embed"]) * cns
            x1, V1 = layer(la, x0, p[..., :, None] * Y[..., None, :], Y, u, False)
            return x1.reshape(E, NS).T, jnp.transpose(V1.reshape(E, C, D), (2, 1, 0))
        x, V, Y, u = a
        xf, _ = layer(lb, x, V, Y, u, True)
        heads = ["readout_mlp"] + (["charge_mlp"] if charges else [])
        return tuple((mlp_apply(tree[h], xf)[..., 0] * u).reshape(1, E) for h in heads)

    jin = tuple(jnp.asarray(ops[key]) for key in (("inp", "Y", "u") if kernel == "k6"
                                                    else ("x", "V", "Y", "u")))
    r_out = jax.jit(ref)(*jin)
    rng = np.random.RandomState(6)
    cots = [rng.randn(*o.shape) for o in r_out]
    g_j = jax.jit(jax.grad(lambda *a: sum(jnp.sum(o * ct) for o, ct in zip(ref(*a), cots)),
                           tuple(range(len(jin)))))(*jin)
    tin = _to_port(ops, torch.float64)
    tin = [tin[key].requires_grad_(True) for key in ARGS[kernel]]
    t_out = _port_fn(kernel, w)(*tin)
    for a, b in zip(t_out, r_out):
        _close(a.detach().numpy(), b, f"{kernel} forward")
    g_t = torch.autograd.grad(sum((o * torch.tensor(ct)).sum() for o, ct in zip(t_out, cots)), tin)
    for name, a, b in zip(ARGS[kernel], g_t, g_j):
        b = np.asarray(b)
        got = a.numpy()
        if name == "V":  # (D, C, E) -> JAX's (nc, k, C, D)
            got = np.transpose(got, (2, 1, 0)).reshape(b.shape)
        else:
            got = got.T.reshape(b.shape)
        _close(got, b, f"{kernel} d{name}")


@pytest.mark.parametrize("kernel", ["k6", "k7"])
def test_weight_cotangents_are_nan(kernel):
    """The reference's contract: every weight leaf K6 (two-body MLP,
    tensor_embed, the first layer's) and K7 (the last layer's, readout and
    charge heads) read gets a NaN-filled cotangent; the operands' are
    finite."""
    _, tp = _layer_params(torch.float32)
    w = _weights(kernel, tp, True)
    want = ([*tp["two_body_mlp"]["w"], tp["tensor_embed"]] if kernel == "k6"
            else [*tp["readout_mlp"]["w"], *tp["charge_mlp"]["w"]])
    assert all(any(t is leaf for leaf in w.tensors()) for t in want)
    for t in w.tensors():
        t.requires_grad_(True)
    try:
        tin = _to_port(_inputs(7, 12), torch.float32)
        tin = [tin[key].requires_grad_(True) for key in ARGS[kernel]]
        out = _port_fn(kernel, w)(*tin)
        grads = torch.autograd.grad(sum(o.sum() for o in out), [*tin, *w.tensors()])
    finally:
        for t in w.tensors():
            t.requires_grad_(False)
    assert all(torch.isfinite(g).all() for g in grads[:len(tin)])
    assert all(torch.isnan(g).all() for g in grads[len(tin):])


def _outputs(o):
    return {"total_energy": float(o.total_energy), "atomic_energy": np.asarray(o.atomic_energy),
            "forces": np.asarray(o.forces), "virial": np.asarray(o.virial),
            "charges": np.asarray(o.extras["charges"]), "dipole": np.asarray(o.extras["dipole"])}


def _model_pair(layers, **kw):
    jcfg, jp, tp = _params(_kw(2, num_layers=layers, **kw))
    jargs, jkw, targs, tkw = _case(2)
    want = _outputs(jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))(*jargs, **jkw))

    def port():
        return _outputs(make_potential(
            lambda *a, **k: allegro_energy(tp, AllegroConfig(**_kw(2, num_layers=layers, **kw)),
                                           *a, **k))(*targs, **tkw))
    return jp, tp, want, port, (jargs, jkw, jcfg)


@pytest.mark.parametrize("layers", [2, 3])
def test_embed_model_matches_jax_f64(layers, monkeypatch):
    """f64, PAT_L1_EMBED=1, two species with typed cutoffs: the port's K6 /
    K1 / K7 tier against JAX's allegro_energy (its layer math off the TPU):
    energy, per-atom energy, forces, virial, charges and dipole, 1e-10."""
    monkeypatch.setenv("PAT_L1_EMBED", "1")
    *_, want, port, _ = _model_pair(layers)
    assert layer_tier(AllegroConfig(**_kw(2, num_layers=layers)), False) == "k1-embed"
    got = port()
    for name in want:
        _close(got[name], want[name], f"{layers} layers {name}")


def test_embed_layouts_follow_in_place_updates(monkeypatch):
    """K6's and K7's cached weight layouts follow in-place updates of the
    two-body MLP, tensor_embed and the heads (the tier ran before the
    update)."""
    monkeypatch.setenv("PAT_L1_EMBED", "1")
    jp, tp, _, port, (jargs, jkw, jcfg) = _model_pair(2)
    port()
    with torch.no_grad():
        tp["two_body_mlp"]["w"][1].mul_(1.5)
        tp["tensor_embed"].add_(0.25)
        tp["readout_mlp"]["w"][0].mul_(-0.5)
        tp["charge_mlp"]["w"][1].add_(0.5)
    jp["two_body_mlp"]["w"][1] = jp["two_body_mlp"]["w"][1] * 1.5
    jp["tensor_embed"] = jp["tensor_embed"] + 0.25
    jp["readout_mlp"]["w"][0] = jp["readout_mlp"]["w"][0] * -0.5
    jp["charge_mlp"]["w"][1] = jp["charge_mlp"]["w"][1] + 0.5
    want = _outputs(jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))(*jargs, **jkw))
    got = port()
    for name in ("total_energy", "forces", "charges"):
        _close(got[name], want[name], f"{name} after the update")


def test_nopos_model_matches_jax_f64(monkeypatch):
    """f64, PAT_L1_POSITIONAL=0 (bench.py's kernel-nopos rung): every layer
    on K1's middle form with V0 materialised, against JAX, 1e-10."""
    monkeypatch.setenv("PAT_L1_POSITIONAL", "0")
    *_, want, port, _ = _model_pair(3)
    assert layer_tier(AllegroConfig(**_kw(2, num_layers=3)), False) == "k1-nopos"
    got = port()
    for name in want:
        _close(got[name], want[name], f"nopos {name}")


def test_embed_model_matches_jax_embed_tier_interpret_f32(monkeypatch):
    """f32: the port's embed/readout tier on the CPU against JAX's own
    (PAT_FORCE_ENV_FUSED=1, PAT_L1_EMBED=1, its K6 / K1 / K7 Pallas kernels
    in interpret mode at exact-f32 dots) at the size of
    tests/test_stack_fused.py::test_embed_readout_fused_ab_interpret.
    Tolerances: f32 sums in another order."""
    import pair_allegro_tpu.ops.pallas_stack as ps
    from pair_allegro_tpu.ops.prec import matmul_precision

    from test_stack_fused import _table_inputs

    monkeypatch.setattr(ps, "_INTERPRET", True)
    for name, value in (("PAT_FORCE_ENV_FUSED", "1"), ("PAT_L1_EMBED", "1"),
                        ("PAT_ENV_MM", "highest"), ("PAT_EMBED_PREC", "highest")):
        monkeypatch.setenv(name, value)
    calls = []
    real = ps.allegro_layer_embed_fused_t
    monkeypatch.setattr(ps, "allegro_layer_embed_fused_t", lambda *a, **k: calls.append(1) or real(*a, **k))
    pos, types, j_tab, mask = _table_inputs(np.random.RandomState(0), n=32, k=16, box=7.0)
    kw = dict(type_names=("A", "B"), r_max=4.0, l_max=2, num_layers=3, num_scalar_features=32,
              num_tensor_features=16, avg_num_neighbors=8.0, output_charges=True)
    jcfg = JaxConfig(**kw)
    jp = allegro_init(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    with matmul_precision("highest"):
        o = j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k))(
            jnp.asarray(pos, jnp.float32), jnp.asarray(types), jnp.asarray(j_tab),
            edge_mask=jnp.asarray(mask))
    assert calls  # JAX's embed/readout tier ran
    want = _outputs(o)
    cfg = AllegroConfig(**kw)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert layer_tier(cfg, False) == "k1-embed"
    got = _outputs(make_potential(lambda *a, **k: allegro_energy(tp, cfg, *a, **k))(
        torch.tensor(pos, dtype=torch.float32), torch.tensor(types, dtype=torch.int64),
        torch.tensor(j_tab, dtype=torch.int64), edge_mask=torch.tensor(mask)))
    np.testing.assert_allclose(got["total_energy"], want["total_energy"], rtol=2e-5)
    for name, atol in (("atomic_energy", 5e-5), ("charges", 5e-5), ("forces", 1e-4)):
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=1e-3, err_msg=name)


# (environment, config fields, flat, capture) -> the tier layer_tier names
ROUTES = [
    ({}, {}, False, False, "k1"),
    ({"PAT_L1_EMBED": "1"}, {}, False, False, "k1-embed"),
    ({"PAT_L1_EMBED": "0"}, {}, False, False, "k1"),
    ({"PAT_L1_POSITIONAL": "0"}, {}, False, False, "k1-nopos"),
    ({"PAT_L1_EMBED": "1", "PAT_L1_POSITIONAL": "0"}, {}, False, False, "k1-nopos"),
    ({"PAT_L1_EMBED": "1", "PAT_L1_POSITIONAL": "1"}, {}, False, False, "k1-embed"),
    ({"PAT_L1_EMBED": "1"}, {"num_layers": 1}, False, False, "k1"),
    ({"PAT_L1_EMBED": "1"}, {"layer_fused": False}, False, False, "perlayer"),
    ({"PAT_L1_POSITIONAL": "0"}, {"layer_fused": False}, False, False, "perlayer"),
    ({"PAT_L1_EMBED": "1"}, {}, False, True, "plain"),
    ({"PAT_L1_EMBED": "1"}, {"fused_tp": False}, False, False, "plain"),
    ({"PAT_L1_EMBED": "1"}, {}, True, False, "k4"),
    ({"PAT_L1_POSITIONAL": "0"}, {}, True, False, "k4"),
    # K6 cannot hold a 1024-wide two-body MLP, K7 a head of width 30: the
    # positional K1 tier runs instead
    ({"PAT_L1_EMBED": "1"}, {"two_body_mlp_width": 1024}, False, False, "k1"),
    ({"PAT_L1_EMBED": "1"}, {"readout_mlp_hidden_layers_width": 30}, False, False, "k1"),
]


@pytest.mark.parametrize("env,fields,flat,capture,tier", ROUTES)
def test_layer_tier_routing(env, fields, flat, capture, tier, monkeypatch):
    """layer_tier reads PAT_L1_EMBED and PAT_L1_POSITIONAL per call, with
    the reference's defaults and precedence (models/allegro.py:474-479,
    670-674); capture, fused_tp=False and the FLAT layout keep their
    tiers; K6 / K7's refusals fall back to the positional K1 tier.  On the
    card at bf16 (K6's and K7's bf16 build) every tier stays but K4, which
    has none.  The memory estimate follows the tier."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, **fields)
    assert layer_tier(cfg, flat, capture) == tier
    assert layer_tier(cfg, flat, capture, torch.bfloat16) == ("plain" if tier == "k4" else tier)
    if tier == "k1-nopos":  # V0 (D*C) and its cotangent on top of K1's count
        with monkeypatch.context() as m:
            m.delenv("PAT_L1_POSITIONAL")
            k1 = cfg.live_bytes_per_edge()
        assert cfg.live_bytes_per_edge() == k1 + 4 * 2 * 9 * 32


def test_embed_refusal_runs_the_k1_tier(monkeypatch):
    """A model K7 cannot hold (head width 30) under PAT_L1_EMBED=1 runs the
    positional K1 tier and gives its energy and forces."""
    kw = _kw(1, readout_mlp_hidden_layers_width=30, output_charges=False)
    _, _, tp = _params(kw)
    _, _, targs, tkw = _case(1)
    cfg = AllegroConfig(**kw)
    base = make_potential(lambda *a, **k: allegro_energy(tp, cfg, *a, **k))(*targs, **tkw)
    monkeypatch.setenv("PAT_L1_EMBED", "1")
    assert layer_tier(cfg, False) == "k1"
    got = make_potential(lambda *a, **k: allegro_energy(tp, cfg, *a, **k))(*targs, **tkw)
    assert float(got.total_energy) == float(base.total_energy)
    assert torch.equal(got.forces, base.forces)
