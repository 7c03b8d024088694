"""K8's plain version (ops/fused_stack.py) and the fused-stack tier
(``fused_stack=True``) against the JAX package on the CPU at f64:
``allegro_stack_reference`` against JAX's ``allegro_stack_ref``, forward
and VJP (dx0, dp, dY, du), at l_max 1 and 2, parity on and off, 1 to 3
layers; the wrapper's CPU path and its NaN weight cotangents; the model
under ``fused_stack=True`` against JAX's (off the TPU JAX's
``allegro_stack_apply`` is ``allegro_stack_ref``), with ``fused_tp`` True
and False; ``layer_tier``'s stack routes and the stack tier's memory
estimate.  The CUDA kernel's own legs are in tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.ops.pallas_stack import allegro_stack_ref
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_params_from_numpy,
    layer_tier,
)
from pair_allegro_tpu_torch.ops import fused_stack as k8
from pair_allegro_tpu_torch.ops.fused_layer import layer_leaves
from test_torch_port_tiers import _case, _close, _jax_outputs, _kw, _params, _port_outputs

torch.set_num_threads(2)

NS, C, K, NC, AVG = 16, 8, 12, 6, 5.0
ENV = ("PAT_L1_EMBED", "PAT_L1_POSITIONAL", "PAT_FORCE_ENV_FUSED")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _layers(lmax, parity, n_layers):
    """The JAX tree's layers and the port's, at f64."""
    kw = dict(type_names=("A",), r_max=4.0, l_max=lmax, num_layers=n_layers,
              num_scalar_features=NS, num_tensor_features=C, avg_num_neighbors=AVG, parity=parity)
    tree = allegro_init(jax.random.PRNGKey(n_layers), JaxConfig(**kw), dtype=jnp.float64)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, tree), AllegroConfig(**kw),
                                   device="cpu", dtype=torch.float64)
    return tree["layers"], tp["layers"]


def _inputs(seed, lmax):
    """(NC, K, ...) numpy operands of the stack, u with padded slots."""
    rng = np.random.RandomState(seed)
    u = rng.rand(NC, K)
    u[-1, -K // 3:] = 0.0
    return {"x0": rng.randn(NC, K, NS) * 0.3, "p": rng.randn(NC, K, C) * 0.3,
            "Y": rng.randn(NC, K, (lmax + 1) ** 2), "u": u}


def _fm(a):
    """(NC, K, F) or (NC, K) -> the port's feature-major (F, E) tensor."""
    a = np.asarray(a).reshape(NC * K, -1)
    return torch.tensor(np.ascontiguousarray(a.T))


def _port_ins(ops):
    return [_fm(ops[name]).requires_grad_(True) for name in ("x0", "p", "Y", "u")]


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("lmax,parity", [(1, True), (1, False), (2, True), (2, False)])
def test_stack_reference_matches_jax_f64(lmax, parity, n_layers):
    jl, tl = _layers(lmax, parity, n_layers)
    ops = _inputs(10 * lmax + n_layers, lmax)

    def f(x0, p, Y, u):
        return allegro_stack_ref(x0, p, Y, u, jl, lmax, AVG, parity)

    out, vjp = jax.vjp(f, *(jnp.asarray(ops[name]) for name in ("x0", "p", "Y", "u")))
    cot = np.random.RandomState(99).randn(*out.shape)
    want = vjp(jnp.asarray(cot))
    ins = _port_ins(ops)
    got = k8.allegro_stack_reference(*ins, tl, K, lmax, AVG, parity)
    _close(got.detach().numpy(), _fm(out).numpy(), "x_final")
    grads = torch.autograd.grad(got, ins, _fm(cot))
    for name, g, w in zip(("dx0", "dp", "dY", "du"), grads, want):
        _close(g.numpy(), _fm(w).numpy(), name)


def test_wrapper_on_the_cpu_is_the_plain_version_with_nan_weight_cotangents():
    """On CPU tensors fused_stack runs the plain version: the same x_final
    and input cotangents; every weight leaf's cotangent is NaN, the TPU
    kernel's contract."""
    _, tl = _layers(2, True, 2)
    ops = _inputs(5, 2)
    leaves = [t.requires_grad_(True) for layer in tl for t in layer_leaves(layer, 2)]
    ins = _port_ins(ops)
    out = k8.fused_stack(*ins, tl, K, 2, AVG, True)
    ref = k8.allegro_stack_reference(*[t.detach().requires_grad_(True) for t in ins], tl, K, 2,
                                     AVG, True)
    assert torch.equal(out, ref)
    cot = torch.randn(out.shape, dtype=out.dtype, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, [*ins, *leaves], cot)
    want = torch.autograd.grad(k8.allegro_stack_reference(*ins, tl, K, 2, AVG, True), ins, cot)
    for g, w in zip(got[:4], want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    assert len(got[4:]) == 2 * (1 + 3 + 3) and all(torch.isnan(g).all() for g in got[4:])


def test_wrapper_refuses_shapes_that_do_not_fit():
    _, tl = _layers(2, True, 2)
    ins = [t.detach() for t in _port_ins(_inputs(6, 2))]
    with pytest.raises(ValueError):
        k8.fused_stack(*ins, tl, K + 1, 2, AVG, True)  # E not a multiple of K
    with pytest.raises(ValueError):
        k8.fused_stack(ins[0], ins[1][:4], *ins[2:], tl, K, 2, AVG, True)
    with pytest.raises(ValueError, match="differ in their widths"):
        _, wider = _layers(2, True, 1)
        wider = [{**wider[0], "latent_mlp": {"w": wider[0]["latent_mlp"]["w"][:1] + [
            torch.zeros(64, NS, dtype=torch.float64)]}}]
        k8.fused_stack(*ins, [tl[0], *wider], K, 2, AVG, True)


@pytest.mark.parametrize("species", [1, 2])
@pytest.mark.parametrize("fused_tp", [True, False])
def test_stack_model_matches_jax_f64(species, fused_tp, monkeypatch):
    """fused_stack=True runs the stack tier on the TABLE layout whatever
    fused_tp says, as JAX's use_stack; energy, per-atom energies, forces,
    virial and charges equal JAX's to 1e-10 relative."""
    import pair_allegro_tpu_torch.models.allegro as t_allegro

    kw = _kw(species, num_layers=3, fused_tp=fused_tp, fused_stack=True)
    jcfg, jp, tp = _params(kw)
    jargs, jkw, targs, tkw = _case(species)
    cfg = AllegroConfig(**kw)
    assert layer_tier(cfg, False, dtype=torch.float64, card=False) == "stack"
    calls = []
    real = t_allegro.fused_stack
    monkeypatch.setattr(t_allegro, "fused_stack", lambda *a: calls.append(1) or real(*a))
    got = _port_outputs(tp, cfg, targs, tkw)
    assert calls == [1]
    want = _jax_outputs(jp, jcfg, jargs, jkw)
    for name in want:
        _close(got[name], want[name], f"stack {name}")


# config fields, flat, capture, dtype -> the tier layer_tier names (no
# environment unless given)
ROUTES = [
    (dict(fused_stack=True), False, False, torch.float32, {}, "stack"),
    (dict(fused_stack=True, fused_tp=False), False, False, torch.float32, {}, "stack"),
    (dict(fused_stack=True, layer_fused=False), False, False, torch.float32, {}, "stack"),
    (dict(fused_stack=True), False, False, torch.float32, {"PAT_L1_EMBED": "1"}, "stack"),
    (dict(fused_stack="auto"), False, False, torch.float32, {}, "k1"),
    (dict(fused_stack=True), False, True, torch.float32, {}, "plain"),
    (dict(fused_stack=True), True, False, torch.float32, {}, "k4"),
    (dict(fused_stack=True, fused_tp=False), True, False, torch.float32, {}, "plain"),
    (dict(fused_stack=True), False, False, torch.float64, {}, "plain"),
    # K8 has a bf16 build (interior="bf16"); where it refuses, as at f32
    (dict(fused_stack=True), False, False, torch.bfloat16, {}, "stack"),
    (dict(fused_stack=True, num_layers=9), False, False, torch.bfloat16, {}, "k1"),
    # K8 takes at most 8 layers, and K1's widths: where it refuses, the
    # call routes as if fused_stack were False
    (dict(fused_stack=True, num_layers=9), False, False, torch.float32, {}, "k1"),
    (dict(fused_stack=True, num_layers=9, layer_fused=False), False, False, torch.float32, {},
     "perlayer"),
    (dict(fused_stack=True, num_layers=9, fused_tp=False), False, False, torch.float32, {},
     "plain"),
    (dict(fused_stack=True, num_tensor_features=64), False, False, torch.float32, {}, "k4"),
]


@pytest.mark.parametrize("fields,flat,capture,dtype,env,tier", ROUTES)
def test_layer_tier_stack_routes(fields, flat, capture, dtype, env, tier, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, **fields)
    assert layer_tier(cfg, flat, capture, dtype) == tier


def test_stack_memory_estimate():
    """The stack tier keeps no V between its calls: x_final, the
    backward's stash of layers 1 .. L-1's inputs x and V, the carried dx
    and dV, and the scalar tensors and geometry every tier counts."""
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, fused_stack=True)
    d, c, ns, L = 9, 32, 64, 3
    stack = 4 * (ns + (L - 1) * (ns + d * c) + ns + d * c + 6 * ns + 64)
    assert cfg.live_bytes_per_edge() == stack
    k1 = dataclasses.replace(cfg, fused_stack=False).live_bytes_per_edge()
    assert stack < k1
    assert cfg.live_bytes_per_edge(flat=True) == \
        dataclasses.replace(cfg, fused_stack=False).live_bytes_per_edge(flat=True)
