"""K1 (ops/fused_layer.py) against the JAX package: the plain version
against the JAX layer math at f64 and against the JAX Pallas kernel
(``allegro_layer_fused_t``) in interpret mode at f32, for all four
(first_v, last) forms, forward and backward; the NaN weight-cotangent
contract; the wrapper's input checks.  The CUDA kernel's own legs are in
tests/test_torch_cuda.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.ops.mlp import mlp_apply
from pair_allegro_tpu.ops.tp import scalar_part, tp_mix_apply, uniform_tp
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_params_from_numpy
from pair_allegro_tpu_torch.ops import fused_layer as fl

torch.set_num_threads(2)

FORMS = [(False, False), (True, False), (False, True), (True, True)]
LMAX, NS, C, K, NC, PARITY, AVG = 2, 16, 8, 32, 8, True, 5.0
D = (LMAX + 1) ** 2
E = NC * K


def _cfg_kw(**kw):
    base = dict(type_names=("A", "B"), r_max=4.0, l_max=LMAX, num_layers=1,
                num_scalar_features=NS, num_tensor_features=C, avg_num_neighbors=AVG)
    base.update(kw)
    return base


def _params(dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    tree = allegro_init(jax.random.PRNGKey(0), JaxConfig(**_cfg_kw()), dtype=jdt)
    tp = allegro_params_from_numpy(jax.tree.map(np.asarray, tree), AllegroConfig(**_cfg_kw()),
                                   device="cpu", dtype=dtype)
    return tree["layers"][0], fl.k1_weights(tp["layers"][0], LMAX, PARITY)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(NC, K, NS) * 0.3, rng.randn(NC, K, C) * 0.3, rng.randn(NC, K, D),
            rng.rand(NC, K))


def _to_t(x0, p, Y, u, first_v, dtype):
    """(nc, k, ...) numpy -> the feature-major torch operands."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype)

    if first_v:
        V = p.reshape(E, C).T
    else:
        V = np.transpose((p[..., :, None] * Y[..., None, :]).reshape(E, C, D), (2, 1, 0))
    return t(x0.reshape(E, NS).T), t(V), t(Y.reshape(E, D).T), t(u.reshape(1, E))


def _torch_layer(w, first_v, last):
    def f(xt, V, yt, ut):
        out = fl.fused_layer(xt, V, yt, ut, w, K, AVG, first_v=first_v, last=last)
        return (out,) if last else out
    return f


@pytest.mark.parametrize("first_v,last", FORMS)
def test_plain_matches_jax_layer_math_f64(first_v, last):
    """f64: the port's K1 (CPU: plain version through the autograd Function)
    against the JAX layer math of tests/test_stack_fused.py, forward + VJP."""
    layer, w = _params(torch.float64)
    x0, p, Y, u = _inputs(1)

    def ref(x0, p, Y, u):
        V = p[..., :, None] * Y[..., None, :]
        w_env = jnp.einsum("nks,sc->nkc", x0, layer["env_weight"]) / math.sqrt(NS) * u[..., None]
        env = jnp.einsum("nkc,nkd->ncd", w_env, Y) / math.sqrt(AVG)
        T = uniform_tp(V, jnp.broadcast_to(env[:, None], V.shape), LMAX, PARITY)
        xn = mlp_apply(layer["latent_mlp"], jnp.concatenate([x0, scalar_part(T)], -1))
        x1 = (x0 + xn * u[..., None]) / math.sqrt(2.0)
        # to the port's layout: x (ns, E), V (D, C, E)
        x1 = x1.reshape(E, NS).T
        if last:
            return (x1,)
        return x1, jnp.transpose(tp_mix_apply(layer["mix"], T).reshape(E, C, D), (2, 1, 0))

    rng = np.random.RandomState(2)
    jin = tuple(jnp.asarray(a) for a in (x0, p, Y, u))
    r_out = ref(*jin)
    cots = [rng.randn(*o.shape) for o in r_out]

    tin = [a.requires_grad_(True) for a in _to_t(x0, p, Y, u, first_v, torch.float64)]
    t_out = _torch_layer(w, first_v, last)(*tin)
    for a, b in zip(t_out, r_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-10, rtol=1e-10)

    loss = sum((o * torch.tensor(ct)).sum() for o, ct in zip(t_out, cots))
    g_t = torch.autograd.grad(loss, tin)
    g_j = jax.grad(lambda *a: sum(jnp.sum(o * ct) for o, ct in zip(ref(*a), cots)),
                   (0, 1, 2, 3))(*jin)
    # bring the port's cotangents to the JAX (nc, k, ...) inputs: a
    # materialised V0 = p * Y adds sum_d dV * Y to dp and sum_c dV * p to dY
    dx, dV, dY, du = (g.numpy() for g in g_t)
    if first_v:
        dp = dV.T
    else:
        dp = np.einsum("dce,de->ec", dV, Y.reshape(E, D).T)
        dY = dY + np.einsum("dce,ec->de", dV, p.reshape(E, C))
    got = (dx.T, dp, dY.T, du.reshape(E))
    for name, a, b in zip(("dx", "dp", "dY", "du"), got, g_j):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape), atol=1e-10, rtol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("first_v,last", FORMS)
def test_plain_matches_jax_kernel_interpret_f32(first_v, last, monkeypatch):
    """f32: the plain version against the JAX Pallas kernel run in interpret
    mode, at exact-f32 matmuls and env averaging (PAT_ENV_MM=highest, so the
    kernel's bf16 split of the env sum is not what is measured)."""
    import pair_allegro_tpu.ops.pallas_stack as ps
    from pair_allegro_tpu.ops.prec import matmul_precision

    monkeypatch.setenv("PAT_ENV_MM", "highest")
    monkeypatch.setattr(ps, "_INTERPRET", True)
    layer, w = _params(torch.float32)
    x0, p, Y, u = _inputs(3)
    tin = _to_t(x0, p, Y, u, first_v, torch.float32)
    jin = tuple(jnp.asarray(a.numpy()) for a in tin)

    def kern(*a):
        out = ps.allegro_layer_fused_t(*a, layer, LMAX, K, AVG, parity=PARITY,
                                       first_v=first_v, last=last)
        return (out,) if last else out

    with matmul_precision("highest"):
        j_out = kern(*jin)
        rng = np.random.RandomState(4)
        cots = [rng.randn(*o.shape).astype(np.float32) for o in j_out]
        g_j = jax.grad(lambda *a: sum(jnp.sum(o * ct) for o, ct in zip(kern(*a), cots)),
                       (0, 1, 2, 3))(*jin)

    tin = [a.requires_grad_(True) for a in tin]
    t_out = _torch_layer(w, first_v, last)(*tin)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=5e-6, rtol=5e-5)
    loss = sum((o * torch.tensor(ct)).sum() for o, ct in zip(t_out, cots))
    g_t = torch.autograd.grad(loss, tin)
    for name, a, b in zip(("dx", "dV", "dY", "du"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("last", [False, True])
def test_weight_cotangents_are_nan(last):
    """The JAX contract: a fused layer's weight cotangents come back
    NaN-filled, so training through it fails loudly."""
    _, w = _params(torch.float32)
    for t in w.tensors():
        t.requires_grad_(True)
    try:
        x0, p, Y, u = _inputs(5)
        tin = [a.requires_grad_(True) for a in _to_t(x0, p, Y, u, True, torch.float32)]
        out = _torch_layer(w, True, last)(*tin)
        grads = torch.autograd.grad(sum(o.sum() for o in out), [*tin, *w.tensors()])
    finally:
        for t in w.tensors():
            t.requires_grad_(False)
    assert all(torch.isfinite(g).all() for g in grads[:4])
    assert all(torch.isnan(g).all() for g in grads[4:])


def test_wrapper_rejects_bad_shapes():
    _, w = _params(torch.float32)
    x0, p, Y, u = _inputs(6)
    xt, V, yt, ut = _to_t(x0, p, Y, u, False, torch.float32)
    with pytest.raises(ValueError):
        fl.fused_layer(xt, V, yt, ut, w, K, AVG, first_v=True)  # V is not (C, E)
    with pytest.raises(ValueError):
        fl.fused_layer(xt, V, yt, ut, w, K + 1, AVG)  # E not a multiple of K
