"""K2 (ops/env_layer.py) and K5 (ops/env_layer_mxu.py) against the JAX
package: the plain versions against the JAX layer math at f64 and against
the JAX Pallas kernels (``tp_mix_env_fused_t``, modes "paths" and "mxu_*")
in interpret mode at f32, forward and backward; the combined TP + mix matrix
and its channels-last product against JAX's; the NaN weight-cotangent
contract; the wrappers' input checks; the layout cache.  The CUDA kernels'
own legs are in tests/test_torch_cuda.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.ops.tp as jtp
from pair_allegro_tpu.ops.tp import scalar_part, tp_mix_apply, tp_mix_init, uniform_tp
from pair_allegro_tpu_torch.ops import env_layer as k2
from pair_allegro_tpu_torch.ops import env_layer_mxu as k5
from pair_allegro_tpu_torch.ops import tp as ttp
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

torch.set_num_threads(2)

LMAX, C, K, NC, PARITY, AVG = 2, 8, 32, 8, True, 5.0
D = (LMAX + 1) ** 2
E = NC * K
MODES = ["mxu_highest", "mxu_bf16x3", "mxu_bf16"]
# kernel form against the interpret-mode Pallas kernel, f32: (fwd atol,
# rtol), (bwd atol, rtol).  "paths" and mxu_highest differ by sum order only
# (the K1 tolerances).  The split modes round O = V * env to bf16, and the
# two sides sum env in another order, so an O element near a rounding
# boundary can round the other way: bf16x3 keeps the remainder in its lo
# term (an error of ~2^-16 of O), bf16 does not (2^-8 of that element;
# measured 5.4e-4 at max|V'| 4.5).  The backward rounds the same dV' on
# both sides, so only the sum order of env and of the products differs.
TOLS = {
    "paths": ((5e-6, 5e-5), (1e-4, 1e-3)),
    "mxu_highest": ((5e-6, 5e-5), (1e-4, 1e-3)),
    "mxu_bf16x3": ((1e-4, 1e-3), (1e-4, 1e-3)),
    "mxu_bf16": ((2e-3, 2e-2), (1e-4, 1e-3)),
}


def _mix(dtype, lmax=LMAX, parity=PARITY, c=C):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ws = tp_mix_init(jax.random.PRNGKey(0), lmax, lmax, lmax, c, c, jdt, parity=parity)
    return ws, {k: torch.tensor(np.asarray(v), dtype=dtype) for k, v in ws.items()}


def _inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    return [torch.tensor(a, dtype=dtype) for a in
            (rng.randn(D, C, E) * 0.5, rng.randn(C, E), rng.randn(D, E))]


def _weights(tmix, mode):
    if mode == "paths":
        return k2.k2_weights(tmix, LMAX, PARITY)
    return k5.k5_weights(tmix, LMAX, PARITY, mode)


def _port(mode, w):
    fn = k2.env_layer if mode == "paths" else k5.env_layer_mxu
    return lambda *a: fn(*a, w, K, AVG)


def _jax_math(jmix):
    """The layer math of the JAX model (make_env + uniform_tp + scalar_part +
    tp_mix_apply) on the port's feature-major layout."""
    def f(Vt, wzt, yt):
        V = jnp.transpose(Vt, (2, 1, 0)).reshape(NC, K, C, D)
        wz, Y = wzt.T.reshape(NC, K, C), yt.T.reshape(NC, K, D)
        env = jnp.einsum("nkc,nkd->ncd", wz, Y) / math.sqrt(AVG)
        T = uniform_tp(V, jnp.broadcast_to(env[:, None], V.shape), LMAX, PARITY)
        out = jnp.transpose(tp_mix_apply(jmix, T).reshape(E, C, D), (2, 1, 0))
        return out, scalar_part(T).reshape(E, -1).T
    return f


@pytest.mark.parametrize("mode", ["paths", "mxu_highest"])
def test_plain_matches_jax_layer_math_f64(mode):
    jmix, tmix = _mix(torch.float64)
    ins = [t.requires_grad_(True) for t in _inputs(1, torch.float64)]
    out = _port(mode, _weights(tmix, mode))(*ins)
    jin = tuple(jnp.asarray(t.detach().numpy()) for t in ins)
    ref = _jax_math(jmix)
    j_out = ref(*jin)
    for a, b in zip(out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-10, rtol=1e-10)
    rng = np.random.RandomState(2)
    cots = [rng.randn(*o.shape) for o in j_out]
    g_t = torch.autograd.grad(out, ins, [torch.tensor(c) for c in cots])
    g_j = jax.grad(lambda *a: sum(jnp.sum(o * c) for o, c in zip(ref(*a), cots)), (0, 1, 2))(*jin)
    for name, a, b in zip(("dV", "dwz", "dY"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=1e-10, err_msg=name)


@pytest.mark.parametrize("mode", ["paths", *MODES])
def test_plain_matches_jax_kernel_interpret_f32(mode, monkeypatch):
    """f32: the plain version (K5's: with the mode's bf16 rounding) against
    the JAX Pallas kernel of the same mode in interpret mode, with exact-f32
    env averaging (PAT_ENV_MM=highest) and matmuls: both packages under the
    'highest' policy (K2's mix follows the policy; the other policies are
    tests/test_torch_port_prec_kernels.py's)."""
    import pair_allegro_tpu.ops.pallas_stack as ps
    from pair_allegro_tpu.ops.prec import matmul_precision

    from pair_allegro_tpu_torch.ops import prec

    monkeypatch.setenv("PAT_ENV_MM", "highest")
    monkeypatch.setattr(ps, "_INTERPRET", True)
    jmix, tmix = _mix(torch.float32)
    ins = _inputs(3, torch.float32)
    jin = tuple(jnp.asarray(t.numpy()) for t in ins)
    ws_flat = tuple(jmix[f"l{l3}"] for l3 in range(LMAX + 1))

    def kern(*a):
        return ps.tp_mix_env_fused_t(*a, ws_flat, LMAX, K, AVG, parity=PARITY, inv_t=True,
                                     mode=mode)

    with matmul_precision("highest"):
        j_out = kern(*jin)
        rng = np.random.RandomState(4)
        cots = [rng.randn(*o.shape).astype(np.float32) for o in j_out]
        g_j = jax.grad(lambda *a: sum(jnp.sum(o * c) for o, c in zip(kern(*a), cots)),
                       (0, 1, 2))(*jin)
    ins = [t.requires_grad_(True) for t in ins]
    with prec.matmul_precision("highest"):
        out = _port(mode, _weights(tmix, mode))(*ins)
    (fa, fr), (ba, br) = TOLS[mode]
    for name, a, b in zip(("out", "inv"), out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=fa, rtol=fr, err_msg=name)
    g_t = torch.autograd.grad(out, ins, [torch.tensor(c) for c in cots])
    for name, a, b in zip(("dV", "dwz", "dY"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ba, rtol=br, err_msg=name)


@pytest.mark.parametrize("lmax,parity", [(1, True), (2, False), (2, True)])
def test_combined_matrix_and_product_match_jax_f64(lmax, parity):
    jmix, tmix = _mix(torch.float64, lmax, parity)
    M_t = ttp.combined_tp_mix_matrix(tmix, lmax, torch.float64, parity)
    M_j = jtp.combined_tp_mix_matrix(jmix, lmax, jnp.float64, parity)
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), atol=1e-12, rtol=1e-12)
    W_t, lay_t = ttp.packed_tp_table(lmax, lmax, lmax, parity)
    W_j, lay_j = jtp.packed_tp_table(lmax, lmax, lmax, parity)
    np.testing.assert_array_equal(W_t, W_j)
    assert lay_t == lay_j
    d = (lmax + 1) ** 2
    rng = np.random.RandomState(5)
    V, env = rng.randn(6, C, d), rng.randn(6, C, d)
    got = ttp.tp_mix_combined(torch.tensor(V), torch.tensor(env), tmix, lmax, parity=parity)
    want = jtp.tp_mix_combined(jnp.asarray(V), jnp.asarray(env), jmix, lmax, parity=parity)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("mode", ["paths", *MODES])
def test_weight_cotangents_are_nan(mode):
    """The JAX contract: the kernels' weight cotangents (here: of the tree's
    mix leaves) come back NaN-filled, the operands' are finite."""
    _, tmix = _mix(torch.float32)
    leaves = [t.requires_grad_(True) for t in tmix.values()]
    ins = [t.requires_grad_(True) for t in _inputs(6, torch.float32)]
    out, inv = _port(mode, _weights(tmix, mode))(*ins)
    grads = torch.autograd.grad(out.sum() + inv.sum(), [*ins, *leaves])
    assert all(torch.isfinite(g).all() for g in grads[:3])
    assert all(torch.isnan(g).all() for g in grads[3:])


@pytest.mark.parametrize("mode", ["paths", "mxu_bf16x3"])
def test_wrappers_reject_bad_shapes(mode):
    _, tmix = _mix(torch.float32)
    w = _weights(tmix, mode)
    V, wz, Y = _inputs(7, torch.float32)
    f = _port(mode, w)
    with pytest.raises(ValueError):
        f(V[:, :4], wz, Y)  # C differs from the weights'
    with pytest.raises(ValueError):
        f(V, wz[:, :-1], Y)
    with pytest.raises(ValueError):
        f(V[:4], wz, Y[:4])  # D is not (l_max + 1)^2
    fn = k2.env_layer if mode == "paths" else k5.env_layer_mxu
    with pytest.raises(ValueError):
        fn(V, wz, Y, w, K + 1, AVG)  # E not a multiple of K
    with pytest.raises(ValueError):
        k5.k5_weights(tmix, LMAX, PARITY, "mxu_fp8")


def test_layouts_follow_the_leaves():
    """The cached kernel layouts are made once and made anew after an
    in-place update or a replaced leaf."""
    _, tmix = _mix(torch.float32)
    b0 = LAYOUTS.builds
    w = k2.k2_weights(tmix, LMAX, PARITY)
    assert k2.k2_weights(tmix, LMAX, PARITY) is w and LAYOUTS.builds == b0 + 1
    with torch.no_grad():
        tmix["l1"].mul_(2.0)
    w2 = k2.k2_weights(tmix, LMAX, PARITY)
    assert w2 is not w
    torch.testing.assert_close(w2.mix[1], 2.0 * w.mix[1])
    tmix["l0"] = tmix["l0"].clone()
    assert k2.k2_weights(tmix, LMAX, PARITY) is not w2
    m1 = k5.k5_weights(tmix, LMAX, PARITY, "mxu_highest")
    assert k5.k5_weights(tmix, LMAX, PARITY, "mxu_bf16") is not m1
