"""K4 (ops/tp_mix_fused.py) against the JAX package: the port's
``tp_mix_fused_t`` on the CPU (its plain version) against JAX's
``pallas_tp.tp_mix_fused_t`` (its plain reference off the TPU) at f64, for
l_max 1 and 2 with and without parity and Cout != C: V', the invariants,
the VJP and the NaN weight cotangents on both sides; the kernel layout of
the weights and its refresh after an in-place update; the wrapper's input
checks.  The CUDA kernel's own legs are in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.ops.pallas_tp import tp_mix_fused_t as j_tp_mix
from pair_allegro_tpu_torch.ops import tp_mix_fused as k4
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

torch.set_num_threads(2)

E = 37  # not a multiple of any edge tile


def _case(lmax, parity, c, cout, seed=0):
    rng = np.random.RandomState(seed)
    d = (lmax + 1) ** 2
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    V = rng.randn(d, c, E)
    env = rng.randn(d, c, E)
    ws = [rng.randn(c * P[l3], cout) for l3 in range(lmax + 1)]
    dout = rng.randn(d, cout, E)
    dinv = rng.randn(E, c * P[0])
    dout[:, :, -3:] = 0.0  # a few edges whose V' is dead
    return V, env, ws, dout, dinv


@pytest.mark.parametrize("lmax,parity,c,cout", [(1, True, 8, 8), (1, False, 8, 12),
                                                (2, True, 8, 8), (2, False, 4, 8),
                                                (2, True, 12, 8)])
def test_k4_matches_jax_f64(lmax, parity, c, cout):
    """1e-12 relative: V' (D, Cout, E), inv (E, C*P0), dV, denv; every
    weight cotangent is NaN on both sides."""
    V, env, ws, dout, dinv = _case(lmax, parity, c, cout)

    def jf(v, e, w):
        return j_tp_mix(v, e, tuple(w), lmax, 512, parity)

    (j_out, j_inv), vjp = jax.vjp(jf, jnp.asarray(V), jnp.asarray(env), [jnp.asarray(w) for w in ws])
    j_dV, j_denv, j_dw = vjp((jnp.asarray(dout), jnp.asarray(dinv)))

    leaves = [torch.tensor(w, requires_grad=True) for w in ws]
    w = k4.prepare_mix({f"l{l3}": t for l3, t in enumerate(leaves)}, lmax, parity)
    assert (w.c, w.cout, w.meta) == (c, cout, None)  # no kernel table on the CPU
    Vt = torch.tensor(V, requires_grad=True)
    envt = torch.tensor(env, requires_grad=True)
    out, inv = k4.tp_mix_fused_t(Vt, envt, w)
    assert out.shape == (V.shape[0], cout, E) and inv.shape == j_inv.shape
    g = torch.autograd.grad((out, inv), [Vt, envt, *leaves],
                            (torch.tensor(dout), torch.tensor(dinv)))
    for name, a, b in (("out", out, j_out), ("inv", inv, j_inv), ("dV", g[0], j_dV),
                       ("denv", g[1], j_denv)):
        b = np.asarray(b)
        err = float(np.abs(a.detach().numpy() - b).max()) / float(np.abs(b).max())
        assert err < 1e-12, f"{name}: relative error {err:.3e}"
    for gw, jw in zip(g[2:], j_dw):
        assert torch.isnan(gw).all() and bool(jnp.isnan(jw).all())


def test_reference_is_the_model_layout_function():
    """The plain version is uniform_tp + tp_mix_apply + scalar_part on the
    (E, C, D) layout, transposed, with the tree's c-major rows: the
    kernel's flat weights are those leaves (and their transposes)."""
    V, env, ws, *_ = _case(2, True, 8, 8, seed=3)
    mix = {f"l{l3}": torch.tensor(w) for l3, w in enumerate(ws)}
    w = k4.prepare_mix(mix, 2, True)
    np.testing.assert_array_equal(w.mix_flat.numpy(), np.concatenate([a.reshape(-1) for a in ws]))
    np.testing.assert_array_equal(w.mixT_flat.numpy(), np.concatenate([a.T.reshape(-1) for a in ws]))
    from pair_allegro_tpu_torch.ops.tp import scalar_part, tp_mix_apply, uniform_tp

    Ve, ee = torch.tensor(V).permute(2, 1, 0), torch.tensor(env).permute(2, 1, 0)
    T = uniform_tp(Ve, ee, 2, True)
    out, inv = k4.tp_mix_fused_reference(torch.tensor(V), torch.tensor(env), w)
    torch.testing.assert_close(out, tp_mix_apply(mix, T).permute(2, 1, 0), rtol=0, atol=0)
    torch.testing.assert_close(inv, scalar_part(T), rtol=0, atol=0)


def test_k4_weights_follow_in_place_updates():
    rng = np.random.RandomState(4)
    mix = {"l0": torch.tensor(rng.randn(8 * 2, 8)), "l1": torch.tensor(rng.randn(8 * 2, 8))}
    w1 = k4.k4_weights(mix, 1, True)
    assert k4.k4_weights(mix, 1, True) is w1  # cached
    with torch.no_grad():
        mix["l1"].mul_(2.0)
    w2 = k4.k4_weights(mix, 1, True)
    assert w2 is not w1
    torch.testing.assert_close(w2.mix_flat[16 * 8:], mix["l1"].reshape(-1))


def test_wrapper_checks_shapes_and_devices():
    V, env, ws, *_ = _case(1, True, 8, 8)
    w = k4.prepare_mix({f"l{l3}": torch.tensor(a) for l3, a in enumerate(ws)}, 1, True)
    with pytest.raises(ValueError, match="shapes"):
        k4.tp_mix_fused_t(torch.tensor(V)[:, :4], torch.tensor(env)[:, :4], w)
    with pytest.raises(ValueError, match="shapes"):
        k4.tp_mix_fused_t(torch.tensor(V), torch.tensor(env)[..., :-1], w)
