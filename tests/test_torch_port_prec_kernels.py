"""The matmul precision policy (``ops/prec.py``) in K2, K4 and K3, on the CPU
against the JAX package's kernels under the same policy:

* the plain versions of K2 (``env_layer``), K4 (``tp_mix_fused_t``), K3
  (``nequip_conv``) and K3 with a bf16 hj, at f32, against JAX's kernels
  (``pallas_stack.tp_mix_env_fused_t`` mode "paths" and
  ``pallas_nequip.nequip_conv_fused`` in interpret mode;
  ``pallas_tp.tp_mix_fused_t``'s pallas_call run with ``interpret=True``,
  since off the TPU it takes its plain reference, whose products do not
  follow the kernels' policy), forward and VJP from seeded cotangents,
  under each of the five policies.  JAX's sums are made exact as the
  port's are (``PAT_ENV_MM=split3``: K2's env average; ``PAT_NEQUIP_AGG_MM
  =highest``: K3's per-center sum); 'highest', 'mixed', 'kernel_high' and
  'high' within a tight gate (the same split arithmetic, summed in another
  order), 'default' within ``KERNEL_TOLS`` (JAX's CPU dot is exact at
  DEFAULT, the port rounds both operands as the card's one-pass builds do);
  a bf16 dhj (rounded to bf16 on both sides) within one bf16 ulp;
* the discrimination case: under 'kernel_high' the port is at least twice
  as close (RMS) to JAX's 'kernel_high' as the port under 'highest' is;
* f64 unchanged under every policy (1e-10 against JAX);
* the forward fixes the mode its backward uses; the kernels' ``kernel_takes``
  and block layouts do not depend on the policy, and the bf16x3 builds'
  weights keep the f32 bytes where the one-pass builds' take half.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.models.nequip as j_nequip
import pair_allegro_tpu.ops.pallas_stack as ps
import pair_allegro_tpu.ops.pallas_tp as ptp
from pair_allegro_tpu.ops.pallas_nequip import conv_viable, nequip_conv_fused
from pair_allegro_tpu.ops.tp import tp_mix_init
from pair_allegro_tpu_torch.ops import env_layer as k2
from pair_allegro_tpu_torch.ops import nequip_conv as k3
from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops import tp_mix_fused as k4
from pair_allegro_tpu_torch.ops.tp import tp_num_paths
from test_torch_port_prec import KERNEL_TOLS, POLICIES, TIGHT, _both, _rel

torch.set_num_threads(2)

LMAX, C, K, NC, PARITY, AVG = 2, 8, 32, 8, True, 5.0
D = (LMAX + 1) ** 2
E = NC * K
E4 = 100  # K4's edges: no multiple of its 512-edge JAX block
# K3: centers, neighbors, channels, Bessels, hidden width, l_max, tracks
N3, K3, C3, B3, H3, L3, T3 = 16, 12, 8, 8, 16, 1, 2
KERNELS = ("k2", "k4", "k3", "k3-hj-bf16")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PAT_ENV_MM", "split3")  # JAX's env sums exact in f32, as the port's
    monkeypatch.setenv("PAT_NEQUIP_AGG_MM", "highest")  # and its per-center sums
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _tup(o):
    return o if isinstance(o, tuple) else (o,)


def _mix(rng, c=C, cout=C, lmax=LMAX, parity=PARITY):
    """Mix leaves {"l0": (C*P0, Cout), ...} as numpy, from tp_mix_init."""
    ws = tp_mix_init(jax.random.PRNGKey(int(rng.randint(1 << 30))), lmax, lmax, lmax, c, cout,
                     jnp.float32, parity=parity)
    return [np.asarray(ws[f"l{l3}"]) for l3 in range(lmax + 1)]


def _case(kernel, seed, monkeypatch):
    """(JAX kernel fn, port fn, numpy operands, port dtypes) at f32 (a bf16
    hj for 'k3-hj-bf16'); the fns take the port's layout."""
    rng = np.random.RandomState(seed)
    if kernel == "k2":
        ws = _mix(rng)
        w = k2.prepare_mix({f"l{i}": torch.tensor(a) for i, a in enumerate(ws)}, LMAX, PARITY)
        ins = [rng.randn(D, C, E) * 0.5, rng.randn(C, E), rng.randn(D, E)]

        def jfn(*a):
            return ps.tp_mix_env_fused_t(*a, tuple(jnp.asarray(x) for x in ws), LMAX, K, AVG,
                                         parity=PARITY, inv_t=True, mode="paths")
        return jfn, lambda *a: k2.env_layer(*a, w, K, AVG), ins, [torch.float32] * 3
    if kernel == "k4":
        from jax.experimental import pallas as pl

        # JAX's own kernel body on the CPU: its pallas_call in interpret mode
        monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        monkeypatch.setattr(ptp, "_use_pallas", lambda: True)
        ws = _mix(rng, cout=12)
        w = k4.prepare_mix({f"l{i}": torch.tensor(a) for i, a in enumerate(ws)}, LMAX, PARITY)
        ins = [rng.randn(D, C, E4), rng.randn(D, C, E4)]

        def jfn(*a):
            return ptp.tp_mix_fused_t(*a, tuple(jnp.asarray(x) for x in ws), LMAX, 512, PARITY)
        return jfn, lambda *a: k4.tp_mix_fused_t(*a, w), ins, [torch.float32] * 2
    d, p = (L3 + 1) ** 2, tp_num_paths(L3)
    ws = [rng.randn(B3, H3), rng.randn(H3, H3), rng.randn(H3, C3 * p * T3)]
    u = rng.rand(N3 * K3, 1)
    u[-5:] = 0.0  # padded slots
    ins = [rng.randn(N3 * K3, d * T3 * C3), rng.randn(N3 * K3, B3), u, rng.randn(N3 * K3, d)]
    hj_dt = torch.bfloat16 if kernel == "k3-hj-bf16" else torch.float32
    if hj_dt == torch.bfloat16:
        ins[0] = torch.tensor(ins[0], dtype=torch.float32).to(torch.bfloat16).float().numpy()
    wcl = j_nequip._radial_cl({"radial_mlp": {"w": [jnp.asarray(x, jnp.float32) for x in ws]}},
                              C3, p, T3)["w"]
    w = k3.prepare_radial(k3.radial_cl([torch.tensor(x, dtype=torch.float32) for x in ws], C3, p,
                                       T3), C3, T3, L3)
    cn = conv_viable(N3, K3, d * T3 * C3)

    def jfn(hj, bes, u_, Y):
        return nequip_conv_fused(hj.reshape(N3, K3, -1), bes.reshape(N3, K3, -1),
                                 u_.reshape(N3, K3), Y.reshape(N3, K3, -1), list(wcl), C=C3,
                                 n_tracks=T3, K=K3, cn=cn, avg_num_neighbors=AVG, interpret=True,
                                 lmax=L3)
    return jfn, lambda *a: k3.nequip_conv(*a, w, K3, AVG), ins, [hj_dt] + [torch.float32] * 3


def _jax(jfn, ins, dtypes):
    """JAX's kernel forward and its VJP from seeded cotangents, under the
    policy in force: (outputs, input cotangents) as f32 numpy, and the
    cotangents."""
    jin = [jnp.asarray(a, jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
           for a, dt in zip(ins, dtypes)]
    outs, vjp = jax.vjp(lambda *a: _tup(jfn(*a)), *jin)
    rng = np.random.RandomState(4)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    f32 = [[np.asarray(x.astype(jnp.float32)) for x in xs] for xs in (outs, grads)]
    return f32, cots


def _port(tfn, ins, dtypes, cots):
    """The port's wrapper (its plain version on the CPU) on the same
    operands, under the policy in force."""
    tin = [torch.tensor(np.asarray(a, np.float32)).to(dt).requires_grad_(True)
           for a, dt in zip(ins, dtypes)]
    outs = _tup(tfn(*tin))
    grads = torch.autograd.grad(outs, tin, [torch.tensor(c) for c in cots])
    assert [g.dtype for g in grads] == dtypes
    return [[x.detach().float().numpy().reshape(-1) for x in xs] for xs in (outs, grads)]


def _split(res, dtypes):
    """(f32 outputs and cotangents, bf16 cotangents) of a result: a bf16
    hj's cotangent is rounded to bf16 on both sides and held apart."""
    outs, grads = res
    f32 = [g for g, dt in zip(grads, dtypes) if dt != torch.bfloat16]
    bf16 = [g for g, dt in zip(grads, dtypes) if dt == torch.bfloat16]
    return ([o.reshape(-1) for o in outs], [g.reshape(-1) for g in f32]), [g.reshape(-1)
                                                                          for g in bf16]


def _dist(port, jx):
    return (max(_rel(a, b) for a, b in zip(port[0], jx[0])),
            max(_rel(a, b) for a, b in zip(port[1], jx[1])))


def _rms(port, jx):
    """RMS distance over RMS size, forward and backward (the f32 parts)."""
    def r(xs, ys):
        num = sum(float(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).sum())
                  for a, b in zip(xs, ys))
        den = sum(float((np.asarray(b, np.float64) ** 2).sum()) for b in ys)
        return (num / den) ** 0.5
    return r(port[0], jx[0]), r(port[1], jx[1])


@pytest.mark.parametrize("p", POLICIES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_kernels_match_jax_kernels_under_each_policy(kernel, p, monkeypatch):
    jfn, tfn, ins, dtypes = _case(kernel, 3, monkeypatch)
    with _both(p):
        jx, cots = _jax(jfn, ins, dtypes)
        port = _port(tfn, ins, dtypes, cots)
    (pf, pb) = _split(port, dtypes)
    (jf, jb) = _split(jx, dtypes)
    fwd, bwd = _dist(pf, jf)
    tol = KERNEL_TOLS if p == "default" else TIGHT
    print(f"{kernel} under {p}: port against JAX {fwd:.3e} fwd, {bwd:.3e} bwd of max (gate "
          f"{tol}); rms {_rms(pf, jf)}")
    assert fwd <= tol[0] and bwd <= tol[1], (kernel, p, fwd, bwd)
    for a, b in zip(pb, jb):  # dhj: the same f32 values rounded to bf16 on each side
        if p == "default":
            assert _rel(a, b) <= KERNEL_TOLS[1]
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=2.0 ** -7, err_msg="dhj")


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_high_is_jax_kernel_high(kernel, monkeypatch):
    """The discrimination case: against JAX under 'kernel_high' the port
    under 'kernel_high' is at least twice as close (RMS, forward and
    backward) as the port under 'highest', whose products are the exact
    f32 ones; the measured factors are printed."""
    jfn, tfn, ins, dtypes = _case(kernel, 5, monkeypatch)
    with _both("kernel_high"):
        jx, cots = _jax(jfn, ins, dtypes)
        near = _rms(_split(_port(tfn, ins, dtypes, cots), dtypes)[0], _split(jx, dtypes)[0])
    with prec.matmul_precision("highest"):
        far = _rms(_split(_port(tfn, ins, dtypes, cots), dtypes)[0], _split(jx, dtypes)[0])
    factor = (far[0] / max(near[0], 1e-30), far[1] / max(near[1], 1e-30))
    print(f"{kernel}: against JAX kernel_high, the port kernel_high {near}, highest {far}: "
          f"factor {factor[0]:.1f} fwd, {factor[1]:.1f} bwd")
    assert factor[0] >= 2 and factor[1] >= 2, (near, far)


@pytest.mark.parametrize("p", POLICIES)
@pytest.mark.parametrize("kernel", ["k2", "k4", "k3"])
def test_f64_is_unchanged_under_every_policy(kernel, p):
    """At f64 every mode is the plain product: each kernel's plain version
    against JAX at f64 to 1e-10 (the f64 tests of its own file) under each
    policy."""
    with _both(p):
        if kernel == "k2":
            from test_torch_port_env_layer import test_plain_matches_jax_layer_math_f64

            test_plain_matches_jax_layer_math_f64("paths")
        elif kernel == "k4":
            from test_torch_port_tp_mix import test_k4_matches_jax_f64

            test_k4_matches_jax_f64(2, True, 8, 8)
            test_k4_matches_jax_f64(1, False, 8, 12)
        else:
            from test_torch_port_nequip_conv import test_plain_matches_jax_kernel_interpret_f64

            test_plain_matches_jax_kernel_interpret_f64(1, 2)
            test_plain_matches_jax_kernel_interpret_f64(2, 1)


@pytest.mark.parametrize("kernel", ["k2", "k4", "k3"])
def test_forward_fixes_the_backward_mode(kernel, monkeypatch):
    """A forward under 'kernel_high' whose backward runs under 'highest'
    (as autograd may run it after the context) takes the bf16x3 products
    both ways: its gradients equal the all-'kernel_high' ones and differ
    from the all-'highest' ones."""
    _, tfn, ins, dtypes = _case(kernel, 7, monkeypatch)
    cots = None

    def run(fwd_policy, bwd_policy):
        nonlocal cots
        tin = [torch.tensor(np.asarray(a, np.float32)).requires_grad_(True) for a in ins]
        with prec.matmul_precision(fwd_policy):
            outs = _tup(tfn(*tin))
        if cots is None:
            g = torch.Generator().manual_seed(0)
            cots = [torch.randn(o.shape, generator=g) for o in outs]
        with prec.matmul_precision(bwd_policy):
            return torch.autograd.grad(outs, tin, cots)

    mixed = run("kernel_high", "highest")
    for a, b in zip(mixed, run("kernel_high", "kernel_high")):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(mixed, run("highest", "highest")))


def test_kernel_takes_and_layouts_do_not_depend_on_the_policy():
    """Every width K2, K4 and K3 take (and the block each launcher lays
    out) is the same under every policy: the bf16x3 builds keep the f32
    bytes and the one-pass builds halve them, and every build keeps its
    tiles f32 in shared memory."""
    k2k4 = [(c, cout, lmax, parity) for c, cout in itertools.product((4, 8, 16, 32, 64, 128),
                                                                      (4, 8, 32, 64, 128))
            for lmax, parity in itertools.product(range(4), (True, False))]
    k3w = [(c, t, lmax, (b, *h, t * tp_num_paths(lmax) * c))
           for c in (4, 8, 16, 32, 64, 128) for t in (1, 2) for lmax in (1, 2)
           for b, h in ((8, (32, 32)), (8, ()), (12, (36,)), (4, (256,)), (16, (1024,)))]

    def answers():
        out = []
        for c, cout, lmax, parity in k2k4:
            d = (lmax + 1) ** 2
            out.append((k2.kernel_takes(c, cout, d, lmax, parity),
                        k2.block_layout(c, cout, d, lmax, parity, True),
                        k4.kernel_takes(c, cout, d, lmax, parity),
                        k4.block_layout(c, cout, d, lmax, parity, True)))
        for c, t, lmax, dims in k3w:
            out.append((k3.kernel_takes(c, t, lmax, dims), k3.block_layout(c, t, lmax, dims, True)))
        return out

    per_policy = []
    for p in POLICIES:
        with prec.matmul_precision(p):
            per_policy.append(answers())
    assert all(a == per_policy[0] for a in per_policy)
    assert any(row[0] for row in per_policy[0]) and not all(row[0] for row in per_policy[0])


@pytest.mark.parametrize("kernel", ["k2", "k4"])
def test_builds_take_their_weight_layouts(kernel):
    """The launcher's mix and mixT per build (``layout``): the f32 leaves
    for 3xTF32, ``pack_x3`` (the f32 bytes, every offset kept) for bf16x3,
    ``pack_pairs`` (half the bytes, every offset halved) for one pass; a
    matrix's packing is the same as on its own, at its offset."""
    from pair_allegro_tpu_torch.ops.fused_layer import build_for, pack_pairs, pack_x3

    rng = np.random.RandomState(2)
    ws = _mix(rng, cout=12)
    mod = k2 if kernel == "k2" else k4
    w = mod.prepare_mix({f"l{i}": torch.tensor(a) for i, a in enumerate(ws)}, LMAX, PARITY)
    f32 = w.layout("tf32x3")
    assert f32[0] is w.mix_flat and f32[1] is w.mixT_flat
    x3, onepass = w.layout("bf16x3"), w.layout("onepass")
    assert [t.dtype for t in (*x3, *onepass)] == [torch.int32] * 4
    for a, b3, b1 in zip(f32, x3, onepass):
        assert b3.numel() == a.numel() and 2 * b1.numel() == a.numel()
    # the second l3 block of the forward's mix, at its offset
    blocks = w.mix if kernel == "k2" else w.leaves
    off = blocks[0].numel()
    m1 = blocks[1]
    assert torch.equal(x3[0][off:off + m1.numel()], pack_x3(m1).reshape(-1))
    assert torch.equal(onepass[0][off // 2:(off + m1.numel()) // 2], pack_pairs(m1).reshape(-1))
    assert build_for(torch.float32, "bf16x3") == "bf16x3"
    assert build_for(torch.float32, "bf16") == "onepass"
    with prec.matmul_precision("default"):
        assert build_for(torch.float32) == "onepass"
    if kernel == "k2":
        assert w.layout("bf16") is w.packed  # the bf16 build's, shared by the one-pass build
