"""The matmul precision policy (``pair_allegro_tpu_torch/ops/prec.py``)
against the JAX package's (``pair_allegro_tpu/ops/prec.py``), on the CPU:

* the API and the mapping: the five public names, every policy string and
  dtype, ``kernel_mode`` against JAX's ``pallas_tp._kernel_precision``, the
  context restored after an exception; ``kmm`` against JAX's in-kernel
  ``pallas_stack._mm`` on the same arrays, and its backward;
* the plain versions of K1 (three forms), K6 (its prologue at the policy
  and under ``PAT_EMBED_PREC=highest``), K7 and K8 at f32 against JAX's
  kernels under each policy: K1, K6 and K7 in interpret mode, K8's kernel
  body (``_stack_fwd_kernel`` / ``_stack_bwd_kernel``, whose pallas_call has
  no interpret switch) run eagerly on whole arrays; the env sums exact on
  both sides (``PAT_ENV_MM=split3``; the port's is an f32 sum under every
  policy, and JAX's K8 sums through ``_mm``, a 2-term split at HIGH);
  'highest', 'mixed', 'kernel_high' and 'high' within a tight gate (the
  same split arithmetic), 'default' within ``KERNEL_TOLS`` (JAX's CPU dot
  is exact at DEFAULT, the port rounds as the card's one-pass build does),
  and the discrimination case: under 'kernel_high' the port is several
  times closer to JAX than the port under 'highest' is;
* f64 unchanged under every policy (1e-10 against JAX's layer math);
* K1's plain version at bf16 rounds its constants as JAX's kernel does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.ops.pallas_stack as ps
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxConfig
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.ops import prec as jprec
from pair_allegro_tpu.ops.pallas_tp import _kernel_precision
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_params_from_numpy
from pair_allegro_tpu_torch.ops import embed_layer as k6
from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.ops import fused_stack as k8
from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops import readout_layer as k7

torch.set_num_threads(2)

POLICIES = ("highest", "mixed", "kernel_high", "high", "default")
LMAX, NS, C, K, NC, PARITY, AVG = 2, 16, 8, 32, 8, True, 5.0
D = (LMAX + 1) ** 2
E = NC * K
FORMS = {"first": (True, False), "middle": (False, False), "last": (False, True)}
# the same split arithmetic on both sides, summed in another order
# (relative to max|JAX|): forward, backward
TIGHT = (5e-6, 5e-5)
# 'default': JAX's CPU dot is exact where the port rounds both operands to
# bf16 (tests/test_torch_port_interior_bf16.py KERNEL_TOLS)
KERNEL_TOLS = (2e-2, 4e-2)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PAT_ENV_MM", "split3")  # JAX's env sums exact in f32, as the port's
    for name in ("PAT_EMBED_PREC", "PAT_L1_EMBED", "PAT_L1_POSITIONAL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _both(p):
    """Both packages under policy ``p``."""
    class Both:
        def __enter__(self):
            self.a, self.b = jprec.matmul_precision(p), prec.matmul_precision(p)
            self.a.__enter__()
            self.b.__enter__()

        def __exit__(self, *exc):
            self.b.__exit__(*exc)
            self.a.__exit__(*exc)
    return Both()


# ---------------------------------------------------------------------------
# API and mapping
# ---------------------------------------------------------------------------

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_MODE_OF = {jax.lax.Precision.HIGHEST: "tf32x3", jax.lax.Precision.HIGH: "bf16x3",
            jax.lax.Precision.DEFAULT: "bf16"}


@pytest.mark.parametrize("p", POLICIES)
def test_api_and_mapping_match_jax(p):
    assert prec.get_precision_policy() == jprec.get_precision_policy() == "kernel_high"
    with _both(p):
        assert prec.get_precision_policy() == jprec.get_precision_policy() == p
        assert prec.get_matmul_precision() == jprec.get_matmul_precision()
        for tdt, jdt in _JDT.items():
            assert prec.matmul_precision_for(tdt) == jprec.matmul_precision_for(jdt)
            assert prec.kernel_mode(tdt) == _MODE_OF[_kernel_precision(jdt)]
        assert prec.kernel_mode(torch.float64) == "tf32x3"  # f64 keeps its own precision
        assert prec.glue_tf32() == (jprec.get_matmul_precision() != "highest")
    prec.set_matmul_precision(p)
    jprec.set_matmul_precision(p)
    try:
        assert prec.get_precision_policy() == jprec.get_precision_policy() == p
    finally:
        prec.set_matmul_precision("kernel_high")
        jprec.set_matmul_precision("kernel_high")


def test_context_restores_after_an_exception():
    with pytest.raises(RuntimeError):
        with prec.matmul_precision("default"):
            with prec.matmul_precision("high"):
                raise RuntimeError("inside")
    assert prec.get_precision_policy() == "kernel_high"
    with pytest.raises(ValueError):
        prec.set_matmul_precision("fast")
    with pytest.raises(ValueError):
        with prec.matmul_precision("fast"):
            pass
    assert prec.get_precision_policy() == "kernel_high"
    flag = torch.backends.cuda.matmul.allow_tf32
    with prec.matmul_precision("high"), prec.glue_scope():
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == flag


@pytest.mark.parametrize("p", POLICIES)
def test_kmm_is_jax_kernel_product(p):
    """``kmm`` in the policy's mode against ``pallas_stack._mm`` (the TPU
    kernels' product) on the same f32 arrays; its backward is the same
    mode's products of the transposes."""
    rng = np.random.RandomState(0)
    a, b, g = rng.randn(24, 40), rng.randn(40, 56), rng.randn(24, 56)
    ta, tb = (torch.tensor(x, dtype=torch.float32).requires_grad_(True) for x in (a, b))
    with _both(p):
        mode = prec.kernel_mode(torch.float32)
        got = prec.kmm(ta, tb, mode)
        want = np.asarray(ps._mm(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
        ga, gb = torch.autograd.grad(got, (ta, tb), torch.tensor(g, dtype=torch.float32))
        gt = torch.tensor(g, dtype=torch.float32)
        ga_w = prec.kmm(gt, tb.detach().T, mode)
        gb_w = prec.kmm(ta.detach().T, gt, mode)
    err = float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())
    tol = KERNEL_TOLS[0] if p == "default" else 1e-6
    assert err <= tol, (p, err)
    assert torch.equal(ga, ga_w) and torch.equal(gb, gb_w)
    if mode != "tf32x3":  # the mode's own function, not the exact product
        exact = (ta @ tb).detach()
        assert not torch.equal(got.detach(), exact)


# ---------------------------------------------------------------------------
# K1, K6, K7, K8 at f32 against JAX's kernels under each policy
# ---------------------------------------------------------------------------


def _trees(dtype, ns=NS, layers=2, charges=True):
    kw = dict(type_names=("A", "B"), r_max=4.0, l_max=LMAX, num_layers=layers,
              num_scalar_features=ns, num_tensor_features=C, avg_num_neighbors=AVG,
              output_charges=charges)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    tree = allegro_init(jax.random.PRNGKey(0), JaxConfig(**kw), dtype=jdt)
    return tree, allegro_params_from_numpy(jax.tree.map(np.asarray, tree), AllegroConfig(**kw),
                                           device="cpu", dtype=dtype)


def _ops(seed, ns=NS, n_in=12):
    """Feature-major numpy operands: two-body rows, x, pT, V (= p Y plus
    noise), Y, u with padded slots."""
    rng = np.random.RandomState(seed)
    u = rng.rand(1, E)
    u[0, -K // 3:] = 0.0
    p = rng.randn(C, E) * 0.3
    Y = rng.randn(D, E)
    V = p[None] * Y[:, None] + rng.randn(D, C, E) * 0.1
    return {"in": rng.randn(n_in, E) * 0.5, "x": rng.randn(ns, E) * 0.3, "pT": p, "V": V,
            "Y": Y, "u": u}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _run_jax(fn, ins, n_out):
    """JAX's kernel forward and its VJP from seeded cotangents."""
    jin = tuple(jnp.asarray(a, jnp.float32) for a in ins)
    outs = fn(*jin)
    rng = np.random.RandomState(4)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs[:n_out]]
    grads = jax.grad(lambda *a: sum(jnp.sum(o * c) for o, c in zip(fn(*a), cots)),
                     tuple(range(len(jin))))(*jin)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads], cots


def _run_port(fn, ins, cots):
    tin = [torch.tensor(np.asarray(a, np.float32)).requires_grad_(True) for a in ins]
    outs = fn(*tin)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, tin, [torch.tensor(c) for c in cots])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _dist(port, jx):
    return (max(_rel(a, b) for a, b in zip(port[0], jx[0])),
            max(_rel(a, b) for a, b in zip(port[1], jx[1])))


def _rms(port, jx):
    """RMS distance over RMS size, forward and backward: the measure of the
    discrimination case (a mode's departure reaches every element, while a
    bf16 split that flips on a one-ulp difference of its operand reaches a
    few)."""
    def r(xs, ys):
        num = sum(float(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).sum())
                  for a, b in zip(xs, ys))
        den = sum(float((np.asarray(b, np.float64) ** 2).sum()) for b in ys)
        return math.sqrt(num / den)
    return r(port[0], jx[0]), r(port[1], jx[1])


def _kernel_case(kernel, form, tree, tp):
    """(JAX kernel fn, port fn, operand names) at f32."""
    la, lb = tree["layers"]
    if kernel == "k1":
        first_v, last = FORMS[form]
        w = fl.k1_weights(tp["layers"][0], LMAX, PARITY)

        def jfn(*a):
            out = ps.allegro_layer_fused_t(*a, la, LMAX, K, AVG, parity=PARITY,
                                           first_v=first_v, last=last)
            return (out,) if last else out

        def tfn(*a):
            return fl.fused_layer(*a, w, K, AVG, first_v=first_v, last=last)
        return jfn, tfn, ("x", "pT" if first_v else "V", "Y", "u")
    if kernel == "k6":
        w = k6.k6_weights(tp, LMAX, PARITY)

        def jfn(*a):
            return ps.allegro_layer_embed_fused_t(*a, la, tuple(tree["two_body_mlp"]["w"]),
                                                  tree["tensor_embed"], LMAX, K, AVG,
                                                  parity=PARITY)

        def tfn(*a):
            return k6.embed_layer(*a, w, K, AVG)
        return jfn, tfn, ("in", "Y", "u")
    w = k7.k7_weights(tp, LMAX, PARITY, True)

    def jfn(*a):
        return ps.allegro_layer_readout_fused_t(*a, lb, tuple(tree["readout_mlp"]["w"]),
                                                tuple(tree["charge_mlp"]["w"]), LMAX, K, AVG,
                                                parity=PARITY)

    def tfn(*a):
        return k7.readout_layer(*a, w, K, AVG)
    return jfn, tfn, ("x", "V", "Y", "u")


def _check_policy(p, port, jx, label):
    fwd, bwd = _dist(port, jx)
    tol = KERNEL_TOLS if p == "default" else TIGHT
    print(f"{label} under {p}: port against JAX {fwd:.3e} fwd, {bwd:.3e} bwd of max "
          f"(gate {tol}); rms {_rms(port, jx)}")
    assert fwd <= tol[0] and bwd <= tol[1], (label, p, fwd, bwd)
    return fwd, bwd


@pytest.mark.parametrize("p", POLICIES)
@pytest.mark.parametrize("kernel,form", [("k1", "first"), ("k1", "middle"), ("k1", "last"),
                                         ("k6", None), ("k7", None)])
def test_plain_kernels_match_jax_kernels_under_each_policy(kernel, form, p):
    tree, tp = _trees(torch.float32)
    jfn, tfn, names = _kernel_case(kernel, form, tree, tp)
    ins = [_ops(3)[n] for n in names]
    with _both(p):
        jx = _run_jax(jfn, ins, 3)
        port = _run_port(tfn, ins, jx[2])
    _check_policy(p, port, jx[:2], f"{kernel} {form or ''}")


@pytest.mark.parametrize("kernel,form,factor", [("k1", "first", 4), ("k1", "middle", 4),
                                                ("k6", None, 2)])
def test_kernel_high_is_jax_kernel_high(kernel, form, factor):
    """The discrimination case: against JAX under 'kernel_high' the port
    under 'kernel_high' is ``factor`` times closer (RMS) than the port under
    'highest' (whose products are the exact f32 ones): K1 4x (measured
    ~9x forward, ~6x backward), K6 2x (~4x, ~3x: its prologue chains three
    more split products, each of which a one-ulp difference of an operand
    can flip)."""
    tree, tp = _trees(torch.float32)
    jfn, tfn, names = _kernel_case(kernel, form, tree, tp)
    ins = [_ops(5)[n] for n in names]
    with _both("kernel_high"):
        jx = _run_jax(jfn, ins, 3)
        near = _rms(_run_port(tfn, ins, jx[2]), jx[:2])
    with prec.matmul_precision("highest"):
        far = _rms(_run_port(tfn, ins, jx[2]), jx[:2])
    print(f"{kernel} {form or ''}: against JAX kernel_high, the port kernel_high {near}, "
          f"highest {far}")
    assert far[0] >= factor * near[0] and far[1] >= factor * near[1], (near, far)


@pytest.mark.parametrize("p", ["kernel_high", "default"])
def test_k6_embed_prec_highest(p, monkeypatch):
    """PAT_EMBED_PREC=highest: JAX's K6 prologue runs _mm_exact, the
    port's f32-accurate products, while the body keeps the policy's mode;
    the port under it is closer to JAX under it than to JAX with the
    prologue at the policy."""
    monkeypatch.setenv("PAT_EMBED_PREC", "highest")
    tree, tp = _trees(torch.float32)
    jfn, tfn, names = _kernel_case("k6", None, tree, tp)
    ins = [_ops(6)[n] for n in names]
    with _both(p):
        jx = _run_jax(jfn, ins, 2)
        port = _run_port(tfn, ins, jx[2])
    _check_policy(p, port, jx[:2], "k6 PAT_EMBED_PREC=highest")


class _Ref:
    """An output ref of a Pallas kernel body run eagerly."""

    value = None

    def __setitem__(self, key, v):
        self.value = v


def _jax_stack(layers, n_lat, x0, pT, Y, u, dxo):
    """JAX's K8 kernel bodies on the whole arrays (one block), forward and
    backward, under the policy in force."""
    ws_flat, _ = ps._flatten_layer_ws(layers, LMAX)
    S = jnp.asarray(ps._s_matrix(E, NC, K), jnp.float32)
    inv_avg = 1.0 / math.sqrt(AVG)
    out = _Ref()
    ps._stack_fwd_kernel(LMAX, PARITY, len(layers), n_lat, inv_avg, x0, pT, Y, u, S, *ws_flat,
                         out)
    grads = [_Ref() for _ in range(4)]
    ps._stack_bwd_kernel(LMAX, PARITY, len(layers), n_lat, inv_avg, x0, pT, Y, u, dxo, S,
                         *ws_flat, *grads)
    return np.asarray(out.value), [np.asarray(g.value) for g in grads]


@pytest.mark.parametrize("p", POLICIES)
def test_plain_k8_matches_jax_kernel_under_each_policy(p, monkeypatch):
    """K8: JAX's env sums run through ``_mm`` (a 2-term split of A at HIGH,
    ~2^-17 of each sum; the port's are exact f32 sums), so the gate is
    twice the tight one forward and backward."""
    monkeypatch.setenv("PAT_MIX_LAYOUT", "pmajor")
    tree, tp = _trees(torch.float32, layers=3, charges=False)
    o = _ops(7)
    ins = [jnp.asarray(o[n], jnp.float32) for n in ("x", "pT", "Y", "u")]
    rng = np.random.RandomState(8)
    dxo = rng.randn(NS, E).astype(np.float32)
    n_lat = len(tree["layers"][0]["latent_mlp"]["w"])
    with _both(p):
        j_out, j_grads = _jax_stack(tree["layers"], n_lat, *ins, jnp.asarray(dxo))
        port = _run_port(lambda *a: k8.fused_stack(*a, tp["layers"], K, LMAX, AVG, PARITY),
                         [o[n] for n in ("x", "pT", "Y", "u")], [dxo])
    fwd, bwd = _dist(port, ([j_out], j_grads))
    tol = KERNEL_TOLS if p == "default" else (2 * TIGHT[0], 2 * TIGHT[1])
    print(f"k8 under {p}: port against JAX {fwd:.3e} fwd, {bwd:.3e} bwd of max (gate {tol})")
    assert fwd <= tol[0] and bwd <= tol[1]


@pytest.mark.parametrize("p", POLICIES)
def test_f64_is_unchanged_under_every_policy(p):
    """At f64 every mode is the plain product: K1's plain version (first
    form) against JAX's layer math at f64 to 1e-10 under each policy."""
    from test_torch_port_layer import test_plain_matches_jax_layer_math_f64

    with _both(p):
        test_plain_matches_jax_layer_math_f64(True, False)
        test_plain_matches_jax_layer_math_f64(False, True)


# ---------------------------------------------------------------------------
# K1 at bf16: the constants round as JAX's weak typing rounds them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ns", [16, 24])
@pytest.mark.parametrize("first_v,last", [(True, False), (False, True)])
def test_k1_bf16_constants_round_as_jax(ns, first_v, last):
    """K1's plain version at bf16 against JAX's K1 in interpret mode at bf16
    (ns 16, and 24 whose 1/sqrt(ns) is not a power of 2): with the
    constants rounded to bf16 (the repair) more of the outputs equal JAX's
    bit for bit than with the f32 constants (``scalars=torch.float32``,
    the version before it); max-norm cannot tell the two apart (one bf16
    ulp of the largest output either way), the share of exact outputs can.
    The distances before and after are printed."""
    tree, tp = _trees(torch.float32, ns=ns, layers=1, charges=False)
    w = fl.k1_weights(tp["layers"][0], LMAX, PARITY)
    o = _ops(3, ns)
    tin = [torch.tensor(o[n], dtype=torch.float32).to(torch.bfloat16)
           for n in ("x", "pT" if first_v else "V", "Y", "u")]
    jin = tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tin)
    j = ps.allegro_layer_fused_t(*jin, tree["layers"][0], LMAX, K, AVG, parity=PARITY,
                                 first_v=first_v, last=last)
    j = [np.asarray(x, np.float32) for x in ((j,) if last else j)]
    res = {}
    for label, sd in (("before (f32 constants)", torch.float32), ("after (rounded)", None)):
        out = fl.fused_layer_reference(*tin, w, K, 1.0 / math.sqrt(AVG), first_v, last, None, sd)
        out = [x.float().numpy() for x in ((out,) if last else out)]
        exact = float(np.mean(np.concatenate([(a == b).ravel() for a, b in zip(out, j)])))
        msig = max(abs(float((a - b).mean() / np.abs(b).mean())) for a, b in zip(out, j))
        res[label] = (max(_rel(a, b) for a, b in zip(out, j)), msig, exact)
    print(f"K1 bf16 ns={ns} first_v={first_v} last={last}: (max-norm, |mean signed|, share "
          f"equal to JAX) {res}")
    before, after = res["before (f32 constants)"], res["after (rounded)"]
    assert after[2] >= before[2] + 0.02, res
    assert after[0] <= KERNEL_TOLS[0]


def test_pack_x3_layout():
    """The bf16x3 builds' weight layout (``fused_layer.pack_x3``): the f32
    layout's words, row 2 k2 the bf16 hi pairs of rows 2 k2 and 2 k2 + 1,
    row 2 k2 + 1 their lo pairs (csrc/allegro_mma.cuh reads them so), hi =
    bf16(w), lo = bf16(w - hi) as JAX's split; a bad row count refuses."""
    w = torch.randn(12, 20, generator=torch.Generator().manual_seed(0))
    p = fl.pack_x3(w)
    assert p.shape == w.shape and p.dtype == torch.int32

    def half(words, upper):
        bits = (words >> 16) & 0xFFFF if upper else words & 0xFFFF
        return (bits << 16).view(torch.float32)

    hi = w.to(torch.bfloat16).float()
    lo = (w - hi).to(torch.bfloat16).float()
    for k in range(12):
        row = 2 * (k // 2)
        assert torch.equal(half(p[row], k % 2), hi[k])
        assert torch.equal(half(p[row + 1], k % 2), lo[k])
    with pytest.raises(ValueError):
        fl.pack_x3(torch.randn(5, 4))
