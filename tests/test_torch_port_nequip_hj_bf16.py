"""NequIP's bf16 h[j] boundary (``PAT_NEQUIP_HJ=bf16``) in the port against
the JAX package on the CPU, at f32:

* the model on K3's route (K3's plain version) against JAX's model through
  its K3 kernel in interpret mode (``PAT_FORCE_NEQUIP_FUSED=1``), both
  with the boundary, parity off and on, one and two layers' hops: both
  round h at the same point (the gather's input), so the gates are tight,
  |dE| <= 1e-4 |E| and max|dF| <= 2e-3 max|F|;
* K3's plain version fed the same bf16 hj as JAX's ``nequip_conv_fused``
  in interpret mode, at K3's f32 tolerances (dhj, bf16 on both sides,
  within one bf16 ulp);
* the reverse-table gather's backward sums a bf16 cotangent in f32 and
  returns it at bf16 (``ops/scatter.py:150-159``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.models.nequip as j_nequip
from pair_allegro_tpu.ops.pallas_nequip import conv_viable, nequip_conv_fused
from pair_allegro_tpu.ops.scatter import table_gather_nodes as j_gather
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, conv_route, hj_bf16, nequip_energy
from pair_allegro_tpu_torch.ops import nequip_conv as nc
from pair_allegro_tpu_torch.ops.scatter import table_gather_nodes
from pair_allegro_tpu_torch.ops.tp import tp_num_paths
from pair_allegro_tpu_torch.potential import make_potential
from test_torch_port_nequip import _kw
from test_torch_port_nequip_conv import AVG, CASES, K, N, _operands, _table

torch.set_num_threads(2)


def _params32(kw):
    from pair_allegro_tpu.models.nequip import NequIPConfig as JaxConfig
    from pair_allegro_tpu.models.nequip import nequip_init
    from pair_allegro_tpu_torch.models.nequip import nequip_params_from_numpy

    jcfg = JaxConfig(remat=False, **kw)
    jp = nequip_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    nt = jcfg.num_types
    jp["per_type_scale"] = jnp.linspace(0.8, 1.3, nt, dtype=jnp.float32)
    jp["per_type_shift"] = jnp.linspace(-0.2, 0.4, nt, dtype=jnp.float32)
    tp = nequip_params_from_numpy(jax.tree.map(np.asarray, jp), NequIPConfig(**kw), device="cpu",
                                  dtype=torch.float32)
    return jcfg, jp, tp


@pytest.mark.parametrize("lmax,parity", [(1, False), (1, True), (2, True)])
def test_model_matches_jax_with_the_bf16_boundary(lmax, parity, monkeypatch):
    from pair_allegro_tpu.models.nequip import nequip_energy as j_energy
    from pair_allegro_tpu.ops.prec import matmul_precision
    from pair_allegro_tpu.potential import make_potential as j_potential

    pos, cell, j_tab, s_tab, m_tab, rev = _table()
    types = np.arange(len(pos)) % 2
    kw = _kw(lmax, parity, 2)
    jcfg, jp, tp = _params32(kw)
    monkeypatch.setenv("PAT_FORCE_NEQUIP_FUSED", "1")
    monkeypatch.setenv("PAT_NEQUIP_AGG_MM", "highest")
    jargs = (jnp.asarray(pos, jnp.float32), jnp.asarray(types, jnp.int32), jnp.asarray(j_tab))
    jkw = dict(cell=jnp.asarray(cell, jnp.float32), edge_shifts=jnp.asarray(s_tab, jnp.float32),
               edge_mask=jnp.asarray(m_tab), edge_rev=jnp.asarray(rev))
    targs = (torch.tensor(pos, dtype=torch.float32), torch.tensor(types, dtype=torch.int64),
             torch.tensor(j_tab, dtype=torch.int64))
    tkw = dict(cell=torch.tensor(cell, dtype=torch.float32),
               edge_shifts=torch.tensor(s_tab, dtype=torch.float32),
               edge_mask=torch.tensor(m_tab), edge_rev=torch.tensor(rev, dtype=torch.int64))
    cfg = NequIPConfig(**kw)
    assert conv_route(cfg, False, dtype=torch.float32, card=False)
    out = {}
    for hj in ("", "bf16"):
        monkeypatch.setenv("PAT_NEQUIP_HJ", hj)
        assert hj_bf16() == (hj == "bf16")
        with matmul_precision("highest"):
            jo = jax.jit(j_potential(lambda *a, **k: j_energy(jp, jcfg, *a, **k)))(*jargs, **jkw)
        seen = []
        real = nc.nequip_conv_reference

        def spy(hj_, *a, **k):
            seen.append(hj_.dtype)
            return real(hj_, *a, **k)

        monkeypatch.setattr(nc, "nequip_conv_reference", spy)
        to = make_potential(lambda *a, **k: nequip_energy(tp, cfg, *a, **k))(*targs, **tkw)
        monkeypatch.setattr(nc, "nequip_conv_reference", real)
        # each layer's forward, and its backward's recompute
        assert seen == [torch.bfloat16 if hj else torch.float32] * (2 * cfg.num_layers)
        out[hj] = (float(jo.total_energy), np.asarray(jo.forces), float(to.total_energy),
                   to.forces.numpy())
    je, jf, te, tf = out["bf16"]
    assert tf.dtype == np.float32
    de, df, fmax = abs(te - je), float(np.abs(tf - jf).max()), float(np.abs(jf).max())
    scale = float(np.abs(out[""][1] - jf).max())
    print(f"l_max {lmax} parity {parity}: |dE| {de:.3e} (E {je:.4f}), max|dF| {df:.3e} "
          f"(max|F| {fmax:.3f}); JAX's bf16 boundary against its f32 path: max|dF| {scale:.3e}")
    assert de <= 1e-4 * abs(je)
    assert df <= 2e-3 * fmax


@pytest.mark.parametrize("lmax,T", CASES)
def test_plain_matches_jax_kernel_interpret_bf16_hj(lmax, T, monkeypatch):
    """The same bf16 hj through K3's plain version and JAX's interpret-mode
    kernel (f32 weights and every other operand): agg, dbessel, du and dY at
    K3's f32 tolerances; dhj is bf16 on both sides, rounded from f32 values
    that agree at those tolerances, so within one bf16 ulp (2^-7 relative
    at the bottom of a binade): a value near a rounding midpoint may round
    the other way on one side.  Both packages run under the 'highest'
    policy (the radial MLP's products follow the policy; the other
    policies are tests/test_torch_port_prec_kernels.py's)."""
    from pair_allegro_tpu.ops.prec import matmul_precision

    from pair_allegro_tpu_torch.ops import prec

    monkeypatch.setenv("PAT_NEQUIP_AGG_MM", "highest")
    C = 8
    (hj, bes, u, Y), ws = _operands(lmax, T, 40 + 10 * lmax + T)
    hj = np.asarray(jnp.asarray(hj, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    rest = [a.astype(np.float32) for a in (bes, u, Y)]
    ws = [w.astype(np.float32) for w in ws]
    layer = {"radial_mlp": {"w": [jnp.asarray(w) for w in ws]}}
    wcl = j_nequip._radial_cl(layer, C, tp_num_paths(lmax), T)["w"]
    cn = conv_viable(N, K, (lmax + 1) ** 2 * T * C)

    def f(hj_, bes_, u_, Y_):
        return nequip_conv_fused(hj_, bes_, u_, Y_, list(wcl), C=C, n_tracks=T, K=K, cn=cn,
                                 avg_num_neighbors=AVG, interpret=True, lmax=lmax)

    with matmul_precision("highest"):
        out, vjp = jax.vjp(f, jnp.asarray(hj, jnp.bfloat16), *(jnp.asarray(a) for a in rest))
        dagg = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
        g_j = vjp(jnp.asarray(dagg))
    assert out.dtype == jnp.float32 and g_j[0].dtype == jnp.bfloat16
    w = nc.prepare_radial(nc.radial_cl([torch.tensor(a) for a in ws], C, tp_num_paths(lmax), T),
                          C, T, lmax)
    ins = [torch.tensor(hj.reshape(N * K, -1)).to(torch.bfloat16).requires_grad_(True)]
    ins += [torch.tensor(a.reshape(N * K, -1)).requires_grad_(True) for a in rest]
    with prec.matmul_precision("highest"):
        agg = nc.nequip_conv(*ins, w, K, AVG)
    assert agg.dtype == torch.float32
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(out), atol=5e-6, rtol=5e-5)
    g_t = torch.autograd.grad(agg, ins, torch.tensor(dagg))
    assert g_t[0].dtype == torch.bfloat16
    a, b = g_t[0].float().numpy(), np.asarray(g_j[0].astype(jnp.float32)).reshape(N * K, -1)
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=2.0 ** -7, err_msg="dhj")
    for name, a, b in zip(("dbessel", "du", "dY"), g_t[1:], g_j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_gather_backward_sums_bf16_in_f32():
    """A bf16 cotangent: the reverse-table sum runs in f32 and returns bf16,
    equal to the f64 sum rounded to bf16 and to JAX's; a sum in bf16 would
    not be (checked on the same data, so the test tells the two apart)."""
    _, _, j_tab, _, m_tab, rev = _table()
    rng = np.random.RandomState(6)
    h = torch.tensor(rng.randn(N, 24), dtype=torch.bfloat16, requires_grad=True)
    g = torch.tensor(rng.randn(N, K, 24) * 3.0) * torch.tensor(m_tab)[:, :, None]
    g = g.to(torch.bfloat16)
    ji, rv = torch.tensor(j_tab, dtype=torch.int64), torch.tensor(rev, dtype=torch.int64)
    out = table_gather_nodes(h, ji, rv)
    assert out.dtype == torch.bfloat16
    (dh,) = torch.autograd.grad(out, h, g)
    assert dh.dtype == torch.bfloat16
    h64 = h.detach().double().requires_grad_(True)
    (dh64,) = torch.autograd.grad(table_gather_nodes(h64, ji, rv), h64, g.double())
    want = dh64.to(torch.bfloat16)
    np.testing.assert_array_equal(dh.float().numpy(), want.float().numpy())
    _, vjp = jax.vjp(lambda a: j_gather(a, jnp.asarray(j_tab), jnp.asarray(rev),
                                        jnp.asarray(m_tab)),
                     jnp.asarray(h.detach().float().numpy(), jnp.bfloat16))
    (dj,) = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    assert dj.dtype == jnp.bfloat16
    np.testing.assert_array_equal(dh.float().numpy(), np.asarray(dj.astype(jnp.float32)))
    # a K-deep sum in bf16 rounds at every term: not the same numbers
    gflat = g.reshape(N * K, -1)
    rows = gflat.index_select(0, torch.clamp_max(rv, N * K - 1).reshape(-1)).reshape(N, K, -1)
    rows = rows.masked_fill(~(rv < N * K)[:, :, None], 0.0)
    in_bf16 = rows[:, 0].clone()
    for kk in range(1, K):
        in_bf16 = in_bf16 + rows[:, kk]
    assert not torch.equal(in_bf16, dh)


def test_route_and_dtype_contract():
    """The boundary changes no route (the working dtype stays f32); on a CPU
    tensor the wrapper takes a bf16 hj and returns an f32 agg."""
    cfg = NequIPConfig(type_names=("A",), r_max=3.0, l_max=1, num_features=8)
    assert conv_route(cfg, False, dtype=torch.float32, card=True)
    assert not conv_route(cfg, False, dtype=torch.bfloat16, card=True)
    assert not conv_route(dataclasses.replace(cfg, fused_conv=False), False)
    (hj, bes, u, Y), ws = _operands(1, 2, 9)
    C = 8
    w = nc.prepare_radial(nc.radial_cl([torch.tensor(a, dtype=torch.float32) for a in ws], C,
                                       tp_num_paths(1), 2), C, 2, 1)
    ins = [torch.tensor(a.reshape(N * K, -1), dtype=torch.float32) for a in (hj, bes, u, Y)]
    agg = nc.nequip_conv(ins[0].to(torch.bfloat16), *ins[1:], w, K, AVG)
    assert agg.dtype == torch.float32 and agg.shape == (N, ins[0].shape[1])
