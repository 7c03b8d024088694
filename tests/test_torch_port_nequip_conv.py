"""K3 (ops/nequip_conv.py) and its helpers against the JAX package: the TP
entry tables, the kernel's generated table header, the
reverse-table node gather, and the plain version against the JAX Pallas
kernel (``nequip_conv_fused``) in interpret mode, at f64 and at f32, for
l_max 1 and 2 and one and two tracks, forward and VJP; the NaN
weight-cotangent contract; the wrapper's input checks.  The CUDA kernel's
own legs are in tests/test_torch_cuda.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.models.nequip as j_nequip
from pair_allegro_tpu.neighbors.device import reverse_table
from pair_allegro_tpu.neighbors.naive import neighbor_list_np
from pair_allegro_tpu.ops.pallas_nequip import conv_viable, nequip_conv_fused
from pair_allegro_tpu.ops.scatter import table_gather_nodes as j_gather
from pair_allegro_tpu_torch.ops import nequip_conv as nc
from pair_allegro_tpu_torch.ops.scatter import table_gather_nodes
from pair_allegro_tpu_torch.ops.tp import tp_entry_table, tp_num_paths

torch.set_num_threads(2)

N, K, C, B, H, AVG = 40, 20, 8, 8, 16, 6.0
CASES = [(1, 1), (1, 2), (2, 1), (2, 2)]  # (l_max, tracks)


def _table(seed=0):
    """The (N, K) neighbor table of tests/test_nequip_fused.py (two species
    by index parity), with its reverse table."""
    rng = np.random.RandomState(seed)
    pos = rng.rand(N, 3) * 7.0
    cell = np.eye(3) * 7.0
    ei, sh = neighbor_list_np(pos, cell, (True,) * 3, 3.0)
    j_tab = np.zeros((N, K), np.int32)
    s_tab = np.zeros((N, K, 3))
    m_tab = np.zeros((N, K), bool)
    cnt = np.zeros(N, int)
    for (i, j), s in zip(ei.T, sh):
        j_tab[i, cnt[i]] = j
        s_tab[i, cnt[i]] = s
        m_tab[i, cnt[i]] = True
        cnt[i] += 1
    for i in range(N):
        j_tab[i, cnt[i]:] = i
    rev = np.asarray(reverse_table(jnp.asarray(j_tab), jnp.asarray(s_tab)))
    return pos, cell, j_tab, s_tab, m_tab, rev


def test_tables_and_consts_equal_jax():
    for lmax in (1, 2):
        assert tp_entry_table(lmax) == j_nequip._tp_entry_table(lmax)
        assert tp_num_paths(lmax) == j_nequip._num_paths(lmax)
    assert (tp_num_paths(1), sum(len(e) for _, rows in tp_entry_table(1) for *_, e in rows)) == (5, 16)
    assert (tp_num_paths(2), sum(len(e) for _, rows in tp_entry_table(2) for *_, e in rows)) == (15, 137)


def test_kernel_header_is_the_generated_table():
    """csrc/nequip_tp_table.cuh holds what tp_table_header() writes (integers
    exact, coefficients to 1e-12: the 3j blocks come from an SVD).
    Regenerate: nc.HEADER.write_text(nc.tp_table_header())."""
    pat = re.compile(r"X\((\d+), (\d+), (\d+), (\d+), (\d), (-?[0-9.e+-]+)f\)")

    def parse(text):
        return [(tuple(int(g) for g in m.groups()[:5]), float(m.group(6))) for m in pat.finditer(text)]

    got, want = parse(nc.HEADER.read_text()), parse(nc.tp_table_header())
    assert len(got) == len(want) == 16 + 137
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=0, atol=1e-12)
    for lmax in (1, 2):
        assert f"#define K3_P_L{lmax} {tp_num_paths(lmax)}" in nc.HEADER.read_text()


def test_table_gather_nodes_matches_jax_and_plain_gather():
    """f64: forward and backward equal JAX's reverse-table gather and the
    plain gather's autograd (the cotangent is zero on padded slots, as the
    model's is)."""
    _, _, j_tab, _, m_tab, rev = _table()
    rng = np.random.RandomState(1)
    h = rng.randn(N, 3, 2, 4)
    g = rng.randn(N, K, 3, 2, 4) * m_tab[:, :, None, None, None]
    ji, rv = torch.tensor(j_tab, dtype=torch.int64), torch.tensor(rev, dtype=torch.int64)
    ht = torch.tensor(h, requires_grad=True)
    out = table_gather_nodes(ht, ji, rv)
    (dh,) = torch.autograd.grad(out, ht, torch.tensor(g))
    jout, vjp = jax.vjp(lambda a: j_gather(a, jnp.asarray(j_tab), jnp.asarray(rev), jnp.asarray(m_tab)),
                        jnp.asarray(h))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(dh.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-12, rtol=0)
    (dh_plain,) = torch.autograd.grad(ht[ji], ht, torch.tensor(g))
    np.testing.assert_allclose(dh.numpy(), dh_plain.numpy(), atol=1e-12, rtol=0)


def _operands(lmax, T, seed):
    rng = np.random.RandomState(seed)
    D, P = (lmax + 1) ** 2, tp_num_paths(lmax)
    hj = rng.randn(N, K, D * T * C)
    bes = rng.randn(N, K, B)
    u = rng.rand(N, K)
    u[:, -3:] = 0.0  # padded slots
    Y = rng.randn(N, K, D)
    ws = [rng.randn(B, H), rng.randn(H, H), rng.randn(H, C * P * T)]
    return (hj, bes, u, Y), ws


def _jax_conv(ws, lmax, T):
    layer = {"radial_mlp": {"w": [jnp.asarray(w) for w in ws]}}
    wcl = j_nequip._radial_cl(layer, C, tp_num_paths(lmax), T)["w"]
    cn = conv_viable(N, K, (lmax + 1) ** 2 * T * C)

    def f(hj, bes, u, Y):
        return nequip_conv_fused(hj, bes, u, Y, [w.astype(hj.dtype) for w in wcl], C=C,
                                 n_tracks=T, K=K, cn=cn, avg_num_neighbors=AVG,
                                 interpret=True, lmax=lmax)
    return f


def _port_conv(ws, lmax, T, dtype, arrays):
    w = nc.prepare_radial(nc.radial_cl([torch.tensor(a, dtype=dtype) for a in ws], C,
                                       tp_num_paths(lmax), T), C, T, lmax)
    ins = [torch.tensor(a.reshape(N * K, -1), dtype=dtype).requires_grad_(True) for a in arrays]
    return w, ins, nc.nequip_conv(*ins, w, K, AVG)


@pytest.mark.parametrize("lmax,T", CASES)
def test_plain_matches_jax_kernel_interpret_f64(lmax, T):
    """f64, where the interpret-mode kernel is exact: agg and the VJP
    (dhj, dbessel, du, dY) to 1e-10."""
    arrays, ws = _operands(lmax, T, 10 * lmax + T)
    out, vjp = jax.vjp(_jax_conv(ws, lmax, T), *(jnp.asarray(a) for a in arrays))
    dagg = np.random.RandomState(3).randn(*out.shape)
    g_j = vjp(jnp.asarray(dagg))
    _, ins, agg = _port_conv(ws, lmax, T, torch.float64, arrays)
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(out), atol=1e-10, rtol=1e-10)
    g_t = torch.autograd.grad(agg, ins, torch.tensor(dagg))
    for name, a, b in zip(("dhj", "dbessel", "du", "dY"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape), atol=1e-10,
                                   rtol=1e-10, err_msg=name)


@pytest.mark.parametrize("lmax,T", CASES)
def test_plain_matches_jax_kernel_interpret_f32(lmax, T, monkeypatch):
    """f32 at exact-f32 matmuls and aggregation (PAT_NEQUIP_AGG_MM=highest,
    so the kernel's bf16 split of the K-sum is not what is measured): both
    packages under the 'highest' policy (the radial MLP's products follow
    the policy; the other policies are tests/test_torch_port_prec_kernels.py's)."""
    from pair_allegro_tpu.ops.prec import matmul_precision

    from pair_allegro_tpu_torch.ops import prec

    monkeypatch.setenv("PAT_NEQUIP_AGG_MM", "highest")
    arrays, ws = _operands(lmax, T, 20 + 10 * lmax + T)
    arrays = tuple(a.astype(np.float32) for a in arrays)
    ws = [w.astype(np.float32) for w in ws]
    with matmul_precision("highest"):
        out, vjp = jax.vjp(_jax_conv(ws, lmax, T), *(jnp.asarray(a) for a in arrays))
        dagg = np.random.RandomState(4).randn(*out.shape).astype(np.float32)
        g_j = vjp(jnp.asarray(dagg))
    with prec.matmul_precision("highest"):
        _, ins, agg = _port_conv(ws, lmax, T, torch.float32, arrays)
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(out), atol=5e-6, rtol=5e-5)
    g_t = torch.autograd.grad(agg, ins, torch.tensor(dagg))
    for name, a, b in zip(("dhj", "dbessel", "du", "dY"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_weight_cotangents_are_nan():
    """The JAX contract: the conv's radial weight cotangents come back
    NaN-filled, so training through it fails loudly."""
    arrays, ws = _operands(1, 2, 5)
    w, ins, agg = _port_conv(ws, 1, 2, torch.float32, arrays)
    for t in w.tensors():
        t.requires_grad_(True)
    try:
        agg = nc.nequip_conv(*ins, w, K, AVG)
        grads = torch.autograd.grad(agg.sum(), [*ins, *w.tensors()])
    finally:
        for t in w.tensors():
            t.requires_grad_(False)
    assert all(torch.isfinite(g).all() for g in grads[:4])
    assert all(torch.isnan(g).all() for g in grads[4:])


def test_radial_and_gate_permutations_match_jax():
    arrays, ws = _operands(2, 2, 6)
    P = tp_num_paths(2)
    layer = {"radial_mlp": {"w": [jnp.asarray(w) for w in ws]}}
    got = nc.radial_cl([torch.tensor(w) for w in ws], C, P, 2)
    for a, b in zip(got, j_nequip._radial_cl(layer, C, P, 2)["w"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    from pair_allegro_tpu_torch.models.nequip import _gate_cl

    gw = np.random.RandomState(7).randn(C, C * 2 * 2)
    for T in (1, 2):
        g = gw[:, : C * 2 * T]
        np.testing.assert_array_equal(_gate_cl(torch.tensor(g), C, 2, T).numpy(),
                                      np.asarray(j_nequip._gate_cl(jnp.asarray(g), C, 2, T)))


def test_wrapper_rejects_bad_shapes():
    arrays, ws = _operands(1, 1, 8)
    w, ins, _ = _port_conv(ws, 1, 1, torch.float32, arrays)
    hj, bes, u, Y = (t.detach() for t in ins)
    with pytest.raises(ValueError):
        nc.nequip_conv(hj[:, :-1], bes, u, Y, w, K, AVG)  # DF is not D*T*C
    with pytest.raises(ValueError):
        nc.nequip_conv(hj, bes, u, Y, w, K + 1, AVG)  # E not a multiple of K
    with pytest.raises(ValueError):
        nc.nequip_conv(hj, bes, u.reshape(-1), Y, w, K, AVG)  # u is not (E, 1)
