"""K2 and K4 on the tensor cores (csrc/env_layer.cu, csrc/tp_mix_fused.cu,
their pieces in csrc/allegro_mma.cuh), checked without the card: each
``kernel_takes`` and ``block_layout`` against its launcher's shared-memory
layout, walked step by step from the take()s read out of the source; every
width the FFMA launchers before them took is still taken, and models of
those widths route to them; a numpy model of K4's per-edge TP rows
(``tp_row_reg_edges`` / ``tp_row_bwd_edges``, fed from the Meta table and
the weight layout the wrapper builds) against the plain version; and that
every kernel library lists every header its source includes.  The kernels' own
legs are in tests/test_torch_cuda.py."""

import dataclasses
import importlib
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pair_allegro_tpu_torch.models.allegro import AllegroConfig, layer_tier
from pair_allegro_tpu_torch.ops import env_layer as k2
from pair_allegro_tpu_torch.ops import tp_mix_fused as k4
from pair_allegro_tpu_torch.ops._build import CudaLibrary
from pair_allegro_tpu_torch.ops.fused_layer import (_meta_table, _row_tables, ring_holds,
                                                     table_fits)
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

torch.set_num_threads(2)

CSRC = Path(k2.__file__).resolve().parent.parent / "csrc"
SRC = {name: (CSRC / name).read_text()
       for name in ("allegro_tiles.cuh", "allegro_mma.cuh", "env_layer.cu", "tp_mix_fused.cu")}


def _const(name):
    for text in SRC.values():
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        if m:
            return m.group(1)
    raise KeyError(name)


SMEM_MAX = int(_const("SMEM_MAX"))
META_WORDS = k2.META_WORDS
MAX_ENT = int(_const("MAX_ENT"))
RING_FWD, RING_BWD = int(_const("RING_FWD")), int(_const("RING_BWD"))
MG = int(_const("MG"))
RING_MIN = 2 * 8 * (MG + 8)  # constexpr int RING_MIN = 2 * 8 * (MG + 8)
LDS_WIDE, LDS_MIN, LDV = int(_const("LDS_WIDE")), int(_const("LDS_MIN")), int(_const("LDV"))
SHARE2 = 233472 // 2 - 1024  # constexpr int SHARE2 = 233472 / 2 - 1024


def test_constants_match_the_sources():
    assert _const("RING_MIN") == "2 * 8 * (MG + 8)"
    assert _const("SHARE2") == "233472 / 2 - 1024"
    assert (SMEM_MAX, RING_FWD, RING_BWD, RING_MIN) == (k2.SMEM_MAX, k2.RING_FWD, k2.RING_BWD,
                                                        k2.RING_MIN)
    assert (LDS_WIDE, LDS_MIN, LDV, SHARE2) == (k2.LDS_WIDE, k2.LDS_MIN, k2.LDV, k2.SHARE2)
    assert "tw == 32 ? LDS_WIDE : tw == 16 ? 24 : 8" in SRC["allegro_mma.cuh"]
    assert [k4.product_stride(t) for t in (32, 16, 8)] == [40, 24, 8]


# ---------------------------------------------------------------------------
# (a) kernel_takes and block_layout mirror the launchers
# ---------------------------------------------------------------------------


def _maxpc(c, lmax, parity):
    return max(num_paths_per_l(lmax, lmax, lmax, parity)) * c


def _body(src, func):
    """The body of ``int func(...)`` in a kernel source."""
    return re.search(rf"\nint {func}\(.*?\n}}\n", src, re.S).group(0)


def _py(expr):
    """A C++ int expression of the launchers in Python: members without
    ``p.``, a ternary as a conditional, ``/`` on ints as ``//``."""
    expr = expr.replace("p.", "").replace(" / ", " // ")
    return re.sub(r"(\w+) \? ([^:,()]+?) : ([^,()]+)", r"(\2 if \1 else \3)", expr)


def _carving(src, func):
    """The launcher's carving of shared memory read from its source: each
    take() of ``func`` in order (a Python expression of the widths), and the
    expression of the words left for the ring and of the block's product
    region (None where it has none)."""
    body = _body(src, func)
    takes = [_py(a) for a in re.findall(r"take\((.+?)\);", body)]
    left = _py(re.search(r"const int left = (.+);", body).group(1))
    r_words = re.search(r"const int r_words = (.+);", body)
    return takes, left, r_words and _py(r_words.group(1))


K2_CARVING = _carving(SRC["env_layer.cu"], "k2_plan")
K4_CARVING = _carving(SRC["tp_mix_fused.cu"], "layout")


def _walk(carving, names, budget, with_ring, bwd):
    """One layout of a launcher (k2_plan, or K4's layout), its take()s
    evaluated in the source's order, each rounded up to 16 bytes; the ring
    its cap or what is left (not below RING_MIN), or none.  Returns (bytes,
    ring words), or None where it does not fit ``budget``."""
    takes, left_expr, r_expr = carving
    env = dict(names, bwd=bwd, budget=budget, MAX_ENT=MAX_ENT, META_WORDS=META_WORDS, LDV=LDV,
               RING_MIN=RING_MIN)
    env["r_words"] = eval(r_expr, {"max": max}, env) if r_expr else 0
    off = 0
    for expr in takes:
        if expr == "ring":
            env["off"] = off
            left = eval(left_expr, {}, env)
            if with_ring:
                if left < RING_MIN:
                    return None
                env["ring"] = min(RING_BWD if bwd else RING_FWD, left)
            elif left < 0:
                return None
            else:
                env["ring"] = 0
        off += -(-eval(expr, {}, env) // 4) * 4
    return 4 * (off + env["r_words"]), env["ring"]


def _k2_walk(bwd, c, cout, d, lmax, parity):
    """k2_layout (csrc/env_layer.cu): its refusals, then k2_plan read from
    the source at the stride 40, then 32, each with the ring, in half an SM,
    then in the whole shared memory, else 32 and no ring.  Returns (bytes,
    stride, ring), or None where the launcher refuses."""
    if not 1 <= d <= 16 or 256 % c or 256 // c > 32 or c % 4 or cout % 4:
        return None
    names = dict(C=c, Cout=cout, D=d, maxpc=_maxpc(c, lmax, parity))
    plans = [(budget, lds, True) for budget in (SHARE2, SMEM_MAX) for lds in (40, 32)]
    for budget, lds, with_ring in plans + [(SMEM_MAX, 32, False)]:
        got = _walk(K2_CARVING, dict(names, L=lds), budget, with_ring, bwd)
        if got:
            return got[0], lds, got[1]
    return None


def _k4_walk(bwd, c, cout, d, lmax, parity):
    """pick_tile (csrc/tp_mix_fused.cu) with its layout read from the
    source: the widest of 32, 16, 8 edges whose block with the ring fits
    half an SM, else the widest that fits with the ring, else 8 edges and
    no ring.  Returns (bytes, tile, ring), or None where nothing fits."""
    names = dict(C=c, Cout=cout, D=d, maxpc=_maxpc(c, lmax, parity))
    plans = [(budget, tw, True) for budget in (SHARE2, SMEM_MAX) for tw in (32, 16, 8)]
    for budget, tw, with_ring in plans + [(SMEM_MAX, 8, False)]:
        got = _walk(K4_CARVING, dict(names, tw=tw, ps={32: 40, 16: 24, 8: 8}[tw]), budget,
                    with_ring, bwd)
        if got:
            return got[0], tw, got[1]
    return None


def test_carvings_are_read_from_the_sources():
    """The take()s the walks evaluate, as the launchers list them."""
    assert K2_CARVING[0] == ["META_WORDS", "(MAX_ENT if bwd else 0)", "D * C",
                             "(D * C if bwd else 0)", "D * C * LDV", "(D * C * LDV if bwd else 0)",
                             "ring", "0"]
    assert K2_CARVING[2] == "max((maxpc + Cout if bwd else maxpc), C + D) * L"
    assert K4_CARVING[0][-2:] == ["(Cout * ps if bwd else 0)", "ring"] and K4_CARVING[2] is None
    assert len(K4_CARVING[0]) == 9


LMAXES = list(itertools.product(range(4), (True, False)))


@pytest.mark.parametrize("bwd", [False, True])
def test_k2_block_layout_is_the_launchers(bwd):
    """block_layout (which kernel_takes sums) against the launcher's layout
    walked region by region, at every C it may take and Cout up to 512:
    the stride-40, stride-32 and ring-less layouts are all met."""
    kinds = set()
    for lmax, parity in LMAXES:
        d = (lmax + 1) ** 2
        for c, cout in itertools.product((8, 16, 32, 64, 128, 256), range(4, 513, 12)):
            want = _k2_walk(bwd, c, cout, d, lmax, parity)
            got = k2.block_layout(c, cout, d, lmax, parity, bwd)
            if want is None:
                assert got[0] > SMEM_MAX, (c, cout, lmax, parity)
            else:
                assert got == want, (c, cout, lmax, parity)
                kinds.add((want[1], want[2] > 0))
    assert kinds == {(40, True), (32, True), (32, False)}


def test_k2_kernel_takes_mirrors_the_launcher():
    for lmax, parity in LMAXES:
        d = (lmax + 1) ** 2
        for c, cout in itertools.product((4, 8, 12, 16, 32, 48, 64, 128, 256), range(4, 513, 20)):
            want = table_fits(lmax, parity) and all(
                _k2_walk(b, c, cout, d, lmax, parity) for b in (False, True))
            assert k2.kernel_takes(c, cout, d, lmax, parity) == bool(want), (c, cout, lmax, parity)
    assert not k2.kernel_takes(132, 132, 9, 2, True)  # C does not divide the 256 threads
    assert not k2.kernel_takes(12, 12, 9, 2, True)
    assert not k2.kernel_takes(8, 6, 9, 2, True)      # Cout not a multiple of 4


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("lmax", range(4))
def test_k4_block_layout_is_the_launchers(bwd, lmax):
    """block_layout (which kernel_takes sums) against pick_tile and its
    layout read from the source, at C and Cout up to 256, with and without
    parity."""
    d = (lmax + 1) ** 2
    for parity in (True, False):
        for c, cout in itertools.product(range(4, 257, 12), (4, 12, 32, 64, 128, 256)):
            want = _k4_walk(bwd, c, cout, d, lmax, parity)
            assert k4.block_layout(c, cout, d, lmax, parity, bwd) == want, (c, cout, parity)


def test_k4_launcher_meets_every_tile():
    """The launcher's own choices over those widths meet every tile with
    the ring and 8 edges without it."""
    kinds = set()
    for (lmax, parity), bwd in itertools.product(LMAXES, (False, True)):
        d = (lmax + 1) ** 2
        for c, cout in itertools.product(range(4, 257, 12), (4, 12, 32, 64, 128, 256)):
            plan = k4.block_layout(c, cout, d, lmax, parity, bwd)
            if plan:
                kinds.add((plan[1], plan[2] > 0))
    assert kinds == {(32, True), (16, True), (8, True), (8, False)}


def test_k4_kernel_takes_mirrors_the_launcher():
    for lmax, parity in LMAXES:
        d = (lmax + 1) ** 2
        for c, cout in itertools.product(range(4, 265, 4), (4, 32, 64, 128, 256)):
            want = table_fits(lmax, parity) and all(
                _k4_walk(b, c, cout, d, lmax, parity) for b in (False, True))
            assert k4.kernel_takes(c, cout, d, lmax, parity) == bool(want), (c, cout, lmax, parity)
    assert not k4.kernel_takes(6, 8, 9, 2, True)
    assert not k4.kernel_takes(256, 256, 9, 2, True)  # shared memory, even at 8 edges


def test_flagship_layouts():
    """At the flagship widths (l_max 2, parity, C = Cout = 32), every block
    two an SM: K2 forward at the stride 40 with a ring that keeps an l3
    block of the mix (128 x 32 words), K2 backward at the stride 32 with a
    ring too small to keep one of mixT; K4 forward at 32 edges and backward
    at 16, each keeping its l3 blocks."""
    assert k2.block_layout(32, 32, 9, 2, True, False) == (79312, 40, 4096)
    assert k2.block_layout(32, 32, 9, 2, True, True) == (115696, 32, 3176)
    assert k4.block_layout(32, 32, 9, 2, True, False) == (115024, 32, 4096)
    assert k4.block_layout(32, 32, 9, 2, True, True) == (115696, 16, 5032)
    # the backward's block at 32 edges keeps no two an SM
    assert _walk(K4_CARVING, dict(C=32, Cout=32, D=9, maxpc=128, tw=32, ps=40), SHARE2, True,
                 True) is None
    for nbytes in (79312, 115024, 115696):
        assert 2 * (nbytes + 1024) <= 233472
    assert ring_holds(128, 32, 4096) and ring_holds(32, 128, 4096) and ring_holds(32, 128, 5032)
    assert not ring_holds(32, 128, 3176)


# ---------------------------------------------------------------------------
# (b) every width the FFMA launchers took is still taken, and routed so
# ---------------------------------------------------------------------------


def _old_k2_takes(c, cout, d, lmax, parity):
    """The FFMA K2 launcher (its refusals and its one layout: tiles of row
    stride 33, the backward's sum the larger), transcribed."""
    if not table_fits(lmax, parity) or 256 % c or 256 // c > 32 or c % 4 or cout % 4 or d > 16:
        return False
    maxpc = _maxpc(c, lmax, parity)
    words = META_WORDS + 2 * d * c + 2 * d * c * 33 + maxpc * 33 + cout * 33 + d * 33 + c * 33
    return words * 4 <= SMEM_MAX


def _old_k4_takes(c, cout, d, lmax, parity):
    """The FFMA K4 launcher at its narrowest tile (8 edges, row stride 9),
    forward and backward, transcribed."""
    if d > 16 or not table_fits(lmax, parity) or c < 4 or c % 4 or cout < 4 or cout % 4:
        return False
    maxpc = _maxpc(c, lmax, parity)
    return all(4 * (META_WORDS + d * c * 9 * (4 if bwd else 2) + maxpc * 9
                    + (cout * 9 if bwd else 0)) <= SMEM_MAX for bwd in (False, True))


def test_every_width_the_ffma_k2_took_is_taken():
    taken = 0
    for lmax, parity in LMAXES:
        d = (lmax + 1) ** 2
        for c, cout in itertools.product((8, 16, 32, 64, 128, 256), range(4, 1025, 4)):
            if _old_k2_takes(c, cout, d, lmax, parity):
                taken += 1
                assert k2.kernel_takes(c, cout, d, lmax, parity), (c, cout, lmax, parity)
    assert taken > 2000


def test_every_width_the_ffma_k4_took_is_taken():
    taken = 0
    for lmax, parity in LMAXES:
        d = (lmax + 1) ** 2
        for c, cout in itertools.product(range(4, 513, 4), (4, 16, 64, 128, 256, 512, 1024)):
            if _old_k4_takes(c, cout, d, lmax, parity):
                taken += 1
                assert k4.kernel_takes(c, cout, d, lmax, parity), (c, cout, lmax, parity)
    assert taken > 1500
    assert k4.kernel_takes(64, 64, 16, 3, True) and k4.kernel_takes(128, 128, 9, 2, True)


def _cfg(c, lmax, parity, **fields):
    return AllegroConfig(type_names=("Cu",), r_max=4.5, l_max=lmax, parity=parity,
                         num_tensor_features=c, **fields)


# the narrowest and widest widths each FFMA launcher took, per l_max
K2_EDGES = [(8, 2, True), (64, 2, True), (8, 0, True), (256, 0, True), (128, 1, False),
            (8, 3, True), (32, 3, True)]
K4_EDGES = [(4, 2, True), (152, 2, True), (4, 0, True), (596, 0, True), (316, 1, False),
            (4, 3, True), (84, 3, True)]


@pytest.mark.parametrize("c,lmax,parity", K2_EDGES)
def test_perlayer_models_route_to_k2(c, lmax, parity):
    d = (lmax + 1) ** 2
    assert _old_k2_takes(c, c, d, lmax, parity) and k2.kernel_takes(c, c, d, lmax, parity)
    assert layer_tier(_cfg(c, lmax, parity, layer_fused=False), flat=False) == "perlayer"


@pytest.mark.parametrize("c,lmax,parity", K4_EDGES)
def test_flat_models_route_to_k4(c, lmax, parity):
    d = (lmax + 1) ** 2
    assert _old_k4_takes(c, c, d, lmax, parity) and k4.kernel_takes(c, c, d, lmax, parity)
    assert layer_tier(_cfg(c, lmax, parity), flat=True) == "k4"
    assert layer_tier(_cfg(c, lmax, parity, layer_fused=False), flat=True) == "k4"


# ---------------------------------------------------------------------------
# (c) a numpy model of K4's per-edge TP rows against the plain version
# ---------------------------------------------------------------------------


def _table(lmax, parity, c, cout):
    """The wrapper's Meta table and its entries' (p, i, j, w), w in f64
    (the table holds them in f32)."""
    m = _meta_table(lmax, parity, c, cout, (0,))
    ent = m["ent"][: m["n_ent"]]
    w = np.array([wv for ents, _ in _row_tables(lmax, parity) for *_, wv in ents])
    np.testing.assert_allclose(w, m["w"][: m["n_ent"]], rtol=1e-7)
    return m, ent & 255, (ent >> 8) & 255, ent >> 16, w


def _jperm(m, nrows):
    """build_jperm: each row's entries ordered by (j, index)."""
    perm = []
    for r in range(nrows):
        idx = range(m["rowstart"][r], m["rowstart"][r + 1])
        perm += sorted(idx, key=lambda e: (m["ent"][e] >> 16, e))
    return perm


def _k4_model(w, V, env, dout, dinv):
    """K4 as the kernel computes it, in f64: per output row, T c-major
    (tp_row_reg_edges: each path's entries one run, in table order, row c*P
    + p), V' = the row's l3 block of mix_flat (the tree's c-major leaves)
    times T, inv from row 0; backward dT from the l3 block of mixT_flat (+
    dinv at row 0), then tp_row_bwd_edges over the j-ordered entries: dV
    per entry, denv summed per run of equal j."""
    d, c, e = V.shape
    cout = w.cout
    m, pp, ii, jj, wt = _table(w.lmax, w.parity, c, cout)
    mix, mixT = w.mix_flat.double().numpy(), w.mixT_flat.double().numpy()
    p0 = m["rowP"][0]
    out = np.zeros((d, cout, e))
    inv = None
    dV, denv = np.zeros_like(V), np.zeros_like(env)
    perm = _jperm(m, d)
    for r in range(d):
        P, kd, s0 = m["rowP"][r], m["rowP"][r] * c, m["rowmix"][r]
        lo, hi = m["rowstart"][r], m["rowstart"][r + 1]
        norm = 1.0 / np.sqrt(kd)
        T = np.zeros((c, P, e))
        e_ = lo
        for p in range(P):  # one run per path, as the entries are grouped
            while e_ < hi and pp[e_] == p:
                T[:, p] += wt[e_] * env[jj[e_]] * V[ii[e_]]
                e_ += 1
        assert e_ == hi
        out[r] = mix[s0:s0 + kd * cout].reshape(kd, cout).T @ T.reshape(kd, e) * norm
        dT = (mixT[s0:s0 + kd * cout].reshape(cout, kd).T @ dout[r] * norm).reshape(c, P, e)
        if r == 0:
            inv = T.transpose(2, 0, 1).reshape(e, c * p0)
            dT = dT + dinv.reshape(e, c, p0).transpose(1, 2, 0)
        q = lo
        while q < hi:
            j, s = jj[perm[q]], np.zeros((c, e))
            while q < hi and jj[perm[q]] == j:
                f = perm[q]
                g = wt[f] * dT[:, pp[f]]
                dV[ii[f]] += g * env[j]
                s += g * V[ii[f]]
                q += 1
            denv[j] += s
    return out, inv, dV, denv


@pytest.mark.parametrize("c,cout,lmax,parity", [(8, 8, 2, True), (12, 20, 1, True),
                                                (4, 8, 2, False), (8, 4, 3, True)])
def test_k4_tp_rows_model_matches_plain(c, cout, lmax, parity):
    """The per-edge TP row variants' arithmetic, fed from the wrapper's Meta
    table and weight layout, against tp_mix_fused_reference forward and
    backward at f64."""
    rng = np.random.RandomState(c + 10 * lmax)
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    mix = {f"l{l3}": torch.tensor(rng.randn(c * P[l3], cout)) for l3 in range(lmax + 1)}
    w = k4.prepare_mix(mix, lmax, parity)
    d, e = (lmax + 1) ** 2, 11
    V, env = rng.randn(d, c, e), rng.randn(d, c, e)
    ins = [torch.tensor(t, requires_grad=True) for t in (V, env)]
    out, inv = k4.tp_mix_fused_reference(*ins, w)
    dout, dinv = rng.randn(*out.shape), rng.randn(*inv.shape)
    g = torch.autograd.grad((out, inv), ins, (torch.tensor(dout), torch.tensor(dinv)))
    got = _k4_model(w, V, env, dout, dinv)
    for a, b in zip(got, (out, inv, *g)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-11, atol=1e-11)


# ---------------------------------------------------------------------------
# (d) the builds: every header a kernel includes is in its cache tag
# ---------------------------------------------------------------------------


def _includes(path, seen=None):
    seen = set() if seen is None else seen
    for name in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M):
        dep = path.parent / name
        if dep not in seen:
            seen.add(dep)
            _includes(dep, seen)
    return seen


OPS = ["fused_layer", "nequip_conv", "env_layer", "env_layer_mxu", "tp_mix_fused", "embed_layer",
       "readout_layer", "fused_stack"]


@pytest.mark.parametrize("name", OPS)
def test_every_library_lists_the_headers_its_source_includes(name):
    """The build cache is keyed on CudaLibrary's sources: a header missing
    there would leave a stale library after it changed."""
    mod = importlib.import_module(f"pair_allegro_tpu_torch.ops.{name}")
    libs = [v for v in vars(mod).values() if isinstance(v, CudaLibrary)]
    assert libs, name
    for lib in libs:
        listed = {Path(s).resolve() for s in lib.sources}
        assert {p.resolve() for p in _includes(Path(lib.sources[0]))} <= listed, lib.stem
        assert all(Path(s).exists() for s in lib.sources)


def test_k2_k4_products_are_on_the_tensor_cores():
    """No FFMA product, shared-memory TP row or atomic is left in K2 and K4:
    their mix and mixT run mma_tile (3xTF32 mma.sync) with the weights
    staged by mma_stage (cp.async), their TP rows keep sums in registers.
    K2 and K4 reach them through prod / stage (allegro_mma.cuh: K2 at its
    activations' type, K4 at f32), which run mma_tile and mma_stage in the
    form ACT_FORM picks: the build's MIX_MMA at f32 (3xTF32 in env_layer.cu
    and tp_mix_fused.cu, bf16x3 or one bf16 pass in the policy's builds,
    which define nothing else), the bf16 product on the same ring at bf16."""
    tiles = SRC["allegro_tiles.cuh"]
    for gone in ("gemm_tile", "tp_row(", "tp_row_edges", "load_tile("):
        assert gone not in tiles
    mma = SRC["allegro_mma.cuh"]
    dispatch = {"prod<Act>": re.search(r"void prod\(.*?\n}\n", mma, re.S).group(0),
                "stage<Act>": re.search(r"void stage\(.*?\n}\n", mma, re.S).group(0)}
    assert "mma_tile<TW, O, ACT_FORM<Act>>(" in dispatch["prod<Act>"]
    assert "mma_stage(" in dispatch["stage<Act>"]
    assert "IS_BF16<Act> ? (int)BF16P : (int)MIX_MMA" in mma
    assert "#ifndef MIX_MMA\n#define MIX_MMA TF32X3\n#endif" in mma
    for name, tp in (("env_layer.cu", ("tp_row_reg(", "tp_row_bwd(")),
                     ("tp_mix_fused.cu", ("tp_row_reg_edges<", "tp_row_bwd_edges<"))):
        src = SRC[name]
        assert "atomicAdd" not in src and "__ldg(A" not in src
        assert (src.count("mma_tile") + src.count("prod<Act>") + src.count("prod<float, TW>") >= 2
                and src.count("mma_stage") + src.count("stage<Act>") + src.count("stage<float>")
                >= 2)
        assert all(t in src for t in tp)
        assert '#include "allegro_mma.cuh"' in src
        stem = name[:-3]
        for build, form in (("bf16x3", "BF16X3"), ("onepass", "BF16P")):
            text = (CSRC / f"{stem}_{build}.cu").read_text()
            code = [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("//")]
            assert code == [f"#define MIX_MMA {form}", f'#include "{name}"'], (stem, build)


def test_k4_weights_keep_the_leaves_for_cotangents():
    """The cached layout is a detached copy; the leaves it names are the
    tree's own tensors (they receive the NaN weight cotangents)."""
    mix = {f"l{l3}": torch.randn(8 * p, 8, requires_grad=True)
           for l3, p in enumerate(num_paths_per_l(1, 1, 1, True))}
    w = k4.prepare_mix(mix, 1, True)
    assert all(a is b for a, b in zip(w.leaves, (mix["l0"], mix["l1"])))
    assert not w.mix_flat.requires_grad and w.meta is None
    assert dataclasses.is_dataclass(w)
