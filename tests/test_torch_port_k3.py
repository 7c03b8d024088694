"""K3 on the tensor cores (csrc/nequip_conv.cu), checked without the card:
``block_layout`` (which ``kernel_takes`` asks) against the launcher's own
layout, walked from the take()s, strides and pick order read out of the
source; the constants the wrapper mirrors; every width the CUDA-core
launcher before it took is still taken; the card legs' widths reach every
layout the launcher picks; and the products are mma.sync, with no FFMA
radial product, shared-memory product tile or atomic left.  The kernel's
own legs are in tests/test_torch_cuda.py (``test_k3_*``)."""

import itertools
import re
from pathlib import Path

import pytest

from pair_allegro_tpu_torch.ops import nequip_conv as k3
from pair_allegro_tpu_torch.ops.tp import tp_num_paths
from test_torch_cuda import K3_LAYOUT_CASES

SRC = (Path(k3.__file__).resolve().parent.parent / "csrc" / "nequip_conv.cu").read_text()


def _const(name):
    return re.search(rf"constexpr int {name}(?:\[\w*\])? = ([^;]+);", SRC).group(1)


def _body(func):
    return re.search(rf"\n\S.* {func}\(.*?\n}}\n", SRC, re.S).group(0)


def _py(expr):
    """A C++ int expression of the launcher in Python: members without
    ``p.``, ``||`` / ``&&`` as ``or`` / ``and``, ``/`` on ints as ``//``,
    one ternary as a conditional."""
    expr = (expr.replace("p.", "").replace("||", " or ").replace("&&", " and ")
            .replace(" / ", " // "))
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        a, b = rest.rsplit(":", 1)
        expr = f"(({a}) if ({cond}) else ({b}))"
    return expr


PLAN, LAYOUT = _body("k3_plan"), _body("k3_layout")
TAKES = [_py(a) for a in re.findall(r"take\((.+?)\);", LAYOUT)]
LDX = _py(re.search(r"p\.ldx = (.+?);", LAYOUT).group(1))
SA = _py(re.search(r"p\.sa = (.+?);", PLAN).group(1))
WO = _py(re.search(r"p\.wo = (.+?);", PLAN).group(1))


def _walk(c, n_tracks, lmax, dims, bwd):
    """k3_plan's pick, evaluated from the source: for the last weight
    resident, then not, each edge tile of ET_BWD / ET_FWD in order, the
    take()s of k3_layout each rounded up to 16 bytes, the first that fits
    SMEM_MAX.  Returns (bytes, edge tile, resident), or None."""
    d = (lmax + 1) ** 2
    nw = len(dims) - 1
    env = dict(C=c, nw=nw, wdim=list(dims), hin=dims[-2], D=d, DT=d * n_tracks, bwd=bwd,
               tpc=n_tracks * tp_num_paths(lmax) * c, NWARP=int(_const("NT")) // 32,
               hmax8=-(-max(dims[:-1]) // 8) * 8, r8=lambda x: -(-x // 8) * 8)
    env["sa"] = eval(SA, {}, env)
    env["wo"] = eval(WO, {}, env)
    env["we"] = env["NWARP"] // env["wo"]
    ets = [int(v) for v in _const("ET_BWD" if bwd else "ET_FWD").strip("{}").split(",")]
    for resident in (True, False):
        for et in ets:
            env.update(resident=resident, et=et)
            env["ldx"] = eval(LDX, {}, env)
            words = sum(-(-eval(t, {}, env) // 4) * 4 for t in TAKES)
            if 4 * words <= int(_const("SMEM_MAX")):
                return 4 * words, et, resident
    return None


def _dims(c, n_tracks, lmax, b, hidden):
    return (b, *hidden, n_tracks * tp_num_paths(lmax) * c)


def test_constants_match_the_source():
    assert (k3.NT, k3.SMEM_MAX, k3._MAX_W) == (int(_const("NT")), int(_const("SMEM_MAX")),
                                               int(_const("MAX_W")))
    assert _const("NWARP") == "NT / 32"
    for name, want in (("ET_FWD", k3.ET_FWD), ("ET_BWD", k3.ET_BWD)):
        assert tuple(int(v) for v in _const(name).strip("{}").split(",")) == want


def test_layout_is_read_from_the_source():
    """The take()s the walk evaluates, as k3_layout lists them."""
    squeeze = [re.sub(r"\s+", "", t) for t in (*TAKES, LDX)]
    assert len(TAKES) == 8
    assert squeeze[0] == "((r8(hin)*sa)if(resident)else(0))"
    assert squeeze[7] == "((0)if(bwd)else(we*DT*C))"
    assert squeeze[8] == "((et+8)if(et>8)else(8))"


WIDTHS = [(c, t, lmax, b, hidden)
          for c in (4, 8, 16, 32, 64, 96, 128) for t in (1, 2) for lmax in (1, 2)
          for b, hidden in ((8, (32, 32)), (8, ()), (12, (36,)), (8, (64, 64, 64)), (4, (256,)),
                            (8, (512, 512)), (16, (1024,)))]


@pytest.mark.parametrize("bwd", [False, True])
def test_block_layout_is_the_launchers(bwd):
    """block_layout against the launcher's layout walked region by region,
    at every C the kernel takes, both track counts and l_max, and radial
    MLPs from none to three hidden layers, up to 1,024 wide: every edge
    tile with and without the resident weight is met."""
    kinds = set()
    for c, t, lmax, b, hidden in WIDTHS:
        dims = _dims(c, t, lmax, b, hidden)
        want = _walk(c, t, lmax, dims, bwd)
        assert k3.block_layout(c, t, lmax, dims, bwd) == want, (c, t, lmax, dims)
        if want:
            kinds.add(want[1:])
    ets = k3.ET_BWD if bwd else k3.ET_FWD
    assert {et for et, _ in kinds} == set(ets) and {r for _, r in kinds} == {True, False}


def test_main_path_layouts():
    """At the NequIP main path's widths (l_max 1, two tracks, C = 64, 2 x 32
    radial MLP) the forward keeps two blocks an SM with the 80 KB last
    weight resident and 64-edge tiles, the backward one block with
    128-edge tiles."""
    dims = _dims(64, 2, 1, 8, (32, 32))
    fwd, bwd = (k3.block_layout(64, 2, 1, dims, b) for b in (False, True))
    assert fwd == (107008, 64, True) and bwd == (159488, 128, True)
    assert 2 * (fwd[0] + 1024) <= 233472 < 2 * (bwd[0] + 1024)


def test_card_legs_reach_every_layout():
    """tests/test_torch_cuda.py's K3 layout legs meet every (edge tile,
    resident) pair the launcher picks over a wide grid of widths, each way."""
    picks = {(bwd, *k3.block_layout(c, t, lmax, _dims(c, t, lmax, b, h), bwd)[1:])
             for bwd in (False, True)
             for c, t, lmax, b, h in itertools.chain(
                 WIDTHS, ((c, t, lmax, 8, (w,) * dep) for c in (4, 8, 16, 64, 128)
                          for t in (1, 2) for lmax in (1, 2) for dep in (0, 1, 2)
                          for w in (32, 128, 256, 384, 512, 768)))
             if k3.kernel_takes(c, t, lmax, _dims(c, t, lmax, b, h))}
    reached = set()
    for lmax, t, c, _k, _n, hidden, b in K3_LAYOUT_CASES:
        dims = _dims(c, t, lmax, b, hidden)
        assert k3.kernel_takes(c, t, lmax, dims)
        reached |= {(bwd, *k3.block_layout(c, t, lmax, dims, bwd)[1:]) for bwd in (False, True)}
    assert picks <= reached, picks - reached


def _old_takes(c, n_tracks, lmax, dims):
    """The CUDA-core launcher before this one (one block a center, tiles of
    Q = 256 / C threads a channel times 4 or 2 edges, the last weight read
    from L2), transcribed: its refusals and its shared-memory sum."""
    nw = len(dims) - 1
    if lmax not in (1, 2) or n_tracks not in (1, 2) or not 1 <= nw <= 8 or min(dims) < 1:
        return False
    if not ((c % 32 == 0 and c <= 128) or c in (4, 8, 16)) or dims[-2] % 4:
        return False
    tp = n_tracks * tp_num_paths(lmax)
    if dims[-1] != tp * c:
        return False
    d, q = (lmax + 1) ** 2, 256 // c
    et = q * (4 if tp <= 16 else 2)
    hin, hmax = dims[-2], max(dims[:-1])

    def words(n):
        return -(-n // 4) * 4

    for bwd in (False, True):
        total = words(et * dims[0]) + 2 * words(et * hmax) + words(et * d) + words(et)
        if bwd:
            nb = (et // 4) * (hin // 4)
            nch = 1 if nb >= 256 else 256 // nb
            total += (words((nw - 1) * et * hmax) + words(et * (tp * c + 4)) + words(et * d)
                      + words(et) + words(nch * et * hin))
        else:
            total += words(q * d * n_tracks * c)
        if 4 * total > 232448:
            return False
    return True


def test_every_width_the_cuda_core_launcher_took_is_taken():
    """Over C in 4, 8, 16, 32, 64, 96, 128, l_max 1 and 2, one and two
    tracks, 4 to 64 Bessels and 0 to 7 hidden layers of 4 to 512 (the last
    input width a multiple of 4, the launcher's own condition), every
    radial MLP the old launcher took, the new one takes."""
    taken = 0
    for c, t, lmax in itertools.product((4, 8, 16, 32, 64, 96, 128), (1, 2), (1, 2)):
        for b, depth, w in itertools.product((4, 8, 12, 16, 32, 64), range(8),
                                             (4, 8, 16, 32, 64, 96, 128, 256, 512)):
            if depth == 0 and w != 4:
                continue
            dims = _dims(c, t, lmax, b, (w,) * depth)
            if _old_takes(c, t, lmax, dims):
                taken += 1
                assert k3.kernel_takes(c, t, lmax, dims), (c, t, lmax, dims)
    assert taken > 7500


@pytest.mark.parametrize("c,t,lmax,dims,takes", [
    (64, 2, 1, (8, 32, 32, 640), True), (12, 1, 1, (8, 32, 60), False),
    (64, 2, 1, (8, 30, 640), False), (64, 2, 1, (8, 32, 600), False),
    (256, 1, 1, (8, 32, 1280), False), (8, 1, 3, (8, 32, 56), False),
    (8, 1, 1, (8,) + (32,) * 8 + (40,), False)])
def test_kernel_takes_refusals(c, t, lmax, dims, takes):
    """C outside 4, 8, 16 and the multiples of 32 up to 128, a last input
    width no multiple of 4, an output width other than T P C, l_max 3, more
    than 8 weights."""
    assert k3.kernel_takes(c, t, lmax, dims) == takes


def test_products_are_on_the_tensor_cores():
    """Both radial products and the hidden layers run mma.sync in the
    build's form (K3_MMA: split_op splits or rounds each operand as it
    loads, mma_op runs the three 3xTF32 / bf16x3 passes or the one pass);
    no FFMA product of the CUDA-core kernel, shared-memory product tile or
    atomic is left; the last weight is staged by cp.async.  The policy's
    builds define K3_MMA (and the bf16-hj ones K3_HJ) and nothing else."""
    for gone in ("radial_last", "back_last", "hidden_fwd", "atomicAdd", "o_part", "o_g",
                 "gstride"):
        assert gone not in SRC
    for func in ("product_terms", "product_bwd", "small_product"):
        body = re.search(rf"void {func}\(.*?\n}}\n", SRC, re.S).group(0)
        assert body.count("mma_op(") == 1 and body.count("split_op(") >= 4, func
        assert "mma_tf32(" not in body and "split_tf32(" not in body, func
    op = re.search(r"void mma_op\(.*?\n}\n", SRC, re.S).group(0)
    assert op.count("mma_tf32(") == 3 and "if constexpr (K3_MMA != BF16P)" in op
    split = re.search(r"void split_op\(.*?\n}\n", SRC, re.S).group(0)
    assert "split_tf32(x, hi, lo)" in split and split.count("__float2bfloat16_rn(") == 2
    assert "#ifndef K3_MMA\n#define K3_MMA TF32X3\n#endif" in SRC
    for stem, defs in (("nequip_conv_bf16x3", ["K3_MMA BF16X3"]),
                       ("nequip_conv_onepass", ["K3_MMA BF16P"]),
                       ("nequip_conv_bf16_bf16x3", ["K3_HJ __nv_bfloat16", "K3_MMA BF16X3"]),
                       ("nequip_conv_bf16_onepass", ["K3_HJ __nv_bfloat16", "K3_MMA BF16P"])):
        text = (k3.CSRC / f"{stem}.cu").read_text()
        code = [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("//")]
        assert code == [f"#define {d}" for d in defs] + ['#include "nequip_conv.cu"'], stem
    # the last product is product_terms on one chain, or in chunks of 64 terms
    body = re.search(r"void product_fwd\(.*?\n}\n", SRC, re.S).group(0)
    assert body.count("product_terms<PG, RES>(") == 2 and "kc += 64" in body
    assert SRC.count("cp_async16(") == 1 and '#include "mma_ptx.cuh"' in SRC

