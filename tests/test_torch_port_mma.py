"""The Allegro layer body of K1, K6, K7 and K8 (csrc/allegro_layer.cuh,
csrc/allegro_mma.cuh), checked without the card: the shared memory each
form launches with (``block_bytes`` beside ops/fused_layer.py against a
step-by-step transcription of ``layer_layout``), the widths every form
takes or refuses and where refused widths route, that every width the FFMA
body before it took is still taken, and a numpy model of the body's 3xTF32
tensor-core products at each product's flagship shape against f64.  The
kernels' own legs, and the library's own layout sums against
``block_bytes``, are in tests/test_torch_cuda.py."""

import dataclasses
import itertools

import numpy as np
import pytest

from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    embed_readout_viable,
    env_fused_viable,
    layer_tier,
    stack_viable,
)
from pair_allegro_tpu_torch.ops import embed_layer as k6
from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.ops import fused_stack as k8
from pair_allegro_tpu_torch.ops import readout_layer as k7
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

FLAG = AllegroConfig(type_names=("Cu",), r_max=4.5, avg_num_neighbors=12.0)
SM_BYTES = 233472  # shared memory of one H100 SM; each resident block also reserves 1 KB


def _latd(ns, c, lmax, parity, width=64, depth=2):
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    return (ns + c * P[0], *(width,) * depth, ns)


def _layout_walk(form, bwd, first_v, ns, c, d, latd, lmax, parity, n_in=0, xmaxw=4, hz=0):
    """layer_layout (csrc/allegro_layer.cuh) offset by offset: every take()
    starts on 16 bytes; the scratch region R holds the largest phase; the
    ring gets its cap, or what is left (not below its least); the product
    tiles take stride 40 with the ring, else 32 with the ring, else 32 and
    no ring."""
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    nlat, in0, maxpc = len(latd) - 1, latd[0], max(P) * c
    maxw = max(latd[1:-1]) if nlat > 1 else 4
    nin = -(-n_in // 4) * 4
    for lds in (40, 32):
        off = 0

        def take(words):
            nonlocal off
            off += -(-words // 4) * 4

        take(fl.META_WORDS)                              # the 3j table
        take(fl.P_WORDS if form == "stack" else 0)       # STACK's layer parameters
        take(512 if bwd else 0)                          # the j-ordered entries
        take(2 * fl.MT_WORDS if form in ("embed", "readout") else 0)
        take(d * c)                                      # env
        take(d * c if bwd else 0)                        # denv
        take(in0 * lds)                                  # cat = [x; inv]
        take(d * c * 32)                                 # V
        take(c * lds if first_v else 0)                  # pT
        take(d * lds)                                    # Y
        take(lds)                                        # u
        take(lds if bwd else 0)                          # du
        phases = [c * lds]                               # center_env's wz
        if bwd:
            phases += [(2 * ns + (nlat - 1) * maxw + 2 * max(in0, maxw)) * lds,  # latent fwd + bwd
                       (2 * c + ns) * lds,                                        # env backward
                       d * c * 32 + ((max(maxpc, c + ns) if form == "embed" else maxpc) + c) * lds]
        else:
            phases += [maxpc * lds, 2 * max(maxw, ns) * lds]                     # T; latent
        if form == "embed":
            phases.append((nin + 2 * xmaxw) * lds)
            if bwd:
                phases.append((2 * c + 2 * ns + hz + nin + 2 * max(xmaxw, ns, nin)) * lds)
        if form == "readout":
            phases.append((2 * ns + (nlat - 1) * maxw + 2 * max(xmaxw, ns) + hz + 2 if bwd
                           else 2 * xmaxw + 2) * lds)
        r_words = max(phases)
        left = (232448 // 4 - off - r_words) // 8 * 8
        if left >= 2 * 8 * 136:
            return 4 * (off + min(8192 if bwd else 4096, left) + r_words)
    return 4 * (off + r_words)


GRID = list(itertools.product((16, 64, 128), (8, 32, 48, 64), (1, 2, 3), (True, False),
                              (32, 64, 256, 512), (1, 2)))


@pytest.mark.parametrize("form", ["plain", "embed", "readout", "stack"])
@pytest.mark.parametrize("bwd", [False, True])
def test_block_bytes_is_the_kernels_layout(form, bwd):
    """block_bytes, which kernel_takes of K1, K6, K7 and K8 sum, equals the
    kernel's own layout walked region by region, at 1,152 widths a form
    (latent widths up to 512, so that every stride and ring choice is met)."""
    for ns, c, lmax, parity, width, depth in GRID:
        d = (lmax + 1) ** 2
        latd = _latd(ns, c, lmax, parity, width, depth)
        kw = {"embed": dict(n_in=10, xmaxw=width, hz=2 * width),
              "readout": dict(xmaxw=width // 2, hz=width // 2)}.get(form, {})
        for first_v in ((False, True) if form == "plain" else (form != "readout",)):
            got = fl.block_bytes(ns, c, c, d, latd, lmax, parity, first_v, bwd, form,
                                 kw.get("n_in", 0), kw.get("xmaxw", 4), kw.get("hz", 0))
            assert got == _layout_walk(form, bwd, first_v, ns, c, d, latd, lmax, parity, **kw), \
                (ns, c, lmax, parity, width, depth, first_v)


def test_flagship_widths_taken_by_every_form():
    """At the flagship widths every form takes the layer forward and
    backward (K7 with and without the charge head), and every forward
    layout leaves room for two blocks on an SM."""
    assert env_fused_viable(FLAG) and embed_readout_viable(FLAG)
    assert embed_readout_viable(dataclasses.replace(FLAG, output_charges=True))
    assert stack_viable(dataclasses.replace(FLAG, fused_stack=True))
    ns, c, lmax, d = 64, 32, 2, 9
    latd = _latd(ns, c, lmax, True)
    fwd = [fl.block_bytes(ns, c, c, d, latd, lmax, True, fv, False) for fv in (False, True)]
    fwd.append(fl.block_bytes(ns, c, c, d, latd, lmax, True, True, False, "embed", 10, 64, 128))
    fwd.append(fl.block_bytes(ns, c, c, d, latd, lmax, True, False, False, "readout", 0, 32, 32))
    fwd.append(fl.block_bytes(ns, c, c, d, latd, lmax, True, True, False, "stack"))
    assert all(2 * (b + 1024) <= SM_BYTES for b in fwd), fwd
    bwd = fl.block_bytes(ns, c, c, d, latd, lmax, True, True, True, "stack")
    assert bwd <= fl.SMEM_MAX


def _ffma_body_bytes(form, bwd, first_v, ns, c, d, latd, lmax, parity, n_in=0, xmaxw=4, hz=0):
    """The shared memory of the FFMA layer body this one replaced: every
    tile at stride 33, no weight ring, no j-ordered entries, and K8's
    parameters in its kernel argument (not in shared memory)."""
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    nlat, in0, maxpc = len(latd) - 1, latd[0], max(P) * c
    maxw = max(latd[1:-1]) if nlat > 1 else 4
    words = fl.META_WORDS + (2 * fl.MT_WORDS if form in ("embed", "readout") else 0)
    words += d * c * (2 if bwd else 1) + in0 * 33 + d * c * 33 + (c * 33 if first_v else 0)
    words += d * 33 + 33 + (33 if bwd else 0)
    if bwd:
        rows = max(c, 2 * ns + (nlat - 1) * maxw + 2 * max(in0, maxw), d * c + maxpc + c,
                   2 * c + ns)
    else:
        rows = max(c, maxpc, 2 * maxw + ns)
    nin = -(-n_in // 4) * 4
    if form == "embed":
        more = nin + 2 * xmaxw
        if bwd:
            more = max(more, d * c + maxpc + max(c, ns),
                       2 * c + 2 * ns + hz + nin + 2 * max(xmaxw, ns, nin))
        rows = max(rows, more)
    if form == "readout":
        rows = max(rows, 2 * ns + (nlat - 1) * maxw + 2 * max(xmaxw, ns) + hz + 2 if bwd
                   else 2 * xmaxw + 2)
    return 4 * (words + rows * 33)


@pytest.mark.parametrize("form", ["plain", "embed", "readout", "stack"])
@pytest.mark.parametrize("bwd", [False, True])
def test_every_width_the_ffma_body_took_is_taken(form, bwd):
    """Over scalar, tensor, latent, two-body and head widths up to 256 (l_max
    0 to 3, with and without parity), every layout the FFMA body fitted in
    shared memory fits in this body's too (at the narrower tile stride, or
    without the ring, where it must)."""
    n_taken = 0
    for ns, c, lmax, parity, width, depth in itertools.product(
            (8, 32, 64, 128, 256), (8, 16, 32, 64), (0, 1, 2, 3), (True, False),
            (32, 64, 128, 192, 224, 256), (1, 2, 3)):
        if not fl.table_fits(lmax, parity):
            continue
        d = (lmax + 1) ** 2
        latd = _latd(ns, c, lmax, parity, width, depth)
        extra = {"embed": [dict(n_in=10, xmaxw=w, hz=2 * w) for w in (64, 128, 192, 256)],
                 "readout": [dict(xmaxw=w, hz=w) for w in (16, 32, 64, 128, 256)]}.get(form, [{}])
        for kw in extra:
            for first_v in ((False, True) if form == "plain" else (form != "readout",)):
                args = (ns, c, d, latd, lmax, parity)
                if _ffma_body_bytes(form, bwd, first_v, *args, **kw) > fl.SMEM_MAX:
                    continue
                n_taken += 1
                got = fl.block_bytes(ns, c, c, d, latd, lmax, parity, first_v, bwd, form,
                                     kw.get("n_in", 0), kw.get("xmaxw", 4), kw.get("hz", 0))
                assert got <= fl.SMEM_MAX, (form, bwd, first_v, ns, c, lmax, parity, latd, kw)
    assert n_taken > 1000


# (config fields, the tier the K1 tier's widths route to, and K6 / K7's
# widths) that the FFMA body took and this body takes at the narrower stride
# or without the ring: wide latent, two-body and head MLPs
WIDE = [
    dict(allegro_mlp_hidden_layers_width=256),
    dict(allegro_mlp_hidden_layers_width=224),
    dict(allegro_mlp_hidden_layers_width=192, allegro_mlp_hidden_layers_depth=3),
    dict(l_max=1, two_body_mlp_width=256),
    dict(readout_mlp_hidden_layers_width=256, output_charges=True),
]


@pytest.mark.parametrize("fields", WIDE)
def test_wide_widths_route_to_the_kernels(fields, monkeypatch):
    """Wide MLPs the FFMA body took route to the same kernels still: the K1
    tier, the fused stack and the embed/readout form."""
    monkeypatch.delenv("PAT_L1_POSITIONAL", raising=False)
    cfg = dataclasses.replace(FLAG, **fields)
    monkeypatch.setenv("PAT_L1_EMBED", "0")
    assert env_fused_viable(cfg) and layer_tier(cfg, flat=False) == "k1"
    assert stack_viable(dataclasses.replace(cfg, fused_stack=True))
    assert layer_tier(dataclasses.replace(cfg, fused_stack=True), flat=False) == "stack"
    monkeypatch.setenv("PAT_L1_EMBED", "1")
    assert embed_readout_viable(cfg) and layer_tier(cfg, flat=False) == "k1-embed"


# widths the kernels refused before this body and refuse still, with the
# tier each routes to instead (this body takes every width the FFMA body
# took, and a band of widths just past its limit too, among them K6's
# 256-wide two-body MLP at l_max 2)
REFUSED = [
    ("k1", dict(num_tensor_features=64), "k4"),
    ("k1", dict(num_scalar_features=16, num_tensor_features=64), "k4"),
    ("k1", dict(l_max=1, num_tensor_features=128), "k4"),
    ("k8", dict(num_tensor_features=64, fused_stack=True), "k4"),
    ("k8", dict(num_layers=9, fused_stack=True), "k1"),
    ("k6", dict(two_body_mlp_width=384), "k1"),
    ("k6", dict(l_max=1, two_body_mlp_width=384), "k1"),
    ("k7", dict(readout_mlp_hidden_layers_width=512, output_charges=True), "k1"),
    ("k7", dict(l_max=3, readout_mlp_hidden_layers_width=256, output_charges=True), "k1"),
]


@pytest.mark.parametrize("kernel,fields,tier", REFUSED)
def test_refused_widths_stay_refused_and_route_away(kernel, fields, tier, monkeypatch):
    """A width a kernel refused before is refused still, decided from the
    shapes, and the call routes to another tier before any launch."""
    monkeypatch.setenv("PAT_L1_EMBED", "1" if kernel in ("k6", "k7") else "0")
    monkeypatch.delenv("PAT_L1_POSITIONAL", raising=False)
    cfg = dataclasses.replace(FLAG, **fields)
    viable = {"k1": env_fused_viable, "k8": stack_viable, "k6": embed_readout_viable,
              "k7": embed_readout_viable}[kernel]
    assert not viable(cfg)
    assert layer_tier(cfg, flat=False) == tier


def test_kernel_takes_of_each_wrapper_agree_with_the_routes():
    """kernel_takes beside each wrapper says what the model's routes say."""
    for fields in ({}, dict(num_tensor_features=48), dict(l_max=3), dict(num_scalar_features=128),
                   dict(num_tensor_features=64)):
        cfg = dataclasses.replace(FLAG, **fields)
        ns, c, lmax = cfg.num_scalar_features, cfg.num_tensor_features, cfg.l_max
        d, latd = (lmax + 1) ** 2, _latd(ns, c, lmax, True)
        assert fl.kernel_takes(ns, c, c, d, latd, lmax, True) == env_fused_viable(cfg)
        assert k8.kernel_takes(ns, c, d, latd, lmax, True, 3) == stack_viable(
            dataclasses.replace(cfg, fused_stack=True))
        both = (k6.kernel_takes(ns, c, d, latd, lmax, True, (10, 64, 64, ns))
                and k7.kernel_takes(ns, c, d, latd, lmax, True, ((ns, 32, 1),)))
        assert both == embed_readout_viable(cfg)


# ---------------------------------------------------------------------------
# 3xTF32: a numpy model of mma_tile's arithmetic
# ---------------------------------------------------------------------------


def _rna_tf32(a):
    """cvt.rna.tf32.f32: keep 10 explicit mantissa bits, round to nearest
    with ties away from zero (add half a unit of the 11th bit to the
    magnitude's bits, clear the 13 below); Inf and NaN pass."""
    u = np.asarray(a, np.float32).view(np.uint32)
    finite = (u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    r = np.where(finite, (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000), u)
    return r.astype(np.uint32).view(np.float32)


def _mma_product(A, B, terms):
    """A^T B as the body computes it: k-steps of 8 (one m16n8k8 each); per
    step and term the 8 products of TF32 values are exact, their sum is
    added to the f32 accumulator with one rounding."""
    acc = np.zeros((A.shape[1], B.shape[1]), np.float32)
    for k0 in range(0, A.shape[0], 8):
        for x, y in terms:
            part = x[k0:k0 + 8].astype(np.float64).T @ y[k0:k0 + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _split(a):
    hi = _rna_tf32(a)
    return hi, _rna_tf32(a.astype(np.float32) - hi)


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert _rna_tf32(one + ulp / 2) == one + ulp  # a tie rounds away from zero
    assert _rna_tf32(-(one + ulp / 2)) == -(one + ulp)
    assert _rna_tf32(one + ulp / 4) == one
    assert _rna_tf32(np.float32(np.inf)) == np.inf


# (depth, output rows) of each product at the flagship widths: the mix rows
# (P*C = 96 for l3 = 0, 128 for l3 = 1, 2 -> C), the latent MLP (160 -> 64,
# 64 -> 64) and the env weights (ns = 64 -> C); the backward runs the same
# shapes transposed
PRODUCTS = [("mix l3=0", 96, 32), ("mix l3>0", 128, 32), ("latent first", 160, 64),
            ("latent hidden", 64, 64), ("env weights", 64, 32)]
MARGIN = 50  # the model's error stays this far below the kernels' forward gate


@pytest.mark.parametrize("name,depth,rows", PRODUCTS)
def test_3xtf32_products_keep_f32_accuracy(name, depth, rows):
    """The three-term split (hi*hi' + hi*lo' + lo*hi', f32 accumulation)
    stays MARGIN times below the kernel-vs-plain forward gate (1e-4 +
    1e-4 max|plain|) against the f64 product, on weights and activations of
    the model's scale; one TF32 pass alone would not."""
    rng = np.random.RandomState(depth + rows)
    A = (rng.randn(depth, rows) / np.sqrt(depth)).astype(np.float32)  # weight * 1/sqrt(fan-in)
    B = (rng.randn(depth, 32) * 1.5).astype(np.float32)  # a tile of 32 edges
    ref = A.astype(np.float64).T @ B.astype(np.float64)
    (ah, al), (bh, bl) = _split(A), _split(B)
    three = _mma_product(A, B, [(al, bh), (ah, bl), (ah, bh)])
    one = _mma_product(A, B, [(ah, bh)])
    gate = 1e-4 + 1e-4 * np.abs(ref).max()
    err3, err1 = np.abs(three - ref).max(), np.abs(one - ref).max()
    assert err3 * MARGIN <= gate, (name, err3, gate)
    assert err1 > 20 * err3, (name, err1, err3)
    # each dropped term (lo*lo') is ~2^-22 of a product: the error is f32 summation's
    assert err3 <= 8 * depth * 2.0 ** -24 * (np.abs(A).T @ np.abs(B)).max()
