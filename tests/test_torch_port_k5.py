"""K5's tensor-core redesign (csrc/env_layer_mxu.cu, ops/env_layer_mxu.py),
checked without the card: ``kernel_takes`` and ``smem_bytes`` against a
step-by-step transcription of the launcher's shared-memory layout; every
width the CUDA-core launcher before it took is still taken; and a numpy
model of the kernel's products in each mode (3xTF32 m16n8k8, bf16
m16n8k16), fed chunk by chunk from the kernel layout the wrapper builds,
at K5's depths (2,592 forward, 288 backward) and at C = 12, whose chunks
are zero-filled past the channels.  The kernel's own legs are in
tests/test_torch_cuda.py."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pair_allegro_tpu_torch.models.allegro import AllegroConfig, env_fused_viable, layer_tier
from pair_allegro_tpu_torch.ops import env_layer_mxu as k5
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

torch.set_num_threads(2)

SOURCE = (Path(k5.__file__).resolve().parent.parent / "csrc" / "env_layer_mxu.cu").read_text()
MODES = list(k5.MODES)


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# ---------------------------------------------------------------------------
# (a) kernel_takes mirrors the launcher
# ---------------------------------------------------------------------------


def _launcher_smem(bwd, c, cout, d, mode):
    """k5_launch's shared memory, transcribed step by step from the launcher
    and the kernels rather than from ``smem_words``: the launcher's plan of
    the product's passes (forward: D*Cout rows in passes of at most 4 x 5
    m16 tiles; backward: blocks of at most min(320 / D, 64) channels, rows
    (j, c)), then the kernels' own carving of ``sm``, pointer by pointer as
    k5_fwd_kernel / k5_bwd_kernel set them, to the end of the last region."""
    kc, et, mtw, wm = _const("KC"), _const("ETK"), _const("MTW"), _const("WM")
    max_d, lde = _const("MAX_D"), _const("ETK") + 4
    rmax = 16 * mtw * wm
    if bwd:
        cb = min(rmax // d, _const("CB_MAX"))
        npass = (c + cb - 1) // cb
        cbp = (c + npass - 1) // npass
        R = 16 * ((d * cbp + 15) // 16)
    else:
        t16 = (d * cout + 15) // 16
        npass = (t16 + rmax // 16 - 1) // (rmax // 16)
        R = 16 * ((t16 + npass - 1) // npass)
    planes = 2 if mode == "mxu_bf16x3" else 1
    lda = kc + 4 if mode == "mxu_highest" else kc // 2 + 4  # f32 words / bf16 pairs + 4
    bwords = (2 if mode == "mxu_highest" else planes) * et * lda  # Geo::BWORDS
    sw = planes * R * lda                                        # Geo::stage_words(R)
    inv0 = 2 * max_d * max_d                                     # INV0_WORDS
    up4 = lambda w: -(-w // 4) * 4  # noqa: E731
    if bwd:  # offsets in words from sm, as k5_bwd_kernel sets its pointers
        env = inv0
        denv = env + up4(d * c)
        ring = denv + up4(d * c)
        bbuf = ring + 2 * sw
        dVs = bbuf + 2 * bwords
        Vi = dVs + cbp * lde
        end = Vi + cbp * lde
    else:    # k5_fwd_kernel: ip / iw, fst, env, ring, bbuf
        fst = inv0
        env = fst + max_d * max_d
        ring = env + up4(d * c)
        bbuf = ring + 2 * sw
        end = bbuf + 2 * bwords
    return 4 * end


GRID = list(itertools.product((4, 8, 12, 20, 32, 48, 64, 100, 128, 200), (4, 12, 32, 64, 128),
                              (1, 4, 9, 16), MODES))


@pytest.mark.parametrize("bwd", [False, True])
def test_smem_bytes_is_the_launchers_layout(bwd):
    assert _const("SMEM_MAX") == k5._SMEM_MAX
    for c, cout, d, mode in GRID:
        assert k5.smem_bytes(bwd, c, cout, d, mode) == _launcher_smem(bwd, c, cout, d, mode), \
            (c, cout, d, mode)


def test_kernel_takes_mirrors_the_launcher():
    for c, cout, d, mode in GRID:
        want = all(_launcher_smem(b, c, cout, d, mode) <= 232448 for b in (False, True))
        assert k5.kernel_takes(c, cout, d, 3, mode) == want, (c, cout, d, mode)
    assert not k5.kernel_takes(32, 32, 25, 3, "mxu_highest")  # D > 16: the Inv0 table
    assert not k5.kernel_takes(32, 32, 9, 3, "mxu_fp8")
    assert not k5.kernel_takes(4096, 32, 9, 3, "mxu_highest")  # env and denv too wide


# ---------------------------------------------------------------------------
# (b) every width the CUDA-core launcher took is still taken
# ---------------------------------------------------------------------------


def _old_takes(c, cout, d, p0, mode):
    """The launcher before the tensor cores (its refusals and its search for
    an edge tile of 64 / 32 down to 8 whose 4 x 8 register tiles fit 576
    threads and whose shared memory fits), transcribed."""
    if d > 16 or c % 4 or cout % 4:
        return False
    two = 2 if mode == "mxu_bf16x3" else 1
    m = d * cout
    for bwd in (False, True):
        rows = d * c if bwd else m
        et, ok = (32 if bwd else 64), False
        while et >= 8 and not ok:
            ld = et + 4
            ntiles = rows // 4 * (et // 8)
            if bwd:
                words = 512 + 2 * d * c + two * m * ld + d * c * ld + c * ld
            else:
                words = 512 + d * c + 2 * two * c * ld + p0 * c * et
            ok = ntiles <= 576 and words * 4 <= 232448
            et //= 2
        if not ok:
            return False
    return True


@pytest.mark.parametrize("mode", MODES)
def test_every_width_the_old_launcher_took_is_taken(mode):
    taken_before = 0
    for lmax, parity in itertools.product(range(4), (True, False)):
        d, p0 = (lmax + 1) ** 2, num_paths_per_l(lmax, lmax, 0, parity)[0]
        for c, cout in itertools.product(range(4, 129, 4), repeat=2):
            if _old_takes(c, cout, d, p0, mode):
                taken_before += 1
                assert k5.kernel_takes(c, cout, d, p0, mode), (lmax, parity, c, cout)
    assert taken_before > 4000  # the grid reaches the old launcher's limits


@pytest.mark.parametrize("mode", MODES)
def test_every_wide_width_the_old_launcher_took_is_taken(mode):
    """Past the grid above: C up to 2,300 (every 44) with Cout in {4, C, 2C,
    512}, where the old launcher's edge-tile search still found room
    (l_max 0 took C up to ~1,500)."""
    taken_before = 0
    for lmax, parity in itertools.product(range(4), (True, False)):
        d, p0 = (lmax + 1) ** 2, num_paths_per_l(lmax, lmax, 0, parity)[0]
        for c in range(132, 2300, 44):
            for cout in (4, c, 2 * c, 512):
                if _old_takes(c, cout, d, p0, mode):
                    taken_before += 1
                    assert k5.kernel_takes(c, cout, d, p0, mode), (lmax, parity, c, cout)
    assert taken_before > 150  # the scan reaches widths the old launcher took


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("l_max,c", [(2, 32), (3, 64), (1, 12), (3, 128)])
def test_perlayer_mxu_models_route_to_k5(mode, l_max, c):
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, l_max=l_max, num_tensor_features=c,
                        layer_fused=False, tp_mode=mode)
    assert env_fused_viable(cfg)
    assert layer_tier(cfg, False) == "perlayer"


# ---------------------------------------------------------------------------
# (c) a numpy model of the kernel's products, fed from the kernel layout
# ---------------------------------------------------------------------------


def _rna_tf32(a):
    """cvt.rna.tf32.f32 as the kernel's tf32_rna: add half a unit of the
    11th mantissa bit to the magnitude's bits, clear the 13 below."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_rz(a):
    """What the tensor cores read of an f32 operand in a TF32 product: its
    top 19 bits (the low 13 bits dropped)."""
    return (np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """The kernel's 3xTF32 split: hi = rna_tf32(a), lo = a - hi as the tensor
    cores read it (truncated to TF32)."""
    hi = _rna_tf32(a)
    return hi, _tf32_rz(np.asarray(a, np.float32) - hi)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _b_planes(b, mode):
    """The B chunk as the kernel builds it and the tensor cores read it:
    TF32 hi / lo, bf16 hi / lo, or bf16-rounded."""
    if mode == "mxu_highest":
        return _split(b)
    hi = _bf16(b)
    return hi, (_bf16(b - hi) if mode == "mxu_bf16x3" else None)


def _a_planes(chunk, mode):
    """The A chunk (planes, R, KC) of the layout as the kernel reads it:
    mxu_highest splits the f32 values at fragment load."""
    a = chunk.float().numpy()
    if mode == "mxu_highest":
        return _split(a[0])
    return a[0], (a[1] if mode == "mxu_bf16x3" else None)


def _mma_chunk(acc, A, B, mode, one_pass=False):
    """acc (R, n) += one chunk as the tensor cores do it: k-steps of 8
    (m16n8k8 TF32) or 16 (m16n8k16 bf16); per step and term the products are
    exact and their sum is added to the f32 accumulator with one rounding;
    terms lo*hi', hi*lo', hi*hi' in the kernel's order."""
    (ah, al), (bh, bl) = _a_planes(A, mode), _b_planes(B, mode)
    terms = [(ah, bh)] if mode == "mxu_bf16" or one_pass else [(al, bh), (ah, bl), (ah, bh)]
    step = 8 if mode == "mxu_highest" else 16
    for k0 in range(0, A.shape[-1], step):
        for x, y in terms:
            part = x[:, k0:k0 + step].astype(np.float64) @ y[k0:k0 + step].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _model_fwd(w, O, one_pass=False):
    """V' rows of every pass, from w.kfwd's chunks in the kernel's order
    (pass, pair, channel block) against O's chunks, zero-filled past C."""
    npass, dd, ncb, _, R, kc = w.kfwd.shape
    c, e = w.c, O.shape[-1]
    Op = np.zeros((dd, ncb * kc, e), np.float32)
    Op[:, :c] = O.reshape(dd, c, e)
    out = []
    for p in range(npass):
        acc = np.zeros((R, e), np.float32)
        for ch, cb in itertools.product(range(dd), range(ncb)):
            acc = _mma_chunk(acc, w.kfwd[p, ch, cb], Op[ch, cb * kc:(cb + 1) * kc], w.mode, one_pass)
        out.append(acc)
    return np.concatenate(out)[:w.Mk.shape[1]]


def _model_bwd(w, dout):
    """dO rows (i, j, c) = M_k dout from w.kbwd's chunks in the kernel's
    order (i, pass over a channel block, block of 32 rows of M) against
    dout's, zero past M; a pass's rows are (j, c) over its channels."""
    d, npass, nq, _, R, kc = w.kbwd.shape
    m, e = dout.shape
    c = w.c
    cbp = -(-c // npass)
    Dp = np.zeros((nq * kc, e), np.float32)
    Dp[:m] = dout
    g = np.zeros((d, d, npass * cbp, e), np.float32)
    for i in range(d):
        for p in range(npass):
            acc = np.zeros((R, e), np.float32)
            for q in range(nq):
                acc = _mma_chunk(acc, w.kbwd[i, p, q], Dp[q * kc:(q + 1) * kc], w.mode)
            g[i, :, p * cbp:(p + 1) * cbp] = acc[:d * cbp].reshape(d, cbp, e)
    return g[:, :, :c].reshape(d * d * c, e)


def _weights(c, mode, lmax=2, parity=True, seed=0):
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    rng = np.random.RandomState(seed)
    mix = {f"l{l3}": torch.tensor(rng.randn(c * P[l3], c) / np.sqrt(c * P[l3]), dtype=torch.float32)
           for l3 in range(lmax + 1)}
    return k5.prepare_mxu(mix, lmax, parity, mode)


MARGIN = 50  # the model's error stays this far below the kernel's forward gate
E_MODEL = 64  # one edge tile


def _gate(ref):
    return 1e-4 + 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("c", [32, 12])
def test_3xtf32_forward_keeps_f32_accuracy(c):
    """mxu_highest at depth D*D*C (2,592 at C = 32; C = 12 zero-fills 20 of
    each chunk's 32 rows): MARGIN times inside the forward gate against the
    f64 product; one TF32 pass is not."""
    w = _weights(c, "mxu_highest")
    O = (np.random.RandomState(1).randn(w.Mk.shape[0], E_MODEL) * 1.5).astype(np.float32)
    ref = w.Mk.double().numpy().T @ O.astype(np.float64)
    err3 = np.abs(_model_fwd(w, O) - ref).max()
    err1 = np.abs(_model_fwd(w, O, one_pass=True) - ref).max()
    assert err3 * MARGIN <= _gate(ref), (err3, _gate(ref))
    assert err1 * MARGIN > _gate(ref), (err1, _gate(ref))


def test_3xtf32_backward_keeps_f32_accuracy():
    """mxu_highest's backward product, depth M = D*Cout = 288."""
    w = _weights(32, "mxu_highest")
    dout = np.random.RandomState(2).randn(w.Mk.shape[1], E_MODEL).astype(np.float32)
    ref = w.Mk.double().numpy() @ dout.astype(np.float64)
    assert np.abs(_model_bwd(w, dout) - ref).max() * MARGIN <= _gate(ref)


@pytest.mark.parametrize("c", [32, 12])
@pytest.mark.parametrize("mode", ["mxu_bf16x3", "mxu_bf16"])
def test_bf16_products_match_mode_mm(mode, c):
    """The bf16 modes' exact products with f32 sums, forward (depth D*D*C)
    and backward (depth M), against the plain version's ``mode_mm``: they
    differ by the order of the f32 sums alone."""
    w = _weights(c, mode)
    rng = np.random.RandomState(3)
    O = (rng.randn(w.Mk.shape[0], E_MODEL) * 1.5).astype(np.float32)
    dout = rng.randn(w.Mk.shape[1], E_MODEL).astype(np.float32)
    ref_f = k5.mode_mm(w.Mt, w.Mt_lo, torch.from_numpy(O), mode).numpy()
    ref_b = k5.mode_mm(w.Mk, w.Mk_lo, torch.from_numpy(dout), mode).numpy()
    assert np.abs(_model_fwd(w, O) - ref_f).max() * MARGIN <= _gate(ref_f)
    assert np.abs(_model_bwd(w, dout) - ref_b).max() * MARGIN <= _gate(ref_b)


def test_kernel_layout_holds_the_matrix():
    """The layout's chunks, read back in the kernel's order, are M_k (hi and
    lo planes, zero-padded) at Cout != C and two row passes (l_max 3)."""
    P = num_paths_per_l(3, 3, 3, False)
    rng = np.random.RandomState(4)
    mix = {f"l{l3}": torch.tensor(rng.randn(20 * P[l3], 24), dtype=torch.float32) for l3 in range(4)}
    for mode in MODES:
        w = k5.prepare_mxu(mix, 3, False, mode)
        d, m = 16, w.Mk.shape[1]
        planes = [w.Mk] + ([w.Mk_lo] if w.Mk_lo is not None else [])
        npass, dd, ncb, _, R, kc = w.kfwd.shape
        assert (npass, dd, ncb, R) == (2, 256, 1, 192)
        for pl, M in enumerate(planes):
            f = w.kfwd[:, :, :, pl].permute(1, 2, 4, 0, 3).reshape(dd, ncb * kc, npass * R).float()
            torch.testing.assert_close(f[:, :20, :m], M.reshape(dd, 20, m), rtol=0, atol=0)
            assert not f[:, 20:].any() and not f[:, :, m:].any()
            _, nb, nq, _, Rb, _ = w.kbwd.shape
            cbp = -(-20 // nb)
            b = w.kbwd[:, :, :, pl].permute(0, 1, 3, 2, 4).reshape(d, nb, Rb, nq * kc).float()
            assert not b[:, :, d * cbp:].any() and not b[..., m:].any()
            b = b[:, :, :d * cbp, :m].reshape(d, nb, d, cbp, m).transpose(1, 2)
            b = b.reshape(d, d, nb * cbp, m)
            torch.testing.assert_close(b[:, :, :20], M.reshape(d, d, 20, m), rtol=0, atol=0)
            assert not b[:, :, 20:].any()
