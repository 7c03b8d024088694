"""K5: K2's function as one product against a folded constant matrix
(counterpart of ``pair_allegro_tpu/ops/pallas_stack.py:_env_layer_mxu_fwd_kernel``
/ ``_env_layer_mxu_bwd_kernel``, entry ``tp_mix_env_fused_t`` with
``mode != "paths"``).

With the channelwise outer product O[(ij, c), e] = V[i, c, e] env[j, c, e]
(D*D*C rows, (ij, c)-major) and M_k the combined TP + mix matrix of
``ops/tp.combined_tp_mix_matrix`` with its rows in the same order:

  V'[(k, c'), e] = sum_(ij, c) M_k[(ij, c), (k, c')] O[(ij, c), e]
  inv[c*P0 + p, e] = sum of the l3=0 3j entries (p, i, j, w) of w O[(ij, c), e]

in three precisions (``_env_mxu_mix``, ``pallas_stack.py:1890``):
``mxu_highest`` f32 products; ``mxu_bf16x3`` hi*hi + hi*lo + lo*hi of bf16
splits with f32 sums; ``mxu_bf16`` one pass of bf16-rounded operands with
f32 sums.  The invariants come from the unrounded O.  The backward forms
dO = M_k dout at the mode's precision, adds the inv cotangent in f32, and
returns dV, dwz and dY as K2's does.

On a CUDA tensor :func:`env_layer_mxu` launches ``csrc/env_layer_mxu.cu``;
on a CPU tensor it runs :func:`env_layer_mxu_reference` and
:func:`env_layer_mxu_reference_bwd`.  Weight cotangents come back NaN-filled
(``pallas_stack.py:2064``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.env_layer import check_operands, edge_env, mix_leaves
from pair_allegro_tpu_torch.ops.tp import _nonzeros, combined_tp_mix_matrix, num_paths_per_l
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

MODES = ("mxu_highest", "mxu_bf16x3", "mxu_bf16")
_MAX_D = 16
# the kernel's table of the l3=0 entries per (i, j) pair (struct Inv0 in the source)
_INV0_DTYPE = np.dtype([("p", np.int32, _MAX_D * _MAX_D), ("w", np.float32, _MAX_D * _MAX_D)])

launches = LaunchCounts()

# the launcher's constants (csrc/env_layer_mxu.cu)
_MAX_THREADS, _SMEM_MAX = 576, 232448
_INV0_WORDS = _INV0_DTYPE.itemsize // 4


def kernel_takes(c: int, cout: int, d: int, p0: int, mode: str) -> bool:
    """Whether ``k5_launch`` (csrc/env_layer_mxu.cu) takes these widths in
    ``mode``, forward and backward: its refusal conditions and its search
    for an edge tile whose register tiles and shared memory fit, mirrored
    here so that a caller decides before any launch."""
    if d > _MAX_D or c % 4 or cout % 4:
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
                words = _INV0_WORDS + 2 * d * c + two * m * ld + d * c * ld + c * ld
            else:
                words = _INV0_WORDS + d * c + 2 * two * c * ld + p0 * c * et
            ok = ntiles <= _MAX_THREADS and words * 4 <= _SMEM_MAX
            et //= 2
        if not ok:
            return False
    return True


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def split_bf16(x: torch.Tensor):
    """(hi, lo): the bf16 rounding of x and of its remainder."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


@dataclasses.dataclass(frozen=True, eq=False)
class K5Weights:
    """The combined matrix in the kernel's row order, for one mode: M_k
    (D*D*C, D*Cout) rows (ij, c)-major (forward) and its transpose Mt
    (backward); in ``mxu_bf16x3`` each is its bf16 hi part and ``*_lo`` its
    remainder, in ``mxu_bf16`` its bf16 rounding (values kept as floats).
    Detached copies made from ``leaves``, the tree's c-major mix leaves."""

    Mk: torch.Tensor
    Mk_lo: torch.Tensor | None
    Mt: torch.Tensor
    Mt_lo: torch.Tensor | None
    inv0: torch.Tensor  # int32 words of struct Inv0
    inv_entries: tuple  # (p, i, j, w) of l3 = 0
    mode: str
    lmax: int
    parity: bool
    c: int
    leaves: tuple

    @property
    def cout(self) -> int:
        return self.Mk.shape[1] // (self.lmax + 1) ** 2


def _inv0_table(lmax: int, parity: bool):
    d = (lmax + 1) ** 2
    ents = tuple((p, i, j, w) for (p, i, j, k, w) in _nonzeros(lmax, parity)[0] if k == 0)
    t = np.zeros((), _INV0_DTYPE)
    t["p"][:] = -1
    for p, i, j, w in ents:
        t["p"][i * d + j] = p
        t["w"][i * d + j] = w
    return ents, t


def prepare_mxu(mix: dict, lmax: int, parity: bool, mode: str) -> K5Weights:
    """K5's weights from a layer's mix leaves for ``mode``, made anew (see
    :func:`k5_weights` for the cached accessor); ``_mxu_mats``
    (``pallas_stack.py:1992``) computes the same."""
    if mode not in MODES:
        raise ValueError(f"tp_mode {mode!r} is not one of {MODES}")
    leaves = mix_leaves(mix, lmax)
    d = (lmax + 1) ** 2
    p0 = num_paths_per_l(lmax, lmax, 0, parity)[0]
    c = leaves[0].shape[0] // p0
    M = combined_tp_mix_matrix({f"l{l3}": w.detach() for l3, w in enumerate(leaves)}, lmax,
                               leaves[0].dtype, parity)
    Mk = M.reshape(c, d * d, -1).transpose(0, 1).reshape(d * d * c, -1).contiguous()
    Mt = Mk.T.contiguous()
    if mode == "mxu_bf16x3":
        (Mk, Mk_lo), (Mt, Mt_lo) = split_bf16(Mk), split_bf16(Mt)
    else:
        Mk_lo = Mt_lo = None
        if mode == "mxu_bf16":
            Mk, Mt = round_bf16(Mk), round_bf16(Mt)
    ents, table = _inv0_table(lmax, parity)
    return K5Weights(
        Mk=Mk, Mk_lo=Mk_lo, Mt=Mt, Mt_lo=Mt_lo,
        inv0=torch.from_numpy(np.frombuffer(table.tobytes(), np.int32).copy()).to(Mk.device),
        inv_entries=ents, mode=mode, lmax=lmax, parity=parity, c=c, leaves=leaves,
    )


def k5_weights(mix: dict, lmax: int, parity: bool, mode: str) -> K5Weights:
    """K5's weights for the mix leaves as they stand now, cached until a
    leaf is replaced or updated in place (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k5", lmax, parity, mode), mix_leaves(mix, lmax),
                       lambda: prepare_mxu(mix, lmax, parity, mode))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def mode_mm(a, a_lo, b, mode: str):
    """a @ b at the mode's precision, with a already split or rounded (see
    :class:`K5Weights`) and b split or rounded here."""
    if mode == "mxu_highest":
        return a @ b
    if mode == "mxu_bf16":
        return a @ round_bf16(b)
    b_hi, b_lo = split_bf16(b)
    return a @ b_hi + a @ b_lo + a_lo @ b_hi


def env_layer_mxu_reference(Vt, wzt, yt, w: K5Weights, K: int, inv_avg: float):
    """The kernel's forward in plain PyTorch on the same layout: Vt (D, C, E),
    wzt (C, E), yt (D, E) -> (Vt' (D, Cout, E), inv (C*P0, E) c-major)."""
    d, c, e = Vt.shape
    O = (Vt.unsqueeze(1) * edge_env(wzt, yt, K, inv_avg).unsqueeze(0)).reshape(d * d * c, e)
    out = mode_mm(w.Mt.to(Vt.dtype), None if w.Mt_lo is None else w.Mt_lo.to(Vt.dtype), O, w.mode)
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    acc = [None] * p0
    for p, i, j, wv in w.inv_entries:
        t = wv * O[(i * d + j) * c : (i * d + j + 1) * c]
        acc[p] = t if acc[p] is None else acc[p] + t
    return out.reshape(d, -1, e), torch.stack(acc, 1).reshape(c * p0, e)


def env_layer_mxu_reference_bwd(Vt, wzt, yt, w: K5Weights, K: int, inv_avg: float, dout, dinv):
    """The kernel's backward in plain PyTorch: dO = M_k dout at the mode's
    precision, plus the inv cotangent in f32; returns (dV, dwz, dY)."""
    d, c, e = Vt.shape
    env_e = edge_env(wzt, yt, K, inv_avg)
    g = mode_mm(w.Mk.to(Vt.dtype), None if w.Mk_lo is None else w.Mk_lo.to(Vt.dtype),
                dout.reshape(-1, e), w.mode).reshape(d, d, c, e)
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    dinvp = dinv.reshape(c, p0, e)
    for p, i, j, wv in w.inv_entries:
        g[i, j] += wv * dinvp[:, p]
    dV = (g * env_e.unsqueeze(0)).sum(1)
    denv = (g * Vt.unsqueeze(1)).sum(0)  # (D, C, E) per edge
    dA = denv.reshape(d, c, e // K, K).sum(-1) * inv_avg
    dA = dA.unsqueeze(-1).expand(d, c, e // K, K).reshape(d, c, e)
    return dV, (dA * yt.unsqueeze(1)).sum(0), (dA * wzt.unsqueeze(0)).sum(1)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def _bind(lib):
    lib.k5_inv0_words.argtypes = []
    lib.k5_inv0_words.restype = ctypes.c_int
    lib.k5_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.k5_launch.restype = ctypes.c_int
    if lib.k5_inv0_words() * 4 != _INV0_DTYPE.itemsize:
        raise RuntimeError("kernel table layout differs from the wrapper's")


LIB = CudaLibrary("k5_env_layer_mxu", [CSRC / "env_layer_mxu.cu"], _bind)


def _launch(bwd: bool, w: K5Weights, Vt, K: int, inv_avg: float, ptrs):
    lib = LIB.load()
    d, c, e = Vt.shape
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    dims = (ctypes.c_int * 7)(c, w.cout, d, K, e, p0, MODES.index(w.mode))
    arr = (ctypes.c_ulonglong * 15)(*ptrs)
    with torch.cuda.device(Vt.device):
        stream = torch.cuda.current_stream(Vt.device).cuda_stream
        rc = lib.k5_launch(int(bwd), arr, dims, ctypes.c_float(inv_avg), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K5 {'backward' if bwd else 'forward'} launch failed (code {rc}): "
                           "a negative code is a shape the kernel does not take")
    if bwd:
        launches.bwd += 1
    else:
        launches.fwd += 1


def _mats(w: K5Weights):
    return [w.Mk.data_ptr(), 0 if w.Mk_lo is None else w.Mk_lo.data_ptr(), w.Mt.data_ptr(),
            0 if w.Mt_lo is None else w.Mt_lo.data_ptr(), w.inv0.data_ptr()]


def _kernel_fwd(Vt, wzt, yt, w: K5Weights, K: int, inv_avg: float):
    d, c, e = Vt.shape
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    out = torch.empty((d, w.cout, e), dtype=Vt.dtype, device=Vt.device)
    inv = torch.empty((c * p0, e), dtype=Vt.dtype, device=Vt.device)
    ptrs = [Vt.data_ptr(), wzt.data_ptr(), yt.data_ptr(), *_mats(w), 0, 0, out.data_ptr(),
            inv.data_ptr(), 0, 0, 0]
    _launch(False, w, Vt, K, inv_avg, ptrs)
    return out, inv


def _kernel_bwd(Vt, wzt, yt, w: K5Weights, K: int, inv_avg: float, dout, dinv):
    dV, dwz, dY = torch.empty_like(Vt), torch.empty_like(wzt), torch.empty_like(yt)
    ptrs = [Vt.data_ptr(), wzt.data_ptr(), yt.data_ptr(), *_mats(w), dout.data_ptr(),
            dinv.data_ptr(), 0, 0, dV.data_ptr(), dwz.data_ptr(), dY.data_ptr()]
    _launch(True, w, Vt, K, inv_avg, ptrs)
    return dV, dwz, dY


class _EnvLayerMxu(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors), forward and
    backward; NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, Vt, wzt, yt, w, K, inv_avg, *leaves):
        ctx.cfg = (w, K, inv_avg)
        ctx.save_for_backward(Vt, wzt, yt)
        if Vt.is_cuda:
            return _kernel_fwd(Vt, wzt, yt, w, K, inv_avg)
        return env_layer_mxu_reference(Vt, wzt, yt, w, K, inv_avg)

    @staticmethod
    def backward(ctx, dout, dinv):
        w, K, inv_avg = ctx.cfg
        Vt, wzt, yt = ctx.saved_tensors
        bwd = _kernel_bwd if Vt.is_cuda else env_layer_mxu_reference_bwd
        grads = bwd(Vt, wzt, yt, w, K, inv_avg, dout.contiguous(), dinv.contiguous())
        nan_w = [torch.full_like(t, float("nan")) for t in w.leaves]
        return (*grads, None, None, None, *nan_w)


def env_layer_mxu(Vt, wzt, yt, w: K5Weights, K: int, avg_num_neighbors: float):
    """K5 on the feature-major TABLE layout, with K2's operands and outputs
    (see :func:`pair_allegro_tpu_torch.ops.env_layer.env_layer`) and the
    precision of ``w.mode``.  CUDA tensors launch the kernel (f32 and
    contiguous only; a shape beyond its shared memory or thread block
    raises); CPU tensors take the plain version."""
    d = (w.lmax + 1) ** 2
    check_operands("env_layer_mxu", Vt, wzt, yt, d, w.c, K, w.leaves)
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _EnvLayerMxu.apply(Vt, wzt, yt, w, K, inv_avg, *w.leaves)
