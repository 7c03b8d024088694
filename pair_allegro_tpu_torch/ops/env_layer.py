"""K2: the per-layer env-fused TP + mix kernel (counterpart of
``pair_allegro_tpu/ops/pallas_stack.py:_env_layer_fwd_kernel`` /
``_env_layer_bwd_kernel``, entry ``tp_mix_env_fused_t`` with
``mode="paths"``).

One call computes the equivariant part of one Allegro layer on the
feature-major layout of the TABLE edge list (E = n_centers * K, each
center's K edges contiguous); the latent MLP runs outside, as plain matrix
products:

  env = per-center sum wz (x) Y / sqrt(avg_n)          wz (C, E) already * u
  T   = channelwise TP of V with env;  V' = per-l3 mix of T
  inv = T[l3=0] as (C*P0, E), c-major (row c*P0 + p: ``scalar_part``'s order)

On a CUDA tensor :func:`env_layer` launches the hand-written Hopper kernel
pair in ``csrc/env_layer.cu``; on a CPU tensor it runs
:func:`env_layer_reference`, the plain PyTorch version of the same function.
Weight cotangents come back NaN-filled, the contract of the TPU kernel
(``pallas_stack.py:1007``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.fused_layer import (
    _META_DTYPE,
    ET,
    LD,
    META_WORDS,
    NT,
    SMEM_MAX,
    _meta_table,
    _row_tables,
    _to_pmajor,
    table_fits,
)
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

launches = LaunchCounts()


def kernel_takes(c: int, cout: int, d: int, lmax: int, parity: bool) -> bool:
    """Whether ``k2_launch`` (csrc/env_layer.cu) takes these widths,
    forward and backward: its refusal conditions and its shared-memory sum
    (the backward's is the larger), mirrored here so that a caller decides
    before any launch."""
    maxpc = max(num_paths_per_l(lmax, lmax, lmax, parity)) * c
    if not table_fits(lmax, parity) or NT % c or NT // c > ET or c % 4 or cout % 4:
        return False
    words = META_WORDS + 2 * d * c + 2 * d * c * LD + maxpc * LD + cout * LD + d * LD + c * LD
    return words * 4 <= SMEM_MAX


@dataclasses.dataclass(frozen=True, eq=False)
class K2Weights:
    """One layer's mix weights in the kernel's layout: p-major rows (row =
    p*C + c) per l3, flat and transposed (for the backward), and the 3j row
    table; detached copies made from ``leaves``, the tree's c-major mix
    leaves {"l0": (C*P0, Cout), ...}, which receive the weight cotangents."""

    mix: tuple  # (P*C, Cout) per l3, p-major rows
    mix_flat: torch.Tensor
    mixT_flat: torch.Tensor
    meta: torch.Tensor  # int32 words of struct Meta (csrc/allegro_tiles.cuh)
    lmax: int
    parity: bool
    leaves: tuple

    @property
    def c(self) -> int:
        return self.leaves[0].shape[0] // num_paths_per_l(self.lmax, self.lmax, 0, self.parity)[0]

    @property
    def cout(self) -> int:
        return self.mix[0].shape[1]


def mix_leaves(mix: dict, lmax: int) -> tuple:
    return tuple(mix[f"l{l3}"] for l3 in range(lmax + 1))


def prepare_mix(mix: dict, lmax: int, parity: bool) -> K2Weights:
    """K2's weights from a layer's mix leaves, made anew (see
    :func:`k2_weights` for the cached accessor)."""
    leaves = mix_leaves(mix, lmax)
    c = leaves[0].shape[0] // num_paths_per_l(lmax, lmax, 0, parity)[0]
    pm = tuple(_to_pmajor(w.detach(), c) for w in leaves)
    meta = _meta_table(lmax, parity, c, pm[0].shape[1], (0,))
    return K2Weights(
        mix=pm,
        mix_flat=torch.cat([w.reshape(-1) for w in pm]).contiguous(),
        mixT_flat=torch.cat([w.T.reshape(-1) for w in pm]).contiguous(),
        meta=torch.from_numpy(np.frombuffer(meta.tobytes(), np.int32).copy()).to(leaves[0].device),
        lmax=lmax,
        parity=parity,
        leaves=leaves,
    )


def k2_weights(mix: dict, lmax: int, parity: bool) -> K2Weights:
    """K2's weights for the mix leaves as they stand now, cached until a
    leaf is replaced or updated in place (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k2", lmax, parity), mix_leaves(mix, lmax),
                       lambda: prepare_mix(mix, lmax, parity))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def edge_env(wzt, yt, K: int, inv_avg: float) -> torch.Tensor:
    """The per-center environment broadcast back to the edges: (D, C, E)
    with env[d, c] = inv_avg * sum over the center's K edges of wz[c] Y[d]."""
    d, e = yt.shape
    c = wzt.shape[0]
    env = (wzt.unsqueeze(0) * yt.unsqueeze(1)).reshape(d, c, e // K, K).sum(-1) * inv_avg
    return env.unsqueeze(-1).expand(d, c, e // K, K).reshape(d, c, e)


def env_layer_reference(Vt, wzt, yt, w: K2Weights, K: int, inv_avg: float):
    """The same function as the kernel, in plain PyTorch on the same
    layout: Vt (D, C, E), wzt (C, E), yt (D, E) -> (Vt' (D, Cout, E),
    inv (C*P0, E) c-major).  Goes through torch autograd."""
    d, c, e = Vt.shape
    env_e = edge_env(wzt, yt, K, inv_avg)
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    out_rows, inv = [], None
    for r, (ents, l3) in enumerate(_row_tables(w.lmax, w.parity)):
        acc = [None] * P[l3]
        for p, i, j, wv in ents:
            t = (wv * Vt[i]) * env_e[j]
            acc[p] = t if acc[p] is None else acc[p] + t
        tiles = [a if a is not None else Vt.new_zeros(c, e) for a in acc]
        if r == 0:
            inv = torch.stack(tiles, 1).reshape(c * P[0], e)
        t_r = torch.cat(tiles, 0)  # (P*C, E) p-major
        out_rows.append((w.mix[l3].to(Vt.dtype).T @ t_r) * (1.0 / math.sqrt(P[l3] * c)))
    return torch.stack(out_rows, 0), inv


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def _bind(lib):
    lib.k2_meta_words.argtypes = []
    lib.k2_meta_words.restype = ctypes.c_int
    lib.k2_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.k2_launch.restype = ctypes.c_int
    if lib.k2_meta_words() * 4 != _META_DTYPE.itemsize:
        raise RuntimeError("kernel table layout differs from the wrapper's")


LIB = CudaLibrary("k2_env_layer", [CSRC / "env_layer.cu", CSRC / "allegro_tiles.cuh"], _bind)


def _launch(bwd: bool, w: K2Weights, Vt, K: int, inv_avg: float, ptrs):
    lib = LIB.load()
    d, c, e = Vt.shape
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    dims = (ctypes.c_int * 7)(c, w.cout, d, K, e, max(P) * c, P[0])
    arr = (ctypes.c_ulonglong * 13)(*ptrs)
    with torch.cuda.device(Vt.device):
        stream = torch.cuda.current_stream(Vt.device).cuda_stream
        rc = lib.k2_launch(int(bwd), arr, dims, ctypes.c_float(inv_avg), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K2 {'backward' if bwd else 'forward'} launch failed (code {rc}): "
                           "a negative code is a shape the kernel does not take")
    if bwd:
        launches.bwd += 1
    else:
        launches.fwd += 1


def _kernel_fwd(Vt, wzt, yt, w: K2Weights, K: int, inv_avg: float):
    d, c, e = Vt.shape
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    out = torch.empty((d, w.cout, e), dtype=Vt.dtype, device=Vt.device)
    inv = torch.empty((c * p0, e), dtype=Vt.dtype, device=Vt.device)
    ptrs = [Vt.data_ptr(), wzt.data_ptr(), yt.data_ptr(), w.mix_flat.data_ptr(),
            w.mixT_flat.data_ptr(), w.meta.data_ptr(), 0, 0, out.data_ptr(), inv.data_ptr(), 0, 0, 0]
    _launch(False, w, Vt, K, inv_avg, ptrs)
    return out, inv


def _kernel_bwd(Vt, wzt, yt, w: K2Weights, K: int, inv_avg: float, dout, dinv):
    dV, dwz, dY = torch.empty_like(Vt), torch.empty_like(wzt), torch.empty_like(yt)
    ptrs = [Vt.data_ptr(), wzt.data_ptr(), yt.data_ptr(), w.mix_flat.data_ptr(),
            w.mixT_flat.data_ptr(), w.meta.data_ptr(), dout.data_ptr(), dinv.data_ptr(), 0, 0,
            dV.data_ptr(), dwz.data_ptr(), dY.data_ptr()]
    _launch(True, w, Vt, K, inv_avg, ptrs)
    return dV, dwz, dY


class _EnvLayer(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes env from (wz, Y), as the TPU kernel does, and hands
    back NaN-filled weight cotangents.  An unused output's cotangent arrives
    as zeros (autograd materialises it), as the dead last-layer V' does."""

    @staticmethod
    def forward(ctx, Vt, wzt, yt, w, K, inv_avg, *leaves):
        ctx.cfg = (w, K, inv_avg)
        ctx.save_for_backward(Vt, wzt, yt)
        if Vt.is_cuda:
            return _kernel_fwd(Vt, wzt, yt, w, K, inv_avg)
        return env_layer_reference(Vt, wzt, yt, w, K, inv_avg)

    @staticmethod
    def backward(ctx, dout, dinv):
        w, K, inv_avg = ctx.cfg
        Vt, wzt, yt = ctx.saved_tensors
        if Vt.is_cuda:
            grads = _kernel_bwd(Vt, wzt, yt, w, K, inv_avg, dout.contiguous(), dinv.contiguous())
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (Vt, wzt, yt)]
                outs = env_layer_reference(*ins, w, K, inv_avg)
                grads = torch.autograd.grad(outs, ins, (dout, dinv))
        nan_w = [torch.full_like(t, float("nan")) for t in w.leaves]
        return (*grads, None, None, None, *nan_w)


def check_operands(name: str, Vt, wzt, yt, d: int, c: int, K: int, weights) -> None:
    """Shapes, devices and, for CUDA tensors, the kernel's dtype and
    contiguity; raises on what the kernel does not take."""
    e = Vt.shape[-1]
    if (tuple(Vt.shape) != (d, c, e) or tuple(wzt.shape) != (c, e) or tuple(yt.shape) != (d, e)
            or K < 1 or e % K):
        raise ValueError(f"{name} shapes: V {tuple(Vt.shape)} (want {(d, c, e)}), wz "
                         f"{tuple(wzt.shape)}, Y {tuple(yt.shape)}, K={K}")
    ts = (Vt, wzt, yt, *weights)
    if any(t.device != Vt.device for t in ts):
        raise ValueError(f"{name}: all tensors must be on one device")
    if Vt.is_cuda:
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError(f"{name}: the CUDA kernel takes float32 tensors only")
        if any(not t.is_contiguous() for t in (Vt, wzt, yt)):
            raise ValueError(f"{name}: CUDA inputs must be contiguous")


def env_layer(Vt, wzt, yt, w: K2Weights, K: int, avg_num_neighbors: float):
    """K2 on the feature-major TABLE layout: Vt (D, C, E), wzt (C, E) env
    weights already * u, yt (D, E); E = n_centers * K.  Returns (Vt'
    (D, Cout, E), inv (C*P0, E) c-major).  CUDA tensors launch the kernel
    (f32 and contiguous only; a shape beyond its shared memory raises);
    CPU tensors take :func:`env_layer_reference`."""
    d = (w.lmax + 1) ** 2
    check_operands("env_layer", Vt, wzt, yt, d, w.c, K, w.leaves)
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _EnvLayer.apply(Vt, wzt, yt, w, K, inv_avg, *w.leaves)
