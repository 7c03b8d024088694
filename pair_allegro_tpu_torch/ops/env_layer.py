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
pair in ``csrc/env_layer.cu``, or at bf16 its bf16 build
``csrc/env_layer_bf16.cu`` (the ``interior="bf16"`` tier: bf16 operands, f32
sums in registers, the mix one bf16 tensor-core pass on pair-packed
weights); on a CPU tensor it runs :func:`env_layer_reference`, the plain
PyTorch version of the same function, at the tensors' dtype.

The mix follows the matmul precision policy (``ops/prec.py``), as K1's
products do: at f32 the call's :func:`prec.kernel_mode` picks the build
(``fused_layer.build_for``), ``tf32x3`` (``env_layer.cu``), ``bf16x3``
(``env_layer_bf16x3.cu``, on the weights ``fused_layer.pack_x3`` lays out)
or one pass (``env_layer_onepass.cu``, on the bf16 build's pair-packed
weights), and the plain version computes the same mode's products
(``prec.kmm``, the scale after the product as JAX's ``_mm(w.T, t) *
norm``).  The forward fixes the mode its backward uses.  The env sum is an
f32 sum under every policy.
Weight cotangents come back NaN-filled, the contract of the TPU kernel
(``pallas_stack.py:1007``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.fused_layer import (
    _MAX_D,
    _MAX_ENT,
    _META_DTYPE,
    ET,
    LDS_MIN,
    LDS_WIDE,
    LDV,
    META_WORDS,
    NT,
    RING_BWD,
    RING_FWD,
    RING_MIN,
    SHARE2,
    SMEM_MAX,
    _ceil4,
    _meta_table,
    _row_tables,
    _to_pmajor,
    build_for,
    count,
    pack_pairs,
    pack_x3,
    table_fits,
)
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

launches = LaunchCounts("K2.tf32x3")  # the f32 kernel's (3xTF32 mix)
launches_bf16 = LaunchCounts("K2.bf16")  # the bf16 build's (bf16 operands)
launches_bf16x3 = LaunchCounts("K2.bf16x3")  # the f32 bf16x3 build's
launches_onepass = LaunchCounts("K2.onepass")  # the f32 one-pass build's


def widths_ok(c: int, cout: int, d: int) -> bool:
    """The refusal conditions of ``k2_layout`` (csrc/env_layer.cu) on the
    widths: D, the TP's cells (C divides the block's threads, at most ET of
    them per channel) and 16-byte weight rows."""
    return 1 <= d <= _MAX_D and not (NT % c or NT // c > ET or c % 4 or cout % 4)


def block_layout(c: int, cout: int, d: int, lmax: int, parity: bool,
                 bwd: bool) -> tuple[int, int, int]:
    """(bytes, tile stride, ring words) of the shared memory ``k2_layout``
    (csrc/env_layer.cu) gives one block, a transcription of its sum: the
    tables, env (and denv), the V (and dV) tiles at LDV, the weight ring
    and a region of product tiles at the stride (the larger of env's wz and
    Y scratch and one row's T, or dT and dV'), each region rounded up to 16
    bytes.  The first that fits of the stride LDS_WIDE, then LDS_MIN, each
    with the ring (its cap or what is left, not below RING_MIN), in half an
    SM (SHARE2), then in SMEM_MAX; else LDS_MIN without the ring, and where
    that does not fit either, its bytes (above SMEM_MAX)."""
    maxpc = max(num_paths_per_l(lmax, lmax, lmax, parity)) * c
    fixed = sum(_ceil4(w) for w in (META_WORDS, _MAX_ENT if bwd else 0, d * c,
                                    d * c if bwd else 0, d * c * LDV,
                                    d * c * LDV if bwd else 0))
    rows = max(maxpc + cout if bwd else maxpc, c + d)
    for budget in (SHARE2, SMEM_MAX):
        for lds in (LDS_WIDE, LDS_MIN):
            left = (budget // 4 - fixed - rows * lds) // 8 * 8
            if left >= RING_MIN:
                ring = min(RING_BWD if bwd else RING_FWD, left)
                return 4 * (fixed + ring + rows * lds), lds, ring
    return 4 * (fixed + rows * LDS_MIN), LDS_MIN, 0


def kernel_takes(c: int, cout: int, d: int, lmax: int, parity: bool,
                 dtype=torch.float32) -> bool:
    """Whether ``k2_launch`` (csrc/env_layer.cu, or a build of ``dtype``:
    ``fused_layer.build_for``) takes these widths at ``dtype``, forward and
    backward: a build of that dtype, its refusal conditions, the 3j table
    the wrapper builds and its shared-memory sum (``block_layout``), mirrored
    here so that a caller decides before any launch.  Every build keeps its
    tiles f32 in shared memory and its ring as many words (the bf16x3
    weights take the f32 bytes, the pair-packed ones half; a ring too shallow
    for a 16-row bf16x3 chunk reads its weights without it), so its sum is
    the f32 one and the answer does not depend on the policy."""
    return dtype in (torch.float32, torch.bfloat16) and table_fits(lmax, parity) and widths_ok(
        c, cout, d) and all(
        block_layout(c, cout, d, lmax, parity, bwd)[0] <= SMEM_MAX for bwd in (False, True))


class MixLayouts:
    """The launchers' mix and mixT of K2 and K4 for each build: ``blocks``
    (the per-l3 matrices in the order of ``mix_flat``, whose transposes
    make ``mixT_flat``) as they are (3xTF32), ``fused_layer.pack_x3``-ed in
    the f32 bytes and offsets (bf16x3), or ``pack_pairs``-ed in half of
    them, every offset halved (one pass, and K2's bf16 build); the packed
    copies are made at the first launch that wants them and go with the
    object when a leaf changes."""

    @functools.cached_property
    def packed(self) -> tuple:
        return self._packs(pack_pairs)

    @functools.cached_property
    def packed_x3(self) -> tuple:
        return self._packs(pack_x3)

    def _packs(self, pack) -> tuple:
        return (torch.cat([pack(w).reshape(-1) for w in self.blocks]).contiguous(),
                torch.cat([pack(w.T).reshape(-1) for w in self.blocks]).contiguous())

    def layout(self, build: str) -> tuple:
        """mix and mixT for ``build`` (``fused_layer.build_for``)."""
        if build == "tf32x3":
            return self.mix_flat, self.mixT_flat
        return self.packed_x3 if build == "bf16x3" else self.packed


@dataclasses.dataclass(frozen=True, eq=False)
class K2Weights(MixLayouts):
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

    @property
    def blocks(self) -> tuple:
        return self.mix


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


def env_layer_reference(Vt, wzt, yt, w: K2Weights, K: int, inv_avg: float,
                        mode: str | None = None):
    """The same function as the kernel, in plain PyTorch on the same
    layout: Vt (D, C, E), wzt (C, E), yt (D, E) -> (Vt' (D, Cout, E),
    inv (C*P0, E) c-major).  The mix is ``prec.kmm`` in kernel ``mode``
    (default: the policy's for the operands' dtype, ``prec.kernel_mode``),
    the env sum an f32 sum under every mode.  Goes through torch autograd."""
    mode = mode or prec.kernel_mode(Vt.dtype)
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
        out_rows.append(prec.kmm(w.mix[l3].to(Vt.dtype).T, t_r, mode,
                                 1.0 / math.sqrt(P[l3] * c)))
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
    lib.k2_layout_bytes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.k2_layout_bytes.restype = ctypes.c_int
    if lib.k2_meta_words() * 4 != _META_DTYPE.itemsize:
        raise RuntimeError("kernel table layout differs from the wrapper's")


_HEADERS = [CSRC / "allegro_mma.cuh", CSRC / "allegro_tiles.cuh", CSRC / "mma_ptx.cuh"]
LIB = CudaLibrary("k2_env_layer", [CSRC / "env_layer.cu", *_HEADERS], _bind)
LIB_BF16, LIB_BF16X3, LIB_ONEPASS = (
    CudaLibrary(f"k2_env_layer_{b}", [CSRC / f"env_layer_{b}.cu", CSRC / "env_layer.cu", *_HEADERS],
                _bind) for b in ("bf16", "bf16x3", "onepass"))

# each build's (library, launch counts), looked up at each launch
BUILDS = {"tf32x3": (LIB, launches), "bf16": (LIB_BF16, launches_bf16),
          "bf16x3": (LIB_BF16X3, launches_bf16x3), "onepass": (LIB_ONEPASS, launches_onepass)}


def _dims(w: K2Weights, d: int, c: int, K: int, e: int):
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    return (ctypes.c_int * 7)(c, w.cout, d, K, e, max(P) * c, P[0])


def _launch(bwd: bool, w: K2Weights, Vt, K: int, inv_avg: float, ptrs, build: str):
    lib, counts = BUILDS[build]
    lib = lib.load()
    d, c, e = Vt.shape
    dims = _dims(w, d, c, K, e)
    arr = (ctypes.c_ulonglong * 13)(*ptrs)
    with torch.cuda.device(Vt.device):
        stream = torch.cuda.current_stream(Vt.device).cuda_stream
        rc = lib.k2_launch(int(bwd), arr, dims, ctypes.c_float(inv_avg), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K2 ({build}) {'backward' if bwd else 'forward'} "
                           f"launch failed (code {rc}): a negative code is a shape the kernel "
                           "does not take")
    count(counts, bwd)


def _kernel_fwd(Vt, wzt, yt, w: K2Weights, K: int, inv_avg: float, mode=None):
    """One forward launch of the build of ``mode`` (default: the policy's)."""
    build = build_for(Vt.dtype, mode)
    d, c, e = Vt.shape
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    out = torch.empty((d, w.cout, e), dtype=Vt.dtype, device=Vt.device)
    inv = torch.empty((c * p0, e), dtype=Vt.dtype, device=Vt.device)
    ptrs = [Vt.data_ptr(), wzt.data_ptr(), yt.data_ptr(),
            *(t.data_ptr() for t in w.layout(build)), w.meta.data_ptr(), 0, 0, out.data_ptr(),
            inv.data_ptr(), 0, 0, 0]
    _launch(False, w, Vt, K, inv_avg, ptrs, build)
    return out, inv


def _kernel_bwd(Vt, wzt, yt, w: K2Weights, K: int, inv_avg: float, dout, dinv, mode=None):
    """One backward launch of the build of ``mode`` (default: the policy's)."""
    build = build_for(Vt.dtype, mode)
    dV, dwz, dY = torch.empty_like(Vt), torch.empty_like(wzt), torch.empty_like(yt)
    ptrs = [Vt.data_ptr(), wzt.data_ptr(), yt.data_ptr(),
            *(t.data_ptr() for t in w.layout(build)), w.meta.data_ptr(), dout.data_ptr(),
            dinv.data_ptr(), 0, 0, dV.data_ptr(), dwz.data_ptr(), dY.data_ptr()]
    _launch(True, w, Vt, K, inv_avg, ptrs, build)
    return dV, dwz, dY


class _EnvLayer(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes env from (wz, Y), as the TPU kernel does, and hands
    back NaN-filled weight cotangents.  An unused output's cotangent arrives
    as zeros (autograd materialises it), as the dead last-layer V' does."""

    @staticmethod
    def forward(ctx, Vt, wzt, yt, w, K, inv_avg, *leaves):
        mode = prec.kernel_mode(Vt.dtype)
        ctx.cfg = (w, K, inv_avg, mode)
        ctx.save_for_backward(Vt, wzt, yt)
        if Vt.is_cuda:
            return _kernel_fwd(Vt, wzt, yt, w, K, inv_avg, mode)
        return env_layer_reference(Vt, wzt, yt, w, K, inv_avg, mode)

    @staticmethod
    def backward(ctx, dout, dinv):
        w, K, inv_avg, mode = ctx.cfg
        Vt, wzt, yt = ctx.saved_tensors
        if Vt.is_cuda:
            grads = _kernel_bwd(Vt, wzt, yt, w, K, inv_avg, dout.contiguous(), dinv.contiguous(),
                                mode)
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (Vt, wzt, yt)]
                outs = env_layer_reference(*ins, w, K, inv_avg, mode)
                grads = torch.autograd.grad(outs, ins, (dout, dinv))
        nan_w = [torch.full_like(t, float("nan")) for t in w.leaves]
        return (*grads, None, None, None, *nan_w)


def check_operands(name: str, Vt, wzt, yt, d: int, c: int, K: int, weights,
                   dtypes=(torch.float32,)) -> None:
    """Shapes, devices and, for CUDA tensors, the kernel's dtypes (V, wz
    and Y all of one of ``dtypes``: K2 takes float32 and, in its bf16 build,
    bfloat16; the weights float32) and contiguity; raises on what the
    kernel does not take."""
    e = Vt.shape[-1]
    if (tuple(Vt.shape) != (d, c, e) or tuple(wzt.shape) != (c, e) or tuple(yt.shape) != (d, e)
            or K < 1 or e % K):
        raise ValueError(f"{name} shapes: V {tuple(Vt.shape)} (want {(d, c, e)}), wz "
                         f"{tuple(wzt.shape)}, Y {tuple(yt.shape)}, K={K}")
    ts = (Vt, wzt, yt, *weights)
    if any(t.device != Vt.device for t in ts):
        raise ValueError(f"{name}: all tensors must be on one device")
    if Vt.is_cuda:
        if (Vt.dtype not in dtypes or any(t.dtype != Vt.dtype for t in (wzt, yt))
                or any(t.dtype != torch.float32 for t in weights)):
            names = " or all ".join(str(t).removeprefix("torch.") for t in dtypes)
            raise TypeError(f"{name}: the CUDA kernel takes V, wz and Y all {names}, and float32 "
                            "weights")
        if any(not t.is_contiguous() for t in (Vt, wzt, yt)):
            raise ValueError(f"{name}: CUDA inputs must be contiguous")


def env_layer(Vt, wzt, yt, w: K2Weights, K: int, avg_num_neighbors: float):
    """K2 on the feature-major TABLE layout: Vt (D, C, E), wzt (C, E) env
    weights already * u, yt (D, E); E = n_centers * K.  Returns (Vt'
    (D, Cout, E), inv (C*P0, E) c-major).  CUDA tensors launch the kernel
    (contiguous, f32 or bf16 (:func:`check_operands`); a shape beyond its
    shared memory raises); CPU tensors take :func:`env_layer_reference` at
    their dtype."""
    d = (w.lmax + 1) ** 2
    check_operands("env_layer", Vt, wzt, yt, d, w.c, K, w.leaves,
                   (torch.float32, torch.bfloat16))
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _EnvLayer.apply(Vt, wzt, yt, w, K, inv_avg, *w.leaves)
