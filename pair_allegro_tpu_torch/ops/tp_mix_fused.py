"""K4: the per-edge TP + mix kernel (counterpart of
``pair_allegro_tpu/ops/pallas_tp.py:_fwd_kernel`` / ``_bwd_kernel``, entry
``tp_mix_fused_t``).

One call computes the equivariant part of one Allegro layer with the
environment already on the edges, on the (D, C, E) layout (the layer stack
keeps V in it across layers):

  T   = channelwise TP of V with env over the parity-pruned paths
  V'  = per-l3 mix of T with the tree's c-major leaves (row c*P + p),
        divided by sqrt(P*C)
  inv = T[l3=0] as (E, C*P0), column c*P0 + p (``scalar_part``'s order)

It is used on the FLAT edge layout, and on the TABLE layout where the
env-fused kernels cannot hold the model's widths, as the reference uses it.
On a CUDA tensor :func:`tp_mix_fused_t` launches the hand-written Hopper
kernel pair in ``csrc/tp_mix_fused.cu``; on a CPU tensor it runs
:func:`tp_mix_fused_reference`, the plain PyTorch version of the same
function.  Weight cotangents come back NaN-filled, the contract of the TPU
kernel (``pallas_tp.py:322-324``).

The mix follows the matmul precision policy (``ops/prec.py``), as JAX's
``pallas_tp._kdot`` does: the call's :func:`prec.kernel_mode` picks the
build (``fused_layer.build_for``), ``tf32x3`` (``tp_mix_fused.cu``),
``bf16x3`` (``tp_mix_fused_bf16x3.cu``, on ``fused_layer.pack_x3``-ed
weights) or one pass (``tp_mix_fused_onepass.cu``, on pair-packed ones),
and the plain version computes the same mode's products
(``tp_mix_apply(..., mode=)``).  The forward fixes the mode its backward
uses.  The kernel takes f32 operands only: a bf16 layer stays on the plain
path, as JAX's ``use_fused`` keeps it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.env_layer import MixLayouts, mix_leaves
from pair_allegro_tpu_torch.ops.fused_layer import (
    _MAX_D,
    _MAX_ENT,
    _META_DTYPE,
    LDS_WIDE,
    META_WORDS,
    RING_BWD,
    RING_FWD,
    RING_MIN,
    SHARE2,
    SMEM_MAX,
    _ceil4,
    _meta_table,
    build_for,
    count,
    table_fits,
)
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l, scalar_part, tp_mix_apply, uniform_tp
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

launches = LaunchCounts("K4.tf32x3")  # the 3xTF32 build's
launches_bf16x3 = LaunchCounts("K4.bf16x3")  # the bf16x3 build's
launches_onepass = LaunchCounts("K4.onepass")  # the one-pass build's


@dataclasses.dataclass(frozen=True, eq=False)
class K4Weights(MixLayouts):
    """One layer's mix weights in the kernel's layout: the tree's c-major
    leaves flat (the forward reads them as they are) and their transposes
    flat (the backward), and the 3j row table; detached copies made from
    ``leaves`` {"l0": (C*P0, Cout), ...}, which receive the weight
    cotangents."""

    mix_flat: torch.Tensor
    mixT_flat: torch.Tensor
    # int32 words of struct Meta (csrc/allegro_tiles.cuh); None on the CPU,
    # whose plain version needs no table (l_max=3 without parity has more
    # 3j entries than the table holds: the kernel refuses it)
    meta: torch.Tensor | None
    lmax: int
    parity: bool
    leaves: tuple

    @property
    def c(self) -> int:
        return self.leaves[0].shape[0] // num_paths_per_l(self.lmax, self.lmax, 0, self.parity)[0]

    @property
    def cout(self) -> int:
        return self.leaves[0].shape[1]

    @property
    def blocks(self) -> tuple:
        return self.leaves


def prepare_mix(mix: dict, lmax: int, parity: bool) -> K4Weights:
    """K4's weights from a layer's mix leaves, made anew (see
    :func:`k4_weights` for the cached accessor)."""
    leaves = mix_leaves(mix, lmax)
    dev = leaves[0].device
    meta = None
    if dev.type == "cuda":
        c = leaves[0].shape[0] // num_paths_per_l(lmax, lmax, 0, parity)[0]
        table = _meta_table(lmax, parity, c, leaves[0].shape[1], (0,))
        meta = torch.from_numpy(np.frombuffer(table.tobytes(), np.int32).copy()).to(dev)
    return K4Weights(
        mix_flat=torch.cat([w.detach().reshape(-1) for w in leaves]).contiguous(),
        mixT_flat=torch.cat([w.detach().T.reshape(-1) for w in leaves]).contiguous(),
        meta=meta,
        lmax=lmax,
        parity=parity,
        leaves=leaves,
    )


def k4_weights(mix: dict, lmax: int, parity: bool) -> K4Weights:
    """K4's weights for the mix leaves as they stand now, cached until a
    leaf is replaced or updated in place (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k4", lmax, parity), mix_leaves(mix, lmax),
                       lambda: prepare_mix(mix, lmax, parity))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def tp_mix_fused_reference(Vt, envt, w: K4Weights, mode: str | None = None):
    """The same function as the kernel in plain PyTorch (``uniform_tp``,
    ``tp_mix_apply`` and ``scalar_part`` on the (E, C, D) layout, as
    ``pallas_tp.tp_mix_fused_ref``): Vt, envt (D, C, E) -> (Vt' (D, Cout,
    E), inv (E, C*P0)), contiguous as the kernel's.  The mix is
    ``prec.kmm`` in kernel ``mode`` (default: the policy's for the
    operands' dtype, ``prec.kernel_mode``).  Goes through torch autograd."""
    mode = mode or prec.kernel_mode(Vt.dtype)
    V, env = Vt.permute(2, 1, 0), envt.permute(2, 1, 0)
    T = uniform_tp(V, env, w.lmax, w.parity)
    ws = {f"l{l3}": leaf for l3, leaf in enumerate(w.leaves)}
    return (tp_mix_apply(ws, T, mode).permute(2, 1, 0).contiguous(),
            scalar_part(T).contiguous())


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def _bind(lib):
    lib.k4_meta_words.argtypes = []
    lib.k4_meta_words.restype = ctypes.c_int
    lib.k4_tile.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.k4_tile.restype = ctypes.c_int
    lib.k4_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p,
    ]
    lib.k4_launch.restype = ctypes.c_int
    for name in ("k4_layout_bytes", "k4_ring_words"):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        getattr(lib, name).restype = ctypes.c_int
    if lib.k4_meta_words() * 4 != _META_DTYPE.itemsize:
        raise RuntimeError("kernel table layout differs from the wrapper's")


_HEADERS = [CSRC / "allegro_mma.cuh", CSRC / "allegro_tiles.cuh", CSRC / "mma_ptx.cuh"]
LIB = CudaLibrary("k4_tp_mix_fused", [CSRC / "tp_mix_fused.cu", *_HEADERS], _bind)
LIB_BF16X3, LIB_ONEPASS = (
    CudaLibrary(f"k4_tp_mix_fused_{b}",
                [CSRC / f"tp_mix_fused_{b}.cu", CSRC / "tp_mix_fused.cu", *_HEADERS], _bind)
    for b in ("bf16x3", "onepass"))

# each build's (library, launch counts), looked up at each launch; the
# kernel has no bf16 build (a bf16 layer runs the plain path)
BUILDS = {"tf32x3": (LIB, launches), "bf16x3": (LIB_BF16X3, launches_bf16x3),
          "onepass": (LIB_ONEPASS, launches_onepass)}

_CODES = {-1: "D above 16", -3: "no edges", -4: "C and Cout must be multiples of 4",
          -6: "the block's shared memory exceeds 227 KB even at 8 edges per tile"}
TILES = (32, 16, 8)


def product_stride(tw: int) -> int:
    """The row stride of the T and dV' tiles at edge tile tw (``ps_of`` in
    csrc/allegro_mma.cuh)."""
    return {32: LDS_WIDE, 16: 24, 8: 8}[tw]


def _layout(c, cout, d, maxpc, bwd, tw, budget, ring):
    """``layout`` (csrc/tp_mix_fused.cu): (bytes, ring words) of one block
    at edge tile tw, or None where it does not fit ``budget`` bytes."""
    ps = product_stride(tw)
    fixed = sum(_ceil4(w) for w in (META_WORDS, _MAX_ENT if bwd else 0, d * c * tw, d * c * tw,
                                    d * c * tw if bwd else 0, d * c * tw if bwd else 0,
                                    maxpc * ps, cout * ps if bwd else 0))
    left = (budget // 4 - fixed) // 8 * 8
    if ring:
        if left < RING_MIN:
            return None
        words = min(RING_BWD if bwd else RING_FWD, left)
        return 4 * (fixed + words), words
    return (4 * fixed, 0) if left >= 0 else None


def block_layout(c: int, cout: int, d: int, lmax: int, parity: bool,
                 bwd: bool) -> tuple[int, int, int] | None:
    """(bytes, edge tile, ring words) of the block ``k4_launch``
    (csrc/tp_mix_fused.cu) launches, a transcription of its ``pick_tile``:
    the tables, the V and env tiles (and dV, denv) at row stride tw, T (and
    dV') at ``product_stride``, each region rounded up to 16 bytes, then the
    ring (its cap or what is left, not below RING_MIN).  The widest tile
    whose block with the ring lets two blocks share an SM, else the widest
    that fits with the ring, else 8 edges without it; None where nothing
    fits."""
    maxpc = max(num_paths_per_l(lmax, lmax, lmax, parity)) * c
    for budget in (SHARE2, SMEM_MAX):
        for tw in TILES:
            plan = _layout(c, cout, d, maxpc, bwd, tw, budget, True)
            if plan:
                return plan[0], tw, plan[1]
    plan = _layout(c, cout, d, maxpc, bwd, 8, SMEM_MAX, False)
    return plan and (plan[0], 8, 0)


def kernel_takes(c: int, cout: int, d: int, lmax: int, parity: bool) -> bool:
    """Whether ``k4_launch`` (csrc/tp_mix_fused.cu, or a build of the
    policy's mode) takes these widths, forward and backward: its refusals
    (``_CODES``), the 3j table the wrapper builds, and a block that fits
    (``block_layout``), mirrored here so that a caller decides before any
    launch.  Every build lays out the same block (its ring as many words; a
    ring too shallow for a 16-row bf16x3 chunk reads its weights without
    it), so the answer does not depend on the policy."""
    if d > _MAX_D or not table_fits(lmax, parity) or c < 4 or c % 4 or cout < 4 or cout % 4:
        return False
    return all(block_layout(c, cout, d, lmax, parity, bwd) for bwd in (False, True))


def _dims(w: K4Weights, Vt):
    d, c, e = Vt.shape
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    return (ctypes.c_int * 6)(c, w.cout, d, e, max(P) * c, P[0])


def kernel_tile(w: K4Weights, Vt, bwd: bool, mode: str | None = None) -> int:
    """The edge tile the build of ``mode`` (default: the policy's) takes
    for these operands (32, 16 or 8), or its negative refusal code (the
    library is built and loaded first)."""
    return BUILDS[build_for(Vt.dtype, mode)][0].load().k4_tile(int(bwd), _dims(w, Vt))


def _launch(bwd: bool, w: K4Weights, Vt, ptrs, build: str):
    lib, counts = BUILDS[build]
    lib = lib.load()
    arr = (ctypes.c_ulonglong * 11)(*ptrs)
    with torch.cuda.device(Vt.device):
        stream = torch.cuda.current_stream(Vt.device).cuda_stream
        rc = lib.k4_launch(int(bwd), arr, _dims(w, Vt), ctypes.c_void_p(stream))
    if rc != 0:
        what = f"K4 ({build}) {'backward' if bwd else 'forward'} launch failed"
        if rc > 0:
            raise RuntimeError(f"{what} (CUDA error {rc})")
        d, c, e = Vt.shape
        raise RuntimeError(
            f"{what} (code {rc}: {_CODES.get(rc, '?')}): the kernel does not take D={d}, C={c}, "
            f"Cout={w.cout}, E={e}, l_max={w.lmax}, parity={w.parity}")
    count(counts, bwd)


def _kernel_fwd(Vt, envt, w: K4Weights, mode=None):
    """One forward launch of the build of ``mode`` (default: the policy's)."""
    build = build_for(Vt.dtype, mode)
    d, c, e = Vt.shape
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    out = torch.empty((d, w.cout, e), dtype=Vt.dtype, device=Vt.device)
    inv = torch.empty((e, c * p0), dtype=Vt.dtype, device=Vt.device)
    ptrs = [Vt.data_ptr(), envt.data_ptr(), *(t.data_ptr() for t in w.layout(build)),
            w.meta.data_ptr(), 0, 0, out.data_ptr(), inv.data_ptr(), 0, 0]
    _launch(False, w, Vt, ptrs, build)
    return out, inv


def _kernel_bwd(Vt, envt, w: K4Weights, dout, dinv, mode=None):
    """One backward launch of the build of ``mode`` (default: the policy's)."""
    build = build_for(Vt.dtype, mode)
    dV, denv = torch.empty_like(Vt), torch.empty_like(envt)
    ptrs = [Vt.data_ptr(), envt.data_ptr(), *(t.data_ptr() for t in w.layout(build)),
            w.meta.data_ptr(), dout.data_ptr(), dinv.data_ptr(), 0, 0, dV.data_ptr(),
            denv.data_ptr()]
    _launch(True, w, Vt, ptrs, build)
    return dV, denv


class _TpMix(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes T from (V, env), as the TPU kernel does, and hands
    back NaN-filled weight cotangents.  An unused output's cotangent
    arrives as zeros (autograd materialises it), as the dead last-layer V'
    does."""

    @staticmethod
    def forward(ctx, Vt, envt, w, *leaves):
        mode = prec.kernel_mode(Vt.dtype)
        ctx.cfg = (w, mode)
        ctx.save_for_backward(Vt, envt)
        if Vt.is_cuda:
            return _kernel_fwd(Vt, envt, w, mode)
        return tp_mix_fused_reference(Vt, envt, w, mode)

    @staticmethod
    def backward(ctx, dout, dinv):
        w, mode = ctx.cfg
        Vt, envt = ctx.saved_tensors
        if Vt.is_cuda:
            grads = _kernel_bwd(Vt, envt, w, dout.contiguous(), dinv.contiguous(), mode)
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (Vt, envt)]
                outs = tp_mix_fused_reference(*ins, w, mode)
                grads = torch.autograd.grad(outs, ins, (dout, dinv))
        nan_w = [torch.full_like(t, float("nan")) for t in w.leaves]
        return (*grads, None, *nan_w)


def tp_mix_fused_t(Vt, envt, w: K4Weights):
    """K4 on the (D, C, E) layout: Vt, envt (D, C, E) -> (Vt' (D, Cout, E),
    inv (E, C*P0)).  CUDA tensors launch the kernel (f32 and contiguous
    only; a shape it does not take raises with the shape in the message);
    CPU tensors take :func:`tp_mix_fused_reference`."""
    d = (w.lmax + 1) ** 2
    e = Vt.shape[-1]
    if tuple(Vt.shape) != (d, w.c, e) or tuple(envt.shape) != (d, w.c, e):
        raise ValueError(f"tp_mix_fused_t shapes: V {tuple(Vt.shape)}, env {tuple(envt.shape)} "
                         f"(want {(d, w.c, e)})")
    ts = (Vt, envt, *w.leaves)
    if any(t.device != Vt.device for t in ts):
        raise ValueError("tp_mix_fused_t: all tensors must be on one device")
    if Vt.is_cuda:
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError("tp_mix_fused_t: the CUDA kernel takes float32 tensors only")
        if not (Vt.is_contiguous() and envt.is_contiguous()):
            raise ValueError("tp_mix_fused_t: CUDA inputs must be contiguous")
    return _TpMix.apply(Vt, envt, w, *w.leaves)
