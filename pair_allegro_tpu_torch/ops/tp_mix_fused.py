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
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.env_layer import mix_leaves
from pair_allegro_tpu_torch.ops.fused_layer import _META_DTYPE, _meta_table
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l, scalar_part, tp_mix_apply, uniform_tp
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

launches = LaunchCounts()


@dataclasses.dataclass(frozen=True, eq=False)
class K4Weights:
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


def tp_mix_fused_reference(Vt, envt, w: K4Weights):
    """The same function as the kernel in plain PyTorch (``uniform_tp``,
    ``tp_mix_apply`` and ``scalar_part`` on the (E, C, D) layout, as
    ``pallas_tp.tp_mix_fused_ref``): Vt, envt (D, C, E) -> (Vt' (D, Cout,
    E), inv (E, C*P0)), contiguous as the kernel's.  Goes through torch
    autograd."""
    V, env = Vt.permute(2, 1, 0), envt.permute(2, 1, 0)
    T = uniform_tp(V, env, w.lmax, w.parity)
    ws = {f"l{l3}": leaf for l3, leaf in enumerate(w.leaves)}
    return tp_mix_apply(ws, T).permute(2, 1, 0).contiguous(), scalar_part(T).contiguous()


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
    if lib.k4_meta_words() * 4 != _META_DTYPE.itemsize:
        raise RuntimeError("kernel table layout differs from the wrapper's")


LIB = CudaLibrary("k4_tp_mix_fused", [CSRC / "tp_mix_fused.cu", CSRC / "allegro_tiles.cuh"], _bind)

_CODES = {-1: "D above 16", -3: "no edges", -4: "C and Cout must be multiples of 4",
          -6: "the block's shared memory exceeds 227 KB even at 8 edges per tile"}


def _dims(w: K4Weights, Vt):
    d, c, e = Vt.shape
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    return (ctypes.c_int * 6)(c, w.cout, d, e, max(P) * c, P[0])


def kernel_tile(w: K4Weights, Vt, bwd: bool) -> int:
    """The edge tile the kernel takes for these operands (32, 16 or 8), or
    its negative refusal code (the library is built and loaded first)."""
    return LIB.load().k4_tile(int(bwd), _dims(w, Vt))


def _launch(bwd: bool, w: K4Weights, Vt, ptrs):
    lib = LIB.load()
    arr = (ctypes.c_ulonglong * 11)(*ptrs)
    with torch.cuda.device(Vt.device):
        stream = torch.cuda.current_stream(Vt.device).cuda_stream
        rc = lib.k4_launch(int(bwd), arr, _dims(w, Vt), ctypes.c_void_p(stream))
    if rc != 0:
        what = f"K4 {'backward' if bwd else 'forward'} launch failed"
        if rc > 0:
            raise RuntimeError(f"{what} (CUDA error {rc})")
        d, c, e = Vt.shape
        raise RuntimeError(
            f"{what} (code {rc}: {_CODES.get(rc, '?')}): the kernel does not take D={d}, C={c}, "
            f"Cout={w.cout}, E={e}, l_max={w.lmax}, parity={w.parity}")
    if bwd:
        launches.bwd += 1
    else:
        launches.fwd += 1


def _kernel_fwd(Vt, envt, w: K4Weights):
    d, c, e = Vt.shape
    p0 = num_paths_per_l(w.lmax, w.lmax, 0, w.parity)[0]
    out = torch.empty((d, w.cout, e), dtype=Vt.dtype, device=Vt.device)
    inv = torch.empty((e, c * p0), dtype=Vt.dtype, device=Vt.device)
    ptrs = [Vt.data_ptr(), envt.data_ptr(), w.mix_flat.data_ptr(), w.mixT_flat.data_ptr(),
            w.meta.data_ptr(), 0, 0, out.data_ptr(), inv.data_ptr(), 0, 0]
    _launch(False, w, Vt, ptrs)
    return out, inv


def _kernel_bwd(Vt, envt, w: K4Weights, dout, dinv):
    dV, denv = torch.empty_like(Vt), torch.empty_like(envt)
    ptrs = [Vt.data_ptr(), envt.data_ptr(), w.mix_flat.data_ptr(), w.mixT_flat.data_ptr(),
            w.meta.data_ptr(), dout.data_ptr(), dinv.data_ptr(), 0, 0, dV.data_ptr(),
            denv.data_ptr()]
    _launch(True, w, Vt, ptrs)
    return dV, denv


class _TpMix(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes T from (V, env), as the TPU kernel does, and hands
    back NaN-filled weight cotangents.  An unused output's cotangent
    arrives as zeros (autograd materialises it), as the dead last-layer V'
    does."""

    @staticmethod
    def forward(ctx, Vt, envt, w, *leaves):
        ctx.w = w
        ctx.save_for_backward(Vt, envt)
        if Vt.is_cuda:
            return _kernel_fwd(Vt, envt, w)
        return tp_mix_fused_reference(Vt, envt, w)

    @staticmethod
    def backward(ctx, dout, dinv):
        w = ctx.w
        Vt, envt = ctx.saved_tensors
        if Vt.is_cuda:
            grads = _kernel_bwd(Vt, envt, w, dout.contiguous(), dinv.contiguous())
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (Vt, envt)]
                outs = tp_mix_fused_reference(*ins, w)
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
