"""K1: the one-layer fused Allegro kernel (counterpart of
``pair_allegro_tpu/ops/pallas_stack.py:_layer1_fwd_kernel`` /
``_layer1_bwd_kernel``, entry ``allegro_layer_fused_t``).

One call computes a whole Allegro layer on the feature-major layout of the
TABLE edge list (E = n_centers * K, each center's K edges contiguous):

  wz  = (Wenv^T x) / sqrt(ns) * u;  env = per-center sum wz (x) Y / sqrt(avg_n)
  T   = channelwise TP of V with env;  V' = per-l3 mix of T;  inv = T[l3=0]
  x'  = (x + MLP([x; inv]) * u) / sqrt(2)

On a CUDA tensor :func:`fused_layer` launches the hand-written Hopper kernel
pair in ``csrc/fused_layer.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``); on a CPU tensor it runs :func:`fused_layer_reference`, the plain
PyTorch version of the same function.  What bounds the kernel on the card and
what its design does about it is written at the top of the CUDA source.

Weight cotangents come back NaN-filled, the contract of the TPU kernel
(``pallas_stack.py:1363``): MD forces never need them, and a training-style
use fails loudly instead of silently returning zeros.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.mlp import silu_norm_const
from pair_allegro_tpu_torch.ops.tp import _nonzeros, num_paths_per_l
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

_MAX_ENT, _MAX_D, _MAX_LAT = 512, 16, 8
# the kernels' shared-memory table (struct Meta in csrc/allegro_tiles.cuh)
_META_DTYPE = np.dtype(
    [
        ("n_ent", np.int32),
        ("ent", np.int32, _MAX_ENT),
        ("w", np.float32, _MAX_ENT),
        ("rowstart", np.int32, _MAX_D + 1),
        ("rowP", np.int32, _MAX_D),
        ("rowmix", np.int32, _MAX_D),
        ("rownorm", np.float32, _MAX_D),
        ("latdim", np.int32, _MAX_LAT + 1),
        ("latoff", np.int32, _MAX_LAT),
    ]
)


launches = LaunchCounts()

# the launchers' constants (csrc/allegro_tiles.cuh): threads per block, the
# edge tile and its shared row stride, the shared memory a block may use
NT, ET, LD, SMEM_MAX = 256, 32, 33, 232448
META_WORDS = _META_DTYPE.itemsize // 4


def table_fits(lmax: int, parity: bool) -> bool:
    """Whether the 3j entries of (l_max, parity) fit the Meta table."""
    n_ent = sum(len(e) for e, _ in _row_tables(lmax, parity))
    return (lmax + 1) ** 2 <= _MAX_D and n_ent <= _MAX_ENT


def kernel_takes(ns: int, c: int, cout: int, d: int, latd: tuple, lmax: int, parity: bool) -> bool:
    """Whether ``k1_launch`` (csrc/fused_layer.cu) takes a layer of these
    widths in every form, forward and backward: its refusal conditions and
    its shared-memory sum, mirrored here so that a caller decides before
    any launch."""
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    nlat, in0 = len(latd) - 1, latd[0]
    hidden = latd[1:-1]
    maxw = max(hidden) if hidden else 4
    maxpc = max(P) * c
    if not table_fits(lmax, parity) or d > _MAX_D or not 1 <= nlat <= _MAX_LAT:
        return False
    if NT % c or NT // c > ET or ns % 4 or c % 4 or cout % 4 or in0 % 4 or maxw % 4:
        return False
    for first_v in (False, True):
        for bwd in (False, True):
            words = META_WORDS + d * c * (2 if bwd else 1) + in0 * LD + d * c * LD
            words += (c * LD if first_v else 0) + d * LD + LD + (LD if bwd else 0)
            if bwd:
                gw = max(in0, maxw)
                r_rows = max(c, 2 * ns + (nlat - 1) * maxw + 2 * gw, d * c + maxpc + cout,
                             2 * c + ns)
            else:
                r_rows = max(c, maxpc, 2 * maxw + ns)
            if (words + r_rows * LD) * 4 > SMEM_MAX:
                return False
    return True


@dataclasses.dataclass(frozen=True, eq=False)
class K1Weights:
    """One layer's weights in the kernel's layout, made by
    :func:`prepare_layer` from the JAX-layout layer (``env_weight`` (ns, C),
    ``latent_mlp`` {"w": [(in, out), ...]}, ``mix`` {"l0": (C*P, C), ...}
    with c-major rows).  The mix rows and the inv rows of the first latent
    weight are permuted to p-major (row = p*C + c); the transposes serve the
    backward.  These are detached copies; ``leaves`` are the layer's own
    tensors, which receive the (NaN) weight cotangents."""

    env_w: torch.Tensor  # (ns, C)
    env_wT: torch.Tensor  # (C, ns)
    lat: tuple  # (in, out) per layer, first layer's inv rows p-major
    mix: tuple  # (P*C, Cout) per l3, p-major rows
    lat_flat: torch.Tensor
    latT_flat: torch.Tensor
    mix_flat: torch.Tensor
    mixT_flat: torch.Tensor
    meta: torch.Tensor  # int32 table of struct Meta
    lmax: int
    parity: bool
    leaves: tuple  # env_weight, latent_mlp w..., mix l0..l_max of the tree

    @property
    def dims(self):
        ns, c = self.env_w.shape
        latd = [self.lat[0].shape[0]] + [w.shape[1] for w in self.lat]
        return ns, c, self.mix[0].shape[1], latd

    def tensors(self):
        return self.leaves


def layer_leaves(layer: dict, lmax: int) -> tuple:
    """The JAX-layout leaves of one Allegro layer the kernels read."""
    return (layer["env_weight"], *layer["latent_mlp"]["w"],
            *(layer["mix"][f"l{l3}"] for l3 in range(lmax + 1)))


def _to_pmajor(w: torch.Tensor, c: int) -> torch.Tensor:
    """(c*P, Cout) c-major rows -> (P*c, Cout) p-major rows."""
    cp, cout = w.shape
    return w.reshape(c, cp // c, cout).transpose(0, 1).reshape(cp, cout)


@functools.lru_cache(maxsize=None)
def _row_tables(lmax: int, parity: bool):
    """Per output row r = l3^2 + k: (entries (p, i, j, w) of that row, l3)."""
    nz = _nonzeros(lmax, parity)
    rows = []
    for l3 in range(lmax + 1):
        for k in range(2 * l3 + 1):
            rows.append(
                (tuple((p, i, j, w) for (p, i, j, kk, w) in nz[l3] if kk == k), l3)
            )
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def _meta_table(lmax, parity, c, cout, latd: tuple) -> np.ndarray:
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    rows = _row_tables(lmax, parity)
    if sum(len(ents) for ents, _ in rows) > _MAX_ENT:
        raise ValueError(f"l_max={lmax}, parity={parity} has more 3j entries than the kernel's table")
    m = np.zeros((), _META_DTYPE)
    mixoff = np.cumsum([0] + [p * c * cout for p in P])
    e = 0
    for r, (ents, l3) in enumerate(rows):
        m["rowstart"][r] = e
        m["rowP"][r] = P[l3]
        m["rowmix"][r] = mixoff[l3]
        m["rownorm"][r] = 1.0 / math.sqrt(P[l3] * c)
        for p, i, j, w in ents:
            m["ent"][e] = p | (i << 8) | (j << 16)
            m["w"][e] = w
            e += 1
    m["rowstart"][len(rows)] = e
    m["n_ent"] = e
    m["latdim"][: len(latd)] = latd
    m["latoff"][: len(latd) - 1] = np.cumsum([0] + [a * b for a, b in zip(latd[:-1], latd[1:])])[:-1]
    m.setflags(write=False)  # memoised: every caller gets this one table
    return m


def prepare_layer(layer: dict, lmax: int, parity: bool) -> K1Weights:
    """Kernel-layout weights of one layer (see :class:`K1Weights`), made
    anew; :func:`k1_weights` is the cached accessor."""
    env_w = layer["env_weight"].detach()
    ns, c = env_w.shape
    lat = [w.detach() for w in layer["latent_mlp"]["w"]]
    lat[0] = torch.cat([lat[0][:ns], _to_pmajor(lat[0][ns:], c)], dim=0)
    mix = tuple(_to_pmajor(layer["mix"][f"l{l3}"].detach(), c) for l3 in range(lmax + 1))
    latd = [lat[0].shape[0]] + [w.shape[1] for w in lat]
    if len(latd) - 1 > _MAX_LAT or (lmax + 1) ** 2 > _MAX_D:
        raise ValueError("layer exceeds the kernel's table sizes")

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts]).contiguous()

    meta = _meta_table(lmax, parity, c, mix[0].shape[1], tuple(latd))
    return K1Weights(
        env_w=env_w.contiguous(),
        env_wT=env_w.T.contiguous(),
        lat=tuple(w.contiguous() for w in lat),
        mix=mix,
        lat_flat=flat(lat),
        latT_flat=flat([w.T for w in lat]),
        mix_flat=flat(mix),
        mixT_flat=flat([w.T for w in mix]),
        meta=torch.from_numpy(np.frombuffer(meta.tobytes(), np.int32).copy()).to(env_w.device),
        lmax=lmax,
        parity=parity,
        leaves=layer_leaves(layer, lmax),
    )


def k1_weights(layer: dict, lmax: int, parity: bool) -> K1Weights:
    """K1's weights for the layer as its leaves stand now: made once and
    kept until a leaf is replaced or updated in place
    (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k1", lmax, parity), layer_leaves(layer, lmax),
                       lambda: prepare_layer(layer, lmax, parity))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def _silu_c(z):
    return F.silu(z) * silu_norm_const()


def fused_layer_reference(xt, Vt, yt, ut, w: K1Weights, K: int, inv_avg: float,
                          first_v: bool = False, last: bool = False):
    """The same function as the kernel, in plain PyTorch on the same
    feature-major layout: xt (ns, E), Vt (D, C, E) or pT (C, E) when
    ``first_v``, yt (D, E), ut (1, E).  Returns xt' or (xt', Vt'); goes
    through torch autograd."""
    ns, e = xt.shape
    d_dim = yt.shape[0]
    c = w.env_w.shape[1]
    nc = e // K
    wz = (w.env_w.T.to(xt.dtype) @ xt) * (1.0 / math.sqrt(ns)) * ut  # (C, E)
    A = wz.unsqueeze(0) * yt.unsqueeze(1)  # (D, C, E)
    env = A.reshape(d_dim, c, nc, K).sum(-1) * inv_avg
    env_e = env.unsqueeze(-1).expand(d_dim, c, nc, K).reshape(d_dim, c, e)
    V = Vt.unsqueeze(0) * yt.unsqueeze(1) if first_v else Vt
    rows = _row_tables(w.lmax, w.parity)
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    out_rows = []
    inv = None
    for r, (ents, l3) in enumerate(rows[:1] if last else rows):
        acc = [None] * P[l3]
        for p, i, j, wv in ents:
            t = (wv * V[i]) * env_e[j]
            acc[p] = t if acc[p] is None else acc[p] + t
        t_r = torch.cat([a if a is not None else V.new_zeros(c, e) for a in acc], 0)
        if r == 0:
            inv = t_r  # (P0*C, E) p-major
        if not last:
            m = w.mix[l3].to(xt.dtype)
            out_rows.append((m.T @ t_r) * (1.0 / math.sqrt(P[l3] * c)))
    h = torch.cat([xt, inv], 0)
    for li, wl in enumerate(w.lat):
        h = (wl.to(xt.dtype).T @ h) * (1.0 / math.sqrt(wl.shape[0]))
        if li < len(w.lat) - 1:
            h = _silu_c(h)
    x_out = (xt + h * ut) * (1.0 / math.sqrt(2.0))
    if last:
        return x_out
    return x_out, torch.stack(out_rows, 0)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _bind(lib):
    lib.k1_meta_words.argtypes = []
    lib.k1_meta_words.restype = ctypes.c_int
    lib.k1_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.k1_launch.restype = ctypes.c_int
    if lib.k1_meta_words() * 4 != _META_DTYPE.itemsize:
        raise RuntimeError("kernel table layout differs from the wrapper's")


LIB = CudaLibrary("k1_fused_layer", [CSRC / "fused_layer.cu", CSRC / "allegro_tiles.cuh"], _bind)


def _launch(bwd: bool, dims, inv_avg, ptrs, device):
    lib = LIB.load()
    arr = (ctypes.c_ulonglong * 19)(*ptrs)
    dm = (ctypes.c_int * 12)(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.k1_launch(int(bwd), arr, dm, ctypes.c_float(inv_avg), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K1 {'backward' if bwd else 'forward'} launch failed (code {rc})")
    if bwd:
        launches.bwd += 1
    else:
        launches.fwd += 1


def _kernel_dims(w: K1Weights, xt, yt, K, first_v, last):
    ns, c, cout, latd = w.dims
    hidden = latd[1:-1]
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    return [ns, c, cout, yt.shape[0], K, xt.shape[1], len(w.lat), int(first_v), int(last),
            max(hidden) if hidden else 4, max(P) * c, latd[0]]


def _kernel_fwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last):
    ns, e = xt.shape
    c, cout = w.env_w.shape[1], w.mix[0].shape[1]
    xo = torch.empty_like(xt)
    vo = None if last else torch.empty((yt.shape[0], cout, e), dtype=xt.dtype, device=xt.device)
    ptrs = [xt.data_ptr(), Vt.data_ptr(), yt.data_ptr(), ut.data_ptr(),
            w.env_w.data_ptr(), w.env_wT.data_ptr(), w.lat_flat.data_ptr(),
            w.latT_flat.data_ptr(), w.mix_flat.data_ptr(), w.mixT_flat.data_ptr(), 0, 0,
            w.meta.data_ptr(), xo.data_ptr(), 0 if last else vo.data_ptr(), 0, 0, 0, 0]
    _launch(False, _kernel_dims(w, xt, yt, K, first_v, last), inv_avg, ptrs, xt.device)
    return xo if last else (xo, vo)


def _kernel_bwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last, dxo, dvo):
    dx = torch.empty_like(xt)
    dV = torch.empty_like(Vt)
    dY = torch.empty_like(yt)
    du = torch.empty_like(ut)
    ptrs = [xt.data_ptr(), Vt.data_ptr(), yt.data_ptr(), ut.data_ptr(),
            w.env_w.data_ptr(), w.env_wT.data_ptr(), w.lat_flat.data_ptr(),
            w.latT_flat.data_ptr(), w.mix_flat.data_ptr(), w.mixT_flat.data_ptr(),
            dxo.data_ptr(), 0 if last else dvo.data_ptr(), w.meta.data_ptr(), 0, 0,
            dx.data_ptr(), dV.data_ptr(), dY.data_ptr(), du.data_ptr()]
    _launch(True, _kernel_dims(w, xt, yt, K, first_v, last), inv_avg, ptrs, xt.device)
    return dx, dV, dY, du


class _FusedLayer(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes what it needs from (x, V, Y, u), as the TPU kernel
    does, and hands back NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, xt, Vt, yt, ut, w, K, inv_avg, first_v, last, *weights):
        ctx.cfg = (w, K, inv_avg, first_v, last)
        ctx.save_for_backward(xt, Vt, yt, ut)
        if xt.is_cuda:
            return _kernel_fwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last)
        return fused_layer_reference(xt, Vt, yt, ut, w, K, inv_avg, first_v, last)

    @staticmethod
    def backward(ctx, dxo, dvo=None):
        w, K, inv_avg, first_v, last = ctx.cfg
        xt, Vt, yt, ut = ctx.saved_tensors
        if xt.is_cuda:
            grads = _kernel_bwd(xt, Vt, yt, ut, w, K, inv_avg, first_v, last,
                                dxo.contiguous(), None if last else dvo.contiguous())
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (xt, Vt, yt, ut)]
                out = fused_layer_reference(*ins, w, K, inv_avg, first_v, last)
                outs, cots = ((out,), (dxo,)) if last else (out, (dxo, dvo))
                grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, None, None, *nan_w)


def fused_layer(xt, Vt, yt, ut, w: K1Weights, K: int, avg_num_neighbors: float,
                first_v: bool = False, last: bool = False):
    """One Allegro layer on the feature-major TABLE layout.

    xt (ns, E); Vt (D, C, E), or the (C, E) tensor embedding pT when
    ``first_v`` (V0 = pT * Y is built inside); yt (D, E); ut (1, E);
    E = n_centers * K.  Returns xt' (``last``: no V output) or (xt', Vt').
    CUDA tensors launch the kernel (f32 and contiguous only); CPU tensors
    take :func:`fused_layer_reference`."""
    ns, e = xt.shape
    d_dim = yt.shape[0]
    c = w.env_w.shape[1]
    want_v = (c, e) if first_v else (d_dim, c, e)
    if tuple(Vt.shape) != want_v or tuple(yt.shape) != (d_dim, e) or tuple(ut.shape) != (1, e):
        raise ValueError(f"fused_layer shapes: x {tuple(xt.shape)}, V {tuple(Vt.shape)} "
                         f"(want {want_v}), Y {tuple(yt.shape)}, u {tuple(ut.shape)}")
    if w.env_w.shape[0] != ns or d_dim != (w.lmax + 1) ** 2 or K < 1 or e % K:
        raise ValueError(f"fused_layer: ns={ns}, D={d_dim}, K={K}, E={e} do not fit the layer")
    ts = (xt, Vt, yt, ut, *w.tensors())
    if any(t.device != xt.device for t in ts):
        raise ValueError("fused_layer: all tensors must be on one device")
    if xt.is_cuda:
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError("fused_layer: the CUDA kernel takes float32 tensors only")
        if any(not t.is_contiguous() for t in (xt, Vt, yt, ut)):
            raise ValueError("fused_layer: CUDA inputs must be contiguous")
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _FusedLayer.apply(xt, Vt, yt, ut, w, K, inv_avg, first_v, last, *w.tensors())
