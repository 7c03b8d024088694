"""K6: the embed-fused first Allegro layer (counterpart of
``pair_allegro_tpu/ops/pallas_stack.py:_layer1e_fwd_kernel`` /
``_layer1e_bwd_kernel``, entry ``allegro_layer_embed_fused_t``).

K1's first layer (its first_v form, ops/fused_layer.py) with the two-body
MLP and the tensor embed as its prologue, on the feature-major layout of the
TABLE edge list:

  x = MLP2b(in) * u;  pT = W_te^T x / sqrt(ns);  then K1's first_v body

with in = [onehot(t_i); onehot(t_j); Bessel * u], (2T + B, E).  Returns
(x', V').  On a CUDA tensor :func:`embed_layer` launches the kernel pair in
``csrc/embed_readout_layer.cu`` (built with ``nvcc`` at first use, bound
with ``ctypes``; the same library holds K7, ops/readout_layer.py); on a CPU
tensor it runs :func:`embed_layer_reference`, the plain PyTorch version.

The port is exact f32, which is what the TPU kernel computes with
``PAT_EMBED_PREC=highest``; that knob (bf16x3 dots in the prologue) and the
block-lane knobs ``PAT_L1_BE`` / ``PAT_L1_BE_BWD`` have no counterpart here.
Weight cotangents come back NaN-filled for every leaf the kernel reads, the
two-body MLP and ``tensor_embed`` included (``pallas_stack.py:1699``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.mlp import mlp_apply_t
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

launches = LaunchCounts()

MT_WORDS = fl.MT_WORDS


def mlp_layout(ws, base: int = 0):
    """(blocks, table, maxw) of a prologue or epilogue MLP for the kernel:
    its (in, out) weights with the first one's rows padded with zeros to a
    multiple of 4, and the int32 words of its MlpTab, the blocks' offsets
    counted from ``base`` floats and each layer's scale 1/sqrt(real fan-in).
    The transposes' blocks sit at the same offsets."""
    blocks = [F.pad(ws[0], (0, 0, 0, -ws[0].shape[0] % 4)), *ws[1:]]
    dims = [blocks[0].shape[0]] + [w.shape[1] for w in ws]
    hidden = dims[1:-1]
    maxw = max(hidden) if hidden else 4
    offs = base + np.cumsum([0] + [b.numel() for b in blocks])[:-1]
    tab = np.zeros(MT_WORDS, np.int32)
    tab[0], tab[1] = len(ws), maxw
    d0 = 2
    o0 = d0 + fl._MAX_LAT + 1
    s0 = o0 + fl._MAX_LAT
    tab[d0:d0 + len(dims)] = dims
    tab[o0:o0 + len(ws)] = offs
    tab[s0:s0 + len(ws)] = np.array([1.0 / math.sqrt(w.shape[0]) for w in ws], np.float32).view(np.int32)
    return blocks, tab, maxw


def mlp_widths_ok(dims, last: int | None = None) -> bool:
    """Whether the kernel's MLP takes these widths: at most MAX_LAT layers,
    every output width a multiple of 4 except a last width of 1 (``last``
    pins it)."""
    n = len(dims) - 1
    outs = dims[1:] if last != 1 else dims[1:-1]
    return 1 <= n <= fl._MAX_LAT and (last is None or dims[-1] == last) and not any(o % 4 for o in outs)


def kernel_takes(ns: int, c: int, d: int, latd: tuple, lmax: int, parity: bool,
                 tb_dims: tuple) -> bool:
    """Whether ``er_launch`` (csrc/embed_readout_layer.cu) takes K6 at these
    widths, forward and backward: K1's conditions (ops/fused_layer.py), the
    two-body MLP's (``tb_dims`` = (2T + B, hidden..., ns)) and the shared
    memory sum with the prologue's rows, mirrored here so that a caller
    decides before any launch."""
    if not fl.widths_ok(ns, c, c, d, latd, lmax, parity) or not mlp_widths_ok(tb_dims, ns):
        return False
    hidden = tb_dims[1:-1]
    xmaxw = max(hidden) if hidden else 4
    hz = (len(tb_dims) - 2) * xmaxw
    return all(fl.block_bytes(ns, c, c, d, latd, lmax, parity, True, bwd, "embed", tb_dims[0],
                              xmaxw, hz) <= fl.SMEM_MAX for bwd in (False, True))


@dataclasses.dataclass(frozen=True, eq=False)
class K6Weights:
    """The first layer's K1 layout (``layer``) with the prologue's weights:
    the two-body MLP as the kernel reads it (``ew`` / ``ewT`` flat blocks and
    transposes, the first padded; ``mt`` its MlpTab and an empty one) and as
    the plain version reads it (``tb``), and W_te (ns, C) with its
    transpose.  Detached copies; ``leaves`` are the tree's own tensors (the
    two-body weights, tensor_embed, the layer's), which receive the (NaN)
    weight cotangents."""

    layer: fl.K1Weights
    tb: tuple
    te: torch.Tensor
    teT: torch.Tensor
    ew: torch.Tensor
    ewT: torch.Tensor
    mt: torch.Tensor
    xmaxw: int
    leaves: tuple

    @property
    def n_in(self) -> int:
        return self.tb[0].shape[0]

    @property
    def tb_dims(self) -> tuple:
        return (self.n_in, *(w.shape[1] for w in self.tb))

    def tensors(self):
        return self.leaves


def embed_leaves(params: dict, lmax: int) -> tuple:
    return (*params["two_body_mlp"]["w"], params["tensor_embed"],
            *fl.layer_leaves(params["layers"][0], lmax))


def prepare_embed(params: dict, lmax: int, parity: bool) -> K6Weights:
    """K6's weights (see :class:`K6Weights`) made anew from the tree;
    :func:`k6_weights` is the cached accessor."""
    tb = tuple(w.detach() for w in params["two_body_mlp"]["w"])
    blocks, tab, maxw = mlp_layout(tb)
    te = params["tensor_embed"].detach()
    mt = np.concatenate([tab, np.zeros(MT_WORDS, np.int32)])
    return K6Weights(
        layer=fl.prepare_layer(params["layers"][0], lmax, parity),
        tb=tb,
        te=te.contiguous(),
        teT=te.T.contiguous(),
        ew=torch.cat([b.reshape(-1) for b in blocks]).contiguous(),
        ewT=torch.cat([b.T.reshape(-1) for b in blocks]).contiguous(),
        mt=torch.from_numpy(mt).to(te.device),
        xmaxw=maxw,
        leaves=embed_leaves(params, lmax),
    )


def k6_weights(params: dict, lmax: int, parity: bool) -> K6Weights:
    """K6's weights for the tree's leaves as they stand now, made once and
    kept until one is replaced or updated in place (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k6", lmax, parity), embed_leaves(params, lmax),
                       lambda: prepare_embed(params, lmax, parity))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def embed_layer_reference(in_t, yt, ut, w: K6Weights, K: int, inv_avg: float):
    """The same function as the kernel in plain PyTorch: in_t (2T + B, E),
    yt (D, E), ut (1, E) -> (x' (ns, E), V' (D, C, E)); goes through torch
    autograd."""
    x = mlp_apply_t({"w": w.tb}, in_t) * ut
    pT = (w.te.to(x.dtype).T @ x) * (1.0 / math.sqrt(x.shape[0]))
    return fl.fused_layer_reference(x, pT, yt, ut, w.layer, K, inv_avg, first_v=True)


# ---------------------------------------------------------------------------
# The CUDA kernels (K6 and K7): build, bind, launch
# ---------------------------------------------------------------------------

_PTRS = ("x", "V", "Y", "u", "envw", "envwT", "lat", "latT", "mix", "mixT", "dxo", "dvo", "meta",
         "xo", "vo", "dx", "dV", "dY", "du", "in", "te", "teT", "din", "mt", "ew", "ewT", "dh0",
         "dh1", "ho0", "ho1")
EMBED, READOUT = 1, 2  # enum Form (csrc/allegro_layer.cuh)


def _bind(lib):
    lib.er_meta_words.argtypes = []
    lib.er_meta_words.restype = ctypes.c_int
    lib.er_mt_words.argtypes = []
    lib.er_mt_words.restype = ctypes.c_int
    lib.er_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
        ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_void_p,
    ]
    lib.er_launch.restype = ctypes.c_int
    lib.er_layout_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.er_layout_bytes.restype = ctypes.c_int
    if lib.er_meta_words() != fl.META_WORDS or lib.er_mt_words() != MT_WORDS:
        raise RuntimeError("kernel table layouts differ from the wrappers'")


LIB = CudaLibrary("k6k7_embed_readout_layer",
                  [CSRC / "embed_readout_layer.cu", CSRC / "allegro_layer.cuh",
                   CSRC / "allegro_mma.cuh", CSRC / "allegro_tiles.cuh", CSRC / "mma_ptx.cuh"],
                  _bind)


def launch(form: int, bwd: bool, w: fl.K1Weights, ts: dict, d: int, K: int, e: int,
           extra_dims: list, inv_avg: float, counts: LaunchCounts, device) -> None:
    """One K6 or K7 launch: ``ts`` maps the launcher's pointer names (_PTRS)
    to tensors (the layer's K1 weights are added here, absent names are
    0); ``extra_dims`` = (n_in, xmaxw, hzrows, nhead).  Raises on any
    refusal or launch error; counts the launch."""
    ts = {"envw": w.env_w, "envwT": w.env_wT, "lat": w.lat_flat, "latT": w.latT_flat,
          "mix": w.mix_flat, "mixT": w.mixT_flat, "meta": w.meta, **ts}
    first_v, last = form == EMBED, form == READOUT
    dims = fl.kernel_dims(w, d, K, e, first_v, last) + list(extra_dims)
    lib = LIB.load()
    arr = (ctypes.c_ulonglong * len(_PTRS))(*(ts[k].data_ptr() if k in ts else 0 for k in _PTRS))
    dm = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.er_launch(form, int(bwd), arr, dm, ctypes.c_float(inv_avg), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K{6 if form == EMBED else 7} {'backward' if bwd else 'forward'} "
                           f"launch failed (code {rc})")
    if bwd:
        counts.bwd += 1
    else:
        counts.fwd += 1


def _extra(w: K6Weights) -> list:
    return [w.n_in, w.xmaxw, (len(w.tb) - 1) * w.xmaxw, 0]


def _common(w: K6Weights) -> dict:
    return {"te": w.te, "teT": w.teT, "mt": w.mt, "ew": w.ew, "ewT": w.ewT}


def _kernel_fwd(in_t, yt, ut, w: K6Weights, K, inv_avg):
    ns, c = w.te.shape
    d, e = yt.shape
    xo = torch.empty((ns, e), dtype=yt.dtype, device=yt.device)
    vo = torch.empty((d, c, e), dtype=yt.dtype, device=yt.device)
    launch(EMBED, False, w.layer, {"Y": yt, "u": ut, "in": in_t, "xo": xo, "vo": vo, **_common(w)},
           d, K, e, _extra(w), inv_avg, launches, yt.device)
    return xo, vo


def _kernel_bwd(in_t, yt, ut, w: K6Weights, K, inv_avg, dxo, dvo):
    d, e = yt.shape
    dx = torch.empty((w.te.shape[0], e), dtype=yt.dtype, device=yt.device)  # pass-1 scratch
    din, dY, du = torch.empty_like(in_t), torch.empty_like(yt), torch.empty_like(ut)
    launch(EMBED, True, w.layer, {"Y": yt, "u": ut, "in": in_t, "dxo": dxo, "dvo": dvo, "dx": dx,
                                  "dY": dY, "du": du, "din": din, **_common(w)},
           d, K, e, _extra(w), inv_avg, launches, yt.device)
    return din, dY, du


class _EmbedLayer(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes the prologue and the layer from (in, Y, u), as the
    TPU kernel does, and hands back NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, in_t, yt, ut, w, K, inv_avg, *weights):
        ctx.cfg = (w, K, inv_avg)
        ctx.save_for_backward(in_t, yt, ut)
        if in_t.is_cuda:
            return _kernel_fwd(in_t, yt, ut, w, K, inv_avg)
        return embed_layer_reference(in_t, yt, ut, w, K, inv_avg)

    @staticmethod
    def backward(ctx, dxo, dvo):
        w, K, inv_avg = ctx.cfg
        in_t, yt, ut = ctx.saved_tensors
        if in_t.is_cuda:
            grads = _kernel_bwd(in_t, yt, ut, w, K, inv_avg, dxo.contiguous(), dvo.contiguous())
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (in_t, yt, ut)]
                out = embed_layer_reference(*ins, w, K, inv_avg)
                grads = torch.autograd.grad(out, ins, (dxo, dvo), allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, *nan_w)


def check_operands(name: str, ts, w_tensors, want: dict) -> None:
    """The wrappers' checks: shapes (``want`` maps an operand's index to its
    shape), one device, and on a CUDA device f32 and contiguous."""
    for i, shape in want.items():
        if tuple(ts[i].shape) != tuple(shape):
            raise ValueError(f"{name}: operand {i} has shape {tuple(ts[i].shape)}, want {tuple(shape)}")
    if any(t.device != ts[0].device for t in (*ts, *w_tensors)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if ts[0].is_cuda:
        if any(t.dtype != torch.float32 for t in (*ts, *w_tensors)):
            raise TypeError(f"{name}: the CUDA kernel takes float32 tensors only")
        if any(not t.is_contiguous() for t in ts):
            raise ValueError(f"{name}: CUDA inputs must be contiguous")


def embed_layer(in_t, yt, ut, w: K6Weights, K: int, avg_num_neighbors: float):
    """The first Allegro layer with the two-body MLP and the tensor embed
    fused in: in_t (2T + B, E) two-body input rows, yt (D, E), ut (1, E),
    E = n_centers * K.  Returns (x' (ns, E), V' (D, C, E)).  CUDA tensors
    launch K6; CPU tensors take :func:`embed_layer_reference`."""
    d, e = yt.shape
    if d != (w.layer.lmax + 1) ** 2 or K < 1 or e % K:
        raise ValueError(f"embed_layer: D={d}, K={K}, E={e} do not fit the layer")
    check_operands("embed_layer", (in_t, yt, ut), w.tensors(),
                   {0: (w.n_in, e), 1: (d, e), 2: (1, e)})
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _EmbedLayer.apply(in_t, yt, ut, w, K, inv_avg, *w.tensors())
