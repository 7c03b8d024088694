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
with ``ctypes``; the same library holds K7, ops/readout_layer.py), or at
bf16 its bf16 build ``csrc/embed_readout_layer_bf16.cu`` (the
``interior="bf16"`` tier: bf16 activations, f32 sums in registers, one bf16
tensor-core pass per product on pair-packed weights); on a CPU tensor it
runs :func:`embed_layer_reference`, the plain PyTorch version, at the
tensors' dtype.

At f32 the products follow the matmul precision policy (``ops/prec.py``),
as K1's do (``fused_layer``): the call's kernel mode picks the build (f32
3xTF32, ``embed_readout_layer_bf16x3.cu`` or ``embed_readout_layer_onepass.cu``)
and the plain version's products (``prec.kmm``); the prologue takes the
body's mode, or f32-accurate products under ``PAT_EMBED_PREC=highest``
(read per call, as JAX reads it per trace: ``_mm_embed``).  The block-lane
knobs ``PAT_L1_BE`` / ``PAT_L1_BE_BWD`` have no counterpart here.
At bf16 the plain version rounds where the TPU kernel does: every product
one bf16 pass with f32 accumulation on bf16-cast weights, and the
prologue's constants (fan-in scales, the SiLU norm, 1/sqrt(ns)) rounded to
bf16, as JAX's weakly typed Python floats are (``mlp.weak_scalar``); the
bf16 build rounds the same constants, and its f32 oracle on the card is
the plain version at f32 with ``scalars=torch.bfloat16``.
Weight cotangents come back NaN-filled for every leaf the kernel reads, the
two-body MLP and ``tensor_embed`` included (``pallas_stack.py:1699``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.mlp import mlp_apply_t, weak_scalar
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

launches = LaunchCounts("K6.tf32x3")  # the f32 kernel's (K6, 3xTF32 products)
launches_bf16 = LaunchCounts("K6.bf16")  # the bf16 build's (K6)
launches_bf16x3 = LaunchCounts("K6.bf16x3")  # the f32 bf16x3 build's (K6)
launches_onepass = LaunchCounts("K6.onepass")  # the f32 one-pass build's (K6)

MT_WORDS = fl.MT_WORDS


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def mlp_layout(ws, base: int = 0):
    """(blocks, table, maxw, offsets, end) of a prologue or epilogue MLP for
    the kernel: its (in, out) weights with the first one's rows padded with
    zeros to a multiple of 4, and the int32 words of its MlpTab, the
    blocks' offsets counted from ``base`` floats and each layer's scale
    1/sqrt(real fan-in).  Each block starts on a multiple of 8 floats, so
    its pair-packed copy (half the offset) starts on 16 bytes too; ``end``
    is the offset after the last.  The transposes' blocks sit at the same
    offsets (:func:`mlp_flat`)."""
    blocks = [F.pad(ws[0], (0, 0, 0, -ws[0].shape[0] % 4)), *ws[1:]]
    dims = [blocks[0].shape[0]] + [w.shape[1] for w in ws]
    hidden = dims[1:-1]
    maxw = max(hidden) if hidden else 4
    offs = base + np.cumsum([0] + [_ceil8(b.numel()) for b in blocks])
    offs, end = offs[:-1], int(offs[-1])
    tab = np.zeros(MT_WORDS, np.int32)
    tab[0], tab[1] = len(ws), maxw
    d0 = 2
    o0 = d0 + fl._MAX_LAT + 1
    s0 = o0 + fl._MAX_LAT
    tab[d0:d0 + len(dims)] = dims
    tab[o0:o0 + len(ws)] = offs
    tab[s0:s0 + len(ws)] = np.array([1.0 / math.sqrt(w.shape[0]) for w in ws], np.float32).view(np.int32)
    return blocks, tab, maxw, [int(o) for o in offs], end


def mlp_flat(blocks, offs, end: int, transpose: bool = False, build: str = "tf32x3"):
    """The kernel's flat weight buffer of MLP blocks at their offsets (in
    floats, :func:`mlp_layout`), zeros between them, in the layout of
    ``build`` (``fused_layer.build_for``): f32; pair-packed (the bf16 and
    one-pass builds: each block ``fused_layer.pack_pairs``-ed at half its
    offset, int32 words); or bf16x3 (``fused_layer.pack_x3`` at its
    offset).  ``transpose`` stores each block's transpose; a width-1
    block's transpose, which the kernel never reads, packs as zeros."""
    dev = blocks[0].device
    halve = build in ("bf16", "onepass")
    buf = torch.zeros(end // 2 if halve else end,
                      dtype=torch.float32 if build == "tf32x3" else torch.int32, device=dev)
    for b, o in zip(blocks, offs):
        m = b.T if transpose else b
        if build == "tf32x3":
            buf[o:o + m.numel()] = m.reshape(-1)
        elif m.shape[0] % 2 == 0 and halve:
            buf[o // 2:o // 2 + m.numel() // 2] = fl.pack_pairs(m).reshape(-1)
        elif m.shape[0] % 2 == 0:
            buf[o:o + m.numel()] = fl.pack_x3(m).reshape(-1)
    return buf


def mlp_widths_ok(dims, last: int | None = None) -> bool:
    """Whether the kernel's MLP takes these widths: at most MAX_LAT layers,
    every output width a multiple of 4 except a last width of 1 (``last``
    pins it)."""
    n = len(dims) - 1
    outs = dims[1:] if last != 1 else dims[1:-1]
    return 1 <= n <= fl._MAX_LAT and (last is None or dims[-1] == last) and not any(o % 4 for o in outs)


def kernel_takes(ns: int, c: int, d: int, latd: tuple, lmax: int, parity: bool,
                 tb_dims: tuple, dtype=torch.float32) -> bool:
    """Whether ``er_launch`` (csrc/embed_readout_layer.cu, or its bf16 build
    embed_readout_layer_bf16.cu) takes K6 at these widths at ``dtype``,
    forward and backward: a build of that dtype, K1's conditions
    (ops/fused_layer.py), the two-body MLP's (``tb_dims`` = (2T + B,
    hidden..., ns)) and the shared memory sum with the prologue's rows,
    mirrored here so that a caller decides before any launch.  Every
    build keeps f32 tiles, so its sum is the f32 one whatever the policy."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
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
    transposes, the first padded, at ``offs`` of ``end`` floats; ``mt`` its
    MlpTab and an empty one) and as the plain version reads it (``tb``),
    and W_te (ns, C) with its transpose.  Detached copies; ``leaves`` are
    the tree's own tensors (the two-body weights, tensor_embed, the
    layer's), which receive the (NaN) weight cotangents.  :attr:`packed`
    holds the bf16 build's copies, made at its first launch and replaced
    with the object when a leaf changes (``k6_weights``)."""

    layer: fl.K1Weights
    tb: tuple
    te: torch.Tensor
    teT: torch.Tensor
    ew: torch.Tensor
    ewT: torch.Tensor
    mt: torch.Tensor
    xmaxw: int
    leaves: tuple
    blocks: tuple
    offs: tuple
    end: int

    @functools.cached_property
    def packed(self) -> dict:
        """W_te, its transpose and the two-body MLP's blocks (at half their
        offsets) pair-packed (``fused_layer.pack_pairs``) for the bf16 and
        one-pass builds; the layer's are ``layer.packed``."""
        return {"te": fl.pack_pairs(self.te), "teT": fl.pack_pairs(self.teT),
                "ew": mlp_flat(self.blocks, self.offs, self.end, build="bf16"),
                "ewT": mlp_flat(self.blocks, self.offs, self.end, transpose=True, build="bf16")}

    @functools.cached_property
    def packed_x3(self) -> dict:
        """The same for the bf16x3 build (``fused_layer.pack_x3``, the f32
        offsets); the layer's are ``layer.packed_x3``."""
        return {"te": fl.pack_x3(self.te), "teT": fl.pack_x3(self.teT),
                "ew": mlp_flat(self.blocks, self.offs, self.end, build="bf16x3"),
                "ewT": mlp_flat(self.blocks, self.offs, self.end, transpose=True,
                                build="bf16x3")}

    def prologue(self, build: str) -> dict:
        """te, teT, ew and ewT in the layout of ``build``."""
        if build == "tf32x3":
            return {"te": self.te, "teT": self.teT, "ew": self.ew, "ewT": self.ewT}
        return self.packed_x3 if build == "bf16x3" else self.packed

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
    blocks, tab, maxw, offs, end = mlp_layout(tb)
    te = params["tensor_embed"].detach()
    mt = np.concatenate([tab, np.zeros(MT_WORDS, np.int32)])
    return K6Weights(
        layer=fl.prepare_layer(params["layers"][0], lmax, parity),
        tb=tb,
        te=te.contiguous(),
        teT=te.T.contiguous(),
        ew=mlp_flat(blocks, offs, end),
        ewT=mlp_flat(blocks, offs, end, transpose=True),
        mt=torch.from_numpy(mt).to(te.device),
        xmaxw=maxw,
        leaves=embed_leaves(params, lmax),
        blocks=tuple(blocks),
        offs=tuple(offs),
        end=end,
    )


def k6_weights(params: dict, lmax: int, parity: bool) -> K6Weights:
    """K6's weights for the tree's leaves as they stand now, made once and
    kept until one is replaced or updated in place (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k6", lmax, parity), embed_leaves(params, lmax),
                       lambda: prepare_embed(params, lmax, parity))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def embed_exact() -> bool:
    """Whether the prologue's products are f32-accurate whatever the policy
    (``PAT_EMBED_PREC=highest``; the default 'policy' gives them the body's
    mode), read per call as JAX's ``_mm_embed`` reads it per trace."""
    return os.environ.get("PAT_EMBED_PREC", "policy") == "highest"


def embed_layer_reference(in_t, yt, ut, w: K6Weights, K: int, inv_avg: float, scalars=None,
                          mode: str | None = None, exact: bool | None = None):
    """The same function as the kernel in plain PyTorch: in_t (2T + B, E),
    yt (D, E), ut (1, E) -> (x' (ns, E), V' (D, C, E)); goes through torch
    autograd.  The constants round as JAX's do at the dtype ``scalars``
    (default: the operands'; ``mlp.mlp_apply_t``); the products are in
    kernel ``mode`` (default: the policy's), the prologue's f32-accurate
    with ``exact`` (default: :func:`embed_exact`)."""
    sd = scalars or in_t.dtype
    mode = mode or prec.kernel_mode(in_t.dtype)
    exact = embed_exact() if exact is None else exact
    pro = "tf32x3" if exact else mode
    x = mlp_apply_t({"w": w.tb}, in_t, sd, pro) * ut
    pT = prec.kmm(w.te.to(x.dtype).T, x, pro, weak_scalar(1.0 / math.sqrt(x.shape[0]), sd))
    return fl.fused_layer_reference(x, pT, yt, ut, w.layer, K, inv_avg, True, False, mode, sd)


# ---------------------------------------------------------------------------
# The CUDA kernels (K6 and K7): build, bind, launch
# ---------------------------------------------------------------------------

_PTRS = ("x", "V", "Y", "u", "envw", "envwT", "lat", "latT", "mix", "mixT", "dxo", "dvo", "meta",
         "xo", "vo", "dx", "dV", "dY", "du", "in", "te", "teT", "din", "mt", "ew", "ewT", "dh0",
         "dh1", "ho0", "ho1", "part")
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


_SOURCES = [CSRC / "embed_readout_layer.cu", CSRC / "allegro_layer.cuh",
            CSRC / "allegro_mma.cuh", CSRC / "allegro_tiles.cuh", CSRC / "mma_ptx.cuh"]
LIB = CudaLibrary("k6k7_embed_readout_layer", _SOURCES, _bind)
LIB_BF16 = CudaLibrary("k6k7_embed_readout_layer_bf16",
                       [CSRC / "embed_readout_layer_bf16.cu", *_SOURCES], _bind)
LIB_BF16X3 = CudaLibrary("k6k7_embed_readout_layer_bf16x3",
                         [CSRC / "embed_readout_layer_bf16x3.cu", *_SOURCES], _bind)
LIB_ONEPASS = CudaLibrary("k6k7_embed_readout_layer_onepass",
                          [CSRC / "embed_readout_layer_onepass.cu", *_SOURCES], _bind)


# each build's (library, K6 launch counts); K7 pairs the same libraries
# with its own counts
BUILDS = {"tf32x3": (LIB, launches), "bf16": (LIB_BF16, launches_bf16),
          "bf16x3": (LIB_BF16X3, launches_bf16x3), "onepass": (LIB_ONEPASS, launches_onepass)}


def launch(form: int, bwd: bool, w: fl.K1Weights, ts: dict, d: int, K: int, e: int,
           extra_dims: list, inv_avg: float, builds: dict, device, build: str) -> None:
    """One K6 or K7 launch of ``build`` (``fused_layer.build_for``): ``ts``
    maps the launcher's pointer names (_PTRS) to tensors (the layer's K1
    weights in the build's layout, and its table, are added here; absent
    names are 0); ``extra_dims`` = (n_in, xmaxw, hzrows, nhead,
    pro_exact); ``builds`` the kernel's (library, launch counts) by build.  Raises on
    any refusal or launch error; counts the launch."""
    meta, ia = fl.launch_scalars(w, build, inv_avg)
    ts = {**dict(zip(("envw", "envwT", "lat", "latT", "mix", "mixT"), w.layout(build))),
          "meta": meta, **ts}
    first_v, last = form == EMBED, form == READOUT
    dims = fl.kernel_dims(w, d, K, e, first_v, last) + list(extra_dims)
    lib, counts = builds[build]
    lib = lib.load()
    arr = (ctypes.c_ulonglong * len(_PTRS))(*(ts[k].data_ptr() if k in ts else 0 for k in _PTRS))
    dm = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.er_launch(form, int(bwd), arr, dm, ctypes.c_float(ia), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K{6 if form == EMBED else 7} ({build}) "
                           f"{'backward' if bwd else 'forward'} launch failed (code {rc})")
    fl.count(counts, bwd)


def _extra(w: K6Weights, pro_exact: bool) -> list:
    return [w.n_in, w.xmaxw, (len(w.tb) - 1) * w.xmaxw, 0, int(pro_exact)]


def _common(w: K6Weights, build: str, exact: bool) -> tuple:
    """(the prologue's pointers and table, pro_exact) of a launch of
    ``build``: an exact prologue takes the f32 weights (at bf16 the
    pair-packed ones: JAX's _mm_exact is one bf16 pass there)."""
    pro = ("bf16" if build == "bf16" else "tf32x3") if exact else build
    return {"mt": w.mt, **w.prologue(pro)}, pro != build


def _kernel_fwd(in_t, yt, ut, w: K6Weights, K, inv_avg, mode=None, exact=None):
    """One forward launch of the build of ``mode`` (default: the policy's),
    the prologue exact with ``exact`` (default: :func:`embed_exact`)."""
    ns, c = w.te.shape
    d, e = yt.shape
    build = fl.build_for(yt.dtype, mode)
    ptr, pro_exact = _common(w, build, embed_exact() if exact is None else exact)
    xo = torch.empty((ns, e), dtype=yt.dtype, device=yt.device)
    vo = torch.empty((d, c, e), dtype=yt.dtype, device=yt.device)
    launch(EMBED, False, w.layer, {"Y": yt, "u": ut, "in": in_t, "xo": xo, "vo": vo, **ptr},
           d, K, e, _extra(w, pro_exact), inv_avg, BUILDS, yt.device, build)
    return xo, vo


def _kernel_bwd(in_t, yt, ut, w: K6Weights, K, inv_avg, dxo, dvo, mode=None, exact=None):
    d, e = yt.shape
    build = fl.build_for(yt.dtype, mode)
    ptr, pro_exact = _common(w, build, embed_exact() if exact is None else exact)
    # the pass-1 partials of dx and du, f32 at either dtype
    part = torch.empty((w.te.shape[0] + 1, e), dtype=torch.float32, device=yt.device)
    din, dY, du = torch.empty_like(in_t), torch.empty_like(yt), torch.empty_like(ut)
    launch(EMBED, True, w.layer, {"Y": yt, "u": ut, "in": in_t, "dxo": dxo, "dvo": dvo,
                                  "part": part, "dY": dY, "du": du, "din": din, **ptr},
           d, K, e, _extra(w, pro_exact), inv_avg, BUILDS, yt.device, build)
    return din, dY, du


class _EmbedLayer(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes the prologue and the layer from (in, Y, u), as the
    TPU kernel does, and hands back NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, in_t, yt, ut, w, K, inv_avg, *weights):
        mode, exact = prec.kernel_mode(in_t.dtype), embed_exact()
        ctx.cfg = (w, K, inv_avg, mode, exact)
        ctx.save_for_backward(in_t, yt, ut)
        if in_t.is_cuda:
            return _kernel_fwd(in_t, yt, ut, w, K, inv_avg, mode, exact)
        return embed_layer_reference(in_t, yt, ut, w, K, inv_avg, mode=mode, exact=exact)

    @staticmethod
    def backward(ctx, dxo, dvo):
        w, K, inv_avg, mode, exact = ctx.cfg
        in_t, yt, ut = ctx.saved_tensors
        if in_t.is_cuda:
            grads = _kernel_bwd(in_t, yt, ut, w, K, inv_avg, dxo.contiguous(), dvo.contiguous(),
                                mode, exact)
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (in_t, yt, ut)]
                out = embed_layer_reference(*ins, w, K, inv_avg, mode=mode, exact=exact)
                grads = torch.autograd.grad(out, ins, (dxo, dvo), allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, *nan_w)


def check_operands(name: str, ts, w_tensors, want: dict) -> None:
    """The wrappers' checks: shapes (``want`` maps an operand's index to its
    shape), one device, and on a CUDA device contiguous operands all f32
    or all bf16 (the bf16 build) with f32 weights."""
    for i, shape in want.items():
        if tuple(ts[i].shape) != tuple(shape):
            raise ValueError(f"{name}: operand {i} has shape {tuple(ts[i].shape)}, want {tuple(shape)}")
    if any(t.device != ts[0].device for t in (*ts, *w_tensors)):
        raise ValueError(f"{name}: all tensors must be on one device")
    if ts[0].is_cuda:
        if (ts[0].dtype not in (torch.float32, torch.bfloat16)
                or any(t.dtype != ts[0].dtype for t in ts)
                or any(t.dtype != torch.float32 for t in w_tensors)):
            raise TypeError(f"{name}: the CUDA kernel takes operands all float32 or all bfloat16, "
                            f"and float32 weights")
        if any(not t.is_contiguous() for t in ts):
            raise ValueError(f"{name}: CUDA inputs must be contiguous")


def embed_layer(in_t, yt, ut, w: K6Weights, K: int, avg_num_neighbors: float):
    """The first Allegro layer with the two-body MLP and the tensor embed
    fused in: in_t (2T + B, E) two-body input rows, yt (D, E), ut (1, E),
    E = n_centers * K.  Returns (x' (ns, E), V' (D, C, E)).  CUDA tensors
    launch K6 (all f32, or all bf16 for its bf16 build); CPU tensors take
    :func:`embed_layer_reference` at their dtype."""
    d, e = yt.shape
    if d != (w.layer.lmax + 1) ** 2 or K < 1 or e % K:
        raise ValueError(f"embed_layer: D={d}, K={K}, E={e} do not fit the layer")
    check_operands("embed_layer", (in_t, yt, ut), w.tensors(),
                   {0: (w.n_in, e), 1: (d, e), 2: (1, e)})
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _EmbedLayer.apply(in_t, yt, ut, w, K, inv_avg, *w.tensors())
