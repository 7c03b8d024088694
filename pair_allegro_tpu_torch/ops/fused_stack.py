"""K8: the fused Allegro layer stack (counterpart of
``pair_allegro_tpu/ops/pallas_stack.py:_stack_fwd_kernel`` /
``_stack_bwd_kernel``, entry ``allegro_stack_apply``).

One call runs every Allegro layer on the feature-major layout of the TABLE
edge list (E = n_centers * K, each center's K edges contiguous): from x0
(ns, E), pT (C, E), Y (D, E) and u (1, E) it builds V0 = pT * Y and, per
layer,

  wz  = (Wenv^T x) / sqrt(ns) * u;  env = per-center sum wz (x) Y / sqrt(avg_n)
  T   = channelwise TP of V with env;  V' = per-l3 mix of T;  inv = T[l3=0]
  x'  = (x + MLP([x; inv]) * u) / sqrt(2)

and returns x_final (ns, E); V never leaves the kernel.  On a CUDA tensor
:func:`fused_stack` launches the hand-written Hopper kernel pair in
``csrc/fused_stack.cu`` (one launch forward, one backward; K1's body in
``csrc/allegro_layer.cuh`` run once per layer), or at bf16 its bf16 build
``csrc/fused_stack_bf16.cu`` (the ``interior="bf16"`` tier: bf16
activations, x and V rounded to bf16 at every layer boundary and stashed
so, one bf16 tensor-core pass per product on pair-packed weights); on a
CPU tensor it runs :func:`allegro_stack_reference`, the plain PyTorch
version of the same function, at the tensors' dtype.  The backward returns dx0, dpT, dY and du; weight cotangents come
back NaN-filled, the contract of the TPU kernel (``pallas_stack.py:780-782``).
At f32 the products follow the matmul precision policy as K1's do
(``ops/prec.py``; the builds ``fused_stack_bf16x3.cu`` and
``fused_stack_onepass.cu``, and the plain version's ``prec.kmm``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.embed_layer import check_operands
from pair_allegro_tpu_torch.ops.mlp import mlp_apply, weak_scalar
from pair_allegro_tpu_torch.ops.tp import scalar_part, tp_mix_apply, uniform_tp

launches = LaunchCounts("K8.tf32x3")  # the f32 kernel's (3xTF32 products)
launches_bf16 = LaunchCounts("K8.bf16")  # the bf16 build's
launches_bf16x3 = LaunchCounts("K8.bf16x3")  # the f32 bf16x3 build's
launches_onepass = LaunchCounts("K8.onepass")  # the f32 one-pass build's

MAX_LAYERS = 8  # K8P::layer in csrc/fused_stack.cu (one kernel argument of <= 4 KB)


def kernel_takes(ns: int, c: int, d: int, latd: tuple, lmax: int, parity: bool,
                 n_layers: int, dtype=torch.float32) -> bool:
    """Whether ``k8_launch`` (csrc/fused_stack.cu, or its bf16 build
    fused_stack_bf16.cu) takes a stack of ``n_layers`` layers of these
    widths at ``dtype``, forward and backward: a build of that dtype, K1's
    width conditions, the shared-memory sum of K1's first form (the layout
    every layer of the stack shares; the bf16 build's tiles are f32, so
    its sum is the f32 one) and the layer count, mirrored here so that a
    caller decides before any launch.  Every build lays out the same
    block, so the answer does not depend on the policy."""
    return (dtype in (torch.float32, torch.bfloat16) and 1 <= n_layers <= MAX_LAYERS
            and fl.widths_ok(ns, c, c, d, latd, lmax, parity)
            and all(fl.block_bytes(ns, c, c, d, latd, lmax, parity, True, bwd, "stack") <= fl.SMEM_MAX
                    for bwd in (False, True)))


@dataclasses.dataclass(frozen=True, eq=False)
class K8Weights:
    """The stack's weights: each layer's K1 layout (``k1``, cached by
    :func:`fl.k1_weights`), the layers of the tree as they are (``tree``,
    for the plain version) and their leaves, which receive the (NaN)
    weight cotangents."""

    k1: tuple
    tree: tuple
    lmax: int
    parity: bool

    def tensors(self):
        return tuple(t for w in self.k1 for t in w.tensors())


def stack_weights(layers, lmax: int, parity: bool) -> K8Weights:
    """K8's weights for the tree's layers as their leaves stand now."""
    k1 = tuple(fl.k1_weights(layer, lmax, parity) for layer in layers)
    if len({(*w.dims[:3], tuple(w.dims[3])) for w in k1}) != 1:
        raise ValueError("fused_stack: the layers differ in their widths")
    return K8Weights(k1=k1, tree=tuple(layers), lmax=lmax, parity=parity)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def allegro_stack_reference(x0T, pT, Y_T, uT, layers, K: int, lmax: int,
                            avg_num_neighbors: float, parity: bool, mode: str | None = None):
    """The same function as the kernel in plain PyTorch, as the reference's
    ``allegro_stack_ref`` computes it (channels-last inside): x0T (ns, E),
    pT (C, E), Y_T (D, E), uT (1, E), ``layers`` the tree's layer list.
    Returns x_final (ns, E).  Goes through torch autograd.  The constants
    round as JAX's do at the operands' dtype (``mlp.weak_scalar``); the
    products (wz, the mix, the latent MLP) are ``prec.kmm`` in kernel
    ``mode`` (default: the policy's), the env sum an f32 sum."""
    mode = mode or prec.kernel_mode(x0T.dtype)
    ns, e = x0T.shape
    nc = e // K
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    x, Y, u = x0T.T, Y_T.T, uT.reshape(e, 1)
    V = pT.T.unsqueeze(-1) * Y.unsqueeze(-2)  # (E, C, D)
    cns, ia, r2 = (weak_scalar(c, x.dtype) for c in (1 / math.sqrt(ns), inv_avg, 1 / math.sqrt(2)))
    for layer in layers:
        w_env = prec.kmm(x, layer["env_weight"].to(x.dtype), mode, cns) * u
        env = (w_env.unsqueeze(-1) * Y.unsqueeze(-2)).reshape(nc, K, *V.shape[1:]).sum(1)
        env_e = (env * ia).unsqueeze(1).expand(nc, K, *V.shape[1:]).reshape(V.shape)
        T = uniform_tp(V, env_e, lmax, parity)
        inv = scalar_part(T)
        V = tp_mix_apply(layer["mix"], T, mode)
        x = (x + mlp_apply(layer["latent_mlp"], torch.cat([x, inv], dim=-1), mode) * u) * r2
    return x.T.contiguous()


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to bf16."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def stack_rounded_reference(x0T, pT, Y_T, uT, layers, K: int, lmax: int,
                            avg_num_neighbors: float, parity: bool,
                            scalars: torch.dtype = torch.bfloat16):
    """The function of K8's bf16 build in plain PyTorch at the operands'
    dtype (f32, fed bf16 values): K1's plain version per layer
    (``fused_layer_reference``: first, middle and last forms) with the
    build's one-pass products (mode 'bf16') and its bf16 constants
    (``scalars``; f32 constants give the function of the body before it
    rounded them, which the card's checks hold apart), x and V rounded to
    bf16 between the layers, where the build's device-memory stores round
    them.  The backward rounds where the build's stores do: the carried
    dx and dV, and before them dx's first-pass share (the residual's and
    the latent MLP's), to which the build adds the env product's in a
    second pass.  Returns x_final (ns, E); the card's parity checks hold
    the bf16 build to it."""
    def r(t):
        return t.to(torch.bfloat16).to(t.dtype)

    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    x, V, n = x0T, pT, len(layers)
    for li, layer in enumerate(layers):
        out = fl.fused_layer_reference(_RoundCotangent.apply(x), V, Y_T, uT,
                                       fl.prepare_layer(layer, lmax, parity), K, inv_avg, li == 0,
                                       li == n - 1, "bf16", scalars, x_env=x)
        if li == n - 1:
            return out
        x, V = r(out[0]), r(out[1])


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def _bind(lib):
    lib.k8_meta_words.argtypes = []
    lib.k8_meta_words.restype = ctypes.c_int
    lib.k8_max_layers.argtypes = []
    lib.k8_max_layers.restype = ctypes.c_int
    lib.k8_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.k8_launch.restype = ctypes.c_int
    lib.k8_layout_bytes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.k8_layout_bytes.restype = ctypes.c_int
    if lib.k8_meta_words() != fl.META_WORDS or lib.k8_max_layers() != MAX_LAYERS:
        raise RuntimeError("kernel table layout or layer limit differs from the wrapper's")


_SOURCES = [CSRC / "fused_stack.cu", CSRC / "allegro_layer.cuh", CSRC / "allegro_mma.cuh",
            CSRC / "allegro_tiles.cuh", CSRC / "mma_ptx.cuh"]
LIB = CudaLibrary("k8_fused_stack", _SOURCES, _bind)
LIB_BF16 = CudaLibrary("k8_fused_stack_bf16", [CSRC / "fused_stack_bf16.cu", *_SOURCES], _bind)
LIB_BF16X3 = CudaLibrary("k8_fused_stack_bf16x3", [CSRC / "fused_stack_bf16x3.cu", *_SOURCES],
                         _bind)
LIB_ONEPASS = CudaLibrary("k8_fused_stack_onepass", [CSRC / "fused_stack_onepass.cu", *_SOURCES],
                          _bind)


# each build's (library, launch counts), looked up at each launch
BUILDS = {"tf32x3": (LIB, launches), "bf16": (LIB_BF16, launches_bf16),
          "bf16x3": (LIB_BF16X3, launches_bf16x3), "onepass": (LIB_ONEPASS, launches_onepass)}

# the launcher's pointer slots (k8_launch in csrc/fused_stack.cu), before
# the six per layer
_PTRS = ("Y", "u", "meta", "x0", "pT", "xo", "xs", "vs", "dxo", "dx", "dvc", "dpT", "dY", "du")


def _launch(bwd: bool, w: K8Weights, ts: dict, K: int, inv_avg: float, build: str):
    """One K8 launch of ``build`` (``fused_layer.build_for``): ``ts`` maps
    _PTRS names to tensors (absent or None names are 0); each layer's
    weights in the build's layout.  Raises on any refusal or launch error;
    counts the launch."""
    meta, ia = fl.launch_scalars(w.k1[0], build, inv_avg)
    ts = {"meta": meta, **ts}
    d, e = ts["Y"].shape
    ptrs = [0 if ts.get(k) is None else ts[k].data_ptr() for k in _PTRS]
    for lw in w.k1:
        ptrs += [t.data_ptr() for t in lw.layout(build)]
    dims = fl.kernel_dims(w.k1[0], d, K, e, True, False) + [len(w.k1)]
    lib, counts = BUILDS[build]
    lib = lib.load()
    arr = (ctypes.c_ulonglong * len(ptrs))(*ptrs)
    dm = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(ts["Y"].device):
        stream = torch.cuda.current_stream(ts["Y"].device).cuda_stream
        rc = lib.k8_launch(int(bwd), arr, dm, ctypes.c_float(ia), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K8 ({build}) {'backward' if bwd else 'forward'} "
                           f"launch failed (code {rc})")
    fl.count(counts, bwd)


def _kernel_fwd(x0T, pT, Y_T, uT, w: K8Weights, K: int, inv_avg: float, mode=None):
    """One forward launch of the build of ``mode`` (default: the policy's)."""
    (d, e), c, L = Y_T.shape, pT.shape[0], len(w.k1)
    build = fl.build_for(x0T.dtype, mode)
    xo = torch.empty_like(x0T)
    vs = torch.empty((d * c, e), dtype=x0T.dtype, device=x0T.device) if L > 1 else None
    _launch(False, w, {"Y": Y_T, "u": uT, "x0": x0T, "pT": pT, "xo": xo, "vs": vs}, K, inv_avg,
            build)
    return xo


def _kernel_bwd(x0T, pT, Y_T, uT, w: K8Weights, K: int, inv_avg: float, dxo, mode=None):
    (ns, e), d, c, L = x0T.shape, Y_T.shape[0], pT.shape[0], len(w.k1)
    dev, dt = x0T.device, x0T.dtype
    stash = {}
    if L > 1:
        stash = {"xs": torch.empty(((L - 1) * ns, e), dtype=dt, device=dev),
                 "vs": torch.empty(((L - 1) * d * c, e), dtype=dt, device=dev),
                 "dvc": torch.empty((d * c, e), dtype=dt, device=dev)}
    dx, dpT, dY, du = (torch.empty_like(t) for t in (x0T, pT, Y_T, uT))
    build = fl.build_for(x0T.dtype, mode)
    _launch(True, w, {"Y": Y_T, "u": uT, "x0": x0T, "pT": pT, "dxo": dxo, "dx": dx, "dpT": dpT,
                      "dY": dY, "du": du, **stash}, K, inv_avg, build)
    return dx, dpT, dY, du


class _FusedStack(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes the layers from (x0, pT, Y, u), as the TPU kernel
    does, and hands back NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, x0T, pT, Y_T, uT, w, K, avg, *weights):
        mode = prec.kernel_mode(x0T.dtype)
        ctx.cfg = (w, K, avg, mode)
        ctx.save_for_backward(x0T, pT, Y_T, uT)
        if x0T.is_cuda:
            return _kernel_fwd(x0T, pT, Y_T, uT, w, K, _inv_avg(avg), mode)
        return allegro_stack_reference(x0T, pT, Y_T, uT, w.tree, K, w.lmax, avg, w.parity, mode)

    @staticmethod
    def backward(ctx, dxo):
        w, K, avg, mode = ctx.cfg
        ins = ctx.saved_tensors
        if ins[0].is_cuda:
            grads = _kernel_bwd(*ins, w, K, _inv_avg(avg), dxo.contiguous(), mode)
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in ins]
                out = allegro_stack_reference(*ins, w.tree, K, w.lmax, avg, w.parity, mode)
                grads = torch.autograd.grad(out, ins, dxo)
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, *nan_w)


def _inv_avg(avg: float) -> float:
    return 1.0 / math.sqrt(max(avg, 1e-6))


def fused_stack(x0T, pT, Y_T, uT, layers, K: int, lmax: int, avg_num_neighbors: float,
                parity: bool):
    """The whole Allegro layer stack on the feature-major TABLE layout:
    x0T (ns, E) the two-body latent (already times u), pT (C, E) the tensor
    embedding (already over sqrt(ns)), Y_T (D, E), uT (1, E), E =
    n_centers * K, ``layers`` the tree's layer list.  Returns x_final (ns,
    E).  CUDA tensors launch K8 (contiguous, all f32, or all bf16 for its
    bf16 build; the launcher refuses a stack it does not take, see
    :func:`kernel_takes`); CPU tensors take :func:`allegro_stack_reference`
    at their dtype."""
    w = stack_weights(layers, lmax, parity)
    ns, e = x0T.shape
    d = (lmax + 1) ** 2
    ns_w, c = w.k1[0].dims[:2]
    if ns_w != ns or K < 1 or e % K:
        raise ValueError(f"fused_stack: ns={ns}, K={K}, E={e} do not fit the layers")
    check_operands("fused_stack", (x0T, pT, Y_T, uT), w.tensors(),
                   {0: (ns, e), 1: (c, e), 2: (d, e), 3: (1, e)})
    return _FusedStack.apply(x0T, pT, Y_T, uT, w, K, avg_num_neighbors, *w.tensors())
