"""K3: the fused NequIP convolution (counterpart of
``pair_allegro_tpu/ops/pallas_nequip.py:_conv_fwd_kernel`` /
``_conv_bwd_kernel``, entry ``nequip_conv_fused``).

One call computes one message-passing layer's messages and their per-center
sum on the edge-major TABLE layout (E = n_centers * K rows, each center's K
edge rows contiguous; lanes channel-minor):

  w    = radial_MLP(bessel) * u                    (E, T*P*C), lanes (tau*P + p)*C + c
  msg  = channelwise TP of hj with Y, weighted by w, routed to track
         tau = pi XOR (l2 mod 2)                   (E, D*T*C), lanes (d*T + tau)*C + c
  agg  = per-center sum of msg / sqrt(avg_n)       (N, D*T*C)

``bessel`` is already bessel_basis(r) * u, and the MLP output is multiplied
by u again (both envelope factors of the JAX model); the kernel's ``du`` is
the gradient of the second factor only.

On a CUDA tensor :func:`nequip_conv` launches the hand-written Hopper kernel
pair in ``csrc/nequip_conv.cu`` (built with ``nvcc`` at first use, bound
with ``ctypes``); on a CPU tensor it runs :func:`nequip_conv_reference`, the
plain PyTorch version of the same function.

Dtypes: every operand is f32, except that ``hj`` may be bf16 (the
``PAT_NEQUIP_HJ=bf16`` boundary, ``models/nequip.py``): the kernel's bf16
build ``csrc/nequip_conv_bf16.cu`` reads it as bf16 and upcasts it in
registers, computes in f32 and returns an f32 ``agg``; its backward returns
``dhj`` at hj's dtype, bf16, and the rest at f32.  The plain version
upcasts hj the same way.  What bounds the kernel on the
card and what its design does about it is written at the top of the CUDA
source.

The radial MLP's products follow the matmul precision policy
(``ops/prec.py``), as JAX's ``pallas_nequip._dot`` / ``_dot_t`` do: the
call's :func:`prec.kernel_mode` of the radial activations' dtype (f32, for
either hj) picks the build, ``tf32x3`` (``nequip_conv.cu``), ``bf16x3``
(``nequip_conv_bf16x3.cu``) or one pass (``nequip_conv_onepass.cu``; with a
bf16 hj ``nequip_conv_bf16_{bf16x3,onepass}.cu``), each splitting or
rounding its operands as they load, and the plain version computes the
same mode's products (``mlp_apply(..., mode=)``).  The forward fixes the
mode its backward uses.  The per-center sum is an f32 sum under every
policy.  Weight cotangents come back NaN-filled, the contract of the TPU
kernel (``pallas_nequip.py:645-647``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.fused_layer import build_for, count
from pair_allegro_tpu_torch.ops.mlp import mlp_apply
from pair_allegro_tpu_torch.ops.tp import tp_entry_table, tp_num_paths

HEADER = CSRC / "nequip_tp_table.cuh"
_MAX_W = 8  # radial MLP weight matrices the kernel takes (K3P::wdim in the source)
# the launcher's threads per block and shared-memory limit, and the edge
# tiles it tries, widest first (csrc/nequip_conv.cu: NT, SMEM_MAX, ET_FWD,
# ET_BWD)
NT, SMEM_MAX = 256, 232448
ET_FWD, ET_BWD = (64, 32, 16, 8), (128, 64, 32, 16, 8)

launches = LaunchCounts("K3.tf32x3")  # the f32-hj 3xTF32 build's
launches_bf16 = LaunchCounts("K3.bf16hj.tf32x3")  # the bf16-hj 3xTF32 build's
launches_bf16x3 = LaunchCounts("K3.bf16x3")  # the f32-hj bf16x3 build's
launches_onepass = LaunchCounts("K3.onepass")  # the f32-hj one-pass build's
launches_bf16_bf16x3 = LaunchCounts("K3.bf16hj.bf16x3")  # the bf16-hj bf16x3 build's
launches_bf16_onepass = LaunchCounts("K3.bf16hj.onepass")  # the bf16-hj one-pass build's


@dataclasses.dataclass(frozen=True, eq=False)
class K3Weights:
    """One layer's radial MLP in the kernel's layout, made by
    :func:`prepare_radial` at every call of the model: ``ws`` [(in, out), ...]
    with the last weight's columns channels-last ((tau*P + p)*C + c), the
    tensors autograd sees; ``flat`` all of them concatenated row-major and
    ``last`` the last one 16-byte aligned (the kernel stages it with
    cp.async), detached copies that only the kernel reads."""

    ws: tuple
    flat: torch.Tensor
    last: torch.Tensor
    C: int
    n_tracks: int
    lmax: int

    @property
    def dims(self) -> list[int]:
        return [self.ws[0].shape[0]] + [w.shape[1] for w in self.ws]

    def tensors(self):
        return self.ws


def widths_ok(C: int, dims) -> bool:
    """The wrapper's and the launcher's width conditions: C in 4, 8, 16 or a
    multiple of 32 up to 128, and a last radial input width that is a
    multiple of 4."""
    return ((C % 32 == 0 and C <= 128) or C in (4, 8, 16)) and dims[-2] % 4 == 0


def _r8(x: int) -> int:
    return -(-x // 8) * 8


def block_layout(C: int, n_tracks: int, lmax: int, dims, bwd: bool):
    """The launcher's pick (``k3_plan`` in csrc/nequip_conv.cu): the widest
    edge tile of ET_FWD / ET_BWD whose block fits SMEM_MAX with the last
    radial weight resident in shared memory, else the widest without it.
    Returns (bytes, edge tile, resident), or None where nothing fits.  The
    block holds, in 16-byte aligned regions of floats: the weight (r8(hin)
    rows at a row stride of 8 mod 32), the bessel tile, the activation
    tiles xa and xb (forward: xa with a hidden layer, xb with two;
    backward: xa always, xb with a hidden layer), the backward's
    pre-activations, Y, u, and the forward's channel sums per edge group;
    the tiles feature-major at row stride et + 8 (8 at et = 8)."""
    d = (lmax + 1) ** 2
    tpc = n_tracks * tp_num_paths(lmax) * C
    nw, hin = len(dims) - 1, dims[-2]
    hmax8 = _r8(max(dims[:-1]))
    sa = (tpc + 23) // 32 * 32 + 8
    wo = min(-(-C // 8), NT // 32)
    we = NT // 32 // wo
    for resident in (True, False):
        for et in ET_BWD if bwd else ET_FWD:
            ldx = et + 8 if et > 8 else 8
            regions = (
                _r8(hin) * sa if resident else 0,
                _r8(dims[0]) * ldx,
                hmax8 * ldx if bwd or nw > 1 else 0,
                hmax8 * ldx if nw > 2 or (bwd and nw > 1) else 0,
                (nw - 1) * hmax8 * ldx if bwd else 0,
                et * d,
                et,
                0 if bwd else we * d * n_tracks * C,
            )
            nbytes = 4 * sum(-(-r // 4) * 4 for r in regions)
            if nbytes <= SMEM_MAX:
                return nbytes, et, resident
    return None


def kernel_takes(C: int, n_tracks: int, lmax: int, dims) -> bool:
    """Whether K3 takes a layer of C channels, ``n_tracks`` tracks and a
    radial MLP of widths ``dims`` (Bessels, hidden..., T*P*C), forward and
    backward: the wrapper's channel and width conditions (``widths_ok``),
    ``k3_plan``'s refusals (csrc/nequip_conv.cu) and its layouts
    (``block_layout``), mirrored here so that a caller decides before any
    launch.  Every build of the policy's modes keeps the f32 weights and
    tiles (it splits or rounds operands as they load), so the answer does
    not depend on the policy."""
    nw = len(dims) - 1
    if lmax not in (1, 2) or n_tracks not in (1, 2) or not 1 <= nw <= _MAX_W or min(dims) < 1:
        return False
    if not widths_ok(C, dims) or dims[-1] != n_tracks * tp_num_paths(lmax) * C:
        return False
    return all(block_layout(C, n_tracks, lmax, dims, bwd) for bwd in (False, True))


def radial_cl(ws, C: int, p_total: int, n_tracks: int) -> list:
    """The stored radial weights with the last one's columns permuted from
    the c-major packing (c*T*P + tau*P + p) to channels-last
    ((tau*P + p)*C + c), as ``models/nequip.py:_radial_cl``."""
    wf = ws[-1]
    width = wf.shape[0]
    wf = wf.reshape(width, C, n_tracks * p_total).transpose(1, 2).reshape(width, -1)
    return [*ws[:-1], wf.contiguous()]


def prepare_radial(ws_cl, C: int, n_tracks: int, lmax: int) -> K3Weights:
    """Kernel-layout radial weights of one layer from its channels-last
    weights (see :class:`K3Weights`)."""
    if len(ws_cl) > _MAX_W:
        raise ValueError(f"radial MLP with {len(ws_cl)} weights exceeds the kernel's {_MAX_W}")
    want = n_tracks * tp_num_paths(lmax) * C
    if ws_cl[-1].shape[1] != want:
        raise ValueError(f"radial MLP output {ws_cl[-1].shape[1]} != T*P*C = {want}")
    ws = tuple(w.contiguous() for w in ws_cl)
    last = ws[-1].detach()
    return K3Weights(
        ws=ws,
        flat=torch.cat([w.detach().reshape(-1) for w in ws]),
        last=last if last.data_ptr() % 16 == 0 else last.clone(),
        C=C,
        n_tracks=n_tracks,
        lmax=lmax,
    )


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def msg_generic_cl(hj, Y, w, lmax: int):
    """The entry-table message, channels-last: hj (..., D, T, C), Y (..., D),
    w (..., T, P, C) -> (..., D, T, C).  Routing tau = pi XOR (l2 mod 2) for
    T = 2 (tau = 0 for T = 1), norm 1/sqrt(paths into l3): the contraction
    of ``models/nequip.py:_msg_generic_{single,parity}_cl``."""
    T = hj.shape[-2]
    blocks = []
    for l3, (n_paths, rows) in enumerate(tp_entry_table(lmax)):
        norm = 1.0 / math.sqrt(max(n_paths, 1))
        for k in range(2 * l3 + 1):
            accs = [None] * T
            for pg, _l1, l2, entries in rows:
                for pi in range(T):
                    tau = pi ^ (l2 % 2) if T == 2 else 0
                    t = None
                    for d1, d2, kk, c in entries:
                        if kk != k:
                            continue
                        term = (c * hj[..., d1, pi, :]) * Y[..., d2, None]
                        t = term if t is None else t + term
                    if t is None:
                        continue
                    contrib = w[..., pi, pg, :] * t
                    accs[tau] = contrib if accs[tau] is None else accs[tau] + contrib
            zero = torch.zeros_like(hj[..., 0, 0, :])
            blocks.append(torch.stack([a * norm if a is not None else zero for a in accs], dim=-2))
    return torch.stack(blocks, dim=-3)


def nequip_conv_reference(hj, bessel, u, Y, w: K3Weights, K: int, inv_avg: float,
                          mode: str | None = None):
    """The same function as the kernel, in plain PyTorch on the same layout:
    hj (E, D*T*C), bessel (E, B), u (E, 1), Y (E, D) -> agg (E / K, D*T*C).
    A bf16 hj is upcast once to bessel's dtype, as the kernel does (its
    cotangent then comes back at bf16).  The radial MLP's products are
    ``prec.kmm`` in kernel ``mode`` (default: the policy's for bessel's
    dtype), so its backward splits the cotangent as it stands and scales
    after, as JAX's ``_dot_t(g, w) * scale``; the per-center sum is an f32
    sum.  Goes through torch autograd."""
    mode = mode or prec.kernel_mode(bessel.dtype)
    e = hj.shape[0]
    hj = hj.to(bessel.dtype)
    C, T, lmax = w.C, w.n_tracks, w.lmax
    D, P = (lmax + 1) ** 2, tp_num_paths(lmax)
    wr = mlp_apply({"w": w.ws}, bessel, mode) * u
    msg = msg_generic_cl(hj.reshape(e, D, T, C), Y, wr.reshape(e, T, P, C), lmax)
    return msg.reshape(e // K, K, D * T * C).sum(dim=1) * inv_avg


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def tp_table_header() -> str:
    """The text of ``csrc/nequip_tp_table.cuh``: for l_max 1 and 2, the
    entry table as an X-macro X(d1, d2, d3, p, l2 odd, coefficient / sqrt(paths
    into l3)), so that the kernel's TP unrolls with constant indices."""
    lines = [
        "// The NequIP tensor-product entry tables of the K3 kernel (nequip_conv.cu).",
        "// Generated by pair_allegro_tpu_torch/ops/nequip_conv.py:tp_table_header()",
        "// from ops/tp.py:tp_entry_table; tests/test_torch_port_nequip_conv.py checks",
        "// that this file is what the generator writes.",
        "//",
        "// X(d1, d2, d3, p, l2_odd, c): msg[d3, tau] += c * w[pi, p] * hj[d1, pi] * Y[d2]",
        "// with tau = pi XOR l2_odd (two tracks) and c = 3j coefficient / sqrt(P_l3).",
        "#pragma once",
        "",
    ]
    for lmax in (1, 2):
        lines.append(f"#define K3_P_L{lmax} {tp_num_paths(lmax)}")
        lines.append(f"#define K3_TP_ENTRIES_L{lmax}(X) \\")
        for l3, (n_paths, rows) in enumerate(tp_entry_table(lmax)):
            norm = 1.0 / math.sqrt(max(n_paths, 1))
            for pg, _l1, l2, entries in rows:
                for d1, d2, k, c in entries:
                    lines.append(f"  X({d1}, {d2}, {l3 * l3 + k}, {pg}, {l2 % 2}, {c * norm!r}f) \\")
        lines.append("")
    return "\n".join(lines) + "\n"


def _bind(lib):
    lib.k3_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
        ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_void_p,
    ]
    lib.k3_launch.restype = ctypes.c_int
    lib.k3_max_weights.argtypes = []
    lib.k3_max_weights.restype = ctypes.c_int
    lib.k3_layout_of.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.k3_layout_of.restype = ctypes.c_int
    if lib.k3_max_weights() != _MAX_W:
        raise RuntimeError("kernel weight table size differs from the wrapper's")


_HEADERS = [HEADER, CSRC / "mma_ptx.cuh"]
LIB = CudaLibrary("k3_nequip_conv", [CSRC / "nequip_conv.cu", *_HEADERS], _bind)
LIB_BF16, LIB_BF16X3, LIB_ONEPASS, LIB_BF16_BF16X3, LIB_BF16_ONEPASS = (
    CudaLibrary(f"k3_nequip_conv_{b}", [CSRC / f"nequip_conv_{b}.cu", CSRC / "nequip_conv.cu",
                                        *_HEADERS], _bind)
    for b in ("bf16", "bf16x3", "onepass", "bf16_bf16x3", "bf16_onepass"))

# each build's (library, launch counts) by (hj's dtype, fused_layer.build_for
# of the radial activations' mode), looked up at each launch
BUILDS = {
    (torch.float32, "tf32x3"): (LIB, launches),
    (torch.float32, "bf16x3"): (LIB_BF16X3, launches_bf16x3),
    (torch.float32, "onepass"): (LIB_ONEPASS, launches_onepass),
    (torch.bfloat16, "tf32x3"): (LIB_BF16, launches_bf16),
    (torch.bfloat16, "bf16x3"): (LIB_BF16_BF16X3, launches_bf16_bf16x3),
    (torch.bfloat16, "onepass"): (LIB_BF16_ONEPASS, launches_bf16_onepass),
}


def build_of(hj_dtype: torch.dtype, mode: str | None = None) -> tuple:
    """The BUILDS key of a launch with hj at ``hj_dtype`` in kernel
    ``mode`` (default: the policy's for the f32 radial activations)."""
    return hj_dtype, build_for(torch.float32, mode)


def launch_dims(w: K3Weights, K: int, E: int):
    """The ``dims`` array of ``k3_launch`` / ``k3_layout_of``."""
    dims = w.dims
    return (ctypes.c_int * (4 + _MAX_W + 1))(w.C, K, E, len(w.ws), *dims,
                                             *([0] * (_MAX_W + 1 - len(dims))))


def _launch(bwd: bool, w: K3Weights, K: int, E: int, inv_avg: float, ptrs, device, build):
    lib, counts = BUILDS[build]
    lib = lib.load()
    dm = launch_dims(w, K, E)
    arr = (ctypes.c_ulonglong * 12)(*ptrs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.k3_launch(int(bwd), w.lmax, w.n_tracks, arr, dm, ctypes.c_float(inv_avg),
                           ctypes.c_void_p(stream))
    if rc != 0:
        hjs = " bf16-hj" if build[0] == torch.bfloat16 else ""
        raise RuntimeError(f"K3{hjs} ({build[1]}) {'backward' if bwd else 'forward'} "
                           f"launch failed (code {rc})")
    count(counts, bwd)


def _kernel_fwd(hj, bessel, u, Y, w: K3Weights, K: int, inv_avg: float, mode=None):
    """One forward launch of the build of hj's dtype and ``mode``
    (default: the policy's)."""
    e, df = hj.shape
    agg = torch.empty((e // K, df), dtype=bessel.dtype, device=hj.device)
    ptrs = [hj.data_ptr(), bessel.data_ptr(), u.data_ptr(), Y.data_ptr(), w.flat.data_ptr(),
            w.last.data_ptr(), 0, agg.data_ptr(), 0, 0, 0, 0]
    _launch(False, w, K, e, inv_avg, ptrs, hj.device, build_of(hj.dtype, mode))
    return agg


def _kernel_bwd(hj, bessel, u, Y, w: K3Weights, K: int, inv_avg: float, dagg, mode=None):
    """One backward launch of the build of hj's dtype and ``mode``
    (default: the policy's)."""
    dhj = torch.empty_like(hj)
    dbes = torch.empty_like(bessel)
    du = torch.empty_like(u)
    dY = torch.empty_like(Y)
    ptrs = [hj.data_ptr(), bessel.data_ptr(), u.data_ptr(), Y.data_ptr(), w.flat.data_ptr(),
            w.last.data_ptr(), dagg.data_ptr(), 0, dhj.data_ptr(), dbes.data_ptr(),
            du.data_ptr(), dY.data_ptr()]
    _launch(True, w, K, hj.shape[0], inv_avg, ptrs, hj.device, build_of(hj.dtype, mode))
    return dhj, dbes, du, dY


class _Conv(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes the radial MLP from (bessel, u), as the TPU kernel
    does, and hands back NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, hj, bessel, u, Y, w, K, inv_avg, *weights):
        mode = prec.kernel_mode(bessel.dtype)
        ctx.cfg = (w, K, inv_avg, mode)
        ctx.save_for_backward(hj, bessel, u, Y)
        if hj.is_cuda:
            return _kernel_fwd(hj, bessel, u, Y, w, K, inv_avg, mode)
        return nequip_conv_reference(hj, bessel, u, Y, w, K, inv_avg, mode)

    @staticmethod
    def backward(ctx, dagg):
        w, K, inv_avg, mode = ctx.cfg
        hj, bessel, u, Y = ctx.saved_tensors
        if hj.is_cuda:
            grads = _kernel_bwd(hj, bessel, u, Y, w, K, inv_avg, dagg.contiguous(), mode)
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (hj, bessel, u, Y)]
                out = nequip_conv_reference(*ins, w, K, inv_avg, mode)
                grads = torch.autograd.grad(out, ins, dagg)
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, *nan_w)


def nequip_conv(hj, bessel, u, Y, w: K3Weights, K: int, avg_num_neighbors: float):
    """One NequIP convolution on the edge-major TABLE layout.

    hj (E, D*T*C) the gathered neighbor rows, lanes (d*T + tau)*C + c;
    bessel (E, B) = bessel_basis(r) * u; u (E, 1); Y (E, D); E = N * K.
    Returns agg (N, D*T*C), f32.  CUDA tensors launch the kernel
    (contiguous, every operand f32 but hj, which may be bf16: the bf16-hj
    build); CPU tensors take :func:`nequip_conv_reference`."""
    C, T, lmax = w.C, w.n_tracks, w.lmax
    d = (lmax + 1) ** 2
    e = hj.shape[0]
    want = {"hj": (e, d * T * C), "bessel": (e, w.dims[0]), "u": (e, 1), "Y": (e, d)}
    got = {"hj": hj, "bessel": bessel, "u": u, "Y": Y}
    bad = {k: tuple(t.shape) for k, t in got.items() if tuple(t.shape) != want[k]}
    if bad:
        raise ValueError(f"nequip_conv shapes {bad}, want {want}")
    if K < 1 or e % K:
        raise ValueError(f"nequip_conv: E={e} is not a multiple of K={K}")
    ts = (hj, bessel, u, Y, *w.tensors())
    if any(t.device != hj.device for t in ts):
        raise ValueError("nequip_conv: all tensors must be on one device")
    if hj.is_cuda:
        if hj.dtype not in (torch.float32, torch.bfloat16) or any(
                t.dtype != torch.float32 for t in ts[1:]):
            raise TypeError("nequip_conv: the CUDA kernel takes float32 tensors, and hj in "
                            "float32 or bfloat16")
        if any(not t.is_contiguous() for t in (hj, bessel, u, Y)):
            raise ValueError("nequip_conv: CUDA inputs must be contiguous")
        if hj.data_ptr() % 8:  # the kernel reads hj as pairs of channels
            hj = hj.clone()
        if not widths_ok(C, w.dims):
            raise ValueError(f"nequip_conv: the CUDA kernel takes C in 4, 8, 16 or a multiple of 32 "
                             f"up to 128, and a last radial input width that is a multiple of 4 "
                             f"(C={C}, width {w.dims[-2]})")
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _Conv.apply(hj, bessel, u, Y, w, K, inv_avg, *w.tensors())
