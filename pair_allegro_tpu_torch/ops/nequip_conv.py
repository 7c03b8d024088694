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
plain PyTorch version of the same function.  What bounds the kernel on the
card and what its design does about it is written at the top of the CUDA
source.  Weight cotangents come back NaN-filled, the contract of the TPU
kernel (``pallas_nequip.py:645-647``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from pair_allegro_tpu_torch.ops._build import CSRC, CudaLibrary, LaunchCounts
from pair_allegro_tpu_torch.ops.mlp import mlp_apply
from pair_allegro_tpu_torch.ops.tp import tp_entry_table, tp_num_paths

HEADER = CSRC / "nequip_tp_table.cuh"
_MAX_W = 8  # radial MLP weight matrices the kernel takes (K3P::wdim in the source)
NT_MAX, SMEM_MAX = 256, 232448  # the launcher's threads per block and shared-memory limit

launches = LaunchCounts()


@dataclasses.dataclass(frozen=True, eq=False)
class K3Weights:
    """One layer's radial MLP in the kernel's layout, made by
    :func:`prepare_radial` at every call of the model: ``ws`` [(in, out), ...]
    with the last weight's columns channels-last ((tau*P + p)*C + c), the
    tensors autograd sees; ``flat`` all of them concatenated row-major and
    ``lastT`` the last weight transposed (for the backward), detached copies
    that only the kernel reads."""

    ws: tuple
    flat: torch.Tensor
    lastT: torch.Tensor
    C: int
    n_tracks: int
    lmax: int

    @property
    def dims(self) -> list[int]:
        return [self.ws[0].shape[0]] + [w.shape[1] for w in self.ws]

    def tensors(self):
        return self.ws


def kernel_takes(C: int, n_tracks: int, lmax: int, dims) -> bool:
    """Whether K3 takes a layer of C channels, ``n_tracks`` tracks and a
    radial MLP of widths ``dims`` (Bessels, hidden..., T*P*C), forward and
    backward: the wrapper's channel and width conditions, ``k3_launch``'s
    refusals (csrc/nequip_conv.cu) and its shared-memory sum, mirrored here
    so that a caller decides before any launch."""
    nw = len(dims) - 1
    if lmax not in (1, 2) or n_tracks not in (1, 2) or not 1 <= nw <= _MAX_W or min(dims) < 1:
        return False
    if not ((C % 32 == 0 and C <= 128) or C in (4, 8, 16)) or dims[-2] % 4:
        return False
    tp = n_tracks * tp_num_paths(lmax)
    if dims[-1] != tp * C:
        return False
    d = (lmax + 1) ** 2
    q = NT_MAX // C
    et = q * (4 if tp <= 16 else 2)  # edges per tile: Q * NE
    hin, hmax = dims[-2], max(dims[:-1])

    def words(n):  # the launcher's 16-byte aligned regions
        return -(-n // 4) * 4

    for bwd in (False, True):
        total = words(et * dims[0]) + 2 * words(et * hmax) + words(et * d) + words(et)
        if bwd:
            nb = (et // 4) * (hin // 4)
            nch = 1 if nb >= NT_MAX else NT_MAX // nb
            total += (words((nw - 1) * et * hmax) + words(et * (tp * C + 4)) + words(et * d)
                      + words(et) + words(nch * et * hin))
        else:
            total += words(q * d * n_tracks * C)
        if 4 * total > SMEM_MAX:
            return False
    return True


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
    return K3Weights(
        ws=ws,
        flat=torch.cat([w.detach().reshape(-1) for w in ws]),
        lastT=ws[-1].detach().T.contiguous(),
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


def nequip_conv_reference(hj, bessel, u, Y, w: K3Weights, K: int, inv_avg: float):
    """The same function as the kernel, in plain PyTorch on the same layout:
    hj (E, D*T*C), bessel (E, B), u (E, 1), Y (E, D) -> agg (E / K, D*T*C).
    Goes through torch autograd."""
    e = hj.shape[0]
    C, T, lmax = w.C, w.n_tracks, w.lmax
    D, P = (lmax + 1) ** 2, tp_num_paths(lmax)
    wr = mlp_apply({"w": w.ws}, bessel) * u
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
    if lib.k3_max_weights() != _MAX_W:
        raise RuntimeError("kernel weight table size differs from the wrapper's")


LIB = CudaLibrary("k3_nequip_conv", [CSRC / "nequip_conv.cu", HEADER], _bind)


def _launch(bwd: bool, w: K3Weights, K: int, E: int, inv_avg: float, ptrs, device):
    lib = LIB.load()
    dims = w.dims
    dm = (ctypes.c_int * (4 + _MAX_W + 1))(w.C, K, E, len(w.ws), *dims,
                                           *([0] * (_MAX_W + 1 - len(dims))))
    arr = (ctypes.c_ulonglong * 12)(*ptrs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.k3_launch(int(bwd), w.lmax, w.n_tracks, arr, dm, ctypes.c_float(inv_avg),
                           ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K3 {'backward' if bwd else 'forward'} launch failed (code {rc})")
    if bwd:
        launches.bwd += 1
    else:
        launches.fwd += 1


def _kernel_fwd(hj, bessel, u, Y, w: K3Weights, K: int, inv_avg: float):
    e, df = hj.shape
    agg = torch.empty((e // K, df), dtype=hj.dtype, device=hj.device)
    ptrs = [hj.data_ptr(), bessel.data_ptr(), u.data_ptr(), Y.data_ptr(), w.flat.data_ptr(),
            w.lastT.data_ptr(), 0, agg.data_ptr(), 0, 0, 0, 0]
    _launch(False, w, K, e, inv_avg, ptrs, hj.device)
    return agg


def _kernel_bwd(hj, bessel, u, Y, w: K3Weights, K: int, inv_avg: float, dagg):
    dhj = torch.empty_like(hj)
    dbes = torch.empty_like(bessel)
    du = torch.empty_like(u)
    dY = torch.empty_like(Y)
    ptrs = [hj.data_ptr(), bessel.data_ptr(), u.data_ptr(), Y.data_ptr(), w.flat.data_ptr(),
            w.lastT.data_ptr(), dagg.data_ptr(), 0, dhj.data_ptr(), dbes.data_ptr(),
            du.data_ptr(), dY.data_ptr()]
    _launch(True, w, K, hj.shape[0], inv_avg, ptrs, hj.device)
    return dhj, dbes, du, dY


class _Conv(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes the radial MLP from (bessel, u), as the TPU kernel
    does, and hands back NaN-filled weight cotangents."""

    @staticmethod
    def forward(ctx, hj, bessel, u, Y, w, K, inv_avg, *weights):
        ctx.cfg = (w, K, inv_avg)
        ctx.save_for_backward(hj, bessel, u, Y)
        if hj.is_cuda:
            return _kernel_fwd(hj, bessel, u, Y, w, K, inv_avg)
        return nequip_conv_reference(hj, bessel, u, Y, w, K, inv_avg)

    @staticmethod
    def backward(ctx, dagg):
        w, K, inv_avg = ctx.cfg
        hj, bessel, u, Y = ctx.saved_tensors
        if hj.is_cuda:
            grads = _kernel_bwd(hj, bessel, u, Y, w, K, inv_avg, dagg.contiguous())
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (hj, bessel, u, Y)]
                out = nequip_conv_reference(*ins, w, K, inv_avg)
                grads = torch.autograd.grad(out, ins, dagg)
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, *nan_w)


def nequip_conv(hj, bessel, u, Y, w: K3Weights, K: int, avg_num_neighbors: float):
    """One NequIP convolution on the edge-major TABLE layout.

    hj (E, D*T*C) the gathered neighbor rows, lanes (d*T + tau)*C + c;
    bessel (E, B) = bessel_basis(r) * u; u (E, 1); Y (E, D); E = N * K.
    Returns agg (N, D*T*C).  CUDA tensors launch the kernel (f32 and
    contiguous only); CPU tensors take :func:`nequip_conv_reference`."""
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
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError("nequip_conv: the CUDA kernel takes float32 tensors only")
        if any(not t.is_contiguous() for t in (hj, bessel, u, Y)):
            raise ValueError("nequip_conv: CUDA inputs must be contiguous")
        if not ((C % 32 == 0 and C <= 128) or C in (4, 8, 16)) or w.dims[-2] % 4:
            raise ValueError(f"nequip_conv: the CUDA kernel takes C in 4, 8, 16 or a multiple of 32 "
                             f"up to 128, and a last radial input width that is a multiple of 4 "
                             f"(C={C}, width {w.dims[-2]})")
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _Conv.apply(hj, bessel, u, Y, w, K, inv_avg, *w.tensors())
