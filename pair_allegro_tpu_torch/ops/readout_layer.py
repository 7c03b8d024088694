"""K7: the readout-fused last Allegro layer (counterpart of
``pair_allegro_tpu/ops/pallas_stack.py:_layer1r_fwd_kernel`` /
``_layer1r_bwd_kernel``, entry ``allegro_layer_readout_fused_t``).

K1's last layer (its last form, ops/fused_layer.py) with the readout head
and the optional charge head as its epilogue, on the feature-major layout of
the TABLE edge list:

  x' = K1's last body (x, V, Y, u);  e = MLP_ro(x') * u  [, q = MLP_q(x') * u]

Returns e_row (1, E), or (e_row, q_row) with the charge head, both already
multiplied by u; the (ns, E) final latent never exists in device memory.  On
a CUDA tensor :func:`readout_layer` launches the kernel pair in
``csrc/embed_readout_layer.cu`` (the library of ops/embed_layer.py), or at
bf16 its bf16 build ``csrc/embed_readout_layer_bf16.cu``; on a CPU tensor it
runs :func:`readout_layer_reference`, the plain PyTorch version, at the
tensors' dtype (at bf16 the heads round as the TPU kernel's do: bf16
constants, the width-1 layer a row sum of bf16 products, ``mlp_apply_t``;
the bf16 build rounds the same, and its f32 oracle on the card passes
``scalars=torch.bfloat16``).  Weight cotangents come back NaN-filled for every leaf
the kernel reads, the heads' included (``pallas_stack.py:1751``).  At f32 the
layer's products follow the matmul precision policy as K1's do (the builds
``embed_readout_layer_bf16x3.cu`` and ``_onepass.cu``); the heads stay
f32-accurate under every policy, as JAX's ``_mm_exact`` keeps them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.ops._build import LaunchCounts
from pair_allegro_tpu_torch.ops.embed_layer import (  # LIB*: K7's, shared with K6
    LIB,
    LIB_BF16,
    LIB_BF16X3,
    LIB_ONEPASS,
    MT_WORDS,
    READOUT,
    check_operands,
    launch,
    mlp_flat,
    mlp_layout,
    mlp_widths_ok,
)
from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops.mlp import mlp_apply_t
from pair_allegro_tpu_torch.ops.weight_cache import LAYOUTS

launches = LaunchCounts("K7.tf32x3")  # the f32 kernel's (K7, 3xTF32 products)
launches_bf16 = LaunchCounts("K7.bf16")  # the bf16 build's (K7)
launches_bf16x3 = LaunchCounts("K7.bf16x3")  # the f32 bf16x3 build's (K7)
launches_onepass = LaunchCounts("K7.onepass")  # the f32 one-pass build's (K7)
# each build's (library, K7 launch counts): K6's libraries
BUILDS = {"tf32x3": (LIB, launches), "bf16": (LIB_BF16, launches_bf16),
          "bf16x3": (LIB_BF16X3, launches_bf16x3), "onepass": (LIB_ONEPASS, launches_onepass)}


def _head_shape(heads_dims):
    """(xmaxw, hzrows) of the heads: their widest hidden layer (4 if none)
    and the rows of the largest pre-activation store."""
    maxws = [max(h[1:-1]) if len(h) > 2 else 4 for h in heads_dims]
    return max(maxws), max((len(h) - 2) * m for h, m in zip(heads_dims, maxws))


def kernel_takes(ns: int, c: int, d: int, latd: tuple, lmax: int, parity: bool,
                 heads_dims: tuple, dtype=torch.float32) -> bool:
    """Whether ``er_launch`` (csrc/embed_readout_layer.cu, or its bf16 build
    embed_readout_layer_bf16.cu) takes K7 at these widths at ``dtype``,
    forward and backward: a build of that dtype, K1's conditions
    (ops/fused_layer.py), the heads' (``heads_dims``: one (ns, hidden...,
    1) per head, one or two) and the shared memory sum with the epilogue's
    rows, mirrored here so that a caller decides before any launch (every
    build's sum is the f32 one, whatever the policy: its tiles are f32)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if not fl.widths_ok(ns, c, c, d, latd, lmax, parity) or not 1 <= len(heads_dims) <= 2:
        return False
    if any(h[0] != ns or not mlp_widths_ok(h, 1) for h in heads_dims):
        return False
    xmaxw, hz = _head_shape(heads_dims)
    return all(fl.block_bytes(ns, c, c, d, latd, lmax, parity, False, bwd, "readout", 0, xmaxw,
                              hz) <= fl.SMEM_MAX for bwd in (False, True))


@dataclasses.dataclass(frozen=True, eq=False)
class K7Weights:
    """The last layer's K1 layout (``layer``) with the epilogue's heads (the
    readout, then the charge head): as the kernel reads them (``ew`` / ``ewT``
    flat ``blocks`` and transposes at ``offs`` of ``end`` floats, ``mt`` one
    MlpTab per head) and as the plain version reads them (``heads``).  Detached copies; ``leaves`` are the
    tree's own tensors (the layer's, then the heads'), which receive the
    (NaN) weight cotangents.  :attr:`packed` holds the bf16 build's
    copies, made at its first launch and replaced with the object when a
    leaf changes (``k7_weights``)."""

    layer: fl.K1Weights
    heads: tuple
    ew: torch.Tensor
    ewT: torch.Tensor
    mt: torch.Tensor
    leaves: tuple
    blocks: tuple
    offs: tuple
    end: int

    @functools.cached_property
    def packed(self) -> dict:
        """The heads' blocks and their transposes pair-packed at half their
        offsets (:func:`mlp_flat`) for the bf16 build; the layer's are
        ``layer.packed``."""
        return {"ew": mlp_flat(self.blocks, self.offs, self.end, build="bf16"),
                "ewT": mlp_flat(self.blocks, self.offs, self.end, transpose=True, build="bf16")}

    @property
    def heads_dims(self) -> tuple:
        return tuple((ws[0].shape[0], *(w.shape[1] for w in ws)) for ws in self.heads)

    def tensors(self):
        return self.leaves


def readout_leaves(params: dict, lmax: int, charges: bool) -> tuple:
    heads = ["readout_mlp"] + (["charge_mlp"] if charges else [])
    return (*fl.layer_leaves(params["layers"][-1], lmax),
            *(w for h in heads for w in params[h]["w"]))


def prepare_readout(params: dict, lmax: int, parity: bool, charges: bool) -> K7Weights:
    """K7's weights (see :class:`K7Weights`) made anew from the tree;
    :func:`k7_weights` is the cached accessor."""
    names = ["readout_mlp"] + (["charge_mlp"] if charges else [])
    heads = tuple(tuple(w.detach() for w in params[h]["w"]) for h in names)
    blocks, offs, tabs, base = [], [], [], 0
    for ws in heads:
        b, tab, _, o, base = mlp_layout(ws, base)
        blocks += b
        offs += o
        tabs.append(tab)
    tabs += [np.zeros(MT_WORDS, np.int32)] * (2 - len(tabs))
    dev = heads[0][0].device
    return K7Weights(
        layer=fl.prepare_layer(params["layers"][-1], lmax, parity),
        heads=heads,
        ew=mlp_flat(blocks, offs, base),
        ewT=mlp_flat(blocks, offs, base, transpose=True),
        mt=torch.from_numpy(np.concatenate(tabs)).to(dev),
        leaves=readout_leaves(params, lmax, charges),
        blocks=tuple(blocks),
        offs=tuple(offs),
        end=base,
    )


def k7_weights(params: dict, lmax: int, parity: bool, charges: bool) -> K7Weights:
    """K7's weights for the tree's leaves as they stand now, made once and
    kept until one is replaced or updated in place (``ops/weight_cache.py``)."""
    return LAYOUTS.get(("k7", lmax, parity, charges), readout_leaves(params, lmax, charges),
                       lambda: prepare_readout(params, lmax, parity, charges))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the oracle of the kernel)
# ---------------------------------------------------------------------------


def readout_layer_reference(xt, Vt, yt, ut, w: K7Weights, K: int, inv_avg: float, scalars=None,
                            mode: str | None = None):
    """The same function as the kernel in plain PyTorch: xt (ns, E), Vt (D,
    C, E), yt (D, E), ut (1, E) -> e_row (1, E) or (e_row, q_row); goes
    through torch autograd.  The constants round as JAX's do at the dtype
    ``scalars`` (default: the operands'; ``mlp.mlp_apply_t``); the layer's
    products are in kernel ``mode`` (default: the policy's), the heads'
    f32-accurate under every mode (JAX's ``_mm_exact``)."""
    sd = scalars or xt.dtype
    xf = fl.fused_layer_reference(xt, Vt, yt, ut, w.layer, K, inv_avg, False, True, mode, sd)
    rows = tuple(mlp_apply_t({"w": ws}, xf, sd) * ut for ws in w.heads)
    return rows if len(rows) > 1 else rows[0]


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/embed_readout_layer.cu, form READOUT)
# ---------------------------------------------------------------------------


def _extra(w: K7Weights) -> list:
    return [0, *_head_shape(w.heads_dims), len(w.heads), 0]


def _heads(w: K7Weights, build: str) -> dict:
    """The heads' pointers: f32 in every f32 build (3xTF32, as JAX's
    ``_mm_exact``), pair-packed in the bf16 build."""
    src = w.packed if build == "bf16" else {"ew": w.ew, "ewT": w.ewT}
    return {"mt": w.mt, "ew": src["ew"], "ewT": src["ewT"]}


def _kernel_fwd(xt, Vt, yt, ut, w: K7Weights, K, inv_avg, mode=None):
    """One forward launch of the build of ``mode`` (default: the policy's)."""
    d, e = yt.shape
    build = fl.build_for(xt.dtype, mode)
    rows = [torch.empty_like(ut) for _ in w.heads]
    ts = {"x": xt, "V": Vt, "Y": yt, "u": ut, **_heads(w, build),
          **{f"ho{h}": r for h, r in enumerate(rows)}}
    launch(READOUT, False, w.layer, ts, d, K, e, _extra(w), inv_avg, BUILDS, xt.device, build)
    return tuple(rows) if len(rows) > 1 else rows[0]


def _kernel_bwd(xt, Vt, yt, ut, w: K7Weights, K, inv_avg, cots, mode=None):
    d, e = yt.shape
    build = fl.build_for(xt.dtype, mode)
    dx, dV, dY, du = (torch.empty_like(t) for t in (xt, Vt, yt, ut))
    ts = {"x": xt, "V": Vt, "Y": yt, "u": ut, **_heads(w, build), "dx": dx, "dV": dV, "dY": dY,
          "du": du, **{f"dh{h}": c for h, c in enumerate(cots)}}
    launch(READOUT, True, w.layer, ts, d, K, e, _extra(w), inv_avg, BUILDS, xt.device, build)
    return dx, dV, dY, du


class _ReadoutLayer(torch.autograd.Function):
    """Kernel (CUDA tensors) or plain version (CPU tensors) forward; the
    backward recomputes the layer and the heads from (x, V, Y, u), as the
    TPU kernel does, takes the rows' cotangents and hands back NaN-filled
    weight cotangents."""

    @staticmethod
    def forward(ctx, xt, Vt, yt, ut, w, K, inv_avg, *weights):
        mode = prec.kernel_mode(xt.dtype)
        ctx.cfg = (w, K, inv_avg, mode)
        ctx.save_for_backward(xt, Vt, yt, ut)
        if xt.is_cuda:
            return _kernel_fwd(xt, Vt, yt, ut, w, K, inv_avg, mode)
        return readout_layer_reference(xt, Vt, yt, ut, w, K, inv_avg, mode=mode)

    @staticmethod
    def backward(ctx, *cots):
        w, K, inv_avg, mode = ctx.cfg
        xt, Vt, yt, ut = ctx.saved_tensors
        if xt.is_cuda:
            grads = _kernel_bwd(xt, Vt, yt, ut, w, K, inv_avg, [c.contiguous() for c in cots],
                                mode)
        else:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (xt, Vt, yt, ut)]
                out = readout_layer_reference(*ins, w, K, inv_avg, mode=mode)
                outs = out if isinstance(out, tuple) else (out,)
                grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
        nan_w = [torch.full_like(t, float("nan")) for t in w.tensors()]
        return (*grads, None, None, None, *nan_w)


def readout_layer(xt, Vt, yt, ut, w: K7Weights, K: int, avg_num_neighbors: float):
    """The last Allegro layer with the readout (and charge) head fused in:
    xt (ns, E), Vt (D, C, E), yt (D, E), ut (1, E), E = n_centers * K.
    Returns e_row (1, E), or (e_row, q_row) with the charge head, both
    multiplied by u.  CUDA tensors launch K7 (all f32, or all bf16 for its
    bf16 build); CPU tensors take :func:`readout_layer_reference` at their
    dtype."""
    ns, e = xt.shape
    d = yt.shape[0]
    c = w.layer.env_w.shape[1]
    if w.layer.env_w.shape[0] != ns or d != (w.layer.lmax + 1) ** 2 or K < 1 or e % K:
        raise ValueError(f"readout_layer: ns={ns}, D={d}, K={K}, E={e} do not fit the layer")
    check_operands("readout_layer", (xt, Vt, yt, ut), w.tensors(),
                   {1: (d, c, e), 2: (d, e), 3: (1, e)})
    inv_avg = 1.0 / math.sqrt(max(avg_num_neighbors, 1e-6))
    return _ReadoutLayer.apply(xt, Vt, yt, ut, w, K, inv_avg, *w.tensors())
