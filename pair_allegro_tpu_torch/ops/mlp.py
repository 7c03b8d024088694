"""Normalized bias-free SiLU MLPs (counterpart of ``pair_allegro_tpu/ops/mlp.py``).

Parameters keep the JAX layout: ``{"w": [W0, W1, ...]}`` with W_i of shape
(in, out); each layer scales by 1/sqrt(fan_in) at run time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch.ops import prec


def silu_norm_const() -> float:
    """1/sqrt(E[silu(x)^2]) for x ~ N(0, 1)."""
    return 1.6790564307512243


def weak_scalar(s: float, dtype: torch.dtype) -> float:
    """The Python float ``s`` as JAX applies it to a value of ``dtype``: a
    weakly typed scalar takes the value's dtype, so at a 16-bit float it is
    rounded to it first (torch would apply it at f32, its op math); at any
    other dtype ``s`` itself."""
    if dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(s, dtype=dtype))
    return s


def mlp_apply(params: dict, x: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    """x (batch, in) -> (batch, out); hidden layers silu * const.  The
    constants round as JAX's do at x's dtype (:func:`weak_scalar`); the
    products are ``prec.kmm`` in kernel ``mode`` where one is given (a
    kernel's plain version), else plain."""
    ws = params["w"]
    n = len(ws)
    for i, w in enumerate(ws):
        wt = w.to(x.dtype)
        scale = weak_scalar(1.0 / math.sqrt(w.shape[0]), x.dtype)
        x = prec.kmm(x, wt, mode, scale) if mode else (x @ wt) * scale
        if i < n - 1:
            x = F.silu(x) * weak_scalar(silu_norm_const(), x.dtype)
    return x


def mlp_apply_t(params: dict, x: torch.Tensor, scalars: torch.dtype | None = None,
                mode: str | None = None) -> torch.Tensor:
    """Feature-major twin: x (in, batch) -> (out, batch).  A width-1 layer
    is a row sum of products, as the reference's kernels take it
    (``pallas_stack._latent_fwd``).  ``scalars`` is the dtype at which JAX
    would apply the constants (fan-in scales, the SiLU norm;
    :func:`weak_scalar`) and round a width-1 layer's operands and products:
    x's own by default; an f32 oracle of a bf16 kernel passes bf16.  The
    other layers' products are ``prec.kmm`` in kernel ``mode`` where one is
    given (a kernel's prologue), else plain."""
    sd = scalars or x.dtype
    if sd == x.dtype:
        def rnd(t):
            return t
    else:
        def rnd(t):
            return t.to(sd).to(x.dtype)
    ws = params["w"]
    n = len(ws)
    for i, w in enumerate(ws):
        scale = weak_scalar(1.0 / math.sqrt(w.shape[0]), sd)
        if w.shape[1] == 1:
            x = rnd(w.to(x.dtype) * rnd(x)).sum(0, keepdim=True) * scale
        else:
            wt = w.to(x.dtype).T
            x = prec.kmm(wt, x, mode, scale) if mode else (wt @ x) * scale
        if i < n - 1:
            x = F.silu(x) * weak_scalar(silu_norm_const(), sd)
    return x


def mlp_dims(in_dim: int, width: int, depth: int, out_dim: int) -> tuple[int, ...]:
    return (in_dim, *([width] * depth), out_dim)
