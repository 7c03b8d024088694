"""Normalized bias-free SiLU MLPs (counterpart of ``pair_allegro_tpu/ops/mlp.py``).

Parameters keep the JAX layout: ``{"w": [W0, W1, ...]}`` with W_i of shape
(in, out); each layer scales by 1/sqrt(fan_in) at run time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def silu_norm_const() -> float:
    """1/sqrt(E[silu(x)^2]) for x ~ N(0, 1)."""
    return 1.6790564307512243


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (batch, in) -> (batch, out); hidden layers silu * const."""
    ws = params["w"]
    n = len(ws)
    for i, w in enumerate(ws):
        x = (x @ w.to(x.dtype)) * (1.0 / math.sqrt(w.shape[0]))
        if i < n - 1:
            x = F.silu(x) * silu_norm_const()
    return x


def mlp_apply_t(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Feature-major twin: x (in, batch) -> (out, batch)."""
    ws = params["w"]
    n = len(ws)
    for i, w in enumerate(ws):
        x = (w.to(x.dtype).T @ x) * (1.0 / math.sqrt(w.shape[0]))
        if i < n - 1:
            x = F.silu(x) * silu_norm_const()
    return x


def mlp_dims(in_dim: int, width: int, depth: int, out_dim: int) -> tuple[int, ...]:
    return (in_dim, *([width] * depth), out_dim)
