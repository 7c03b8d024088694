"""Bessel radial basis and polynomial cutoff (counterpart of
``pair_allegro_tpu/ops/radial.py``)."""

from __future__ import annotations

import math

import torch


def bessel_basis(r: torch.Tensor, r_max: float, num_basis: int = 8, eps: float = 1e-8):
    """sqrt(2/rc) * sin(n pi r / rc) / r, n = 1..N -> (..., N)."""
    n = torch.arange(1, num_basis + 1, dtype=r.dtype, device=r.device)
    r_safe = torch.clamp_min(r, eps).unsqueeze(-1)
    x = n * (math.pi / r_max) * r_safe
    return math.sqrt(2.0 / r_max) * torch.sin(x) / r_safe


def polynomial_cutoff(r: torch.Tensor, r_max, p: int = 6):
    """Smooth envelope with u(0)=1, u(rc)=0 and p vanishing derivatives at rc;
    zero beyond rc.  ``r_max`` may be a scalar or a per-edge tensor."""
    x = r / r_max
    xc = torch.clamp(x, 0.0, 1.0)
    xp = xc**p
    out = (
        1.0
        - 0.5 * (p + 1.0) * (p + 2.0) * xp
        + p * (p + 2.0) * xp * xc
        - 0.5 * p * (p + 1.0) * xp * xc**2
    )
    return torch.where(x < 1.0, out, torch.zeros_like(out))
