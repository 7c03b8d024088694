"""Closed-form 3x3 cell algebra (counterpart of ``pair_allegro_tpu/ops/geometry.py``)."""

from __future__ import annotations

import torch


def det3x3(m: torch.Tensor) -> torch.Tensor:
    return (
        m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
        - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
        + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
    )


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C]), torch.stack([D, E, F]), torch.stack([G, H, I])])
    return adj / det


def volume(cell: torch.Tensor) -> torch.Tensor:
    return torch.abs(det3x3(cell))
