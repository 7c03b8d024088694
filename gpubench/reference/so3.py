"""Real spherical harmonics, Wigner-3j blocks and the channelwise tensor
product, in plain numpy and PyTorch: the reference's own copy, frozen, so
that the yardstick does not move when the program's tables do.

Conventions: m runs -l..l (l = 1 is (y, z, x)), component normalisation
|Y_l(n)|^2 = 2l + 1, each 3j block Frobenius-normalised to 1 with the sign
of its largest entry positive.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def sh_slice(l: int) -> slice:  # noqa: E741
    return slice(l * l, (l + 1) * (l + 1))


def _sh_norm_consts(lmax: int) -> list[list[float]]:
    out = []
    for l in range(lmax + 1):  # noqa: E741
        row = []
        for m in range(l + 1):
            n = math.sqrt((2 * l + 1) * math.factorial(l - m) / math.factorial(l + m))
            row.append(n * math.sqrt(2.0) if m else n)
        out.append(row)
    return out


def _sh_impl(x, y, z, lmax: int, stack):
    """Cartesian recurrences of the real harmonics of a unit vector."""
    norms = _sh_norm_consts(lmax)
    C = [x * 0 + 1]
    S = [x * 0]
    for m in range(1, lmax + 1):
        C.append(x * C[m - 1] - y * S[m - 1])
        S.append(x * S[m - 1] + y * C[m - 1])
    P: dict = {(0, 0): z * 0 + 1}
    for m in range(lmax + 1):
        if m > 0:
            P[(m, m)] = (2 * m - 1) * P[(m - 1, m - 1)]
        if m + 1 <= lmax:
            P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
        for l in range(m + 2, lmax + 1):  # noqa: E741
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)] - (l - 1 + m) * P[(l - 2, m)]) / (l - m)
    comps = []
    for l in range(lmax + 1):  # noqa: E741
        for m in range(-l, l + 1):
            am = abs(m)
            n = norms[l][am]
            if m < 0:
                comps.append(n * P[(l, am)] * S[am])
            elif m == 0:
                comps.append(n * P[(l, 0)])
            else:
                comps.append(n * P[(l, am)] * C[am])
    return stack(comps)


def spherical_harmonics(vecs: torch.Tensor, lmax: int) -> torch.Tensor:
    """(..., 3) -> (..., (lmax + 1)^2) harmonics of the direction; the
    reference's edges all have r > 0."""
    r = torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
    u = vecs / r
    return _sh_impl(u[..., 0], u[..., 1], u[..., 2], lmax, lambda c: torch.stack(c, dim=-1))


def _sh_np(vecs: np.ndarray, lmax: int) -> np.ndarray:
    v = vecs / np.linalg.norm(vecs, axis=-1, keepdims=True)
    return _sh_impl(v[..., 0], v[..., 1], v[..., 2], lmax, lambda c: np.stack(c, axis=-1))


def _rotation(angles) -> np.ndarray:
    a, b, c = angles

    def rz(t):
        return np.array([[math.cos(t), -math.sin(t), 0.0], [math.sin(t), math.cos(t), 0.0],
                         [0.0, 0.0, 1.0]])

    def ry(t):
        return np.array([[math.cos(t), 0.0, math.sin(t)], [0.0, 1.0, 0.0],
                         [-math.sin(t), 0.0, math.cos(t)]])

    return rz(a) @ ry(b) @ rz(c)


def _wigner_d(l: int, R: np.ndarray) -> np.ndarray:  # noqa: E741
    """Real Wigner-D: Y_l(R x) = D_l(R) Y_l(x), fitted on sample points."""
    rng = np.random.RandomState(12345)
    pts = rng.randn(4 * (l + 1) ** 2 + 8, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    A = _sh_np(pts, l)[:, sh_slice(l)]
    B = _sh_np(pts @ R.T, l)[:, sh_slice(l)]
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T


@functools.lru_cache(maxsize=None)
def real_wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """(2l1+1, 2l2+1, 2l3+1) block: the null space of the intertwiner
    condition over three generic rotations."""
    n1, n2, n3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return np.zeros((n1, n2, n3))
    rng = np.random.RandomState(54321)
    rows = []
    for _ in range(3):
        R = _rotation(rng.uniform(0.1, 2.8, size=3))
        D1, D2, D3 = _wigner_d(l1, R), _wigner_d(l2, R), _wigner_d(l3, R)
        lhs = np.einsum("ia,jb,ck->abkijc", D1, D2, np.eye(n3))
        rhs = np.einsum("ia,jb,kc->abkijc", np.eye(n1), np.eye(n2), D3)
        rows.append((lhs - rhs).reshape(n1 * n2 * n3, n1 * n2 * n3))
    _, s, vt = np.linalg.svd(np.concatenate(rows, axis=0))
    if s[-1] > 1e-8 or (len(s) > 1 and s[-2] < 1e-6):
        raise RuntimeError(f"no unique 3j block for ({l1}, {l2}, {l3})")
    C = vt[-1].reshape(n1, n2, n3)
    C = C * np.sign(C.ravel()[np.argmax(np.abs(C.ravel()))])
    C[np.abs(C) < 1e-12] = 0.0
    return C


@functools.lru_cache(maxsize=None)
def paths_to_l(lmax1: int, lmax2: int, l3: int, parity: bool = False) -> tuple:
    """The (l1, l2) pairs that couple to l3 (parity: l1 + l2 + l3 even)."""
    return tuple((l1, l2) for l1 in range(lmax1 + 1) for l2 in range(lmax2 + 1)
                 if abs(l1 - l2) <= l3 <= l1 + l2 and not (parity and (l1 + l2 + l3) % 2))


def uniform_tp(x: torch.Tensor, y: torch.Tensor, lmax_out: int, parity: bool = False) -> list:
    """Channelwise product of x (..., C, D1) and y (..., C, D2) or (..., D2):
    per l3 a (..., C, P_l3, 2 l3 + 1) tensor, or None where no path lands."""
    lx = math.isqrt(x.shape[-1]) - 1
    if y.dim() == x.dim() - 1:
        y = y.unsqueeze(-2)
    ly = math.isqrt(y.shape[-1]) - 1
    out = []
    for l3 in range(lmax_out + 1):
        blocks = [torch.einsum("...ci,...cj,ijk->...ck", x[..., sh_slice(l1)], y[..., sh_slice(l2)],
                               torch.as_tensor(real_wigner_3j(l1, l2, l3), dtype=x.dtype,
                                               device=x.device))
                  for l1, l2 in paths_to_l(lx, ly, l3, parity)]
        out.append(torch.stack(blocks, dim=-2) if blocks else None)
    return out
