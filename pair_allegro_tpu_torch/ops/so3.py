"""Real spherical harmonics and Wigner-3j tables (counterpart of
``pair_allegro_tpu/ops/so3.py``).

Same conventions as the reference: m ordering ``-l..l`` (l=1 is (y, z, x)),
component normalization ``|Y_l(n)|^2 = 2l+1``, 3j blocks Frobenius-normalized
to 1 with a deterministic sign.  The 3j tables are built in numpy float64
by the same intertwiner construction, so they equal the reference's bit
for bit on one machine.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def sh_dim(lmax: int) -> int:
    return (lmax + 1) ** 2


def sh_slice(l: int) -> slice:  # noqa: E741
    return slice(l * l, (l + 1) * (l + 1))


def _sh_norm_consts(lmax: int) -> list[list[float]]:
    out = []
    for l in range(lmax + 1):  # noqa: E741
        row = []
        for m in range(l + 1):
            n = math.sqrt((2 * l + 1) * math.factorial(l - m) / math.factorial(l + m))
            if m != 0:
                n *= math.sqrt(2.0)
            row.append(n)
        out.append(row)
    return out


def _sh_impl(x, y, z, lmax: int, stack):
    """Cartesian recurrences shared by the torch and numpy versions."""
    norms = _sh_norm_consts(lmax)
    C = [x * 0 + 1]
    S = [x * 0]
    for m in range(1, lmax + 1):
        C.append(x * C[m - 1] - y * S[m - 1])
        S.append(x * S[m - 1] + y * C[m - 1])
    P: dict = {(0, 0): z * 0 + 1}
    for m in range(0, lmax + 1):
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


def spherical_harmonics(vecs: torch.Tensor, lmax: int, eps: float = 1e-30) -> torch.Tensor:
    """(..., 3) vectors -> (..., (lmax+1)^2) real SH of the direction.

    r = 0 (padded self-edges) gives finite values and finite gradients:
    1/r is replaced by 0 there, as in the reference."""
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    r2 = x * x + y * y + z * z
    rinv = torch.where(
        r2 > eps, 1.0 / torch.sqrt(torch.clamp_min(r2, eps)), torch.zeros_like(r2)
    )
    x, y, z = x * rinv, y * rinv, z * rinv
    return _sh_impl(x, y, z, lmax, lambda c: torch.stack(c, dim=-1))


def spherical_harmonics_np(vecs: np.ndarray, lmax: int) -> np.ndarray:
    v = np.asarray(vecs, dtype=np.float64)
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.where(n > 0, n, 1.0)
    return _sh_impl(v[..., 0], v[..., 1], v[..., 2], lmax, lambda c: np.stack(c, axis=-1))


def _rotation_matrix(angles: np.ndarray) -> np.ndarray:
    a, b, c = angles

    def rz(t):
        return np.array(
            [[math.cos(t), -math.sin(t), 0.0], [math.sin(t), math.cos(t), 0.0], [0.0, 0.0, 1.0]]
        )

    def ry(t):
        return np.array(
            [[math.cos(t), 0.0, math.sin(t)], [0.0, 1.0, 0.0], [-math.sin(t), 0.0, math.cos(t)]]
        )

    return rz(a) @ ry(b) @ rz(c)


@functools.lru_cache(maxsize=None)
def _sample_points(lmax: int) -> np.ndarray:
    rng = np.random.RandomState(12345)
    k = 4 * (lmax + 1) ** 2 + 8
    pts = rng.randn(k, 3)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


def wigner_D_np(l: int, R: np.ndarray) -> np.ndarray:  # noqa: E741
    """Real Wigner-D matrix: Y_l(R x) = D_l(R) @ Y_l(x) (least squares)."""
    pts = _sample_points(l)
    A = spherical_harmonics_np(pts, l)[:, sh_slice(l)]
    B = spherical_harmonics_np(pts @ R.T, l)[:, sh_slice(l)]
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T


@functools.lru_cache(maxsize=None)
def _intertwiner_rotations() -> tuple:
    rng = np.random.RandomState(54321)
    return tuple(_rotation_matrix(rng.uniform(0.1, 2.8, size=3)) for _ in range(3))


@functools.lru_cache(maxsize=None)
def real_wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Wigner-3j block (2l1+1, 2l2+1, 2l3+1): the SVD nullspace of the
    intertwiner condition over 3 generic rotations; zeros off-triangle."""
    n1, n2, n3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((n1, n2, n3))
    rows = []
    eye1, eye2, eye3 = np.eye(n1), np.eye(n2), np.eye(n3)
    for R in _intertwiner_rotations():
        D1 = wigner_D_np(l1, R)
        D2 = wigner_D_np(l2, R)
        D3 = wigner_D_np(l3, R)
        lhs = np.einsum("ia,jb,ck->abkijc", D1, D2, eye3)
        rhs = np.einsum("ia,jb,kc->abkijc", eye1, eye2, D3)
        rows.append((lhs - rhs).reshape(n1 * n2 * n3, n1 * n2 * n3))
    M = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(M)
    if len(s) > 1 and s[-2] < 1e-6:
        raise RuntimeError(f"3j nullspace not unique for ({l1},{l2},{l3})")
    if s[-1] > 1e-8:
        raise RuntimeError(f"no 3j intertwiner for ({l1},{l2},{l3}): sigma={s[-1]}")
    C = vt[-1].reshape(n1, n2, n3)
    flat = C.ravel()
    C = C * np.sign(flat[np.argmax(np.abs(flat))])
    C[np.abs(C) < 1e-12] = 0.0
    return C
