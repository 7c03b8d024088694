"""Channelwise tensor products on the uniform irreps layout (counterpart of
``pair_allegro_tpu/ops/tp.py`` and ``ops/pallas_tp._nonzeros``), and the
NequIP tensor-product entry table (``models/nequip.py:259-289``), kept
here so that the model and the K3 kernel module share them.

Layout: features (..., C, D) with D = (lmax+1)^2; every channel carries one
copy of each l = 0..lmax.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pair_allegro_tpu_torch.ops import prec
from pair_allegro_tpu_torch.ops.so3 import real_wigner_3j, sh_slice


@functools.lru_cache(maxsize=None)
def tp_paths(lmax_in1: int, lmax_in2: int, lmax_out: int, parity: bool = False):
    """Triangle-valid (l1, l2, l3) paths; parity=True drops odd l1+l2+l3."""
    paths = []
    for l1 in range(lmax_in1 + 1):
        for l2 in range(lmax_in2 + 1):
            for l3 in range(abs(l1 - l2), min(lmax_out, l1 + l2) + 1):
                if parity and (l1 + l2 + l3) % 2:
                    continue
                paths.append((l1, l2, l3))
    return tuple(paths)


@functools.lru_cache(maxsize=None)
def paths_to_l(lmax_in1: int, lmax_in2: int, l3: int, parity: bool = False):
    return tuple(
        (l1, l2)
        for (l1, l2, l) in tp_paths(lmax_in1, lmax_in2, max(l3, lmax_in1), parity)
        if l == l3  # noqa: E741
    )


def num_paths_per_l(lmax_in1: int, lmax_in2: int, lmax_out: int, parity: bool = False):
    return [len(paths_to_l(lmax_in1, lmax_in2, l3, parity)) for l3 in range(lmax_out + 1)]


@functools.lru_cache(maxsize=None)
def _nonzeros(lmax: int, parity: bool = False):
    """Per l3: tuple of (p, i, j, k, w) nonzero 3j entries (global SH
    indices i of the first operand, j of the second)."""
    table = {}
    for l3 in range(lmax + 1):
        entries = []
        for p, (l1, l2) in enumerate(paths_to_l(lmax, lmax, l3, parity)):
            C = real_wigner_3j(l1, l2, l3)
            for i, j, k in zip(*np.nonzero(C)):
                entries.append(
                    (p, int(i) + sh_slice(l1).start, int(j) + sh_slice(l2).start,
                     int(k), float(C[i, j, k]))
                )
        table[l3] = tuple(entries)
    return table


@functools.lru_cache(maxsize=None)
def tp_entry_table(lmax: int):
    """The unrolled NequIP tensor product (counterpart of
    ``models/nequip.py:_tp_entry_table``): per l3, (n_paths, rows) with rows
    (p_global, l1, l2, entries) and entries (d1, d2, k_local, coeff), the
    nonzeros of real_wigner_3j(l1, l2, l3) at global SH indices d1, d2.
    Paths are those of the SO(3) product (no parity filter); the l_max=1
    closed forms are this table's lmax == 1 instance."""
    table = []
    p_off = 0
    for l3 in range(lmax + 1):
        paths = paths_to_l(lmax, lmax, l3)
        rows = []
        for p_local, (l1, l2) in enumerate(paths):
            C3 = np.asarray(real_wigner_3j(l1, l2, l3))
            o1, o2 = l1 * l1, l2 * l2
            entries = tuple(
                (o1 + i, o2 + j, k, float(C3[i, j, k]))
                for i in range(2 * l1 + 1)
                for j in range(2 * l2 + 1)
                for k in range(2 * l3 + 1)
                if abs(float(C3[i, j, k])) > 1e-14
            )
            rows.append((p_off + p_local, l1, l2, entries))
        table.append((len(paths), tuple(rows)))
        p_off += len(paths)
    return tuple(table)


def tp_num_paths(lmax: int) -> int:
    """P: the NequIP tensor product's paths over all l3."""
    return sum(n for n, _ in tp_entry_table(lmax))


def uniform_tp(x: torch.Tensor, y: torch.Tensor, lmax_out: int, parity: bool = False):
    """Channelwise TP: x (..., C, D1), y (..., C, D2) or (..., D2).
    Returns a list over l3 of (..., C, P_l3, 2*l3+1)."""
    lx = math.isqrt(x.shape[-1]) - 1
    if y.dim() == x.dim() - 1:
        y = y.unsqueeze(-2)
    ly = math.isqrt(y.shape[-1]) - 1
    out = []
    for l3 in range(lmax_out + 1):
        blocks = []
        for (l1, l2) in paths_to_l(lx, ly, l3, parity):
            C = torch.as_tensor(real_wigner_3j(l1, l2, l3), dtype=x.dtype, device=x.device)
            blocks.append(
                torch.einsum("...ci,...cj,ijk->...ck", x[..., sh_slice(l1)], y[..., sh_slice(l2)], C)
            )
        out.append(torch.stack(blocks, dim=-2) if blocks else None)
    return out


def tp_mix_apply(ws: dict, tp_out: list, mode: str | None = None) -> torch.Tensor:
    """Per-l3 (channel, path) -> channel mix; weights have c-major rows
    (row = c*P + p, the ``tp_mix_init`` contract).  Returns (..., C_out, D).
    The products are ``prec.kmm`` in kernel ``mode`` where one is given (a
    kernel's plain version), else plain."""
    pieces = []
    for l3, t in enumerate(tp_out):
        if t is None:
            continue
        w = ws[f"l{l3}"]
        c_in, p = t.shape[-3], t.shape[-2]
        t = torch.movedim(t, -1, -3)  # (..., k, c, p)
        t = t.reshape(*t.shape[:-2], c_in * p)
        wt = w.to(t.dtype)
        scale = 1.0 / math.sqrt(c_in * p)
        m = prec.kmm(t, wt, mode, scale) if mode else (t @ wt) * scale
        pieces.append(torch.movedim(m, -1, -2))
    return torch.cat(pieces, dim=-1)


def scalar_part(tp_out: list) -> torch.Tensor:
    """The l3=0 invariants as (..., C*P0), c-major."""
    t = tp_out[0][..., 0]
    return t.reshape(*t.shape[:-2], -1)


@functools.lru_cache(maxsize=None)
def packed_tp_table(lmax_x: int, lmax_y: int, lmax_out: int, parity: bool = False):
    """Dense 3j matrix W (Dx*Dy, OUT) as numpy, and the per-l3 layout
    ((offset, num_paths), ...).  OUT columns are l3-major, then path
    (``paths_to_l`` order), then m3 (counterpart of ``ops/tp.py:165``)."""
    dx, dy = (lmax_x + 1) ** 2, (lmax_y + 1) ** 2
    cols, layout, off = [], [], 0
    for l3 in range(lmax_out + 1):
        paths = paths_to_l(lmax_x, lmax_y, l3, parity)
        layout.append((off, len(paths)))
        for (l1, l2) in paths:
            blk = np.zeros((dx, dy, 2 * l3 + 1))
            blk[sh_slice(l1), sh_slice(l2), :] = real_wigner_3j(l1, l2, l3)
            cols.append(blk.reshape(dx * dy, 2 * l3 + 1))
        off += len(paths) * (2 * l3 + 1)
    W = np.concatenate(cols, axis=1) if cols else np.zeros((dx * dy, 0))
    return W, tuple(layout)


def combined_tp_mix_matrix(ws: dict, lmax: int, dtype=torch.float32, parity: bool = False):
    """TP and the per-l3 mix folded into one matrix M (C*D*D, D*C_out), rows
    (c, ij)-major, columns (k, c')-major, the normalisation 1/sqrt(P*C)
    folded in per l3 (counterpart of ``ops/tp.py:218``):

      V'[e, k, c'] = sum_{c, ij} O[e, c, ij] M[(c, ij), (k, c')],
      O[e, c, ij]  = V[e, c, i] env[e, c, j].

    ``ws`` holds the mix weights with c-major rows (row = c*P + p)."""
    W3, layout = packed_tp_table(lmax, lmax, lmax, parity)
    d = (lmax + 1) ** 2
    c_in = ws["l0"].shape[0] // layout[0][1]
    c_out = ws["l0"].shape[1]
    dev = ws["l0"].device
    blocks = []
    for l3, (off, p) in enumerate(layout):
        k3 = 2 * l3 + 1
        w3 = torch.as_tensor(W3[:, off : off + p * k3].reshape(d * d, p, k3), dtype=dtype, device=dev)
        wmix = ws[f"l{l3}"].to(dtype).reshape(c_in, p, c_out)
        # einsum("xpk,cpd->cxkd") as one product, exact f32 under every
        # policy as JAX pins it (precision="highest")
        a = w3.permute(0, 2, 1).reshape(d * d * k3, p)
        b = wmix.permute(1, 0, 2).reshape(p, c_in * c_out)
        m_l = prec.exact_mm(a, b).reshape(d * d, k3, c_in, c_out).permute(2, 0, 1, 3)
        m_l = m_l * (1.0 / math.sqrt(c_in * p))
        blocks.append(m_l.reshape(c_in, d * d, k3 * c_out))
    return torch.cat(blocks, dim=-1).reshape(c_in * d * d, d * c_out)


def tp_mix_combined(V, env, ws: dict, lmax: int, M=None, parity: bool = False):
    """TP + mix + invariants through the combined matrix, channels-last:
    V, env (..., C, D) -> (V' (..., C_out, D), inv (..., C*P0) c-major)
    (counterpart of ``ops/tp.py:252``)."""
    *batch, c, d = V.shape
    if M is None:
        M = combined_tp_mix_matrix(ws, lmax, V.dtype, parity)
    outer = V[..., :, None] * env[..., None, :]  # (..., C, D, D)
    out = outer.reshape(*batch, c * d * d) @ M.to(V.dtype)
    Vp = out.reshape(*batch, d, -1).transpose(-1, -2)
    W3, layout = packed_tp_table(lmax, lmax, lmax, parity)
    p0 = layout[0][1]
    w0 = torch.as_tensor(W3[:, :p0], dtype=V.dtype, device=V.device)
    inv = outer.reshape(*batch, c, d * d) @ w0
    return Vp, inv.reshape(*batch, c * p0)


def uniform_tp_packed(x, y, lmax_out: int, parity: bool = False):
    """All-path channelwise TP as one product with the dense 3j matrix
    (counterpart of ``ops/tp.py:189``): x (..., C, D1), y (..., C, D2) or
    (..., D2) -> (..., C, OUT) in ``packed_tp_table``'s column layout, the
    same numbers as :func:`uniform_tp` stacked in that order."""
    lx = math.isqrt(x.shape[-1]) - 1
    if y.dim() == x.dim() - 1:
        y = y.unsqueeze(-2)
    ly = math.isqrt(y.shape[-1]) - 1
    W, _ = packed_tp_table(lx, ly, lmax_out, parity)
    outer = x[..., :, None] * y[..., None, :]  # (..., C, D1, D2)
    return outer.reshape(*outer.shape[:-2], -1) @ torch.as_tensor(W, dtype=x.dtype,
                                                                  device=x.device)


def packed_scalar_part(T, lmax_x: int, lmax_y: int, lmax_out: int, parity: bool = False):
    """The l3=0 invariant columns of a packed TP output as (..., C*P0),
    c-major (counterpart of ``ops/tp.py:210``)."""
    _, layout = packed_tp_table(lmax_x, lmax_y, lmax_out, parity)
    off, p0 = layout[0]
    t = T[..., off:off + p0]  # (..., C, P0)
    return t.reshape(*t.shape[:-2], -1)


def tp_mix_apply_packed(ws: dict, T, lmax_x: int, lmax_y: int, lmax_out: int,
                        parity: bool = False):
    """:func:`tp_mix_apply` on a packed TP output (counterpart of
    ``ops/tp.py:278``): the same c-major mix weights, T (..., C, OUT) ->
    (..., C_out, (lmax_out+1)^2)."""
    _, layout = packed_tp_table(lmax_x, lmax_y, lmax_out, parity)
    c_in = T.shape[-2]
    pieces = []
    for l3, (off, p) in enumerate(layout):
        if p == 0:
            continue
        k = 2 * l3 + 1
        t = T[..., off:off + p * k].reshape(*T.shape[:-2], c_in, p, k)
        t = torch.movedim(t, -1, -3).reshape(*t.shape[:-3], k, c_in * p)
        m = (t @ ws[f"l{l3}"].to(t.dtype)) * (1.0 / math.sqrt(c_in * p))
        pieces.append(torch.movedim(m, -1, -2))  # (..., C_out, k)
    return torch.cat(pieces, dim=-1)
