"""On-device neighbor builds (counterpart of
``pair_allegro_tpu/neighbors/device.py:37-220, 239-443, 578-649``).

Two strategies, as in the reference:

* ``cell_list_neighbors``: the TABLE layout, an (N, K) j-table with the
  center implicit in the row, padded with self-references (mask False,
  zero shift).  Each row is compacted with the same top-k key as the
  reference, so the kept edges come out in the same slot order.
* ``dense_neighbors``: all pairs times a static table of image shifts
  (``static_image_shifts``), for small boxes and any box with a
  non-periodic axis.  It produces the FLAT layout, a (2, E) edge list
  compacted in the flat (shift, i, j) order.

Capacity overflow is reported in a flag, not hidden; callers check it at
chunk ends and regrow.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pair_allegro_tpu_torch.ops.geometry import inv3x3


@dataclasses.dataclass
class NeighborData:
    """Padded fixed-shape edge arrays, in one of two layouts:

    * TABLE (``cell_list_neighbors``): edge_index (N, K) j-table,
      edge_shifts (N, K, 3), edge_mask (N, K), edge_rev (N, K) the flat
      index of each edge's reverse (N*K = pad);
    * FLAT (``dense_neighbors``): edge_index (2, E) rows i and j,
      edge_shifts (E, 3), edge_mask (E,), edge_rev None; padded slots are
      (q0, q0) self edges with zero shift.

    Both carry overflow () bool and ref_positions (N, 3) for the skin
    check."""

    edge_index: torch.Tensor
    edge_shifts: torch.Tensor
    edge_mask: torch.Tensor
    overflow: torch.Tensor
    ref_positions: torch.Tensor | None = None
    edge_rev: torch.Tensor | None = None

    def count(self):
        return self.edge_mask.sum()


def _cell_heights(cell: torch.Tensor) -> torch.Tensor:
    vol = torch.abs(torch.linalg.det(cell))
    crosses = torch.stack(
        [
            torch.linalg.cross(cell[1], cell[2]),
            torch.linalg.cross(cell[2], cell[0]),
            torch.linalg.cross(cell[0], cell[1]),
        ]
    )
    return vol / torch.clamp_min(torch.linalg.norm(crosses, dim=-1), 1e-30)


def static_image_shifts(cell: np.ndarray, pbc, cutoff: float, extra_images: int = 0) -> np.ndarray:
    """Host list of the integer image shifts that cover ``cutoff`` in
    ``cell``: ceil(cutoff / height) + ``extra_images`` layers on each
    periodic axis, none on a non-periodic one (or in a zero cell).  (S, 3)
    float64, the zero shift first (the self-pair exclusion is per shift)."""
    vol = abs(np.linalg.det(cell))
    ns = []
    for a in range(3):
        if not pbc[a] or vol < 1e-12:
            ns.append(0)
            continue
        cross = np.cross(cell[(a + 1) % 3], cell[(a + 2) % 3])
        height = vol / np.linalg.norm(cross)
        ns.append(int(np.ceil(cutoff / height)) + extra_images)
    out = [(i, j, k) for i in range(-ns[0], ns[0] + 1) for j in range(-ns[1], ns[1] + 1)
           for k in range(-ns[2], ns[2] + 1)]
    out.sort(key=lambda s: (s != (0, 0, 0), s))
    return np.asarray(out, dtype=np.float64)


# candidate pairs per pass of the dense build, and the device bytes one
# candidate holds during a pass besides the displacement, d2 and the typed
# pair cutoff (5 words of the working dtype): three bool masks and six int64
# words (running count, output slot, flat index, target and its two terms)
DENSE_CHUNK = 1 << 24
_DENSE_CAND_BYTES = 3 + 6 * 8
_DUMP = 1024


def _dense_passes(n_shifts: int, nq: int, n: int, chunk: int):
    """(shift slice, center-row slice) of each pass of the dense build, in
    the flat (s, i, j) order: whole shifts while one shift's NQ*N pairs fit
    in ``chunk``, else windows of center rows within each shift."""
    per_shift = nq * n
    if per_shift <= chunk:
        sp = max(1, chunk // max(per_shift, 1))
        return [(slice(s0, min(s0 + sp, n_shifts)), slice(0, nq)) for s0 in range(0, n_shifts, sp)]
    rows = max(1, chunk // n)
    return [(slice(s, s + 1), slice(r0, min(r0 + rows, nq)))
            for s in range(n_shifts) for r0 in range(0, nq, rows)]


def dense_build_bytes(n_atoms: int, n_shifts: int, max_edges: int, itemsize: int = 4,
                      chunk: int = DENSE_CHUNK) -> int:
    """Device bytes :func:`dense_neighbors` holds at its peak: the candidate
    tensors of its largest pass (at most ``chunk`` of the S*N*N pairs) and
    the compacted outputs with their index arithmetic (max_edges + 1024
    int64 slots, then i, j, s, mask and shifts per edge)."""
    passes = _dense_passes(n_shifts, n_atoms, n_atoms, chunk)
    cand = max((s.stop - s.start) * (r.stop - r.start) * n_atoms for s, r in passes)
    per_cand = 5 * itemsize + _DENSE_CAND_BYTES
    per_edge = 8 + 4 * 8 + 1 + 3 * itemsize
    return cand * per_cand + (max_edges + _DUMP) * per_edge


def dense_neighbors(positions, cell, shifts_table: np.ndarray, cutoff: float, max_edges: int,
                    atom_mask=None, query_start: int = 0, n_query: int | None = None, pbc=None,
                    types=None, cutoff_table: np.ndarray | None = None,
                    chunk: int = DENSE_CHUNK) -> NeighborData:
    """All pairs times a static shift table, compacted into the FLAT layout
    of ``max_edges`` slots (the reference's ``dense_neighbors``).

    A candidate (s, i, j) is an edge when |pos[j] + shift_s @ cell - pos[i]|
    <= cutoff (or, with ``types`` and a symmetric ``cutoff_table``, the
    pair's typed cutoff), it is not the zero-shift self pair, and both atoms
    are valid under ``atom_mask``.  Edges keep the flat (s, i, j) order; the
    ones past ``max_edges`` are dropped and flag ``overflow``.  Padded slots
    are (q0, q0) self edges with zero shift and mask False.  Centers are the
    window [query_start, query_start + n_query); neighbors range over all
    atoms.  With ``pbc``, ``overflow`` is also set when the current cell
    needs more image layers than the table holds.

    The candidates are taken in passes of at most ``chunk`` pairs (whole
    shifts, or windows of center rows), each compacted with a cumulative
    count and a scatter into the fixed-size outputs: no host
    synchronisation, no data-dependent shape, int64 flat indices."""
    n = positions.shape[0]
    nq = n if n_query is None else n_query
    q0 = int(query_start)
    dtype, dev = positions.dtype, positions.device
    geom_bad = torch.zeros((), dtype=torch.bool, device=dev)
    if pbc is not None and any(pbc):
        ns_table = np.abs(np.asarray(shifts_table)).max(axis=0)
        need = torch.ceil(cutoff / _cell_heights(cell.to(dtype)))
        for a in range(3):
            if pbc[a]:
                geom_bad = geom_bad | (need[a] > float(ns_table[a]))
    shifts = torch.as_tensor(shifts_table, dtype=dtype, device=dev)
    shift_cart = shifts @ cell.to(dtype)
    s_zero = np.all(np.asarray(shifts_table) == 0, axis=1)
    pos_q = positions[q0:q0 + nq]
    gq = q0 + torch.arange(nq, device=dev)
    typed = types is not None and cutoff_table is not None
    if typed:
        ct = torch.as_tensor(cutoff_table, dtype=dtype, device=dev)
        types_q = types[q0:q0 + nq]
    mask_q = None if atom_mask is None else atom_mask[q0:q0 + nq]

    # dropped candidates go to _DUMP slots past the outputs, spread so that
    # their stores do not all land on one address
    slots = torch.full((max_edges + _DUMP,), -1, dtype=torch.int64, device=dev)
    base = torch.zeros((), dtype=torch.int64, device=dev)
    ar_n = torch.arange(n, device=dev)
    for ss, rs in _dense_passes(len(shifts_table), nq, n, chunk):
        disp = positions[None, None] + shift_cart[ss, None, None, :] - pos_q[None, rs, None, :]
        d2 = torch.sum(disp * disp, dim=-1)  # (s, r, N)
        del disp
        if typed:
            cut_pair = ct[types_q[rs]][:, types]
            within = d2 <= (cut_pair * cut_pair)[None]
        else:
            within = d2 <= cutoff * cutoff
        del d2
        zero = s_zero[ss]
        if zero.any():
            self_pair = gq[rs, None] == ar_n[None, :]
            zs = torch.as_tensor(zero, device=dev)
            within = within & ~(zs[:, None, None] & self_pair[None])
        if mask_q is not None:
            within = within & (mask_q[rs, None] & atom_mask[None, :])[None]
        flat = within.reshape(-1)
        count = torch.cumsum(flat, 0)
        pos_out = base + count - 1
        keep = flat & (pos_out < max_edges)
        start = (ss.start * nq + rs.start) * n
        src = torch.arange(start, start + flat.numel(), device=dev)
        tgt = torch.where(keep, pos_out, max_edges + src % _DUMP)
        slots.scatter_(0, tgt, src)
        base = base + count[-1]
        del flat, count, pos_out, keep, src, tgt

    m = slots[:max_edges]
    emask = m >= 0
    mc = torch.clamp_min(m, 0)
    q0_t = torch.full_like(mc, q0)
    ei = torch.where(emask, q0 + torch.div(mc, n, rounding_mode="floor") % nq, q0_t)
    ej = torch.where(emask, mc % n, q0_t)
    es = shifts[torch.div(mc, nq * n, rounding_mode="floor")] * emask[:, None].to(dtype)
    return NeighborData(
        edge_index=torch.stack([ei, ej]),
        edge_shifts=es,
        edge_mask=emask,
        overflow=(base > max_edges) | geom_bad,
    )


class CellBins(NamedTuple):
    table: torch.Tensor  # (n_cells, cap) atom ids, n = empty
    bin_frac: torch.Tensor  # (n_cells, cap, 3)
    bin_wrap: torch.Tensor  # (n_cells, cap, 3)
    bin_mask: torch.Tensor  # (n_cells, cap) or scalar True
    frac_wrapped: torch.Tensor  # (N, 3)
    wrap_shift: torch.Tensor  # (N, 3)
    bins: torch.Tensor  # (N, 3)
    overflow: torch.Tensor  # () bool
    bin_type: torch.Tensor | None = None


def build_cell_bins(positions, cell, cutoff: float, grid, cell_capacity: int,
                    atom_mask=None, types=None) -> CellBins:
    """O(N) binning: a stable sort by bin id, then per-bin attribute tables."""
    n = positions.shape[0]
    dtype, dev = positions.dtype, positions.device
    gx, gy, gz = grid
    n_cells = gx * gy * gz
    grid_t = torch.tensor(grid, device=dev)
    h = _cell_heights(cell)
    geom_bad = torch.any(h / grid_t.to(dtype) < cutoff)

    frac = positions @ inv3x3(cell)
    frac_wrapped = frac - torch.floor(frac)
    wrap_shift = -torch.floor(frac)
    if atom_mask is not None:
        frac_wrapped = torch.where(atom_mask[:, None], frac_wrapped, torch.zeros_like(frac_wrapped))
    bins = torch.minimum(
        torch.clamp_min(torch.floor(frac_wrapped * grid_t.to(dtype)).to(torch.int64), 0),
        grid_t - 1,
    )
    cell_id = (bins[:, 0] * gy + bins[:, 1]) * gz + bins[:, 2]
    order = torch.argsort(cell_id, stable=True)
    sorted_cid = cell_id[order]
    counts = torch.bincount(cell_id, minlength=n_cells)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sorted_cid]
    bucket_overflow = torch.any(counts > cell_capacity)
    table = torch.full((n_cells, cell_capacity), n, dtype=torch.int64, device=dev)
    keep = rank < cell_capacity  # rank >= capacity is dropped (flagged above)
    table[sorted_cid[keep], rank[keep]] = order[keep]

    table_safe = torch.clamp_max(table, n - 1)
    bin_mask = atom_mask[table_safe] if atom_mask is not None else torch.ones((), dtype=torch.bool, device=dev)
    bin_type = types.to(dtype)[table_safe] if types is not None else None
    return CellBins(
        table, frac_wrapped[table_safe], wrap_shift[table_safe], bin_mask,
        frac_wrapped, wrap_shift, bins, bucket_overflow | geom_bad, bin_type,
    )


_OFFS = np.array(
    [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)], dtype=np.int64
)


def cell_list_neighbors(positions, cell, cutoff: float, grid, cell_capacity: int,
                        max_neighbors: int, atom_mask=None, types=None,
                        cutoff_table: np.ndarray | None = None) -> NeighborData:
    """Binned minimum-image build of the (N, K) TABLE (the reference's
    ``flatten=False`` form).  With ``types`` + a symmetric ``cutoff_table``
    candidates are filtered by the per-edge-type cutoff."""
    n = positions.shape[0]
    dtype, dev = positions.dtype, positions.device
    gx, gy, gz = grid
    typed = types is not None and cutoff_table is not None
    b = build_cell_bins(positions, cell, cutoff, grid, cell_capacity, atom_mask,
                        types=types if typed else None)
    gq = torch.arange(n, device=dev)
    offs = torch.as_tensor(_OFFS, device=dev)
    nb = torch.stack(
        [
            torch.remainder(b.bins[:, None, 0] + offs[None, :, 0], gx),
            torch.remainder(b.bins[:, None, 1] + offs[None, :, 1], gy),
            torch.remainder(b.bins[:, None, 2] + offs[None, :, 2], gz),
        ],
        dim=-1,
    )
    nb_id = (nb[..., 0] * gy + nb[..., 1]) * gz + nb[..., 2]  # (N, 27)
    m_tot = 27 * cell_capacity
    cand = b.table[nb_id].reshape(n, m_tot)
    cand_frac = b.bin_frac[nb_id].reshape(n, m_tot, 3)
    cand_wrap = b.bin_wrap[nb_id].reshape(n, m_tot, 3)

    df = cand_frac - b.frac_wrapped[:, None, :]
    mic = -torch.round(df)
    dx = (df + mic) @ cell
    d2 = torch.sum(dx * dx, dim=-1)
    if typed:
        ct = torch.as_tensor(cutoff_table, dtype=dtype, device=dev)
        n_t = ct.shape[0]
        cut_rows = ct[types]  # (N, T)
        cand_t = b.bin_type[nb_id].reshape(n, m_tot)
        oh = (cand_t[..., None] == torch.arange(n_t, dtype=dtype, device=dev)).to(dtype)
        rc = torch.einsum("nmt,nt->nm", oh, cut_rows)
        valid = (cand < n) & (d2 <= rc * rc) & (cand != gq[:, None])
    else:
        valid = (cand < n) & (d2 <= cutoff * cutoff) & (cand != gq[:, None])
    if atom_mask is not None:
        valid = valid & atom_mask[:, None] & b.bin_mask[nb_id].reshape(n, m_tot)

    row_overflow = torch.any(valid.sum(dim=1) > max_neighbors)
    ar = torch.arange(m_tot, device=dev)
    col_key = torch.where(valid, m_tot - ar[None, :], torch.zeros_like(ar)[None, :])
    key_top, idx_top = torch.topk(col_key, max_neighbors, dim=1, sorted=True)
    keep = key_top > 0
    nbr = torch.where(keep, torch.gather(cand, 1, idx_top), torch.full_like(idx_top, n))
    net_shift = mic + cand_wrap - b.wrap_shift[:, None, :]
    shf = torch.gather(net_shift, 1, idx_top[..., None].expand(-1, -1, 3)) * keep[..., None]
    mask_tab = nbr < n
    j_tab = torch.where(mask_tab, nbr, gq[:, None].expand_as(nbr))
    return NeighborData(
        edge_index=j_tab,
        edge_shifts=shf,
        edge_mask=mask_tab,
        overflow=b.overflow | row_overflow,
    )


def choose_grid(cell: np.ndarray, cutoff: float):
    """Per-axis bin count floor(height/cutoff); None if any axis has < 3."""
    vol = abs(np.linalg.det(cell))
    if vol < 1e-12:
        return None
    g = []
    for a in range(3):
        cross = np.cross(cell[(a + 1) % 3], cell[(a + 2) % 3])
        g.append(int(np.floor(vol / np.linalg.norm(cross) / cutoff)))
    if min(g) < 3:
        return None
    return tuple(g)


def _encode(s):
    return ((s[..., 0] + 128) * 256 + (s[..., 1] + 128)) * 256 + (s[..., 2] + 128)


def reverse_table(j_idx: torch.Tensor, shifts: torch.Tensor, block_entries: int = 4 * 1024 * 1024):
    """(N, K) flat index j*K + k'' of each edge's reverse edge (j -> a with
    shift -s); padded slots (self-reference, zero shift) map to N*K.  The
    (rows, K, K) comparison runs in row blocks of about ``block_entries``."""
    n, k = j_idx.shape
    s = torch.round(shifts).to(torch.int64)
    enc = _encode(s)
    nenc = _encode(-s)
    zero_enc = (128 * 256 + 128) * 256 + 128
    bs = max(1, block_entries // (k * k))
    out = torch.empty_like(j_idx)
    for a0 in range(0, n, bs):
        ji = j_idx[a0 : a0 + bs]
        ne = nenc[a0 : a0 + bs]
        aid = torch.arange(a0, a0 + ji.shape[0], device=j_idx.device)
        m = (j_idx[ji] == aid[:, None, None]) & (enc[ji] == ne[:, :, None])
        hit = torch.any(m, dim=-1)
        k2 = torch.argmax(m.to(torch.int8), dim=-1)  # first match
        rev = ji * k + k2
        is_pad = (ji == aid[:, None]) & (enc[a0 : a0 + bs] == zero_enc)
        out[a0 : a0 + bs] = torch.where(hit & ~is_pad, rev, torch.full_like(rev, n * k))
    return out
