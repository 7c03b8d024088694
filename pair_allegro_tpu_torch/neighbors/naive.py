"""Host-side neighbor statistics for capacity sizing (numpy copy of
``pair_allegro_tpu/neighbors/naive.py``: ``host_neighbor_stats``, the
exact list it falls back to when the box is too small to bin, and
``pad_edges``, which pads a training frame's edge list)."""

from __future__ import annotations

import numpy as np


def _shift_ranges(cell: np.ndarray, pbc, cutoff: float) -> list[range]:
    ranges = []
    vol = abs(np.linalg.det(cell))
    if vol < 1e-12:
        return [range(0, 1)] * 3
    for a in range(3):
        cross = np.cross(cell[(a + 1) % 3], cell[(a + 2) % 3])
        height = vol / np.linalg.norm(cross)
        n = int(np.ceil(cutoff / height)) if pbc[a] else 0
        ranges.append(range(-n, n + 1))
    return ranges


def neighbor_list_np(positions, cell, pbc, cutoff, types=None, cutoff_matrix=None):
    """Exact FULL neighbor list: (edge_index (2, E), shifts (E, 3))."""
    pos0 = np.asarray(positions, dtype=np.float64)
    pos = pos0
    n = pos.shape[0]
    wrap = np.zeros((n, 3), dtype=np.float64)
    if cell is None or not any(pbc):
        cell_m = np.eye(3)
        shift_list = [np.zeros(3)]
    else:
        cell_m = np.asarray(cell, dtype=np.float64)
        frac = pos @ np.linalg.inv(cell_m)
        for a in range(3):
            if pbc[a]:
                wrap[:, a] = -np.floor(frac[:, a])
        pos = pos + wrap @ cell_m
        rs = _shift_ranges(cell_m, pbc, float(cutoff))
        shift_list = [np.array([i, j, k], dtype=np.float64) for i in rs[0] for j in rs[1] for k in rs[2]]
    src, dst, shf = [], [], []
    cut2 = float(cutoff) ** 2
    for s in shift_list:
        disp = pos[None, :, :] + (s @ cell_m)[None, None, :] - pos[:, None, :]
        d2 = np.sum(disp * disp, axis=-1)
        mask = d2 <= cut2
        if np.all(s == 0):
            np.fill_diagonal(mask, False)
        ii, jj = np.nonzero(mask)
        src.append(ii)
        dst.append(jj)
        shf.append(s[None, :] + wrap[jj] - wrap[ii])
    i_idx = np.concatenate(src).astype(np.int32)
    j_idx = np.concatenate(dst).astype(np.int32)
    shifts = np.concatenate(shf, axis=0)
    if cutoff_matrix is not None and types is not None:
        vec = pos0[j_idx] - pos0[i_idx] + shifts @ cell_m
        r = np.linalg.norm(vec, axis=-1)
        keep = r <= cutoff_matrix[types[i_idx], types[j_idx]]
        i_idx, j_idx, shifts = i_idx[keep], j_idx[keep], shifts[keep]
    return np.stack([i_idx, j_idx]), shifts


def host_neighbor_stats(positions, cell, pbc, cutoff: float, types=None, cutoff_matrix=None):
    """(total_edge_count, max_neighbors_of_any_atom) by binned counting."""
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    typed = types is not None and cutoff_matrix is not None
    if typed:
        types = np.asarray(types, np.int64)
        cutoff_matrix = np.asarray(cutoff_matrix, np.float64)
    use_bins = cell is not None and all(pbc) and abs(np.linalg.det(cell)) > 1e-12
    if use_bins:
        cell_m = np.asarray(cell, np.float64)
        vol = abs(np.linalg.det(cell_m))
        grid = []
        for a in range(3):
            cross = np.cross(cell_m[(a + 1) % 3], cell_m[(a + 2) % 3])
            grid.append(int(np.floor(vol / np.linalg.norm(cross) / cutoff)))
        use_bins = min(grid) >= 3
    if not use_bins:
        ei, _ = neighbor_list_np(
            pos, cell, pbc, cutoff,
            types=types if typed else None,
            cutoff_matrix=cutoff_matrix if typed else None,
        )
        counts = np.bincount(ei[0], minlength=n)
        return int(ei.shape[1]), int(counts.max()) if n else 0

    gx, gy, gz = grid
    frac = pos @ np.linalg.inv(cell_m)
    frac -= np.floor(frac)
    bins = np.minimum((frac * [gx, gy, gz]).astype(np.int64), [gx - 1, gy - 1, gz - 1])
    cid = (bins[:, 0] * gy + bins[:, 1]) * gz + bins[:, 2]
    n_cells = gx * gy * gz
    counts_per_bin = np.bincount(cid, minlength=n_cells)
    cap = int(counts_per_bin.max())
    table = np.full((n_cells, cap), n, np.int64)
    order = np.argsort(cid, kind="stable")
    scid = cid[order]
    starts = np.cumsum(counts_per_bin) - counts_per_bin
    rank = np.arange(n) - starts[scid]
    table[scid, rank] = order

    frac_pad = np.concatenate([frac, np.zeros((1, 3))])
    neigh_count = np.zeros(n, np.int64)
    if typed:
        types_pad = np.concatenate([types, np.zeros((1,), np.int64)])
    cut2 = cutoff * cutoff
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            for c in (-1, 0, 1):
                nb = np.stack(
                    [(bins[:, 0] + a) % gx, (bins[:, 1] + b) % gy, (bins[:, 2] + c) % gz], axis=-1
                )
                cand = table[(nb[:, 0] * gy + nb[:, 1]) * gz + nb[:, 2]]
                df = frac_pad[cand] - frac[:, None, :]
                df -= np.round(df)
                dx = df @ cell_m
                d2 = np.sum(dx * dx, axis=-1)
                if typed:
                    rc = cutoff_matrix[types[:, None], types_pad[cand]]
                    ok = (cand < n) & (d2 <= rc * rc) & (cand != np.arange(n)[:, None])
                else:
                    ok = (cand < n) & (d2 <= cut2) & (cand != np.arange(n)[:, None])
                neigh_count += ok.sum(axis=1)
    return int(neigh_count.sum()), int(neigh_count.max()) if n else 0


def pad_edges(edge_index: np.ndarray, shifts: np.ndarray, n_pad: int, dump_atom: int = 0):
    """Pad an edge list to ``n_pad`` slots with masked self-loops on
    ``dump_atom``: (edge_index (2, n_pad) int32, shifts (n_pad, 3),
    edge_mask (n_pad,) bool).  The padded slots are (dump, dump) edges with
    zero shift, which the model masks with edge_mask."""
    e = edge_index.shape[1]
    if n_pad < e:
        raise ValueError(f"edge capacity {n_pad} < actual edges {e}")
    ei = np.full((2, n_pad), dump_atom, dtype=np.int32)
    sh = np.zeros((n_pad, 3), dtype=shifts.dtype if shifts is not None else np.float64)
    mask = np.zeros((n_pad,), dtype=bool)
    ei[:, :e] = edge_index
    if shifts is not None:
        sh[:e] = shifts
    mask[:e] = True
    return ei, sh, mask
