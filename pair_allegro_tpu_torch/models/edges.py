"""Per-edge geometry shared by the models, on the TABLE layout
(``table_edges``) and on the FLAT layout (``flat_edges``): edge vectors,
the typed per-edge cutoff, envelope, spherical harmonics and the Bessel
basis (``pair_allegro_tpu/models/allegro.py:285-393`` and
``models/nequip.py:492-625`` compute the same quantities the same way)."""

from __future__ import annotations

import torch

from pair_allegro_tpu_torch.ops.radial import bessel_basis, polynomial_cutoff
from pair_allegro_tpu_torch.ops.scatter import table_edge_vec, table_edge_vec_typed
from pair_allegro_tpu_torch.ops.so3 import spherical_harmonics


def table_edges(cfg, positions, types, edge_index, *, cell=None, edge_shifts=None,
                edge_mask=None, edge_rev=None, center_offset: int = 0, edge_vec=None,
                edge_tjf=None) -> dict:
    """For the (Nc, K) j-table of the centers [center_offset, center_offset
    + Nc) (all N atoms by default; neighbors range over all atoms): 'u'
    (Nc, K) envelope (zero on masked slots), 'Y' (Nc, K, D) with D =
    (cfg.l_max + 1)^2, 'bessel' (Nc, K, B) = bessel_basis(r) * u, and
    'oh_j' (Nc, K, T) the neighbor type one-hot (ones (Nc, K, 1) with one
    species).  ``edge_vec`` (and ``edge_tjf``, the neighbor types as floats,
    for a typed model) are the window's edge vectors before the shift
    gathered by the caller (the row-chunk mode); else, with ``edge_rev``
    and a table over all atoms, the position gradient is a gather
    (ops/scatter.py); else the neighbor rows are gathered here."""
    dtype, dev = positions.dtype, positions.device
    nc, k = edge_index.shape
    c0 = int(center_offset)
    if c0 < 0 or c0 + nc > positions.shape[0]:
        raise ValueError(f"center window [{c0}, {c0 + nc}) outside {positions.shape[0]} atoms")
    whole = nc == positions.shape[0]
    nt = cfg.num_types
    typed = nt > 1
    pos_c = positions if whole else positions[c0:c0 + nc]
    types_c = types if whole else types[c0:c0 + nc]
    pos_t = torch.cat([positions, types.to(dtype)[:, None]], 1) if typed else positions
    if edge_vec is not None:
        vec, tjf = edge_vec, edge_tjf
        if typed and tjf is None:
            raise ValueError("a typed model's window needs edge_tjf beside edge_vec")
    elif edge_rev is not None and edge_mask is not None and whole:
        if typed:
            vec, tjf = table_edge_vec_typed(pos_t, edge_index, edge_rev, edge_mask)
        else:
            vec, tjf = table_edge_vec(pos_t, edge_index, edge_rev, edge_mask), None
    else:
        ext = pos_t[edge_index]
        vec = (ext[..., :3] if typed else ext) - pos_c[:, None, :]
        tjf = ext[..., 3] if typed else None
    if edge_shifts is not None and cell is not None:
        vec = vec + edge_shifts.to(dtype) @ cell.to(dtype)
    r = torch.sqrt(torch.clamp_min(torch.sum(vec * vec, dim=-1), 1e-32))

    cut_mat = torch.as_tensor(cfg.cutoff_matrix(), dtype=dtype, device=dev)
    if typed:
        oh_j = (tjf[..., None] == torch.arange(nt, dtype=dtype, device=dev)).to(dtype)
        r_cut = torch.einsum("nkt,nt->nk", oh_j, cut_mat[types_c])
    else:
        oh_j = torch.ones((nc, k, 1), dtype=dtype, device=dev)
        r_cut = cut_mat[0, 0]
    u = polynomial_cutoff(r, r_cut, cfg.polynomial_cutoff_p)
    if edge_mask is not None:
        u = u * edge_mask.to(dtype)
    Y = spherical_harmonics(vec, cfg.l_max)
    bessel = bessel_basis(r, cfg.r_max, cfg.num_bessels) * u[..., None]
    return {"u": u, "Y": Y, "bessel": bessel, "oh_j": oh_j}


def is_flat(edge_index) -> bool:
    """True for the FLAT (2, E) layout, False for the (N, K) TABLE (the
    reference's test, ``models/allegro.py:286``)."""
    return edge_index.dim() == 2 and edge_index.shape[0] == 2


def flat_edges(cfg, positions, types, edge_index, *, cell=None, edge_shifts=None,
               edge_mask=None) -> dict:
    """For the (2, E) edge list (rows i and j): 'u' (E,) envelope at the
    pair's typed cutoff cutoff_matrix[t_i, t_j] (zero on masked slots), 'Y'
    (E, D), 'bessel' (E, B) = bessel_basis(r) * u, and the one-hots 'oh_i',
    'oh_j' (E, T) of the center and neighbor types.  The position gradient
    is autograd's scatter-add, as in the reference: ``index_select``'s
    backward is an ``index_add`` (the backward of ``positions[idx]``, an
    accumulating ``index_put`` that sorts the ids and walks duplicates,
    took 9.5 ms per gather at 266k edges on an H100, chip_smoke.py
    --profile flat)."""
    dtype, dev = positions.dtype, positions.device
    i_idx, j_idx = edge_index[0], edge_index[1]
    vec = positions.index_select(0, j_idx) - positions.index_select(0, i_idx)
    if edge_shifts is not None and cell is not None:
        vec = vec + edge_shifts.to(dtype) @ cell.to(dtype)
    r = torch.sqrt(torch.clamp_min(torch.sum(vec * vec, dim=-1), 1e-32))
    t_i, t_j = types[i_idx], types[j_idx]
    cut_mat = torch.as_tensor(cfg.cutoff_matrix(), dtype=dtype, device=dev)
    u = polynomial_cutoff(r, cut_mat[t_i, t_j], cfg.polynomial_cutoff_p)
    if edge_mask is not None:
        u = u * edge_mask.to(dtype)
    onehot = torch.eye(cfg.num_types, dtype=dtype, device=dev)
    return {"u": u, "Y": spherical_harmonics(vec, cfg.l_max),
            "bessel": bessel_basis(r, cfg.r_max, cfg.num_bessels) * u[..., None],
            "oh_i": onehot[t_i], "oh_j": onehot[t_j]}
