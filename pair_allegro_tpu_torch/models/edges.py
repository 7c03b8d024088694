"""Per-edge geometry of the TABLE layout shared by the models: edge vectors,
the typed per-edge cutoff, envelope, spherical harmonics and the Bessel
basis (``pair_allegro_tpu/models/allegro.py`` and ``models/nequip.py:492-625``
compute the same quantities the same way)."""

from __future__ import annotations

import torch

from pair_allegro_tpu_torch.ops.radial import bessel_basis, polynomial_cutoff
from pair_allegro_tpu_torch.ops.scatter import table_edge_vec, table_edge_vec_typed
from pair_allegro_tpu_torch.ops.so3 import spherical_harmonics


def table_edges(cfg, positions, types, edge_index, *, cell=None, edge_shifts=None,
                edge_mask=None, edge_rev=None) -> dict:
    """For the (N, K) j-table over all atoms: 'u' (N, K) envelope (zero on
    masked slots), 'Y' (N, K, D) with D = (cfg.l_max + 1)^2, 'bessel'
    (N, K, B) = bessel_basis(r) * u, and 'oh_j' (N, K, T) the neighbor
    type one-hot (ones (N, K, 1) with one species).  With ``edge_rev`` the
    position gradient is a gather (ops/scatter.py)."""
    dtype, dev = positions.dtype, positions.device
    n, k = edge_index.shape
    if n != positions.shape[0]:
        raise ValueError(
            f"edge_index has {n} rows for {positions.shape[0]} atoms: only the TABLE "
            "layout over all atoms is ported (FLAT and windowed layouts are not)"
        )
    nt = cfg.num_types
    typed = nt > 1
    pos_t = torch.cat([positions, types.to(dtype)[:, None]], 1) if typed else positions
    if edge_rev is not None and edge_mask is not None:
        if typed:
            vec, tjf = table_edge_vec_typed(pos_t, edge_index, edge_rev, edge_mask)
        else:
            vec, tjf = table_edge_vec(pos_t, edge_index, edge_rev, edge_mask), None
    else:
        ext = pos_t[edge_index]
        vec = (ext[..., :3] if typed else ext) - positions[:, None, :]
        tjf = ext[..., 3] if typed else None
    if edge_shifts is not None and cell is not None:
        vec = vec + edge_shifts.to(dtype) @ cell.to(dtype)
    r = torch.sqrt(torch.clamp_min(torch.sum(vec * vec, dim=-1), 1e-32))

    cut_mat = torch.as_tensor(cfg.cutoff_matrix(), dtype=dtype, device=dev)
    if typed:
        oh_j = (tjf[..., None] == torch.arange(nt, dtype=dtype, device=dev)).to(dtype)
        r_cut = torch.einsum("nkt,nt->nk", oh_j, cut_mat[types])
    else:
        oh_j = torch.ones((n, k, 1), dtype=dtype, device=dev)
        r_cut = cut_mat[0, 0]
    u = polynomial_cutoff(r, r_cut, cfg.polynomial_cutoff_p)
    if edge_mask is not None:
        u = u * edge_mask.to(dtype)
    Y = spherical_harmonics(vec, cfg.l_max)
    bessel = bessel_basis(r, cfg.r_max, cfg.num_bessels) * u[..., None]
    return {"u": u, "Y": Y, "bessel": bessel, "oh_j": oh_j}
