"""Edge -> atom reductions and the gathers of the two edge layouts, and the
masked mean (counterpart of ``pair_allegro_tpu/ops/scatter.py``).

``segment_sum`` is the per-atom reduction of the FLAT (2, E) layout, an
``index_add`` over unsorted ids (its backward is a gather).  On the TABLE
layout the reduction is a sum over the row, and the gathers below take a
gather-based backward instead of autograd's scatter-add.

The plain gather's transpose is a scatter-add of the (N*K, 3) edge-vector
cotangent into (N, 3).  The TABLE is symmetric (one scalar build cutoff),
so the edges into atom a are the reverses of a's own row, located by
``reverse_table``:

  dpos[a] = sum_k' dvec_masked_flat[rev[a, k']] - sum_k dvec_masked[a, k]

which is a row gather and a reduction.  Padded slots map to the appended
zero row.  Only valid when the table rows are all atoms.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """out[s] = sum of the rows of ``data`` whose id is s, for s <
    ``num_segments`` (ids unsorted, each in range).  On CUDA the sum order
    is that of the atomics, so the last bits vary from run to run."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def _vec_cotangent_to_atoms(dvec, rev_idx, edge_mask):
    n, k = rev_idx.shape
    dm = dvec * edge_mask.to(dvec.dtype).unsqueeze(-1)
    dflat = torch.cat([dm.reshape(n * k, 3), dm.new_zeros(1, 3)], dim=0)
    return dflat[rev_idx].sum(dim=1) - dm.sum(dim=1)


class _TableEdgeVec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, j_idx, rev_idx, edge_mask):
        ctx.save_for_backward(rev_idx, edge_mask)
        return positions[j_idx] - positions.unsqueeze(1)

    @staticmethod
    def backward(ctx, dvec):
        rev_idx, edge_mask = ctx.saved_tensors
        return _vec_cotangent_to_atoms(dvec, rev_idx, edge_mask), None, None, None


class _TableEdgeVecTyped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos_t, j_idx, rev_idx, edge_mask):
        ctx.save_for_backward(rev_idx, edge_mask)
        ext = pos_t[j_idx]
        return ext[..., :3] - pos_t[:, None, :3], ext[..., 3]

    @staticmethod
    def backward(ctx, dvec, _dtj):
        rev_idx, edge_mask = ctx.saved_tensors
        dpos = _vec_cotangent_to_atoms(dvec, rev_idx, edge_mask)
        return torch.cat([dpos, dpos.new_zeros(dpos.shape[0], 1)], dim=1), None, None, None


def table_edge_vec(positions, j_idx, rev_idx, edge_mask):
    """vec[i, k] = positions[j_idx[i, k]] - positions[i]."""
    return _TableEdgeVec.apply(positions, j_idx, rev_idx, edge_mask)


def table_edge_vec_typed(pos_t, j_idx, rev_idx, edge_mask):
    """(vec, t_j as float): ``pos_t`` carries the type as a 4th column, which
    the model consumes only through comparisons (no cotangent)."""
    return _TableEdgeVecTyped.apply(pos_t, j_idx, rev_idx, edge_mask)


class _TableGatherNodes(torch.autograd.Function):
    """out[i, k] = h[j_idx[i, k]]; the backward is the reverse-table row
    gather of ``pair_allegro_tpu/ops/scatter.py:136-160``:

      dh[a] = sum_k' g_flat[rev[a, k']]   over the valid rev entries

    Slots whose rev is the sentinel N*K (padding, edges without a mirror)
    are clamped onto a real row and zeroed after the gather, so no zero row
    is appended to the (E, feat) cotangent.  The zeroing is in place on the
    gathered buffer: one (E, feat) allocation instead of two.  A bf16
    cotangent (the NequIP bf16 hj boundary) is summed in f32 and returned
    at bf16, as the reference does (``ops/scatter.py:150-159``): a K-deep
    bf16 sum would cost ~1% relative."""

    @staticmethod
    def forward(ctx, h, j_idx, rev_idx):
        ctx.save_for_backward(rev_idx)
        return h[j_idx]

    @staticmethod
    def backward(ctx, g):
        (rev_idx,) = ctx.saved_tensors
        n, k = rev_idx.shape
        feat = g.shape[2:]
        gflat = g.reshape(n * k, *feat)
        valid = rev_idx < n * k
        rows = gflat.index_select(0, torch.clamp_max(rev_idx, n * k - 1).reshape(-1))
        rows = rows.reshape(n, k, *feat)
        rows.masked_fill_(~valid.reshape(n, k, *([1] * len(feat))), 0.0)
        if g.dtype == torch.bfloat16:
            return rows.sum(dim=1, dtype=torch.float32).to(g.dtype), None, None
        return rows.sum(dim=1), None, None


def table_gather_nodes(h, j_idx, rev_idx):
    """out[i, k, ...] = h[j_idx[i, k], ...] with the gather-based backward
    (valid when the table rows are all atoms and the table is symmetric)."""
    return _TableGatherNodes.apply(h, j_idx, rev_idx)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None, eps: float = 1e-12):
    """The mean of ``x`` over the entries where ``mask`` is set, along
    ``axis`` (every axis when None), never dividing by less than ``eps``
    (counterpart of ``ops/scatter.py:166``)."""
    m = mask.to(x.dtype)
    if axis is None:
        return (x * m).sum() / torch.clamp(m.sum(), min=eps)
    return (x * m).sum(dim=axis) / torch.clamp(m.sum(dim=axis), min=eps)
