"""Neighbor tables of the PyTorch port against the JAX package at f64: the
cell-list TABLE build (same slots, shifts, masks and overflow flag),
reverse_table, the host statistics, and the gather-based backward of the
edge-vector gathers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_allegro_tpu.neighbors.device as j_dev
import pair_allegro_tpu.neighbors.naive as j_naive
import pair_allegro_tpu_torch.neighbors.device as t_dev
import pair_allegro_tpu_torch.neighbors.naive as t_naive
from pair_allegro_tpu_torch.ops.scatter import table_edge_vec, table_edge_vec_typed
from pair_allegro_tpu_torch.system import fcc_lattice

torch.set_num_threads(2)
CUT_TABLE = np.array([[4.9, 4.4], [4.4, 4.0]])


def _case(typed, jitter=0.05):
    pos, cell = fcc_lattice(5, jitter=jitter, seed=3)
    types = np.random.RandomState(4).randint(0, 2, pos.shape[0]) if typed else None
    return pos, cell, types


def _build(pos, cell, types, k, cap, rc=4.9):
    grid = t_dev.choose_grid(cell, rc)
    assert grid == j_dev.choose_grid(cell, rc)
    ct = CUT_TABLE if types is not None else None
    j = j_dev.cell_list_neighbors(
        jnp.asarray(pos), jnp.asarray(cell), rc, grid, cap, k, flatten=False,
        types=None if types is None else jnp.asarray(types), cutoff_table=ct)
    t = t_dev.cell_list_neighbors(
        torch.tensor(pos), torch.tensor(cell), rc, grid, cap, k,
        types=None if types is None else torch.tensor(types), cutoff_table=ct)
    return j, t


@pytest.mark.parametrize("typed,k,cap,overflow", [
    (False, 64, 40, False),
    (True, 64, 40, False),
    (False, 24, 40, True),   # rows longer than K
    (False, 64, 12, True),   # bins fuller than their capacity
])
def test_cell_list_table_matches_jax(typed, k, cap, overflow):
    pos, cell, types = _case(typed)
    j, t = _build(pos, cell, types, k, cap)
    assert bool(j.overflow) == bool(t.overflow) == overflow
    np.testing.assert_array_equal(t.edge_index.numpy(), np.asarray(j.edge_index))
    np.testing.assert_array_equal(t.edge_mask.numpy(), np.asarray(j.edge_mask))
    np.testing.assert_array_equal(t.edge_shifts.numpy(), np.asarray(j.edge_shifts))
    if not overflow:
        rev_j = np.asarray(j_dev.reverse_table(j.edge_index, j.edge_shifts))
        np.testing.assert_array_equal(t_dev.reverse_table(t.edge_index, t.edge_shifts).numpy(),
                                      rev_j)
        # small row blocks take the same answer
        np.testing.assert_array_equal(
            t_dev.reverse_table(t.edge_index, t.edge_shifts, block_entries=5000).numpy(), rev_j)


@pytest.mark.parametrize("typed", [False, True])
def test_host_neighbor_stats_matches_jax(typed):
    pos, cell, types = _case(typed, jitter=0.1)
    kw = dict(types=types, cutoff_matrix=CUT_TABLE) if typed else {}
    assert t_naive.host_neighbor_stats(pos, cell, (True,) * 3, 4.9, **kw) == \
        j_naive.host_neighbor_stats(pos, cell, (True,) * 3, 4.9, **kw)


@pytest.mark.parametrize("typed", [False, True])
def test_table_edge_vec_backward_is_the_gather_transpose(typed):
    """The gather-based backward equals autograd of the plain gather."""
    pos, cell, types = _case(typed)
    _, t = _build(pos, cell, types, 64, 40)
    rev = t_dev.reverse_table(t.edge_index, t.edge_shifts)
    rng = np.random.RandomState(5)
    cot = torch.tensor(rng.randn(*t.edge_index.shape, 3))
    p = torch.tensor(pos)
    if typed:
        p = torch.cat([p, torch.tensor(types, dtype=p.dtype)[:, None]], 1)
    p1, p2 = p.clone().requires_grad_(True), p.clone().requires_grad_(True)
    if typed:
        vec, tjf = table_edge_vec_typed(p1, t.edge_index, rev, t.edge_mask)
        np.testing.assert_array_equal(tjf.detach().numpy(), types[t.edge_index.numpy()])
    else:
        vec = table_edge_vec(p1, t.edge_index, rev, t.edge_mask)
    plain = p2[t.edge_index][..., :3] - p2[:, None, :3]
    # padded self-edges carry zero vectors, as the model sees them
    plain = plain * t.edge_mask[..., None]
    (g1,) = torch.autograd.grad((vec * cot).sum(), p1)
    (g2,) = torch.autograd.grad((plain * cot).sum(), p2)
    np.testing.assert_allclose(vec.detach().numpy(), plain.detach().numpy(), atol=1e-12)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), atol=1e-12, rtol=1e-12)
