"""The edge-dump channel (counterpart of ``pair_allegro_tpu/debug.py``): with
``PAT_LOG_LEVEL=DEBUG`` the CLI prints every edge the first neighbor build
holds as canonical (i, j, shift[, r]) tuples, the analog of the reference's
``_NEQUIP_LOG_LEVEL=DEBUG`` dump; ``edge_set`` gives the same tuples for
differential tests, from either layout."""

from __future__ import annotations

import os
import sys

import numpy as np

from pair_allegro_tpu_torch.io.dump import host

ENV_VAR = "PAT_LOG_LEVEL"


def debug_enabled() -> bool:
    return os.environ.get(ENV_VAR, "").upper() == "DEBUG"


def edge_set(neighbors, positions=None, cell=None) -> set:
    """Canonical edge tuples {(i, j, sx, sy, sz[, r])} of a NeighborData on
    the FLAT (2, E) or the TABLE (N, K) layout; with ``positions`` (and
    ``cell`` for periodic systems) each tuple carries the edge's length,
    rounded to 1e-10.  A sharded engine's data is joined first
    (``ShardedNeighbors.gathered``)."""
    if hasattr(neighbors, "gathered"):
        neighbors = neighbors.gathered()
    ei = host(neighbors.edge_index)
    mask = host(neighbors.edge_mask).reshape(-1)
    if ei.ndim == 2 and ei.shape[0] == 2 and mask.shape[0] == ei.shape[1]:  # FLAT
        i_arr, j_arr = ei[0], ei[1]
    else:  # TABLE: row n holds center n's neighbors
        n, k = ei.shape
        i_arr = np.repeat(np.arange(n, dtype=np.int64), k)
        j_arr = ei.reshape(-1)
    sh = (np.zeros((len(mask), 3)) if neighbors.edge_shifts is None
          else host(neighbors.edge_shifts).reshape(-1, 3))
    pos = None if positions is None else np.asarray(host(positions), np.float64)
    cl = None if cell is None else np.asarray(host(cell), np.float64)
    out = set()
    for idx in np.nonzero(mask)[0]:
        i, j = int(i_arr[idx]), int(j_arr[idx])
        s = tuple(int(round(x)) for x in sh[idx])
        if pos is None:
            out.add((i, j, *s))
            continue
        vec = pos[j] - pos[i]
        if cl is not None:
            vec = vec + np.asarray(sh[idx], np.float64) @ cl
        out.add((i, j, *s, round(float(np.linalg.norm(vec)), 10)))
    return out


def dump_edges(neighbors, positions=None, cell=None, file=None) -> int:
    """Print the canonical edge list, sorted; returns the edge count."""
    file = file or sys.stdout
    edges = sorted(edge_set(neighbors, positions, cell))
    for e in edges:
        print("EDGE " + " ".join(str(x) for x in e), file=file)
    print(f"EDGES TOTAL {len(edges)}", file=file)
    return len(edges)
