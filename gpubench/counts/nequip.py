"""Operations and bytes of one NequIP force evaluation (energy and forces)
on E real edges: the pairs within r_max that the benchmark's own neighbor
routine counts, not the program's padded slots.

The convolution's terms are a frozen copy of ``chip_smoke.py``'s
``k3_cost`` (the K3 kernel, forward and backward with its recompute of the
radial MLP), taken per real edge and per node; the rest of the evaluation
(edge geometry, the self-connections, mixes and gates of every layer, the
readout, and the backward of each for the position gradient alone) is
counted here from the model's equations.  Products are the matrix
products; of K3's, those of the last radial layer, as ``k3_cost`` counts
them.  Bytes: each input read once (positions, types, the edge list as two
int32 a pair, the weights) and each output written once (forces, per-atom
energies), f32.
"""

from __future__ import annotations

import functools

import numpy as np

from gpubench.counts.allegro import GEOMETRY_OPS, SILU_OPS, mlp_ops
from gpubench.reference.so3 import paths_to_l, real_wigner_3j


@functools.lru_cache(maxsize=None)
def n_entries(lmax: int) -> int:
    """Nonzero 3j entries of the message's product over every path."""
    return sum(int((np.abs(real_wigner_3j(l1, l2, l3)) > 1e-14).sum())
               for l3 in range(lmax + 1) for l1, l2 in paths_to_l(lmax, lmax, l3))


def radial_dims(m: dict) -> list[int]:
    from gpubench.reference.nequip import n_paths

    T = 2 if m["parity"] else 1
    return [m["num_bessels"], *[m["radial_mlp_width"]] * m["radial_mlp_depth"],
            T * n_paths(m["l_max"]) * m["num_features"]]


def k3_cost(dims, c: int, n_tracks: int, lmax: int, n_weights: int, e: int, n_centers: int,
            bwd: bool):
    """(flops, prod, bytes) of one K3 call on E edges of ``n_centers``
    centers (``chip_smoke.k3_cost``, its E // K being the centers)."""
    T = n_tracks
    n_ent = n_entries(lmax)
    d = (lmax + 1) ** 2
    df, tpc, b = d * T * c, dims[-1], dims[0]
    hidden = sum(2 * a * o + 5 * o for a, o in zip(dims[:-2], dims[1:-1]))
    last = 2 * dims[-2] * tpc
    radial = hidden + last + tpc
    if not bwd:
        per = radial + 4 * n_ent * T * c
        prod = last
        io = (df + b + 1 + d) * e + df * n_centers
    else:
        back = last + sum(2 * a * o + 8 * o for a, o in zip(dims[:-2], dims[1:-1]))
        per = radial + 9 * n_ent * T * c + 3 * tpc + back
        prod = 2 * last
        io = 2 * (df + b + 1 + d) * e + df * n_centers
    return per * e, prod * e, 4 * (io + n_weights)


def n_weights(m: dict) -> int:
    from gpubench.families import n_leaves
    from gpubench.families.nequip import tree_shapes

    return n_leaves(tree_shapes(m))


def evaluation(m: dict, n_atoms: int, n_edges: int) -> dict:
    """'flops', 'products' (of the flops) and 'bytes' of one force
    evaluation of the model ``m`` (a configuration's ``model`` block) on
    ``n_atoms`` atoms with ``n_edges`` real edges."""
    C, lmax = m["num_features"], m["l_max"]
    T = 2 if m["parity"] else 1
    d = (lmax + 1) ** 2
    dims = radial_dims(m)
    radial_w = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    flops = prod = 0
    for bwd in (False, True):
        f, p, _ = k3_cost(dims, C, T, lmax, radial_w, n_edges, n_atoms, bwd)
        flops, prod = flops + f, prod + p
    flops *= m["num_layers"]
    prod *= m["num_layers"]
    # per node and layer: self-connection and mix (each T * D * 2 C^2) and
    # the gate's product, forward and the position backward; the
    # activations and gating
    node_prod = 2 * (2 * T * d * 2 * C * C + 2 * C * C * lmax * T)
    node_other = 3 * 5 * d * T * C
    readout = [C, *[m["readout_mlp_width"]] * m["readout_mlp_depth"], 1]
    flops += n_atoms * (m["num_layers"] * (node_prod + node_other) + 2 * mlp_ops(readout)
                        + 3 * SILU_OPS * sum(readout[1:-1]) + 4)
    prod += n_atoms * (m["num_layers"] * node_prod + 2 * mlp_ops(readout))
    flops += n_edges * 3 * GEOMETRY_OPS
    nbytes = 4 * (n_atoms * (3 + 1 + 3 + 1) + 2 * n_edges + n_weights(m))
    return {"flops": flops, "products": prod, "bytes": nbytes}
