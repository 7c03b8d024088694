"""Operations and bytes of one Allegro force evaluation (energy and forces)
on E real edges: the pairs within r_max that the benchmark's own neighbor
routine counts, not the program's padded slots.

The layer stack's terms are a frozen copy of ``chip_smoke.py``'s
``k1_terms`` / ``k1_cost`` / ``k1_products`` (the K1 kernel's forms,
forward and backward with its recompute), taken per real edge; the rest
of the evaluation (edge geometry, the two-body MLP, the tensor embedding,
the readout, the per-center sums, and the backward of each for the
position gradient alone) is counted here from the model's equations.
Products are the matrix products, which the policy's builds may run on
the tensor cores; everything else counts as f32 work.  Bytes: each input
read once (positions, types, the edge list as two int32 a pair, the
weights) and each output written once (forces, per-atom energies), f32.
"""

from __future__ import annotations

import functools

import numpy as np

from gpubench.reference.allegro import parity_paths as paths
from gpubench.reference.so3 import paths_to_l, real_wigner_3j, sh_slice

FORMS = {"first": (True, False), "middle": (False, False), "last": (False, True)}
# edge geometry per edge: vector and length (~10), the l <= 2 harmonics
# (~40), the Bessel basis and envelope (~40); its backward twice that
GEOMETRY_OPS = 90
SILU_OPS = 5  # sigmoid, product and norm constant, per element


@functools.lru_cache(maxsize=None)
def row_tables(lmax: int, parity: bool) -> tuple:
    """Per output row r = l3^2 + k: (the nonzero 3j entries (p, i, j, w)
    landing on it, l3), the K1 body's row tables."""
    rows = []
    for l3 in range(lmax + 1):
        ents = []
        for p, (l1, l2) in enumerate(paths_to_l(lmax, lmax, l3, parity)):
            C = real_wigner_3j(l1, l2, l3)
            for i, j, k in zip(*np.nonzero(C)):
                ents.append((p, int(i) + sh_slice(l1).start, int(j) + sh_slice(l2).start,
                             int(k), float(C[i, j, k])))
        for k in range(2 * l3 + 1):
            rows.append((tuple((p, i, j, w) for p, i, j, kk, w in ents if kk == k), l3))
    return tuple(rows)


def mlp_ops(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def k1_terms(dims, lmax: int, parity: bool, form, bwd: bool):
    """(operations per edge, rows read, rows written) of one K1 call of
    ``form``; ``dims`` = (ns, C, C_out, latent MLP widths)."""
    first_v, last = FORMS[form] if isinstance(form, str) else form
    ns, c, cout, latd = dims
    rows = row_tables(lmax, parity)
    P = paths(lmax, parity)
    d = len(rows)
    used = rows[:1] if last else rows
    n_tp = sum(len(ents) for ents, _ in used)
    mlp = mlp_ops(latd)
    mix = 0 if last else sum(2 * cout * P[l3] * c for _, l3 in rows)
    env = 2 * ns * c + 2 * d * c
    if not bwd:
        per = env + (d * c if first_v else 0) + 2 * c * n_tp + mix + mlp + 3 * ns
        io_in = ns + (c if first_v else d * c) + d + 1
        io_out = ns + (0 if last else d * cout)
    else:
        n_inv = len(rows[0][0])
        per = (env + 2 * c * n_inv + mlp) + mlp + mix + 4 * c * n_tp \
            + (4 * d * c + 2 * c + 2 * ns * c) + (4 * d * c if first_v else 0)
        v_rows = c if first_v else d * c
        io_in = ns + v_rows + d + 1 + ns + (0 if last else d * cout)
        io_out = ns + v_rows + d + 1
    return per, io_in, io_out


def k1_cost(dims, n_weights: int, lmax: int, parity: bool, e: int, form, bwd: bool, nb: int = 4):
    """(flops, bytes) of one K1 call at E edges (``chip_smoke.k1_cost``)."""
    per, io_in, io_out = k1_terms(dims, lmax, parity, form, bwd)
    return per * e, nb * ((io_in + io_out) * e + n_weights)


def k1_products(dims, lmax: int, parity: bool, form, bwd: bool) -> int:
    """Of ``k1_terms``'s operations per edge, those of the matrix products."""
    first_v, last = FORMS[form] if isinstance(form, str) else form
    ns, c, cout, latd = dims
    P = paths(lmax, parity)
    mlp = mlp_ops(latd)
    mix = 0 if last else sum(2 * cout * P[l3] * c for _, l3 in row_tables(lmax, parity))
    return 4 * ns * c + 2 * mlp + mix if bwd else 2 * ns * c + mlp + mix


def layer_dims(m: dict):
    ns, c = m["num_scalar_features"], m["num_tensor_features"]
    P = paths(m["l_max"], m["parity"])
    latd = [ns + c * P[0], *[m["allegro_mlp_hidden_layers_width"]]
            * m["allegro_mlp_hidden_layers_depth"], ns]
    return ns, c, c, latd


def layer_forms(n_layers: int) -> list:
    if n_layers == 1:
        return [(True, True)]
    return ["first", *["middle"] * (n_layers - 2), "last"]


def n_weights(m: dict) -> int:
    from gpubench.families import n_leaves
    from gpubench.families.allegro import tree_shapes

    return n_leaves(tree_shapes(m))


def evaluation(m: dict, n_atoms: int, n_edges: int) -> dict:
    """'flops', 'products' (of the flops) and 'bytes' of one force
    evaluation of the model ``m`` (a configuration's ``model`` block) on
    ``n_atoms`` atoms with ``n_edges`` real edges."""
    ns, c = m["num_scalar_features"], m["num_tensor_features"]
    nt = len(m["type_names"])
    dims = layer_dims(m)
    two_body = [2 * nt + m["num_bessels"], *[m["two_body_mlp_width"]] * m["two_body_mlp_depth"], ns]
    readout = [ns, *[m["readout_mlp_hidden_layers_width"]]
               * m["readout_mlp_hidden_layers_depth"], 1]
    hidden = sum(two_body[1:-1]) + sum(readout[1:-1])
    # forward and the position backward of the glue: each product once
    # each way, the SiLUs and the envelope products
    glue_prod = 2 * (mlp_ops(two_body) + 2 * ns * c + mlp_ops(readout))
    glue_other = 3 * GEOMETRY_OPS + 3 * SILU_OPS * hidden + 4 * (ns + 1) + 2
    per_edge, per_prod = glue_prod + glue_other, glue_prod
    for form in layer_forms(m["num_layers"]):
        for bwd in (False, True):
            per_edge += k1_terms(dims, m["l_max"], m["parity"], form, bwd)[0]
            per_prod += k1_products(dims, m["l_max"], m["parity"], form, bwd)
    nbytes = 4 * (n_atoms * (3 + 1 + 3 + 1) + 2 * n_edges + n_weights(m))
    return {"flops": per_edge * n_edges + 4 * n_atoms, "products": per_prod * n_edges,
            "bytes": nbytes}
