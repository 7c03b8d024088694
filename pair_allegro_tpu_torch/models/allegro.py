"""Allegro energies on the TABLE layout (counterpart of
``pair_allegro_tpu/models/allegro.py``, its feature-major fused tier).

Per ordered edge (i, j) of the (N, K) neighbor table, feature-major
(features, E) with E = N*K:

  two-body: x0 = MLP2b([onehot(t_i); onehot(t_j); Bessel(r)]) * u(r)
            pT = W_embed^T x0 / sqrt(ns)                   (V0 = pT * Y)
  layers:   one K1 call each (ops/fused_layer.py): first (builds V0 from
            pT), middle, last (no V output)
  readout:  E_ij = MLP_out(x) * u;  E_i = scale[t_i] * sum_j E_ij + shift[t_i]

The parameter tree keeps the JAX layout (``allegro_params_from_numpy``);
each layer also carries its kernel-layout weights under ``"k1"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pair_allegro_tpu_torch.models.edges import table_edges
from pair_allegro_tpu_torch.ops.fused_layer import fused_layer, prepare_layer
from pair_allegro_tpu_torch.ops.mlp import mlp_apply_t
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l


@dataclasses.dataclass(frozen=True)
class AllegroConfig:
    """Hyperparameters, with the field names and defaults of the JAX
    package's ``AllegroConfig`` (its TPU tier switches are not carried)."""

    type_names: tuple[str, ...]
    r_max: float
    l_max: int = 2
    num_layers: int = 3
    num_scalar_features: int = 64
    num_tensor_features: int = 32
    num_bessels: int = 8
    polynomial_cutoff_p: int = 6
    two_body_mlp_depth: int = 2
    two_body_mlp_width: int = 64
    allegro_mlp_hidden_layers_depth: int = 2
    allegro_mlp_hidden_layers_width: int = 64
    readout_mlp_hidden_layers_depth: int = 1
    readout_mlp_hidden_layers_width: int = 32
    avg_num_neighbors: float = 1.0
    # True keeps only even (l1 + l2 + l3) tensor-product paths
    parity: bool = True
    per_edge_type_cutoff: tuple | None = None  # (num_types, num_types) nested tuple
    # extra head: per-atom 'charges' and the global 'dipole' sum q_i r_i
    output_charges: bool = False

    @property
    def num_types(self) -> int:
        return len(self.type_names)

    def live_bytes_per_edge(self) -> int:
        """A rough upper estimate of the force evaluation's device bytes per
        edge slot: every layer's V (D*C floats) and its cotangent, a few
        scalar-feature tensors and the geometry (f32)."""
        d = (self.l_max + 1) ** 2
        c, ns = self.num_tensor_features, self.num_scalar_features
        return 4 * (2 * d * c * self.num_layers + 6 * ns + 64)

    def cutoff_matrix(self) -> np.ndarray:
        """(num_types, num_types) per-edge-type cutoffs, defaulting to r_max."""
        if self.per_edge_type_cutoff is None:
            return np.full((self.num_types, self.num_types), self.r_max)
        m = np.asarray(self.per_edge_type_cutoff, dtype=np.float64)
        if m.shape != (self.num_types, self.num_types):
            raise ValueError(f"per_edge_type_cutoff shape {m.shape} != {(self.num_types,) * 2}")
        return m


def allegro_init_numpy(cfg: AllegroConfig, seed: int = 0) -> dict:
    """A random parameter tree of the JAX layout (unit-normal weights, zero
    shifts, unit scales), made from ``seed`` with numpy."""
    rng = np.random.RandomState(seed)
    nt, ns, c, lmax = cfg.num_types, cfg.num_scalar_features, cfg.num_tensor_features, cfg.l_max
    P = num_paths_per_l(lmax, lmax, lmax, cfg.parity)

    def mlp(*dims):
        return {"w": [rng.randn(a, b) for a, b in zip(dims[:-1], dims[1:])]}

    ro = (ns, *[cfg.readout_mlp_hidden_layers_width] * cfg.readout_mlp_hidden_layers_depth, 1)
    tree = {
        "two_body_mlp": mlp(2 * nt + cfg.num_bessels,
                            *[cfg.two_body_mlp_width] * cfg.two_body_mlp_depth, ns),
        "tensor_embed": rng.randn(ns, c),
        "layers": [
            {
                "env_weight": rng.randn(ns, c),
                "latent_mlp": mlp(ns + c * P[0], *[cfg.allegro_mlp_hidden_layers_width]
                                  * cfg.allegro_mlp_hidden_layers_depth, ns),
                "mix": {f"l{l3}": rng.randn(c * P[l3], c) for l3 in range(lmax + 1)},
            }
            for _ in range(cfg.num_layers)
        ],
        "readout_mlp": mlp(*ro),
        "per_type_shift": np.zeros(nt),
        "per_type_scale": np.ones(nt),
    }
    if cfg.output_charges:
        tree["charge_mlp"] = mlp(*ro)
    return tree


def allegro_params_from_numpy(tree: dict, cfg: AllegroConfig, device=None,
                              dtype=torch.float32) -> dict:
    """The port's parameters from the JAX parameter tree given as numpy
    arrays (``jax.tree.map(np.asarray, allegro_init(...))``).  The JAX layout
    is kept; each layer gains its kernel-layout weights under ``"k1"``."""
    from pair_allegro_tpu_torch.system import resolve_device

    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [conv(v) for v in a]
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    params = conv(tree)
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(params['layers'])} layers in the tree, cfg says {cfg.num_layers}")
    for layer in params["layers"]:
        layer["k1"] = prepare_layer(layer, cfg.l_max, cfg.parity)
    return params


def allegro_inputs(params: dict, cfg: AllegroConfig, positions, types, edge_index, *,
                   cell=None, edge_shifts=None, edge_mask=None, edge_rev=None) -> dict:
    """The per-edge operands of the layer stack on the TABLE layout:
    'u' (N, K) envelope, and feature-major 'uT' (1, E), 'Y_T' (D, E),
    'xT' (ns, E) two-body latent and 'pT' (C, E) tensor embedding."""
    dtype, dev = positions.dtype, positions.device
    n, k = edge_index.shape
    nt = cfg.num_types
    geo = table_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                      edge_mask=edge_mask, edge_rev=edge_rev)
    u, Y, bessel, oh_j = geo["u"], geo["Y"], geo["bessel"], geo["oh_j"]

    e = n * k
    ti = types[:, None].expand(n, k).reshape(1, e)
    in_T = torch.cat(
        [
            (ti == torch.arange(nt, device=dev)[:, None]).to(dtype),
            oh_j.reshape(e, nt).T,
            bessel.reshape(e, -1).T,
        ],
        dim=0,
    )
    uT = u.reshape(1, e)
    xT = mlp_apply_t(params["two_body_mlp"], in_T) * uT  # (ns, E)
    ns = params["tensor_embed"].shape[0]
    pT = (params["tensor_embed"].to(dtype).T @ xT) * (1.0 / math.sqrt(ns))  # (C, E)
    return {"u": u, "uT": uT, "Y_T": Y.reshape(e, -1).T.contiguous(), "xT": xT, "pT": pT}


def allegro_energy(params: dict, cfg: AllegroConfig, positions, types, edge_index, *,
                   cell=None, edge_shifts=None, atom_mask=None, edge_mask=None,
                   edge_rev=None) -> dict:
    """Per-atom energies on the TABLE layout.

    edge_index is the (N, K) j-table with the center implicit in the row
    (padded slots reference the center itself with edge_mask False); the
    edge vector is pos[j] - pos[i] + edge_shifts @ cell.  With ``edge_rev``
    (neighbors.device.reverse_table) the force backward is a gather.
    Returns 'atomic_energy' (N,), 'total_energy' (), 'edge_energy' (N, K)
    and, with ``output_charges``, 'charges' (N,) and 'dipole' (3,)."""
    dtype = positions.dtype
    n, k = edge_index.shape
    ins = allegro_inputs(params, cfg, positions, types, edge_index, cell=cell,
                         edge_shifts=edge_shifts, edge_mask=edge_mask, edge_rev=edge_rev)
    u, uT, Y_T, xT, pT = (ins[key] for key in ("u", "uT", "Y_T", "xT", "pT"))
    layers = params["layers"]
    Vc = pT
    for li, layer in enumerate(layers):
        last = li == len(layers) - 1
        out = fused_layer(xT, Vc, Y_T, uT, layer["k1"], k, cfg.avg_num_neighbors,
                          first_v=li == 0, last=last)
        if last:
            xT = out
        else:
            xT, Vc = out

    e_edge = mlp_apply_t(params["readout_mlp"], xT)[0].reshape(n, k) * u
    e_atom = e_edge.sum(dim=1)
    e_atom = params["per_type_scale"].to(dtype)[types] * e_atom + params["per_type_shift"].to(dtype)[types]
    if atom_mask is not None:
        e_atom = e_atom * atom_mask.to(dtype)
    out = {"atomic_energy": e_atom, "total_energy": e_atom.sum(), "edge_energy": e_edge}
    if cfg.output_charges:
        q_edge = mlp_apply_t(params["charge_mlp"], xT)[0].reshape(n, k) * u
        q_atom = q_edge.sum(dim=1)
        if atom_mask is not None:
            q_atom = q_atom * atom_mask.to(dtype)
        out["charges"] = q_atom
        out["dipole"] = torch.sum(q_atom[:, None] * positions, dim=0)
    return out
