"""NequIP energies on both edge layouts (counterpart of
``pair_allegro_tpu/models/nequip.py``, its channels-last path).

Node features are channels-last (N, D, T, C): D = (l_max+1)^2, T tracks
(T = 2 with ``parity``: even and odd copies of every l), C channels.  Per
layer, on the (N, K) neighbor TABLE:

  hj   = h[j] gathered as (E, D*T*C) rows (gather backward: the reverse table)
  agg  = K3 (ops/nequip_conv.py): radial MLP of the bessel basis * u, the
         channelwise TP of hj with Y routed to tau = pi XOR (l2 mod 2), the
         per-center sum / sqrt(avg_n)   -- or, with ``fused_conv=False``,
         the plain channels-last message and sum

and on the FLAT (2, E) edge list the plain channels-last message of h[j]
(``msg_generic_cl``) summed per center with ``segment_sum``: K3 serves the
TABLE layout only, as the reference gates it (``models/nequip.py:642-649``),
so the FLAT path runs no kernel;
  h'   = gate(self_connection(h, type) + mix(agg)) per track and l: silu on
         even scalars, tanh * 1.5926 on odd scalars, sigmoid gates from the
         even scalars on l > 0

and E_i = scale[t_i] * readout_MLP(h[i, l=0, even]) + shift[t_i].

The parameter tree keeps the JAX layout (``nequip_params_from_numpy``); the
channels-last radial and gate columns and K3's weight layout are made from
it per call.  Both l_max go through the entry-table message
(``msg_generic_cl``).  Ported: l_max 1 and 2, one or two
tracks, any number of species, both layouts.  Not ported: the
channels-first generic path, l_max 3, remat=True, the bf16 hj tier,
``shard_axis``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch.models.edges import flat_edges, is_flat, table_edges
from pair_allegro_tpu_torch.ops.mlp import mlp_apply, mlp_dims, silu_norm_const
from pair_allegro_tpu_torch.ops.nequip_conv import (
    msg_generic_cl,
    nequip_conv,
    prepare_radial,
    radial_cl,
)
from pair_allegro_tpu_torch.ops.scatter import segment_sum, table_gather_nodes
from pair_allegro_tpu_torch.ops.so3 import sh_slice
from pair_allegro_tpu_torch.ops.tp import tp_num_paths

TANH_C = 1.5926  # 1/sqrt(E[tanh(x)^2]) for x ~ N(0, 1), as in the JAX model


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    """Hyperparameters, with the field names and defaults of the JAX
    package's ``NequIPConfig``."""

    type_names: tuple[str, ...]
    r_max: float
    l_max: int = 1
    num_layers: int = 3
    num_features: int = 64
    num_bessels: int = 8
    polynomial_cutoff_p: int = 6
    radial_mlp_depth: int = 2
    radial_mlp_width: int = 32
    readout_mlp_depth: int = 1
    readout_mlp_width: int = 32
    avg_num_neighbors: float = 1.0
    # "auto" and False keep no per-layer recompute; True is not ported
    remat: bool | str = "auto"
    per_edge_type_cutoff: tuple | None = None
    # two tracks (even and odd) per l, routed by pi XOR (l2 mod 2)
    parity: bool = False
    # the K3 kernel (weight cotangents NaN); False runs the plain message path
    fused_conv: bool = True

    @property
    def num_types(self) -> int:
        return len(self.type_names)

    @property
    def feature_dim(self) -> int:
        return (self.l_max + 1) ** 2

    @property
    def n_tracks(self) -> int:
        return 2 if self.parity else 1

    def cutoff_matrix(self) -> np.ndarray:
        if self.per_edge_type_cutoff is None:
            return np.full((self.num_types, self.num_types), self.r_max)
        m = np.asarray(self.per_edge_type_cutoff, dtype=np.float64)
        if m.shape != (self.num_types, self.num_types):
            raise ValueError(f"per_edge_type_cutoff shape {m.shape} != {(self.num_types,) * 2}")
        return m

    def for_training(self) -> "NequIPConfig":
        """The plain message path, whose weight gradients are finite."""
        return dataclasses.replace(self, fused_conv=False)

    def live_bytes_per_edge(self, flat: bool = False) -> int:
        """A rough upper estimate of the force evaluation's device bytes per
        edge slot (f32).  Kernel path (TABLE layout): every layer's gathered
        hj row (D*T*C floats, kept for the backward), one layer's dhj and the
        gather backward's buffer at a time, the bessel basis, Y, u and the
        geometry.  Plain path (``fused_conv=False``, or the FLAT layout): per
        layer also the radial weights (T*P*C) and the message terms autograd
        keeps (about six hj-sized tensors)."""
        df = self.feature_dim * self.n_tracks * self.num_features
        per = df * (self.num_layers + 2) + self.num_bessels + self.feature_dim + 1 + 64
        if flat or not self.fused_conv:
            tpc = self.n_tracks * tp_num_paths(self.l_max) * self.num_features
            per += self.num_layers * (2 * tpc + 6 * df)
        return 4 * per


def _check_supported(cfg: NequIPConfig) -> None:
    if cfg.l_max not in (1, 2):
        raise NotImplementedError(f"l_max={cfg.l_max}: the port runs NequIP at l_max 1 and 2")
    if cfg.remat is True:
        raise NotImplementedError("remat=True is not ported (use 'auto' or False)")


def nequip_init_numpy(cfg: NequIPConfig, seed: int = 0) -> dict:
    """A random parameter tree of the JAX layout (unit-normal weights, zero
    shifts, unit scales), made from ``seed`` with numpy."""
    rng = np.random.RandomState(seed)
    nt, C, lmax, T = cfg.num_types, cfg.num_features, cfg.l_max, cfg.n_tracks
    p_total = tp_num_paths(lmax)

    def mlp(dims):
        return {"w": [rng.randn(a, b) for a, b in zip(dims[:-1], dims[1:])]}

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "radial_mlp": mlp(mlp_dims(cfg.num_bessels, cfg.radial_mlp_width,
                                       cfg.radial_mlp_depth, C * p_total * T)),
            "self_w": [rng.randn(nt, C, C) for _ in range(lmax + 1)],
            "mix_w": [rng.randn(C, C) for _ in range(lmax + 1)],
            "gate_w": rng.randn(C, C * max(lmax, 1) * T),
        }
        if cfg.parity:
            layer["self_w_o"] = [rng.randn(nt, C, C) for _ in range(lmax + 1)]
            layer["mix_w_o"] = [rng.randn(C, C) for _ in range(lmax + 1)]
        layers.append(layer)
    return {
        "chem_embed": rng.randn(nt, C),
        "layers": layers,
        "readout_mlp": mlp(mlp_dims(C, cfg.readout_mlp_width, cfg.readout_mlp_depth, 1)),
        "per_type_shift": np.zeros(nt),
        "per_type_scale": np.ones(nt),
    }


def _gate_cl(gate_w, C: int, lmax: int, n_tracks: int):
    """Gate columns from the stored c-major packing (c*lmax*T + l*T + tau)
    to channels-last ((l*T + tau)*C + c), as ``models/nequip.py:_gate_cl``."""
    rows = gate_w.shape[0]
    return gate_w.reshape(rows, C, lmax * n_tracks).transpose(1, 2).reshape(rows, -1).contiguous()


def nequip_params_from_numpy(tree: dict, cfg: NequIPConfig, device=None,
                             dtype=torch.float32) -> dict:
    """The port's parameters from the JAX parameter tree given as numpy
    arrays (``jax.tree.map(np.asarray, nequip_init(...))``), in the JAX
    layout and nothing else: :func:`nequip_energy` permutes the radial and
    gate columns to channels-last on every call (a view and a small copy per
    layer), so gradients land on these leaves and an update to them is
    never stale."""
    from pair_allegro_tpu_torch.system import resolve_device

    _check_supported(cfg)
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
    return params


def _self_connect(hb, w_t, types):
    """Species-dependent self-connection sc[n] = hb[n] @ w_t[types[n]]
    (hb (N, d, C), w_t (T, C, C)): one matmul per type and a one-hot
    contraction, which never materializes the (N, C, C) per-atom weights.
    One type is one plain matmul: the one-hot form's extra launches cost the
    one-species NequIP main path 3.6-4.8 ms of its ~28 ms step on the H100
    (host dispatch, measured with chip_smoke.py; see PERF.md)."""
    if w_t.shape[0] == 1:
        return torch.einsum("ndc,ce->nde", hb, w_t[0])
    per_t = torch.einsum("ndc,tce->tnde", hb, w_t)
    onehot = F.one_hot(types, w_t.shape[0]).to(hb.dtype)
    return torch.einsum("tnde,nt->nde", per_t, onehot)


def nequip_energy(params: dict, cfg: NequIPConfig, positions, types, edge_index, *,
                  cell=None, edge_shifts=None, atom_mask=None, edge_mask=None,
                  edge_rev=None, capture: dict | None = None) -> dict:
    """Per-atom energies on either edge layout.

    edge_index is the (N, K) TABLE j-table over all atoms, padded slots
    referencing the center with edge_mask False, or the FLAT (2, E) list of
    rows i and j (padded slots are masked self edges); the edge vector is
    pos[j] - pos[i] + edge_shifts @ cell.  With ``edge_rev`` (TABLE only,
    neighbors.device.reverse_table) the position and node-feature backwards
    are gathers.  K3 runs on the TABLE layout with ``fused_conv``; the FLAT
    layout runs the plain message and ``segment_sum``, as in JAX.
    ``capture``, when a dict, receives the final node features
    channels-first, (N, C, D) or (N, C, D, 2) with parity, as the JAX
    model's does; the routing does not depend on it.  Returns
    'atomic_energy' (N,) and 'total_energy' ()."""
    _check_supported(cfg)
    dtype = positions.dtype
    n = positions.shape[0]
    C, lmax, T = cfg.num_features, cfg.l_max, cfg.n_tracks
    D, P = cfg.feature_dim, tp_num_paths(lmax)
    flat = is_flat(edge_index)
    if flat:
        geo = flat_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                         edge_mask=edge_mask)
        i_idx, j_idx = edge_index[0], edge_index[1]

        def gather(a):
            return a.index_select(0, j_idx)

        def agg_edges(a):
            return segment_sum(a, i_idx, n)
    else:
        k = edge_index.shape[1]
        geo = table_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                          edge_mask=edge_mask, edge_rev=edge_rev)
        if edge_rev is not None and edge_mask is not None:
            def gather(a):
                return table_gather_nodes(a, edge_index, edge_rev)
        else:
            def gather(a):
                return a[edge_index]

        def agg_edges(a):
            return a.sum(dim=1)
    u, Y, bessel = geo["u"], geo["Y"], geo["bessel"]
    use_k3 = cfg.fused_conv and not flat
    if use_k3:
        e = n * k
        u_e, Y_e, bes_e = u.reshape(e, 1), Y.reshape(e, D), bessel.reshape(e, -1)

    inv_avg = 1.0 / math.sqrt(max(cfg.avg_num_neighbors, 1e-6))
    act_c = silu_norm_const()
    keys = (("self_w", "mix_w"), ("self_w_o", "mix_w_o"))[:T]

    def layer_step(layer, h):
        ws_cl = radial_cl([w.to(dtype) for w in layer["radial_mlp"]["w"]], C, P, T)
        if use_k3:
            hj = gather(h.reshape(n, D * T * C)).reshape(e, D * T * C)
            k3 = prepare_radial(ws_cl, C, T, lmax)
            agg = nequip_conv(hj, bes_e, u_e, Y_e, k3, k, cfg.avg_num_neighbors)
            agg = agg.reshape(n, D, T, C)
        else:
            w = mlp_apply({"w": ws_cl}, bessel) * u[..., None]
            w = w.reshape(*u.shape, T, P, C)
            agg = agg_edges(msg_generic_cl(gather(h), Y, w, lmax)) * inv_avg
        new = []
        for tau, (sw, mw) in enumerate(keys):
            blocks = []
            for l3 in range(lmax + 1):
                sl = sh_slice(l3)
                sc = _self_connect(h[:, sl, tau, :], layer[sw][l3].to(dtype), types)
                mixed = agg[:, sl, tau, :] @ layer[mw][l3].to(dtype)
                blocks.append((sc + mixed) * (1.0 / math.sqrt(C)))
            new.append(blocks)
        act_even = F.silu(new[0][0][:, 0, :]) * act_c
        gate_w = _gate_cl(layer["gate_w"].to(dtype), C, lmax, T)
        gates = torch.sigmoid((act_even @ gate_w) * (1.0 / math.sqrt(C)))
        gates = gates.reshape(n, lmax, T, C)
        tracks = []
        for tau in range(T):
            s = act_even if tau == 0 else torch.tanh(new[1][0][:, 0, :]) * TANH_C
            parts = [s[:, None, :]]
            parts += [new[tau][l3] * gates[:, l3 - 1 : l3, tau, :] for l3 in range(1, lmax + 1)]
            tracks.append(torch.cat(parts, dim=1))
        return torch.stack(tracks, dim=2)

    h = torch.zeros((n, D, T, C), dtype=dtype, device=positions.device)
    h[:, 0, 0, :] = params["chem_embed"].to(dtype)[types]
    for layer in params["layers"]:
        h = layer_step(layer, h)
    if capture is not None:
        capture["node_features"] = h.permute(0, 3, 1, 2) if T == 2 else h[:, :, 0, :].transpose(1, 2)

    e_atom = mlp_apply(params["readout_mlp"], h[:, 0, 0, :])[:, 0]
    e_atom = params["per_type_scale"].to(dtype)[types] * e_atom + params["per_type_shift"].to(dtype)[types]
    if atom_mask is not None:
        e_atom = e_atom * atom_mask.to(dtype)
    return {"atomic_energy": e_atom, "total_energy": e_atom.sum()}
