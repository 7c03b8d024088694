"""NequIP energies on both edge layouts (counterpart of
``pair_allegro_tpu/models/nequip.py``, its channels-last path).

Node features are channels-last (N, D, T, C): D = (l_max+1)^2, T tracks
(T = 2 with ``parity``: even and odd copies of every l), C channels.  Per
layer, on the (N, K) neighbor TABLE:

  hj   = h[j] gathered as (E, D*T*C) rows (gather backward: the reverse table)
  agg  = K3 (ops/nequip_conv.py): radial MLP of the bessel basis * u, the
         channelwise TP of hj with Y routed to tau = pi XOR (l2 mod 2), the
         per-center sum / sqrt(avg_n)   -- or, with ``fused_conv=False``,
         ``capture``, widths K3 does not take or, on the card, any dtype
         but f32 (``conv_route``), the plain channels-last message and sum

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
(``msg_generic_cl``); so does l_max 3, which K3 does not take.  Above
l_max 3, or with ``PAT_NEQUIP_GENERIC=1``, the layers run the reference's
generic channels-first path (``layer_fn`` / ``layer_fn_parity``,
``models/nequip.py:733-866``): node features (N, C, D[, 2]), the message
from ``uniform_tp`` per path, and no kernel.  With remat (``cfg.remat``,
or "auto" wherever K3 does not run, as in the reference) each layer is a
``torch.utils.checkpoint``.  Ported: l_max >= 1, one or two tracks, any
number of species, both layouts, node windows over a device mesh
(``mesh``, JAX's ``shard_axis``), and the bf16 hj tier: with
``PAT_NEQUIP_HJ=bf16`` (read per call, ``hj_bf16``) a call on K3's route at
f32 gathers the flat node rows through a bf16 boundary, as the reference
does (``models/nequip.py:135-147, 880-881``): K3 (its bf16-hj build on the
card, its plain version on the CPU) upcasts hj and computes in f32, and
the gather's reverse-table backward sums the bf16 cotangent in f32.  Not
ported: l_max 0 (the reference fails there too).
"""

from __future__ import annotations

import dataclasses
import math
import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.models.edges import flat_edges, is_flat, table_edges
from pair_allegro_tpu_torch.ops.mlp import mlp_apply, mlp_dims, silu_norm_const
from pair_allegro_tpu_torch.ops.nequip_conv import (
    kernel_takes,
    msg_generic_cl,
    nequip_conv,
    prepare_radial,
    radial_cl,
)
from pair_allegro_tpu_torch.ops.remat import rematerialized
from pair_allegro_tpu_torch.ops.scatter import segment_sum, table_gather_nodes
from pair_allegro_tpu_torch.ops.so3 import sh_slice
from pair_allegro_tpu_torch.ops.tp import paths_to_l, tp_num_paths, uniform_tp

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
    # recompute each layer's forward in the backward: True, False, or "auto"
    # (resolved by the engines; where it reaches the model, on exactly when
    # K3 does not run)
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

    def live_bytes_per_edge(self, flat: bool = False, dtype=torch.float32) -> int:
        """A rough upper estimate of the force evaluation's device bytes per
        edge slot on the card at ``dtype``.  Kernel path (``conv_route``):
        every layer's gathered hj row (D*T*C floats, kept for the backward),
        one layer's dhj and the gather backward's buffer at a time, the
        bessel basis, Y, u and the geometry.  Plain path: per layer also the
        radial weights (T*P*C) and the message terms autograd keeps (about
        six hj-sized tensors)."""
        df = self.feature_dim * self.n_tracks * self.num_features
        per = df * (self.num_layers + 2) + self.num_bessels + self.feature_dim + 1 + 64
        if not conv_route(self, flat, dtype=dtype):
            tpc = self.n_tracks * tp_num_paths(self.l_max) * self.num_features
            per += self.num_layers * (2 * tpc + 6 * df)
        return torch.finfo(dtype).bits // 8 * per


def hj_bf16() -> bool:
    """``PAT_NEQUIP_HJ=bf16``: gather the node rows for K3 through a bf16
    boundary (the reference's ``_hj_bf16``, read per call)."""
    return os.environ.get("PAT_NEQUIP_HJ", "") == "bf16"


def generic_path(cfg: NequIPConfig) -> bool:
    """Whether the layers run the generic channels-first path: above l_max
    3, or with ``PAT_NEQUIP_GENERIC`` set (the reference's switch, read per
    call, ``models/nequip.py:633``)."""
    return cfg.l_max > 3 or bool(os.environ.get("PAT_NEQUIP_GENERIC"))


def conv_route(cfg: NequIPConfig, flat: bool, capture: bool = False, dtype=torch.float32,
               card: bool = True, sharded: bool = False) -> bool:
    """Whether a call runs K3, routed as the reference routes it
    (``models/nequip.py:633-666``): on the TABLE layout with ``fused_conv``,
    without ``capture``, off the generic path, where K3 takes the widths
    (``kernel_takes`` beside its wrapper, the counterpart of the
    reference's ``conv_viable``; it takes l_max 1 and 2 only, as the
    reference's kernel does) and, on the card (``card``), at f32 only (the
    kernel takes f32; on the CPU its plain version takes any dtype), never
    for a sharded call (``sharded``: JAX never runs its kernel under
    ``shard_axis``, ``models/nequip.py:640-647``).  Otherwise the plain
    message path runs."""
    if flat or capture or sharded or not cfg.fused_conv or (card and dtype != torch.float32):
        return False
    if generic_path(cfg):
        return False
    dims = mlp_dims(cfg.num_bessels, cfg.radial_mlp_width, cfg.radial_mlp_depth,
                    cfg.n_tracks * tp_num_paths(cfg.l_max) * cfg.num_features)
    return kernel_takes(cfg.num_features, cfg.n_tracks, cfg.l_max, dims)


def _check_supported(cfg: NequIPConfig) -> None:
    if cfg.l_max < 1:
        raise NotImplementedError(f"l_max={cfg.l_max}: the port runs NequIP at l_max >= 1 "
                                  "(the reference fails at l_max 0)")


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


def _parity_routing(lmax: int):
    """Per (l3, tau): the (source track pi, path within l3) pairs that land
    on track tau = pi XOR (l2 mod 2) (the reference's ``_ParityRouting``)."""
    table = []
    for l3 in range(lmax + 1):
        per_tau = ([], [])
        for p, (_l1, l2) in enumerate(paths_to_l(lmax, lmax, l3)):
            for pi in (0, 1):
                per_tau[pi ^ (l2 % 2)].append((pi, p))
        table.append(per_tau)
    return table


def _msg_generic_cf(hj, Y, w, lmax: int):
    """The generic channels-first message (``models/nequip.py:733-866``):
    hj (..., C, D, T), Y (..., D), w (..., C, T, P) -> (..., C, D, T).
    Each path's TP from ``uniform_tp`` is weighted per channel and summed
    per output l; with two tracks the paths route to tau = pi XOR (l2 mod
    2); norm 1/sqrt(contributions)."""
    T = hj.shape[-1]
    tp = [uniform_tp(hj[..., pi], Y, lmax) for pi in range(T)]
    routing = _parity_routing(lmax) if T == 2 else None
    tracks = [[] for _ in range(T)]
    p_off = 0
    for l3 in range(lmax + 1):
        p_l = len(paths_to_l(lmax, lmax, l3))
        for tau in range(T):
            contribs = [(0, p) for p in range(p_l)] if T == 1 else routing[l3][tau]
            acc = None
            for pi in range(T):
                sel = [p for (q, p) in contribs if q == pi]
                if not sel:
                    continue
                t = tp[pi][l3][..., :, sel, :]  # (..., C, Psel, 2l3+1)
                w_sel = w[..., :, pi, [p_off + p for p in sel]]
                term = torch.einsum("...cpk,...cp->...ck", t, w_sel)
                acc = term if acc is None else acc + term
            tracks[tau].append(acc * (1.0 / math.sqrt(max(len(contribs), 1))))
        p_off += p_l
    return torch.stack([torch.cat(blocks, dim=-1) for blocks in tracks], dim=-1)


def _node_windows(cfg: NequIPConfig, positions, types, edge_index, cell, edge_shifts,
                  edge_mask, edge_rev, mesh):
    """One record per node window: its device, first row c0 and row count nw,
    its types, edge geometry ('u', 'Y', 'bessel'), ``gather`` (node rows to
    its edges) and ``agg`` (its edges to its nw rows).  Without ``mesh`` the
    one window is every atom, on either layout."""
    n = positions.shape[0]
    if mesh is None:
        devs, tables = [positions.device], [(edge_index, edge_shifts, edge_mask, edge_rev)]
    else:
        if any(is_flat(ei) for ei in edge_index):
            raise ValueError("sharded nequip requires the TABLE edge layout")
        devs = list(mesh.devices)
        tables = [(edge_index[s], None if edge_shifts is None else edge_shifts[s],
                   None if edge_mask is None else edge_mask[s], None) for s in range(len(devs))]
    out = []
    c0 = 0
    for dev, (ei, sh, em, rev) in zip(devs, tables):
        pos, typ = positions.to(dev), types.to(dev)
        cl = None if cell is None else cell.to(dev)
        if is_flat(ei):
            geo = flat_edges(cfg, pos, typ, ei, cell=cl, edge_shifts=sh, edge_mask=em)
            nw, k = n, None

            def gather(a, j=ei[1]):
                return a.index_select(0, j)

            def agg(a, i=ei[0]):
                return segment_sum(a, i, n)
        else:
            nw, k = ei.shape
            if mesh is None and nw != n:
                raise ValueError(f"NequIP takes a TABLE over all {n} atoms, not {nw} rows "
                                 "(message passing is not local)")
            geo = table_edges(cfg, pos, typ, ei, cell=cl, edge_shifts=sh, edge_mask=em,
                              edge_rev=rev, center_offset=c0)
            if rev is not None and em is not None:
                def gather(a, ei=ei, rev=rev):
                    return table_gather_nodes(a, ei, rev)
            else:
                def gather(a, ei=ei):
                    return a[ei]

            def agg(a):
                return a.sum(dim=1)
        out.append(SimpleNamespace(dev=dev, c0=c0, nw=nw, k=k, flat=is_flat(ei),
                                   types_w=typ if nw == n else typ[c0:c0 + nw], u=geo["u"],
                                   Y=geo["Y"], bessel=geo["bessel"], gather=gather, agg=agg))
        c0 += nw
    if c0 != n and mesh is not None:
        raise ValueError(f"the shards' windows cover {c0} rows, not the {n} atoms")
    return out


def nequip_energy(params: dict, cfg: NequIPConfig, positions, types, edge_index, *,
                  cell=None, edge_shifts=None, atom_mask=None, edge_mask=None,
                  edge_rev=None, capture: dict | None = None, mesh=None,
                  mesh_params: list | None = None) -> dict:
    """Per-atom energies on either edge layout.

    edge_index is the (N, K) TABLE j-table over all atoms, padded slots
    referencing the center with edge_mask False, or the FLAT (2, E) list of
    rows i and j (padded slots are masked self edges); the edge vector is
    pos[j] - pos[i] + edge_shifts @ cell.  With ``edge_rev`` (TABLE only,
    neighbors.device.reverse_table) the position and node-feature backwards
    are gathers.  K3 runs on the TABLE layout with ``fused_conv``; the FLAT
    layout runs the plain message and ``segment_sum``, as in JAX; above
    l_max 3 or with ``PAT_NEQUIP_GENERIC=1`` the generic channels-first
    layers run (``generic_path``).  ``capture``, when a dict, receives the
    final node features channels-first, (N, C, D) or (N, C, D, 2) with
    parity, as the JAX model's does, and sends the call through the plain
    message path, as the reference does (``conv_route``).

    ``mesh`` (a ``parallel.mesh.Mesh``; the JAX model's ``shard_axis``,
    ``models/nequip.py:482-530``): multi-device message passing.
    ``edge_index``, ``edge_shifts`` and ``edge_mask`` are then sequences of
    one TABLE window per shard, shard s holding the rows of the atoms
    [s * nw, (s + 1) * nw) with global j on ``mesh.devices[s]``.
    Positions, types and node features are replicated; each shard computes
    the messages and the update of its node window, and each layer's
    windows are concatenated and handed to every shard (the all_gather;
    autograd writes its reverse), so the messages cross the shards
    num_layers hops.  A sharded call runs the plain message path
    (``conv_route``), as JAX never runs its kernel under ``shard_axis``.
    ``mesh_params`` is one copy of ``params`` per mesh device, made once
    by the caller (``parallel.sharded.params_on``); without it every
    shard uses ``params``, which must then live on its device.

    The spans ``model.inputs``, ``model.layers`` and ``model.readout``
    (``tracing``) mark the windows' geometry and the embedding, the layers,
    and the readout with the per-atom sum.

    Returns 'atomic_energy' (N,) and 'total_energy' ()."""
    _check_supported(cfg)
    dtype = positions.dtype
    n, home = positions.shape[0], positions.device
    C, lmax, T = cfg.num_features, cfg.l_max, cfg.n_tracks
    D, P = cfg.feature_dim, tp_num_paths(lmax)
    with tracing.span("model.inputs"):
        parts = _node_windows(cfg, positions, types, edge_index, cell, edge_shifts, edge_mask,
                              edge_rev, mesh)
        use_k3 = conv_route(cfg, parts[0].flat, capture is not None, dtype, positions.is_cuda,
                            sharded=mesh is not None)
        generic = generic_path(cfg)
        if use_k3:
            k = parts[0].k
            e = n * k
            u_e, Y_e = parts[0].u.reshape(e, 1), parts[0].Y.reshape(e, D)
            bes_e = parts[0].bessel.reshape(e, -1)
        h = torch.zeros((n, C, D, T) if generic else (n, D, T, C), dtype=dtype, device=home)
        if generic:
            h[:, :, 0, 0] = params["chem_embed"].to(dtype)[types]
        else:
            h[:, 0, 0, :] = params["chem_embed"].to(dtype)[types]

    inv_avg = 1.0 / math.sqrt(max(cfg.avg_num_neighbors, 1e-6))
    act_c = silu_norm_const()
    keys = (("self_w", "mix_w"), ("self_w_o", "mix_w_o"))[:T]

    def layer_step(layer, h, p):
        """Channels-last: h (N, D, T, C) -> the window's (nw, D, T, C)."""
        nw = p.nw
        ws_cl = radial_cl([w.to(dtype) for w in layer["radial_mlp"]["w"]], C, P, T)
        if use_k3:
            hsrc = h.reshape(n, D * T * C)
            if hj_bf16() and dtype == torch.float32:
                hsrc = hsrc.to(torch.bfloat16)
            hj = p.gather(hsrc).reshape(e, D * T * C)
            k3 = prepare_radial(ws_cl, C, T, lmax)
            agg = nequip_conv(hj, bes_e, u_e, Y_e, k3, k, cfg.avg_num_neighbors)
            agg = agg.reshape(n, D, T, C)
        else:
            w = mlp_apply({"w": ws_cl}, p.bessel) * p.u[..., None]
            w = w.reshape(*p.u.shape, T, P, C)
            agg = p.agg(msg_generic_cl(p.gather(h), p.Y, w, lmax)) * inv_avg
        h_w = h if nw == n else h[p.c0:p.c0 + nw]
        new = []
        for tau, (sw, mw) in enumerate(keys):
            blocks = []
            for l3 in range(lmax + 1):
                sl = sh_slice(l3)
                sc = _self_connect(h_w[:, sl, tau, :], layer[sw][l3].to(dtype), p.types_w)
                mixed = agg[:, sl, tau, :] @ layer[mw][l3].to(dtype)
                blocks.append((sc + mixed) * (1.0 / math.sqrt(C)))
            new.append(blocks)
        act_even = F.silu(new[0][0][:, 0, :]) * act_c
        gate_w = _gate_cl(layer["gate_w"].to(dtype), C, lmax, T)
        gates = torch.sigmoid((act_even @ gate_w) * (1.0 / math.sqrt(C)))
        gates = gates.reshape(nw, lmax, T, C)
        tracks = []
        for tau in range(T):
            s = act_even if tau == 0 else torch.tanh(new[1][0][:, 0, :]) * TANH_C
            parts_ = [s[:, None, :]]
            parts_ += [new[tau][l3] * gates[:, l3 - 1 : l3, tau, :] for l3 in range(1, lmax + 1)]
            tracks.append(torch.cat(parts_, dim=1))
        return torch.stack(tracks, dim=2)

    def generic_step(layer, h, p):
        """Channels-first (the reference's ``layer_fn`` / ``layer_fn_parity``):
        h (N, C, D, T) -> the window's (nw, C, D, T); the stored weight
        packings as they are."""
        nw = p.nw
        w = mlp_apply({"w": [t.to(dtype) for t in layer["radial_mlp"]["w"]]}, p.bessel)
        w = (w * p.u[..., None]).reshape(*p.u.shape, C, T, P)
        agg = p.agg(_msg_generic_cf(p.gather(h), p.Y, w, lmax)) * inv_avg  # (nw, C, D, T)
        h_w = h if nw == n else h[p.c0:p.c0 + nw]
        new = []
        for tau, (sw, mw) in enumerate(keys):
            blocks = []
            for l3 in range(lmax + 1):
                sl = sh_slice(l3)
                sc = _self_connect(h_w[:, :, sl, tau].transpose(1, 2), layer[sw][l3].to(dtype),
                                   p.types_w).transpose(1, 2)
                mixed = torch.einsum("ncd,ce->ned", agg[:, :, sl, tau], layer[mw][l3].to(dtype))
                blocks.append((sc + mixed) * (1.0 / math.sqrt(C)))
            new.append(blocks)
        act_even = F.silu(new[0][0][:, :, 0]) * act_c
        gates = torch.sigmoid((act_even @ layer["gate_w"].to(dtype)) * (1.0 / math.sqrt(C)))
        gates = gates.reshape(nw, C, lmax, T)
        tracks = []
        for tau in range(T):
            s = act_even if tau == 0 else torch.tanh(new[1][0][:, :, 0]) * TANH_C
            parts_ = [s[:, :, None]]
            parts_ += [new[tau][l3] * gates[:, :, l3 - 1 : l3, tau] for l3 in range(1, lmax + 1)]
            tracks.append(torch.cat(parts_, dim=2))
        return torch.stack(tracks, dim=3)

    remat = (not use_k3) if cfg.remat == "auto" else bool(cfg.remat)
    step = generic_step if generic else layer_step
    # each window's copy of the layers
    layers = [t["layers"] for t in mesh_params or [params] * len(parts)]

    def all_windows(i, h):
        """Layer i over every window; the windows' rows concatenated (the
        all_gather) on the home device."""
        outs = [step(layers[s][i], h.to(p.dev), p) for s, p in enumerate(parts)]
        return outs[0] if len(outs) == 1 else torch.cat([o.to(home) for o in outs])

    with tracing.span("model.layers"):
        for i in range(len(params["layers"])):
            h = rematerialized(lambda h, i=i: all_windows(i, h), remat)(h)
        if generic:
            h = h.permute(0, 2, 3, 1)  # channels-last (N, D, T, C) for the readout
    if capture is not None:
        capture["node_features"] = h.permute(0, 3, 1, 2) if T == 2 else h[:, :, 0, :].transpose(1, 2)

    with tracing.span("model.readout"):
        e_atom = mlp_apply(params["readout_mlp"], h[:, 0, 0, :])[:, 0]
        e_atom = (params["per_type_scale"].to(dtype)[types] * e_atom
                  + params["per_type_shift"].to(dtype)[types])
        if atom_mask is not None:
            e_atom = e_atom * atom_mask.to(dtype)
        return {"atomic_energy": e_atom, "total_energy": e_atom.sum()}


nequip_energy.per_center_outputs = ("atomic_energy",)
