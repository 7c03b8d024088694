"""Allegro energies (counterpart of ``pair_allegro_tpu/models/allegro.py``)
on both edge layouts, in four tiers chosen as the JAX model chooses them
(``layer_tier``):

* TABLE (N, K) layout, ``layer_fused=True`` (default): feature-major
  (features, E), E = N*K, one K1 call per layer (ops/fused_layer.py: first
  builds V0 from pT, middle, last without a V output);
* TABLE, ``layer_fused=False``: feature-major, per layer wz = Wenv^T x /
  sqrt(ns) * u, then K2 (``tp_mode="paths"``, ops/env_layer.py) or K5
  (``"mxu_*"``, ops/env_layer_mxu.py) for env + TP + mix, the latent MLP
  split over [x; inv] and the residual as plain matrix products (JAX
  ``env_step``);
* ``fused_tp=True`` on the FLAT (2, E) layout, or on the TABLE layout when
  the env-fused kernel of the tier cannot hold the model's widths
  (``env_fused_viable``): channels-last x (E, ns) with V kept as (D, C, E),
  per layer env summed per center (``segment_sum`` on FLAT), handed back to
  the edges and K4 (ops/tp_mix_fused.py) for TP + mix (JAX ``layer_fn_t``);
* ``fused_tp=False`` (``for_training()``), or ``capture``: the plain
  channels-last path on either layout (JAX ``layer_fn``), no kernel; the
  only tier whose weight gradients are finite.

Per ordered edge (i, j): two-body x0 = MLP2b([onehot(t_i); onehot(t_j);
Bessel(r)]) * u, pT = W_embed^T x0 / sqrt(ns), V0 = pT * Y; the layers; then
E_ij = MLP_out(x) * u and E_i = scale[t_i] * sum_j E_ij + shift[t_i].

The parameter tree keeps the JAX layout (``allegro_params_from_numpy``); the
kernels' weight layouts are made from its leaves and cached until a leaf
changes (ops/weight_cache.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch.models.edges import flat_edges, is_flat, table_edges
from pair_allegro_tpu_torch.ops.env_layer import env_layer, k2_weights
from pair_allegro_tpu_torch.ops.env_layer import kernel_takes as k2_takes
from pair_allegro_tpu_torch.ops.env_layer_mxu import MODES, env_layer_mxu, k5_weights
from pair_allegro_tpu_torch.ops.env_layer_mxu import kernel_takes as k5_takes
from pair_allegro_tpu_torch.ops.fused_layer import fused_layer, k1_weights
from pair_allegro_tpu_torch.ops.fused_layer import kernel_takes as k1_takes
from pair_allegro_tpu_torch.ops.mlp import mlp_apply, mlp_apply_t, silu_norm_const
from pair_allegro_tpu_torch.ops.scatter import segment_sum
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l, scalar_part, tp_mix_apply, uniform_tp
from pair_allegro_tpu_torch.ops.tp_mix_fused import k4_weights, tp_mix_fused_t

TP_MODES = ("paths", *MODES)


@dataclasses.dataclass(frozen=True)
class AllegroConfig:
    """Hyperparameters, with the field names and defaults of the JAX
    package's ``AllegroConfig`` (its ``interior`` dtype switch is not
    carried)."""

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
    # "auto" and False keep no per-layer recompute; True is not ported
    remat: bool | str = "auto"
    # the kernel tiers (weight cotangents NaN); False runs the plain path
    fused_tp: bool = True
    # the all-layers kernel (K8); only False (and "auto", which resolves to
    # off: K8 is not ported) is accepted
    fused_stack: bool | str = False
    # True parity keeps only even (l1 + l2 + l3) tensor-product paths
    parity: bool = True
    # TP + mix form of the per-layer tier: "paths" (K2) or the combined
    # one-matrix form "mxu_highest" / "mxu_bf16x3" / "mxu_bf16" (K5)
    tp_mode: str = "paths"
    # True: one K1 call per layer; False: the per-layer tier (K2 or K5)
    layer_fused: bool = True
    per_edge_type_cutoff: tuple | None = None  # (num_types, num_types) nested tuple
    # extra head: per-atom 'charges' and the global 'dipole' sum q_i r_i
    output_charges: bool = False

    @property
    def num_types(self) -> int:
        return len(self.type_names)

    @property
    def tier(self) -> str:
        """'k1', 'perlayer' or 'plain': the tier the config asks for on the
        TABLE layout (``layer_tier`` gives the one a call runs)."""
        if not self.fused_tp:
            return "plain"
        return "k1" if self.layer_fused else "perlayer"

    def for_training(self) -> "AllegroConfig":
        """The plain path, whose weight gradients are finite; the tree is the
        same, so train with this config and run MD with the original."""
        return dataclasses.replace(self, fused_tp=False, fused_stack=False)

    def live_bytes_per_edge(self, flat: bool = False) -> int:
        """A rough upper estimate of the force evaluation's device bytes per
        edge slot (f32), for the tier this config runs on the TABLE layout
        or, with ``flat``, on the FLAT one.  Every tier keeps each layer's V
        (D*C floats) and its cotangent, a few scalar-feature tensors and the
        geometry; the per-layer tier also keeps per layer wz (C), inv
        (C*P0), the latent MLP's input x and its hidden activations before
        and after the SiLU; the K4 tier keeps per layer besides those env on
        the edges (D*C) and its per-edge terms (D*C); the plain tier keeps
        per layer the TP outputs and their cotangents (C * sum_l3
        P*(2*l3+1) each), inv, x and the hidden activations."""
        d = (self.l_max + 1) ** 2
        c, ns = self.num_tensor_features, self.num_scalar_features
        per = 2 * d * c * self.num_layers + 6 * ns + 64
        P = num_paths_per_l(self.l_max, self.l_max, self.l_max, self.parity)
        hidden = 2 * self.allegro_mlp_hidden_layers_depth * self.allegro_mlp_hidden_layers_width
        tier = layer_tier(self, flat)
        if tier == "perlayer":
            per += self.num_layers * (c + c * P[0] + ns + hidden)
        elif tier == "k4":
            per += self.num_layers * (2 * d * c + c + c * P[0] + ns + hidden)
        elif tier == "plain":
            n_t = c * sum(p * (2 * l3 + 1) for l3, p in enumerate(P))
            per += self.num_layers * (2 * n_t + c * P[0] + ns + hidden)
        return 4 * per

    def cutoff_matrix(self) -> np.ndarray:
        """(num_types, num_types) per-edge-type cutoffs, defaulting to r_max."""
        if self.per_edge_type_cutoff is None:
            return np.full((self.num_types, self.num_types), self.r_max)
        m = np.asarray(self.per_edge_type_cutoff, dtype=np.float64)
        if m.shape != (self.num_types, self.num_types):
            raise ValueError(f"per_edge_type_cutoff shape {m.shape} != {(self.num_types,) * 2}")
        return m


def env_fused_viable(cfg: AllegroConfig) -> bool:
    """Whether the env-fused kernel of the config's TABLE tier (K1, or K2 /
    K5 with ``layer_fused=False``) takes the model's widths: each kernel's
    own refusal conditions and shared-memory sum (``kernel_takes`` beside
    its wrapper), decided from the shapes before any launch.  The
    reference's ``pallas_stack.env_fused_viable`` asks the same of the
    TPU's blocks; where it is False both send the model to K4."""
    d = (cfg.l_max + 1) ** 2
    c, ns = cfg.num_tensor_features, cfg.num_scalar_features
    P = num_paths_per_l(cfg.l_max, cfg.l_max, cfg.l_max, cfg.parity)
    if cfg.layer_fused:
        latd = (ns + c * P[0], *[cfg.allegro_mlp_hidden_layers_width]
                * cfg.allegro_mlp_hidden_layers_depth, ns)
        return k1_takes(ns, c, c, d, latd, cfg.l_max, cfg.parity)
    if cfg.tp_mode == "paths":
        return k2_takes(c, c, d, cfg.l_max, cfg.parity)
    return k5_takes(c, c, d, P[0], cfg.tp_mode)


def layer_tier(cfg: AllegroConfig, flat: bool, capture: bool = False) -> str:
    """The tier a call runs, routed as the reference routes it
    (``models/allegro.py:403-506, 758``): 'plain' with ``capture`` or
    ``fused_tp=False``; 'k4' on the FLAT layout, whatever ``layer_fused``
    and ``tp_mode`` say (the env-fused kernels need the TABLE layout), and
    on the TABLE layout where ``env_fused_viable`` is False; else
    ``cfg.tier`` ('k1' or 'perlayer')."""
    if capture or not cfg.fused_tp:
        return "plain"
    if flat or not env_fused_viable(cfg):
        return "k4"
    return cfg.tier


def check_supported(cfg: AllegroConfig) -> None:
    if cfg.fused_stack not in (False, "auto"):
        raise NotImplementedError(
            "fused_stack=True (the all-layers kernel K8) is not ported: ROADMAP queue 2, K8")
    if cfg.remat is True:
        raise NotImplementedError("remat=True is not ported: ROADMAP queue 1, item 5")
    if cfg.tp_mode not in TP_MODES:
        raise ValueError(f"tp_mode {cfg.tp_mode!r} is not one of {TP_MODES}")


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
    arrays (``jax.tree.map(np.asarray, allegro_init(...))``), in the JAX
    layout and nothing else: the kernels' layouts are made from these leaves
    when a layer runs, so gradients land on them and an update to them is
    never stale."""
    from pair_allegro_tpu_torch.system import resolve_device

    check_supported(cfg)
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


def _two_body_in(cfg: AllegroConfig, types, geo, n: int, k: int) -> torch.Tensor:
    """The two-body MLP's input [onehot(t_i); onehot(t_j); Bessel * u] as
    (2*T + B, E), feature-major."""
    e = n * k
    dev, dtype = geo["u"].device, geo["u"].dtype
    ti = types[:, None].expand(n, k).reshape(1, e)
    return torch.cat(
        [
            (ti == torch.arange(cfg.num_types, device=dev)[:, None]).to(dtype),
            geo["oh_j"].reshape(e, -1).T,
            geo["bessel"].reshape(e, -1).T,
        ],
        dim=0,
    )


def _feature_major(params, cfg, types, geo, n: int, k: int) -> dict:
    u = geo["u"]
    uT = u.reshape(1, n * k)
    xT = mlp_apply_t(params["two_body_mlp"], _two_body_in(cfg, types, geo, n, k)) * uT  # (ns, E)
    ns = params["tensor_embed"].shape[0]
    pT = (params["tensor_embed"].to(xT.dtype).T @ xT) * (1.0 / math.sqrt(ns))  # (C, E)
    return {"u": u, "uT": uT, "Y_T": geo["Y"].reshape(n * k, -1).T.contiguous(), "xT": xT,
            "pT": pT}


def allegro_inputs(params: dict, cfg: AllegroConfig, positions, types, edge_index, *,
                   cell=None, edge_shifts=None, edge_mask=None, edge_rev=None) -> dict:
    """The per-edge operands of the layer stack on the TABLE layout:
    'u' (N, K) envelope, and feature-major 'uT' (1, E), 'Y_T' (D, E),
    'xT' (ns, E) two-body latent and 'pT' (C, E) tensor embedding."""
    n, k = edge_index.shape
    geo = table_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                      edge_mask=edge_mask, edge_rev=edge_rev)
    return _feature_major(params, cfg, types, geo, n, k)


def _k1_layers(params, cfg, xT, pT, Y_T, uT, k):
    """The K1 tier: one fused kernel per layer; returns the final xT."""
    layers = params["layers"]
    Vc = pT
    for li, layer in enumerate(layers):
        last = li == len(layers) - 1
        out = fused_layer(xT, Vc, Y_T, uT, k1_weights(layer, cfg.l_max, cfg.parity), k,
                          cfg.avg_num_neighbors, first_v=li == 0, last=last)
        if last:
            xT = out
        else:
            xT, Vc = out
    return xT


def env_step(layer, cfg: AllegroConfig, xT, Vt, Y_T, uT, k):
    """One layer of the per-layer tier (JAX ``env_step``,
    ``models/allegro.py:626-657``): K2 or K5 for env + TP + mix, the latent
    MLP with its first layer split over [x; inv], the residual.  Returns
    (xT', Vt'); the last layer's Vt' is computed and unused, as in JAX."""
    ns = xT.shape[0]
    wzT = (layer["env_weight"].to(xT.dtype).T @ xT) * (1.0 / math.sqrt(ns)) * uT
    if cfg.tp_mode == "paths":
        w = k2_weights(layer["mix"], cfg.l_max, cfg.parity)
        Vt, invT = env_layer(Vt, wzT.contiguous(), Y_T, w, k, cfg.avg_num_neighbors)
    else:
        w = k5_weights(layer["mix"], cfg.l_max, cfg.parity, cfg.tp_mode)
        Vt, invT = env_layer_mxu(Vt, wzT.contiguous(), Y_T, w, k, cfg.avg_num_neighbors)
    lat = layer["latent_mlp"]["w"]
    w0 = lat[0].to(xT.dtype)
    h = (w0[:ns].T @ xT + w0[ns:].T @ invT) * (1.0 / math.sqrt(w0.shape[0]))
    if len(lat) == 1:
        x_new = h
    else:
        x_new = mlp_apply_t({"w": lat[1:]}, F.silu(h) * silu_norm_const())
    return (xT + x_new * uT) * (1.0 / math.sqrt(2.0)), Vt


def _perlayer_layers(params, cfg, xT, pT, Y_T, uT, k):
    Vt = pT.unsqueeze(0) * Y_T.unsqueeze(1)  # (D, C, E), materialised once
    for layer in params["layers"]:
        xT, Vt = env_step(layer, cfg, xT, Vt, Y_T, uT, k)
    return xT


def _plain_layers(params, cfg, x, Y, u, agg, per_edge, capture):
    """The plain tier (JAX ``layer_fn``, ``models/allegro.py:515-537``),
    channels-last on the layout's edge batch ((N, K) or (E,)): ``agg`` sums
    each center's edges, ``per_edge`` hands a per-center tensor back to the
    edges (broadcastable); returns the final latent (..., ns)."""
    inv_avg = 1.0 / math.sqrt(max(cfg.avg_num_neighbors, 1e-6))
    ns = x.shape[-1]
    p_embed = (x @ params["tensor_embed"].to(x.dtype)) * (1.0 / math.sqrt(ns))
    V = p_embed[..., :, None] * Y[..., None, :]  # (N, K, C, D)
    for li, layer in enumerate(params["layers"]):
        w_env = (x @ layer["env_weight"].to(x.dtype)) * (1.0 / math.sqrt(ns)) * u[..., None]
        env = agg(w_env[..., :, None] * Y[..., None, :]) * inv_avg  # (N, C, D)
        T = uniform_tp(V, per_edge(env).expand(V.shape), cfg.l_max, cfg.parity)
        inv = scalar_part(T)
        if capture is not None:
            capture[f"layer{li}/invariants"] = inv
        V = tp_mix_apply(layer["mix"], T)
        x_new = mlp_apply(layer["latent_mlp"], torch.cat([x, inv], dim=-1))
        x = (x + x_new * u[..., None]) * (1.0 / math.sqrt(2.0))
        if capture is not None:
            capture[f"layer{li}/latent"] = x
    return x


def k4_env(layer, cfg: AllegroConfig, x, Y, u, agg, spread):
    """One layer's environment on the edges, (D, C, E), for K4 (JAX
    ``make_env`` + the broadcast of ``layer_fn_t``): w_env = (x W_env) /
    sqrt(ns) * u, summed as w_env (x) Y per center by ``agg`` ((E, F) ->
    (centers, F)), times 1/sqrt(avg_n), and handed back to each edge by
    ``spread`` ((F, centers) -> (F, E))."""
    inv_avg = 1.0 / math.sqrt(max(cfg.avg_num_neighbors, 1e-6))
    e, ns = x.shape
    d = Y.shape[1]
    c = layer["env_weight"].shape[1]
    w_env = (x @ layer["env_weight"].to(x.dtype)) * (1.0 / math.sqrt(ns)) * u[:, None]
    env = agg((Y[:, :, None] * w_env[:, None, :]).reshape(e, d * c)) * inv_avg
    return spread(env.T).reshape(d, c, e).contiguous()


def k4_step(layer, cfg: AllegroConfig, x, Vt, Y, u, agg, spread):
    """One layer of the K4 tier (JAX ``layer_fn_t``,
    ``models/allegro.py:539-560``) on E edges: x (E, ns) channels-last, Vt
    (D, C, E), Y (E, D), u (E,); env from :func:`k4_env`, K4 for V' and the
    invariants (E, C*P0), which join x in the latent MLP through the split
    rows of its first weight (c-major, ``scalar_part``'s order), then the
    residual.  Returns (x', Vt'); the last layer's Vt' is unused (its
    cotangent arrives as zeros)."""
    ns = x.shape[1]
    envt = k4_env(layer, cfg, x, Y, u, agg, spread)
    Vt, inv = tp_mix_fused_t(Vt, envt, k4_weights(layer["mix"], cfg.l_max, cfg.parity))
    lat = layer["latent_mlp"]["w"]
    w0 = lat[0].to(x.dtype)
    h = (x @ w0[:ns] + inv @ w0[ns:]) * (1.0 / math.sqrt(w0.shape[0]))
    if len(lat) == 1:
        x_new = h
    else:
        x_new = mlp_apply({"w": lat[1:]}, F.silu(h) * silu_norm_const())
    return (x + x_new * u[:, None]) * (1.0 / math.sqrt(2.0)), Vt


def k4_v0(params, x, Y):
    """V0 = pT * Y on the (D, C, E) layout, pT = (x W_embed)^T / sqrt(ns);
    built once, before the first layer."""
    p = (x @ params["tensor_embed"].to(x.dtype)) * (1.0 / math.sqrt(x.shape[1]))  # (E, C)
    return p.T.contiguous().unsqueeze(0) * Y.T.contiguous().unsqueeze(1)


def _k4_layers(params, cfg, x, Y, u, agg, spread):
    """The K4 tier's layer stack: V0, then :func:`k4_step` per layer;
    returns the final x (E, ns)."""
    Vt = k4_v0(params, x, Y)
    for layer in params["layers"]:
        x, Vt = k4_step(layer, cfg, x, Vt, Y, u, agg, spread)
    return x


def flat_reducers(i_idx, n: int):
    """(agg, per_edge, spread) of the FLAT layout with centers ``i_idx``:
    ``segment_sum`` of edge rows into the n atoms, a row gather back to the
    edges, and a column gather (F, n) -> (F, E); the gathers are
    ``index_select`` (backward: ``index_add``)."""

    def agg(a):
        return segment_sum(a, i_idx, n)

    def per_edge(a):
        return a.index_select(0, i_idx)

    def spread(a):
        return a.index_select(1, i_idx)

    return agg, per_edge, spread


def flat_inputs(params: dict, cfg: AllegroConfig, positions, types, edge_index, *, cell=None,
                edge_shifts=None, edge_mask=None) -> dict:
    """The K4 tier's per-edge operands on the FLAT (2, E) layout: 'x' (E, ns)
    two-body latent, 'Y' (E, D), 'u' (E,), 'Vt' (D, C, E) = V0, and the
    layout's 'agg' and 'spread' (see :func:`k4_step`)."""
    geo = flat_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                     edge_mask=edge_mask)
    agg, _, spread = flat_reducers(edge_index[0], positions.shape[0])
    x_in = torch.cat([geo["oh_i"], geo["oh_j"], geo["bessel"]], dim=-1)
    x = mlp_apply(params["two_body_mlp"], x_in) * geo["u"][:, None]
    return {"x": x, "Y": geo["Y"], "u": geo["u"], "Vt": k4_v0(params, x, geo["Y"]), "agg": agg,
            "spread": spread}


def allegro_energy(params: dict, cfg: AllegroConfig, positions, types, edge_index, *,
                   cell=None, edge_shifts=None, atom_mask=None, edge_mask=None,
                   edge_rev=None, capture: dict | None = None) -> dict:
    """Per-atom energies on either edge layout.

    edge_index is the (N, K) TABLE j-table with the center implicit in the
    row (padded slots reference the center itself with edge_mask False), or
    the FLAT (2, E) list of rows i and j (padded slots are masked self
    edges); the edge vector is pos[j] - pos[i] + edge_shifts @ cell.  With
    ``edge_rev`` (TABLE only, neighbors.device.reverse_table) the force
    backward is a gather; on FLAT the per-atom sums are ``segment_sum``.
    ``capture``, when a dict, receives 'two_body_latent',
    'layer{i}/invariants', 'layer{i}/latent' and 'edge_energy' and sends the
    call through the plain tier, as in JAX.  Returns 'atomic_energy' (N,),
    'total_energy' (), 'edge_energy' (N, K) or (E,) and, with
    ``output_charges``, 'charges' (N,) and 'dipole' (3,) = sum_i q_i r_i."""
    check_supported(cfg)
    dtype = positions.dtype
    n = positions.shape[0]
    flat = is_flat(edge_index)
    tier = layer_tier(cfg, flat, capture is not None)
    if flat:
        geo = flat_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                         edge_mask=edge_mask)
        agg, per_edge, spread = flat_reducers(edge_index[0], n)
        agg_rows = agg
    else:
        k = edge_index.shape[1]
        geo = table_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                          edge_mask=edge_mask, edge_rev=edge_rev)

        def agg(a):
            return a.sum(dim=1)

        def agg_rows(a):
            return a.reshape(n, k, *a.shape[1:]).sum(dim=1)

        def per_edge(a):
            return a[:, None]

        def spread(a):
            return a[:, :, None].expand(*a.shape, k).reshape(a.shape[0], n * k)
    u = geo["u"]
    if tier in ("k1", "perlayer"):
        ins = _feature_major(params, cfg, types, geo, n, k)
        layers = _k1_layers if tier == "k1" else _perlayer_layers
        xT = layers(params, cfg, ins["xT"], ins["pT"], ins["Y_T"], ins["uT"], k)

        def head(mlp):
            return mlp_apply_t(mlp, xT)[0].reshape(n, k) * u
    else:
        if flat:
            x_in = torch.cat([geo["oh_i"], geo["oh_j"], geo["bessel"]], dim=-1)
        else:
            x_in = _two_body_in(cfg, types, geo, n, k).T.reshape(n, k, -1)
        x = mlp_apply(params["two_body_mlp"], x_in) * u[..., None]
        if capture is not None:
            capture["two_body_latent"] = x
        if tier == "plain":
            x = _plain_layers(params, cfg, x, geo["Y"], u, agg, per_edge, capture)
        else:
            d, ns = geo["Y"].shape[-1], x.shape[-1]
            x = _k4_layers(params, cfg, x.reshape(-1, ns), geo["Y"].reshape(-1, d), u.reshape(-1),
                           agg_rows, spread).reshape(x.shape)

        def head(mlp):
            return mlp_apply(mlp, x)[..., 0] * u

    e_edge = head(params["readout_mlp"])
    if capture is not None:
        capture["edge_energy"] = e_edge
    e_atom = agg(e_edge)
    e_atom = params["per_type_scale"].to(dtype)[types] * e_atom + params["per_type_shift"].to(dtype)[types]
    if atom_mask is not None:
        e_atom = e_atom * atom_mask.to(dtype)
    out = {"atomic_energy": e_atom, "total_energy": e_atom.sum(), "edge_energy": e_edge}
    if cfg.output_charges:
        q_atom = agg(head(params["charge_mlp"]))
        if atom_mask is not None:
            q_atom = q_atom * atom_mask.to(dtype)
        out["charges"] = q_atom
        out["dipole"] = torch.sum(q_atom[:, None] * positions, dim=0)
    return out
