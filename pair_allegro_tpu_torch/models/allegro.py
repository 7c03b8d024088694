"""Allegro energies (counterpart of ``pair_allegro_tpu/models/allegro.py``)
on both edge layouts, in the tiers the JAX model chooses (``layer_tier``):

* TABLE (N, K) layout, ``fused_stack=True``: feature-major (features, E),
  E = N*K, the whole layer stack in one K8 call each way
  (ops/fused_stack.py), whatever ``fused_tp`` and ``layer_fused`` say, as
  the reference's ``use_stack``; where K8 cannot hold the model
  (``stack_viable``) the call routes as if ``fused_stack`` were False;
* TABLE (N, K) layout, ``layer_fused=True`` (default): feature-major
  (features, E), E = N*K, one K1 call per layer (ops/fused_layer.py: first
  builds V0 from pT, middle, last without a V output).  Two forms are
  selected per call by the reference's environment switches:
  ``PAT_L1_EMBED=1`` with at least 2 layers runs the first layer as K6
  (ops/embed_layer.py: the two-body MLP and tensor embed fused in) and the
  last as K7 (ops/readout_layer.py: the readout and charge heads fused in),
  the middle layers on K1 ('k1-embed'); ``PAT_L1_POSITIONAL=0`` runs every
  layer as K1's middle form on a materialised V0 ('k1-nopos', bench.py's
  kernel-nopos rung);
* TABLE, ``layer_fused=False``: feature-major, per layer wz = Wenv^T x /
  sqrt(ns) * u, then K2 (``tp_mode="paths"``, ops/env_layer.py) or K5
  (``"mxu_*"``, ops/env_layer_mxu.py) for env + TP + mix, the latent MLP
  split over [x; inv] and the residual as plain matrix products (JAX
  ``env_step``);
* ``fused_tp=True`` on the FLAT (2, E) layout, or on the TABLE layout when
  the env-fused kernel of the tier cannot hold the model's widths
  (``env_fused_viable``), where K4 takes the widths (``k4_viable``):
  channels-last x (E, ns) with V kept as (D, C, E), per layer env summed
  per center (``segment_sum`` on FLAT), handed back to the edges and K4
  (ops/tp_mix_fused.py) for TP + mix (JAX ``layer_fn_t``);
* ``fused_tp=False`` (``for_training()``), ``capture``, widths no kernel
  of the route takes, on the card any interior dtype but f32 and bf16 (and
  at bf16 every tier but K1's and the per-layer ``paths`` one), or the
  per-layer rounding modes (``mxu_bf16``, ``mxu_bf16x3``) at any dtype but
  f32: the plain channels-last path on either layout (JAX ``layer_fn``),
  no kernel; the only tier whose weight gradients are finite.

``interior="bf16"`` (JAX's memory tier) runs the layer stack on bf16
operands: geometry (edge vectors, Y, u, the Bessel basis), the two-body MLP
and the final energy sums stay in the working dtype, and the interior is
cast where the reference casts it (``models/allegro.py:397-400, 591-620,
761-762``): on the feature-major tiers x, u and Y (pT then a bf16 product
of the bf16 x), on the plain and K4 tiers x, V, Y and u; the readout runs
on x cast back.  On the card the K1 tier runs K1's bf16 build (its
embed/readout form K6's and K7's), the stack K8's and the per-layer
``paths`` tier K2's; the per-layer ``mxu_*`` modes (K5) and K4 run the plain
path at bf16, as the reference has no bf16 kernel for them
(``layer_tier``).

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
import os

import numpy as np
import torch
import torch.nn.functional as F

from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.models.edges import flat_edges, is_flat, table_edges
from pair_allegro_tpu_torch.ops.embed_layer import embed_layer, k6_weights
from pair_allegro_tpu_torch.ops.embed_layer import kernel_takes as k6_takes
from pair_allegro_tpu_torch.ops.env_layer import env_layer, k2_weights
from pair_allegro_tpu_torch.ops.env_layer import kernel_takes as k2_takes
from pair_allegro_tpu_torch.ops.env_layer_mxu import MODES, env_layer_mxu, k5_weights
from pair_allegro_tpu_torch.ops.env_layer_mxu import kernel_takes as k5_takes
from pair_allegro_tpu_torch.ops.fused_layer import fused_layer, k1_weights
from pair_allegro_tpu_torch.ops.fused_layer import kernel_takes as k1_takes
from pair_allegro_tpu_torch.ops.fused_stack import fused_stack
from pair_allegro_tpu_torch.ops.fused_stack import kernel_takes as k8_takes
from pair_allegro_tpu_torch.ops.mlp import (
    mlp_apply,
    mlp_apply_t,
    mlp_dims,
    silu_norm_const,
    weak_scalar,
)
from pair_allegro_tpu_torch.ops.readout_layer import k7_weights, readout_layer
from pair_allegro_tpu_torch.ops.readout_layer import kernel_takes as k7_takes
from pair_allegro_tpu_torch.ops.remat import rematerialized
from pair_allegro_tpu_torch.ops.scatter import segment_sum
from pair_allegro_tpu_torch.ops.tp import num_paths_per_l, scalar_part, tp_mix_apply, uniform_tp
from pair_allegro_tpu_torch.ops.tp_mix_fused import k4_weights, tp_mix_fused_t
from pair_allegro_tpu_torch.ops.tp_mix_fused import kernel_takes as k4_takes

TP_MODES = ("paths", *MODES)
# the outputs with one row per center; every other output is extensive
# (the row-chunk mode sums it over the windows, engine._make_chunked_energy)
PER_CENTER_OUTPUTS = ("atomic_energy", "edge_energy", "charges")
ROUNDING_MODES = ("mxu_bf16x3", "mxu_bf16")  # the per-layer modes that round at f32
INTERIORS = ("working", "bf16")


@dataclasses.dataclass(frozen=True)
class AllegroConfig:
    """Hyperparameters, with the field names and defaults of the JAX
    package's ``AllegroConfig``, so that the config dict a JAX checkpoint
    carries builds this one."""

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
    # recompute each layer's forward in the backward (torch.utils.checkpoint):
    # True, False, or "auto", which the engines resolve from the capacity
    # (engine._resolve_remat) and which means True where it reaches the model
    remat: bool | str = "auto"
    # interior compute dtype of the layer stack: "working" (the positions'
    # dtype) or "bf16" (the layers on bf16 operands: half the per-edge bytes;
    # geometry and the energy sums stay in the working dtype)
    interior: str = "working"
    # the kernel tiers (weight cotangents NaN); False runs the plain path
    fused_tp: bool = True
    # True: the whole layer stack in one kernel (K8) on the TABLE layout;
    # "auto" stays off, as the reference turns it on only on a TPU
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

    def interior_dtype(self, dtype=torch.float32) -> torch.dtype:
        """The layer stack's dtype at working dtype ``dtype`` (JAX's cdtype)."""
        return torch.bfloat16 if self.interior == "bf16" else dtype

    def live_bytes_per_edge(self, flat: bool = False, dtype=torch.float32) -> int:
        """A rough upper estimate of the force evaluation's device bytes per
        edge slot, for the tier this config runs on the card at working dtype
        ``dtype`` on the TABLE layout or, with ``flat``, on the FLAT one.  The
        geometry (64 numbers) counts at ``dtype``, everything else at the
        interior's dtype (2 bytes with ``interior="bf16"``).  Every tier
        but the stack keeps each layer's V (D*C numbers) and its cotangent,
        a few scalar-feature tensors and the geometry; the per-layer tier
        also keeps per layer wz (C), inv (C*P0), the latent MLP's input x
        and its hidden activations before and after the SiLU; the K4 tier
        keeps per layer besides those env on the edges (D*C) and its
        per-edge terms (D*C); the plain tier keeps per layer the TP outputs
        and their cotangents (C * sum_l3 P*(2*l3+1) each), inv, x and the
        hidden activations.  The K1 tier's K6/K7 form counts as K1; its
        non-positional form adds V0 and its cotangent.  The stack tier (K8)
        keeps no V between its calls: x_final (ns), the backward's stash of
        every layer's input x and V but the first's, and the carried dx and
        dV."""
        d = (self.l_max + 1) ** 2
        c, ns = self.num_tensor_features, self.num_scalar_features
        per = 2 * d * c * self.num_layers + 6 * ns + 64
        P = num_paths_per_l(self.l_max, self.l_max, self.l_max, self.parity)
        hidden = 2 * self.allegro_mlp_hidden_layers_depth * self.allegro_mlp_hidden_layers_width
        cdtype = self.interior_dtype(dtype)
        tier = layer_tier(self, flat, dtype=cdtype)
        if tier == "stack":
            per = ns + (self.num_layers - 1) * (ns + d * c) + ns + d * c + 6 * ns + 64
        elif tier == "k1-nopos":  # V0 materialised, and its cotangent
            per += 2 * d * c
        elif tier == "perlayer":
            per += self.num_layers * (c + c * P[0] + ns + hidden)
        elif tier == "k4":
            per += self.num_layers * (2 * d * c + c + c * P[0] + ns + hidden)
        elif tier == "plain":
            n_t = c * sum(p * (2 * l3 + 1) for l3, p in enumerate(P))
            per += self.num_layers * (2 * n_t + c * P[0] + ns + hidden)
        return torch.finfo(cdtype).bits // 8 * (per - 64) + torch.finfo(dtype).bits // 8 * 64

    def cutoff_matrix(self) -> np.ndarray:
        """(num_types, num_types) per-edge-type cutoffs, defaulting to r_max."""
        if self.per_edge_type_cutoff is None:
            return np.full((self.num_types, self.num_types), self.r_max)
        m = np.asarray(self.per_edge_type_cutoff, dtype=np.float64)
        if m.shape != (self.num_types, self.num_types):
            raise ValueError(f"per_edge_type_cutoff shape {m.shape} != {(self.num_types,) * 2}")
        return m


def env_fused_viable(cfg: AllegroConfig, dtype=torch.float32) -> bool:
    """Whether the env-fused kernel of the config's TABLE tier (K1, or K2 /
    K5 with ``layer_fused=False``) takes the model's widths at ``dtype``:
    each kernel's own refusal conditions and shared-memory sum
    (``kernel_takes`` beside its wrapper), decided from the shapes before
    any launch.  The reference's ``pallas_stack.env_fused_viable`` asks the
    same of the TPU's blocks; where it is False both send the model to K4."""
    d = (cfg.l_max + 1) ** 2
    c, ns = cfg.num_tensor_features, cfg.num_scalar_features
    P = num_paths_per_l(cfg.l_max, cfg.l_max, cfg.l_max, cfg.parity)
    if cfg.layer_fused:
        latd = (ns + c * P[0], *[cfg.allegro_mlp_hidden_layers_width]
                * cfg.allegro_mlp_hidden_layers_depth, ns)
        return k1_takes(ns, c, c, d, latd, cfg.l_max, cfg.parity, dtype)
    if cfg.tp_mode == "paths":
        return k2_takes(c, c, d, cfg.l_max, cfg.parity, dtype)
    return dtype == torch.float32 and k5_takes(c, c, d, P[0], cfg.tp_mode)


def stack_viable(cfg: AllegroConfig, dtype=torch.float32) -> bool:
    """Whether K8 (``kernel_takes`` beside its wrapper) takes the model's
    layer stack at ``dtype``, decided from the shapes before any launch."""
    d = (cfg.l_max + 1) ** 2
    c, ns = cfg.num_tensor_features, cfg.num_scalar_features
    P = num_paths_per_l(cfg.l_max, cfg.l_max, cfg.l_max, cfg.parity)
    latd = mlp_dims(ns + c * P[0], cfg.allegro_mlp_hidden_layers_width,
                    cfg.allegro_mlp_hidden_layers_depth, ns)
    return k8_takes(ns, c, d, latd, cfg.l_max, cfg.parity, cfg.num_layers, dtype)


def k4_viable(cfg: AllegroConfig) -> bool:
    """Whether K4 (``kernel_takes`` beside its wrapper) takes the model's
    widths, decided from the shapes before any launch."""
    c = cfg.num_tensor_features
    return k4_takes(c, c, (cfg.l_max + 1) ** 2, cfg.l_max, cfg.parity)


def embed_readout_viable(cfg: AllegroConfig, dtype=torch.float32) -> bool:
    """Whether K6 and K7 (``kernel_takes`` beside their wrappers) take the
    model's widths at ``dtype``, decided from the shapes before any
    launch."""
    d = (cfg.l_max + 1) ** 2
    c, ns = cfg.num_tensor_features, cfg.num_scalar_features
    P = num_paths_per_l(cfg.l_max, cfg.l_max, cfg.l_max, cfg.parity)
    latd = mlp_dims(ns + c * P[0], cfg.allegro_mlp_hidden_layers_width,
                    cfg.allegro_mlp_hidden_layers_depth, ns)
    tb = mlp_dims(2 * cfg.num_types + cfg.num_bessels, cfg.two_body_mlp_width,
                  cfg.two_body_mlp_depth, ns)
    head = mlp_dims(ns, cfg.readout_mlp_hidden_layers_width,
                    cfg.readout_mlp_hidden_layers_depth, 1)
    heads = (head, head) if cfg.output_charges else (head,)
    return (k6_takes(ns, c, d, latd, cfg.l_max, cfg.parity, tb, dtype)
            and k7_takes(ns, c, d, latd, cfg.l_max, cfg.parity, heads, dtype))


def layer_tier(cfg: AllegroConfig, flat: bool, capture: bool = False, dtype=torch.float32,
               card: bool = True) -> str:
    """The tier a call runs at interior dtype ``dtype`` (the reference's
    cdtype: ``AllegroConfig.interior_dtype``), routed as the reference
    routes it (``models/allegro.py:403-506, 670-758``): 'plain' with
    ``capture``, and on the card (``card``) at any ``dtype`` but f32 and
    bf16 (the reference runs every other dtype on its XLA path; on the CPU
    every tier runs its kernels' plain versions, which take any dtype).
    Otherwise: 'stack' on the TABLE layout with ``fused_stack is True``
    where K8 takes the model (``stack_viable``), whatever ``fused_tp`` and
    ``layer_fused`` say, as the reference's ``use_stack``; else as if
    ``fused_stack`` were False: 'plain' with ``fused_tp=False``; 'k4' on
    the FLAT layout, whatever ``layer_fused`` and ``tp_mode`` say (the
    env-fused kernels need the TABLE layout), and on the TABLE layout where
    ``env_fused_viable`` is False, in both cases where K4 takes the widths
    (``k4_viable``; else 'plain'); 'perlayer' with ``layer_fused=False``;
    else the K1 tier, in the form the environment asks for, read per call
    with the reference's defaults: 'k1-nopos' with ``PAT_L1_POSITIONAL=0``,
    'k1-embed' with ``PAT_L1_EMBED=1`` and at least 2 layers, else 'k1'.
    Where K6 or K7 cannot hold widths that K1 takes
    (``embed_readout_viable``), 'k1-embed' falls back to 'k1', the same
    function (the reference's TPU blocks have no such limit).

    On the card at bf16 K1 (every form, the embed/readout form's K6 and K7
    included), K8 and K2 (the per-layer ``paths`` mode) run their bf16
    builds, as the reference's TPU runs those kernels on bf16 operands; the
    per-layer ``mxu_*`` modes and K4 run 'plain' there, an explicit rule:
    the reference's K5 (``tp_mix_env_fused_t`` in an ``mxu_*`` mode) raises
    on bf16 operands, as its f32 product is stored into a bf16 output, and
    its K4 layer (``use_fused``) is f32 only, so its bf16 model runs both
    on XLA.

    The rounding modes ``tp_mode="mxu_bf16"`` / ``"mxu_bf16x3"`` act only
    at f32: at any other dtype the reference never takes its env-fused
    tier, so it runs its exact plain layer function (``layer_fn``), and a
    per-layer call in those modes routes to 'plain' on the CPU too.  The
    exact per-layer modes (``paths``, ``mxu_highest``) keep 'perlayer' on
    the CPU at any dtype: their kernels' plain versions are exact, and
    they are what the f64 tests hold to JAX."""
    if capture or (card and dtype not in (torch.float32, torch.bfloat16)):
        return "plain"
    f32_only = card and dtype != torch.float32  # a tier whose kernel has no bf16 build
    kdtype = dtype if card else torch.float32  # the dtype a kernel would run at
    if not flat and cfg.fused_stack is True and stack_viable(cfg, kdtype):
        return "stack"
    if not cfg.fused_tp:
        return "plain"
    if flat or not env_fused_viable(cfg, kdtype):
        return "k4" if k4_viable(cfg) and not f32_only else "plain"
    if cfg.tier == "perlayer" and cfg.tp_mode in ROUNDING_MODES and dtype != torch.float32:
        return "plain"
    if cfg.tier != "k1":
        return "plain" if f32_only and cfg.tp_mode != "paths" else cfg.tier
    if os.environ.get("PAT_L1_POSITIONAL", "1") == "0":
        return "k1-nopos"
    if (os.environ.get("PAT_L1_EMBED", "0") == "1" and cfg.num_layers >= 2
            and embed_readout_viable(cfg, kdtype)):
        return "k1-embed"
    return "k1"


def check_supported(cfg: AllegroConfig) -> None:
    if cfg.interior not in INTERIORS:
        raise ValueError(f"interior {cfg.interior!r} is not one of {INTERIORS}")
    if cfg.tp_mode not in TP_MODES:
        raise ValueError(f"tp_mode {cfg.tp_mode!r} is not one of {TP_MODES}")


def remat_on(cfg, capture=None) -> bool:
    """Whether the layer steps recompute their forward in the backward, as
    the reference decides it (``models/allegro.py:574-576``): ``cfg.remat``
    when it is a bool, True for an unresolved "auto", never with
    ``capture``."""
    return (cfg.remat if isinstance(cfg.remat, bool) else True) and capture is None


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


def _feature_major(params, cfg, types, geo, n: int, k: int, cdtype=None) -> dict:
    """The feature-major operands: the two-body MLP in the working dtype,
    then 'xT', 'uT', 'Y_T' cast to the interior dtype ``cdtype`` (default:
    the working one) and 'pT' the interior's product of the cast xT, as the
    reference's env-fused tier makes them."""
    u = geo["u"]
    uT = u.reshape(1, n * k)
    xT = mlp_apply_t(params["two_body_mlp"], _two_body_in(cfg, types, geo, n, k)) * uT  # (ns, E)
    cdtype = cdtype or xT.dtype
    xT = xT.to(cdtype)
    ns = params["tensor_embed"].shape[0]
    pT = (params["tensor_embed"].to(cdtype).T @ xT) * weak_scalar(1.0 / math.sqrt(ns), cdtype)
    Y_T = geo["Y"].reshape(n * k, -1).T.to(cdtype).contiguous()
    return {"u": u, "uT": uT.to(cdtype), "Y_T": Y_T, "xT": xT, "pT": pT}


def allegro_inputs(params: dict, cfg: AllegroConfig, positions, types, edge_index, *,
                   cell=None, edge_shifts=None, edge_mask=None, edge_rev=None) -> dict:
    """The per-edge operands of the layer stack on the TABLE layout:
    'u' (N, K) envelope, and feature-major 'uT' (1, E), 'Y_T' (D, E),
    'xT' (ns, E) two-body latent and 'pT' (C, E) tensor embedding."""
    n, k = edge_index.shape
    geo = table_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                      edge_mask=edge_mask, edge_rev=edge_rev)
    return _feature_major(params, cfg, types, geo, n, k)


def embed_inputs(cfg: AllegroConfig, positions, types, edge_index, *, cell=None,
                 edge_shifts=None, edge_mask=None, edge_rev=None) -> dict:
    """K6's per-edge operands on the TABLE layout: 'in_T' (2T + B, E) the
    two-body input rows, 'Y_T' (D, E) and 'uT' (1, E), feature-major."""
    n, k = edge_index.shape
    geo = table_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                      edge_mask=edge_mask, edge_rev=edge_rev)
    return _embed_major(cfg, types, geo, n, k)


def _embed_major(cfg, types, geo, n: int, k: int, cdtype=None) -> dict:
    """K6's operands, at the interior dtype ``cdtype`` (default: the
    working one; the reference casts in_T, Y and u, ``models/allegro.py:696``)."""
    cdtype = cdtype or geo["u"].dtype
    return {"in_T": _two_body_in(cfg, types, geo, n, k).to(cdtype),
            "Y_T": geo["Y"].reshape(n * k, -1).T.to(cdtype).contiguous(),
            "uT": geo["u"].reshape(1, n * k).to(cdtype)}


def _k1_layers(params, cfg, xT, pT, Y_T, uT, k, positional=True, remat=False):
    """The K1 tier: one fused kernel per layer; returns the final xT.  The
    positional forms build V0 in the first layer and skip the last layer's
    V; without them (``PAT_L1_POSITIONAL=0``) V0 = pT * Y is materialised
    and every layer runs the middle form (the last V' unused).  With
    ``remat`` each layer is a checkpoint (JAX ``fused_step``)."""
    layers = params["layers"]
    Vc = pT if positional else pT.unsqueeze(0) * Y_T.unsqueeze(1)
    for li, layer in enumerate(layers):
        first_v, last = positional and li == 0, positional and li == len(layers) - 1

        def step(xT, Vc, layer=layer, first_v=first_v, last=last):
            return fused_layer(xT, Vc, Y_T, uT, k1_weights(layer, cfg.l_max, cfg.parity), k,
                               cfg.avg_num_neighbors, first_v=first_v, last=last)

        out = rematerialized(step, remat)(xT, Vc)
        if last:
            xT = out
        else:
            xT, Vc = out
    return xT


def _embed_layers(params, cfg, in_T, Y_T, uT, k, remat=False):
    """The K1 tier's embed/readout form (JAX ``models/allegro.py:685-725``):
    K6 on the two-body input rows, K1's middle form, K7; returns the rows
    e (1, E), and q (1, E) with the charge head, already times u.  With
    ``remat`` each of the three steps is a checkpoint."""
    avg = cfg.avg_num_neighbors

    def embed_step(in_T):
        return embed_layer(in_T, Y_T, uT, k6_weights(params, cfg.l_max, cfg.parity), k, avg)

    def mid_step(xT, Vc, layer):
        return fused_layer(xT, Vc, Y_T, uT, k1_weights(layer, cfg.l_max, cfg.parity), k, avg)

    def ro_step(xT, Vc):
        return readout_layer(xT, Vc, Y_T, uT,
                             k7_weights(params, cfg.l_max, cfg.parity, cfg.output_charges), k,
                             avg)

    xT, Vc = rematerialized(embed_step, remat)(in_T)
    for layer in params["layers"][1:-1]:
        xT, Vc = rematerialized(lambda x, v, layer=layer: mid_step(x, v, layer), remat)(xT, Vc)
    rows = rematerialized(ro_step, remat)(xT, Vc)
    return rows if cfg.output_charges else (rows,)


def env_step(layer, cfg: AllegroConfig, xT, Vt, Y_T, uT, k):
    """One layer of the per-layer tier (JAX ``env_step``,
    ``models/allegro.py:626-657``): K2 or K5 for env + TP + mix, the latent
    MLP with its first layer split over [x; inv], the residual.  Returns
    (xT', Vt'); the last layer's Vt' is computed and unused, as in JAX.
    The constants round as JAX's do at xT's dtype (``mlp.weak_scalar``)."""
    ns, dt = xT.shape[0], xT.dtype
    wzT = (layer["env_weight"].to(dt).T @ xT) * weak_scalar(1.0 / math.sqrt(ns), dt) * uT
    if cfg.tp_mode == "paths":
        w = k2_weights(layer["mix"], cfg.l_max, cfg.parity)
        Vt, invT = env_layer(Vt, wzT.contiguous(), Y_T, w, k, cfg.avg_num_neighbors)
    else:
        w = k5_weights(layer["mix"], cfg.l_max, cfg.parity, cfg.tp_mode)
        Vt, invT = env_layer_mxu(Vt, wzT.contiguous(), Y_T, w, k, cfg.avg_num_neighbors)
    lat = layer["latent_mlp"]["w"]
    w0 = lat[0].to(dt)
    h = (w0[:ns].T @ xT + w0[ns:].T @ invT) * weak_scalar(1.0 / math.sqrt(w0.shape[0]), dt)
    if len(lat) == 1:
        x_new = h
    else:
        x_new = mlp_apply_t({"w": lat[1:]}, F.silu(h) * weak_scalar(silu_norm_const(), dt))
    return (xT + x_new * uT) * weak_scalar(1.0 / math.sqrt(2.0), dt), Vt


def _perlayer_layers(params, cfg, xT, pT, Y_T, uT, k, remat=False):
    Vt = pT.unsqueeze(0) * Y_T.unsqueeze(1)  # (D, C, E), materialised once
    for layer in params["layers"]:
        xT, Vt = rematerialized(
            lambda x, v, layer=layer: env_step(layer, cfg, x, v, Y_T, uT, k), remat)(xT, Vt)
    return xT


def _plain_layers(params, cfg, x, Y, u, agg, per_edge, capture, remat=False, cdtype=None):
    """The plain tier (JAX ``layer_fn``, ``models/allegro.py:515-537``),
    channels-last on the layout's edge batch ((N, K) or (E,)): ``agg`` sums
    each center's edges, ``per_edge`` hands a per-center tensor back to the
    edges (broadcastable); returns the final latent (..., ns) at the
    interior dtype ``cdtype`` (default: x's), to which x, V0, Y and u are
    cast after V0 is made (``models/allegro.py:761-762``); the layers'
    constants round as JAX's do at that dtype (``mlp.weak_scalar``).  With
    ``remat`` (never with ``capture``) each layer is a checkpoint."""
    inv_avg = 1.0 / math.sqrt(max(cfg.avg_num_neighbors, 1e-6))
    ns = x.shape[-1]
    p_embed = (x @ params["tensor_embed"].to(x.dtype)) * (1.0 / math.sqrt(ns))
    V = p_embed[..., :, None] * Y[..., None, :]  # (N, K, C, D)
    if cdtype is not None and cdtype != x.dtype:
        x, V, Y, u = (t.to(cdtype) for t in (x, V, Y, u))
    if capture is not None:
        capture["two_body_latent"] = x

    def step(layer, li, x, V):
        w_env = ((x @ layer["env_weight"].to(x.dtype)) * weak_scalar(1.0 / math.sqrt(ns), x.dtype)
                 * u[..., None])
        env = agg(w_env[..., :, None] * Y[..., None, :]) * weak_scalar(inv_avg, x.dtype)
        T = uniform_tp(V, per_edge(env).expand(V.shape), cfg.l_max, cfg.parity)
        inv = scalar_part(T)
        if capture is not None:
            capture[f"layer{li}/invariants"] = inv
        V = tp_mix_apply(layer["mix"], T)
        x_new = mlp_apply(layer["latent_mlp"], torch.cat([x, inv], dim=-1))
        return (x + x_new * u[..., None]) * weak_scalar(1.0 / math.sqrt(2.0), x.dtype), V

    for li, layer in enumerate(params["layers"]):
        x, V = rematerialized(lambda x, V, layer=layer, li=li: step(layer, li, x, V), remat)(x, V)
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


def _k4_layers(params, cfg, x, Y, u, agg, spread, remat=False):
    """The K4 tier's layer stack: V0, then :func:`k4_step` per layer (each
    a checkpoint with ``remat``); returns the final x (E, ns)."""
    Vt = k4_v0(params, x, Y)
    for layer in params["layers"]:
        x, Vt = rematerialized(
            lambda x, v, layer=layer: k4_step(layer, cfg, x, v, Y, u, agg, spread), remat)(x, Vt)
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
                   edge_rev=None, capture: dict | None = None, center_offset: int = 0,
                   num_centers: int | None = None, edge_vec=None, edge_tjf=None) -> dict:
    """Per-atom energies on either edge layout.

    edge_index is the (Nc, K) TABLE j-table with the center implicit in the
    row (padded slots reference the center itself with edge_mask False), or
    the FLAT (2, E) list of rows i and j (padded slots are masked self
    edges); the edge vector is pos[j] - pos[i] + edge_shifts @ cell.  With
    ``edge_rev`` (TABLE only, neighbors.device.reverse_table) the force
    backward is a gather; on FLAT the per-atom sums are ``segment_sum``.
    ``capture``, when a dict, receives 'two_body_latent',
    'layer{i}/invariants', 'layer{i}/latent' and 'edge_energy' and sends the
    call through the plain tier, as in JAX.  ``cfg.remat`` (see
    :func:`remat_on`) recomputes each layer step's forward in the backward,
    on every tier but the stack's, as in JAX.

    The TABLE rows may be a window of centers, the reference's contract
    (``models/allegro.py:237-298``): the rows are the atoms
    [center_offset, center_offset + Nc) (``num_centers``, when given, must
    be Nc), ``atom_mask`` covers the window, and every per-center output
    has Nc rows.  On FLAT the window is [center_offset, center_offset +
    num_centers) (default: every atom) and every edge's center i lies in
    it (the sharded engines' dense build).  ``edge_vec`` (Nc, K, 3) and,
    for a typed model, ``edge_tjf`` (Nc, K) are the window's edge vectors
    before the shift and neighbor types, gathered by the caller (the
    row-chunk mode, engine._make_chunked_energy).

    Returns 'atomic_energy' (Nc,), 'total_energy' (), 'edge_energy' (Nc, K)
    or (E,) and, with ``output_charges``, 'charges' (Nc,) and 'dipole' (3,) =
    sum_i q_i r_i over the centers.  The three stretches, inputs, layers and
    readout, are the spans ``model.inputs``, ``model.layers`` and
    ``model.readout`` (``tracing``)."""
    check_supported(cfg)
    dtype = positions.dtype
    cdtype = cfg.interior_dtype(dtype)
    flat = is_flat(edge_index)
    tier = layer_tier(cfg, flat, capture is not None, cdtype, positions.is_cuda)
    remat = remat_on(cfg, capture)
    with tracing.span("model.inputs"):
        if flat:
            if edge_vec is not None:
                raise ValueError("edge_vec takes the TABLE layout only")
            c0 = int(center_offset)
            n = positions.shape[0] - c0 if num_centers is None else num_centers
            whole = c0 == 0 and n == positions.shape[0]
            types_c = types if whole else types[c0:c0 + n]
            pos_c = positions if whole else positions[c0:c0 + n]
            geo = flat_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                             edge_mask=edge_mask)
            agg, per_edge, spread = flat_reducers(edge_index[0] - c0 if c0 else edge_index[0], n)
            agg_rows = agg
        else:
            n, k = edge_index.shape
            if num_centers is not None and num_centers != n:
                raise ValueError(f"num_centers={num_centers} != table rows {n}")
            c0 = int(center_offset)
            types_c, pos_c = types[c0:c0 + n], positions[c0:c0 + n]
            geo = table_edges(cfg, positions, types, edge_index, cell=cell, edge_shifts=edge_shifts,
                              edge_mask=edge_mask, edge_rev=edge_rev, center_offset=c0,
                              edge_vec=edge_vec, edge_tjf=edge_tjf)

            def agg(a):
                return a.sum(dim=1)

            def agg_rows(a):
                return a.reshape(n, k, *a.shape[1:]).sum(dim=1)

            def per_edge(a):
                return a[:, None]

            def spread(a):
                return a[:, :, None].expand(*a.shape, k).reshape(a.shape[0], n * k)
        u = geo["u"]
        if tier == "k1-embed":
            ins = _embed_major(cfg, types_c, geo, n, k, cdtype)
        elif tier in ("stack", "k1", "k1-nopos", "perlayer"):
            ins = _feature_major(params, cfg, types_c, geo, n, k, cdtype)
        else:
            if flat:
                x_in = torch.cat([geo["oh_i"], geo["oh_j"], geo["bessel"]], dim=-1)
            else:
                x_in = _two_body_in(cfg, types_c, geo, n, k).T.reshape(n, k, -1)
            x = mlp_apply(params["two_body_mlp"], x_in) * u[..., None]
    with tracing.span("model.layers"):
        if tier == "k1-embed":
            rows = _embed_layers(params, cfg, ins["in_T"], ins["Y_T"], ins["uT"], k, remat)
            rows = dict(zip(("readout_mlp", "charge_mlp"), rows))

            def head(name):  # the heads ran in K7's epilogue
                return rows[name].reshape(n, k).to(dtype)
        elif tier in ("stack", "k1", "k1-nopos", "perlayer"):
            if tier == "stack":  # no remat, as in JAX: K8's backward recomputes its forward
                xT = fused_stack(ins["xT"], ins["pT"], ins["Y_T"], ins["uT"], params["layers"],
                                 k, cfg.l_max, cfg.avg_num_neighbors, cfg.parity)
            elif tier == "perlayer":
                xT = _perlayer_layers(params, cfg, ins["xT"], ins["pT"], ins["Y_T"], ins["uT"],
                                      k, remat)
            else:
                xT = _k1_layers(params, cfg, ins["xT"], ins["pT"], ins["Y_T"], ins["uT"], k,
                                positional=tier == "k1", remat=remat)

            xT = xT.to(dtype)

            def head(name):
                return mlp_apply_t(params[name], xT)[0].reshape(n, k) * u
        else:
            if tier == "plain":
                x = _plain_layers(params, cfg, x, geo["Y"], u, agg, per_edge, capture, remat,
                                  cdtype)
            else:
                d, ns = geo["Y"].shape[-1], x.shape[-1]
                x, Y_e, u_e = (t.to(cdtype) for t in (x.reshape(-1, ns),
                                                       geo["Y"].reshape(-1, d), u.reshape(-1)))
                x = _k4_layers(params, cfg, x, Y_e, u_e, agg_rows, spread,
                               remat).reshape(*u.shape, ns)
            x = x.to(dtype)

            def head(name):
                return mlp_apply(params[name], x)[..., 0] * u

    with tracing.span("model.readout"):
        e_edge = head("readout_mlp")
        if capture is not None:
            capture["edge_energy"] = e_edge
        e_atom = agg(e_edge)
        e_atom = (params["per_type_scale"].to(dtype)[types_c] * e_atom
                  + params["per_type_shift"].to(dtype)[types_c])
        if atom_mask is not None:
            e_atom = e_atom * atom_mask.to(dtype)
        out = {"atomic_energy": e_atom, "total_energy": e_atom.sum(), "edge_energy": e_edge}
        if cfg.output_charges:
            q_atom = agg(head("charge_mlp"))
            if atom_mask is not None:
                q_atom = q_atom * atom_mask.to(dtype)
            out["charges"] = q_atom
            out["dipole"] = torch.sum(q_atom[:, None] * pos_c, dim=0)
    return out


allegro_energy.per_center_outputs = PER_CENTER_OUTPUTS
