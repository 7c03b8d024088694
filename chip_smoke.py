#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pair_allegro_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; the builds of K1 (csrc/fused_layer.cu),
     K3 (csrc/nequip_conv.cu), K2 (csrc/env_layer.cu), K5
     (csrc/env_layer_mxu.cu), K4 (csrc/tp_mix_fused.cu), K6 / K7
     (csrc/embed_readout_layer.cu) and K8 (csrc/fused_stack.cu) with nvcc
     for sm_90a, started together;
  2. K1 parity: the CUDA kernel against its plain PyTorch version, f32,
     forward and backward, for the first / middle / last forms, at flagship
     widths (ns=64, C=32, l_max=2) on a 500-atom FCC Cu neighbor table;
  3. K3 parity: the same for the NequIP convolution at (l_max, tracks) in
     {1, 2} x {1, 2}, C=64, on the 500-atom table at the engine's K, also
     within the tight gate (TIGHT_TOLS) that its plain version with the
     radial MLP in cuBLAS TF32 (one pass) must fail;
     K2 and K5 parity: the same for the per-layer tier's kernels (K5 in its
     three precision modes) at flagship widths, l_max 2 and 1 with parity;
     K2 and K5's three-pass modes also within a tight gate (TIGHT_TOLS)
     that their one-pass controls must fail;
  4. model parity on the same 500 atoms, the kernel path on the card against
     the plain path (the CPU): Allegro with the charge head (max|dF|, max|dq|
     below 5e-4) on the K1 tier and on the per-layer tier with tp_mode
     paths, mxu_highest and mxu_bf16x3 (mxu_bf16's distance from the exact
     path is printed, not gated), NequIP with one and with two species;
  5. the Allegro main path: 5,324-atom FCC Cu, l_max=2 / 3 layers / 64
     scalar and 32 tensor features, AllegroEngine(skin=0.4) with regrow, NVE
     at 2 fs from 50 K, a 60-step warmup chunk and a timed 60-step chunk;
  6. the NequIP main path: the same system and run with NequIP l_max=1,
     parity, 3 layers, 64 features, 2x32 radial MLP, NequIPEngine(skin=0.4);
  7. K1 and K3 timings at their main path's shapes (CUDA events, warm),
     beside the plain versions' and the least time the card could take
     (bound), and kernel parity at those shapes as in phases 2 and 3 (K3
     within the tight gate too);
  8. the per-layer main path (bench.py's kernel-perlayer tier): phase 5's
     run with layer_fused=False (K2); K2 and K5 (each mode) timings and
     parity at its shapes, K2's beside its two bounds and the mix weights
     it stages, K5's beside its library time (the bare product at the
     mode's precision: cuBLAS f32, or one bf16 product of thrice the depth
     for mxu_bf16x3) and its tensor-core bound; the same run (60 + 60
     steps) with tp_mode=mxu_highest (K5);
  9. K4 (csrc/tp_mix_fused.cu) parity against its plain version, f32,
     forward and backward, on operands of a 256-atom dense (FLAT) build at
     flagship widths and at l_max 1, with a tail tile and a zero dV', and
     within the tight gate its one-pass control must fail; FLAT
     model parity, card against the CPU: Allegro with charges on the
     256-atom box and on a 500-atom slab (two species, typed cutoffs),
     NequIP with one and two species on the 256 atoms (no K3 launch);
 10. the FLAT main path: a 5,324-atom Cu slab (FCC 11^3 cells, 20 A of
     vacuum along z, pbc (T, T, F)) on the dense strategy, Allegro at phase
     5's widths, 60 + 60 NVE steps: 3 + 3 K4 launches per force evaluation
     and no other kernel; K4 timings (two bounds, the mix weights it
     stages, its edge tile) and parity at its shapes; a NequIP run
     (10 + 10 steps) on the same slab, which launches no kernel;
 11. K6 and K7 (csrc/embed_readout_layer.cu) parity against their plain
     versions, f32, forward and backward, on the 500-atom table at flagship
     widths (K7 with and without the charge head); Allegro model parity
     with charges under PAT_L1_EMBED=1 (1 K6, 1 K1 and 1 K7 launch each
     way) and under PAT_L1_POSITIONAL=0 (3 K1 launches of the middle form);
 12. the embed main path: phase 5's run under PAT_L1_EMBED=1, 60 + 60
     steps: 1 K6, num_layers - 2 K1 and 1 K7 launch per force evaluation
     each way and no other kernel; K6 and K7 timings and parity at its
     shapes;
 13. K8 (csrc/fused_stack.cu) parity against its plain version, f32,
     forward and backward (dx0, dpT, dY, du), on the 500-atom table at
     flagship widths with 3 layers, at l_max 1 with parity, and with 1 and
     2 layers; its NaN weight cotangents; Allegro model parity with
     charges under fused_stack=True (1 K8 launch each way, no other
     kernel); f64 systems on the card on the K1, per-layer, stack and
     NequIP paths against the CPU f64 path (no kernel launches);
 14. the stack main path: phase 5's run with fused_stack=True, 60 + 60
     steps: 1 K8 launch per force evaluation each way and no other kernel;
     K8 timings and parity at its shapes;
 15. the accuracy gate of the tiers whose products run on the tensor cores
     (the K1 tier, PAT_L1_POSITIONAL=0 (k1-nopos), PAT_L1_EMBED=1,
     fused_stack=True, the per-layer tier with tp_mode paths (K2),
     mxu_highest and mxu_bf16x3 (K5), the fixture as a slab, pbc (T, T, F),
     on the dense build (K4), and NequIP (K3) on
     benchmarks/accuracy.py:_setup_nequip's config of record) on
     benchmarks/accuracy.py's fixture (500 perturbed FCC Cu atoms), Allegro
     at flagship widths: f32 on the card against the port's plain path of
     the same model at f64 on the CPU, max|dF| <= 1e-4 eV/A (rms|dF| and
     dE/atom printed); mxu_bf16 is printed, not gated;
 16. the CLI's run path (``pair_allegro_tpu_torch.cli.main(["run", ...])``
     in-process) at full width: phase 5's system written as extxyz, the
     flagship Allegro with the charge head and phase 6's NequIP written as
     checkpoints; NVT (dump every 20 with a per-atom charge compute, a
     dipole thermo compute, restart) 60 + 60 steps, its resume 60 steps,
     MTK and Berendsen NPT 20 + 20 steps each, NequIP Langevin 60 + 60, and
     the NVE control (NVT's config with nve) 60 + 60: each leg launches K1
     (Allegro) or K3 (NequIP) its per-evaluation count times its force
     evaluations and no other kernel; the dump's frames and columns; the
     restart read back equals the NVT leg's final state and the resumed
     first force evaluation is within 5e-4 of its last dump frame; the cell
     moved under NPT; each leg's steps/s beside the NVE control's, and one
     dump frame's host ms;
 17. the million-atom mode: bench.py:scale_line's 1,000,188 atoms (FCC Cu
     63^3 cells, jitter 0.03) through AllegroEngine(row_chunk=5292) (189
     windows) at flagship width: the host capacity estimate's seconds, one
     rebuild's, a first and a steady force evaluation's, K, counted edges,
     peak memory and the resolved remat; finite values, |sum F| <= 1e-6 N
     max|F|, exactly 2 x 3 x 189 K1 launches forward and 3 x 189 backward
     per evaluation (each window's checkpoint recomputes its forward) and
     no other kernel; phase 5's system in 4 windows of 1,331 rows against
     no windows (forces within 1e-5 eV/A) and its 60 + 60 steps beside
     phase 5's steps/s; remat=True against remat=False on K1, K6/K7, K2,
     K5, K4 (slab) and K3 on the 500-atom table (the tight gate, twice the
     forward launches), and row_chunk=125 on each TABLE tier against none
     (the model gate);
 18. training and import at full width: 16 frames of 500-atom FCC Cu
     (jitter 0.1 A) labelled by the flagship Allegro on the K1 tier
     (energy, forces, the virial) and read back by ``data.load_frames``; a
     perturbed student trained on ``for_training()`` (Adam, batch 4, 3
     epochs, 12 train / 4 val frames) with no kernel launch, finite
     losses and a falling val rmse_F (ms per update, frames/s, peak
     memory); one batch's gradient on the card (f32) against the CPU (f64),
     each leaf within 1e-3 of its max; the trained tree in AllegroEngine,
     its K1 layouts cached before training: 3 / 3 K1 launches and forces
     within 5e-4 of the plain path; NequIP (phase 6's config) 4 updates
     with no K3 launch, then NequIPEngine with K3; ``cli train``,
     ``cli import`` of a Lightning-style checkpoint of the trained tree
     (equal to it exactly) and ``cli run`` (20 NVE steps, K1 its count).
Phases 7, 8, 10, 12 and 14 print two bounds for K1, K2, K3, K4, K6, K7 and K8:
with the products on the tensor cores in 3xTF32 (the kernels'
``bound_ms``) and on the CUDA cores alone (``bound_ms_f32``), and the
bytes of weights the kernel stages from L2 per call as computed from its
layout (a formula, not a measurement); phase 1 prints ptxas's registers,
shared memory and spills of every kernel.
The launch counts of each main path are read from its phase alone (every
count is set to 0 just before it).  The line before the last is a JSON
object of the kernels; the last line is {"ok": true, "device": {...}}.
Weights are random, made from a seed.

``python3 chip_smoke.py --profile`` instead prints where the device time of
an Allegro main-path MD step goes (torch.profiler; a third argument ``nvt``
runs the step under phase 16's Nosé-Hoover thermostat); ``--profile nequip``,
``--profile perlayer``, ``--profile flat``, ``--profile embed`` and
``--profile stack`` the same for the NequIP, per-layer, FLAT slab, embed
and stack main paths (``--profile perlayer-mxu``: the per-layer path with
K5).  ``python3 chip_smoke.py --timings body`` runs only phases 7, 12 and
14's timings of the layer body's kernels (K1, K6, K7, K8), ``--timings
env`` only phase 8's K2 and K5 timings, ``--timings flat`` only phase 10's
K4 timings, ``--timings nequip`` only phase 7's K3 timings, each at its
main paths' shapes (the engines' first neighbor build, no MD run): run
from two checkouts in one call, it compares two builds of those kernels.
``--scale`` runs phase 5 and phase 17 alone, ``--train`` phase 18 alone; ``--profile scale`` prints
where one steady 1,000,188-atom force evaluation's device time goes;
``--profile allegro-chunked`` profiles phase 5's step in 4 windows;
``--k3-spread [n]`` prints K3's backward error (and the plain f32
version's) against the plain version at f64 over n cotangent seeds on
the card leg's 768-wide case.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM: f32 outside the tensor cores, dense bf16 on the tensor cores and
# HBM3 rate (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# dense TF32 on the tensor cores (NVIDIA data sheet); the layer body's 3xTF32
# products take three passes, so f32-accurate products run at a third of it
PEAK_TF32_FLOPS = 495e12
FORMS = {"first": (True, False), "middle": (False, False), "last": (False, True)}
SEED = 0


def nequip_cfg(species=1, l_max=1, parity=True):
    """The NequIP config of record (bench.py:nequip_line); two species add a
    per-edge-type cutoff."""
    from pair_allegro_tpu_torch.models.nequip import NequIPConfig

    kw = {} if species == 1 else dict(per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)))
    return NequIPConfig(
        type_names=("Cu", "Ag")[:species], r_max=4.5, l_max=l_max, num_layers=3,
        num_features=64, radial_mlp_depth=2, radial_mlp_width=32, avg_num_neighbors=12.0,
        parity=parity, **kw,
    )


def make_nequip_case(n_rep, device, species=1, l_max=1, parity=True, slab=False):
    """(cfg, params, system) for NequIP on FCC Cu of n_rep^3 cells (see
    :func:`fcc_system`); with two species the types are drawn from a
    seed."""
    from pair_allegro_tpu_torch.models.nequip import nequip_init_numpy, nequip_params_from_numpy

    cfg = nequip_cfg(species, l_max, parity)
    params = nequip_params_from_numpy(nequip_init_numpy(cfg, SEED), cfg, device=device)
    return cfg, params, fcc_system(n_rep, device, species, slab)


def flagship_cfg(output_charges=False, **tier):
    """bench.py:main's Allegro config; ``tier`` sets other config fields
    (layer_fused=False is the kernel-perlayer tier)."""
    from pair_allegro_tpu_torch.models.allegro import AllegroConfig

    base = dict(type_names=("Cu",), r_max=4.5, l_max=2, num_layers=3, num_scalar_features=64,
                num_tensor_features=32, avg_num_neighbors=12.0, output_charges=output_charges)
    return AllegroConfig(**{**base, **tier})


SLAB_VACUUM = 20.0  # A of vacuum above a slab, along z (non-periodic there)
TWO_SPECIES = dict(type_names=("Cu", "Ag"), per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)))


def fcc_system(n_rep, device, species=1, slab=False, dtype=None):
    """FCC Cu of n_rep^3 cells (types drawn from a seed with two species),
    or, with ``slab``, the same atoms under SLAB_VACUUM with pbc (T, T, F);
    f32 unless ``dtype`` says otherwise."""
    import numpy as np
    import torch

    from pair_allegro_tpu_torch.system import System, fcc_lattice

    pos, cell = fcc_lattice(n_rep)
    pbc = None
    if slab:
        cell = cell.copy()
        cell[2, 2] += SLAB_VACUUM
        pbc = (True, True, False)
    n = pos.shape[0]
    types = np.random.RandomState(SEED + 1).randint(0, species, n)
    return System.create(pos, types, cell=cell, masses=np.where(types == 0, 63.546, 107.87),
                         pbc=pbc, dtype=dtype or torch.float32, device=device)


def make_case(n_rep, device, output_charges=False, species=1, slab=False, **tier):
    """(cfg, params, system) for FCC Cu of n_rep^3 cells on ``device`` (see
    :func:`fcc_system`); two species add Ag and the typed cutoffs."""
    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy, allegro_params_from_numpy

    cfg = flagship_cfg(output_charges, **({**TWO_SPECIES, **tier} if species == 2 else tier))
    params = allegro_params_from_numpy(allegro_init_numpy(cfg, SEED), cfg, device=device)
    return cfg, params, fcc_system(n_rep, device, species, slab)


def layer_operands(cfg, params, system, eng):
    """The main path's K1 operands for each form, from one neighbor build:
    (x, pT, Y, u) of the first layer, (x, V) of the layers after it."""
    import torch

    from pair_allegro_tpu_torch.models.allegro import allegro_inputs
    from pair_allegro_tpu_torch.ops.fused_layer import fused_layer, k1_weights

    nb = eng.rebuild_fn(system, None)
    with torch.no_grad():
        ins = allegro_inputs(params, cfg, system.positions, system.types, nb.edge_index,
                             cell=system.cell, edge_shifts=nb.edge_shifts,
                             edge_mask=nb.edge_mask)
        k = nb.edge_index.shape[1]
        x1, v1 = fused_layer(ins["xT"], ins["pT"], ins["Y_T"], ins["uT"],
                             k1_weights(params["layers"][0], cfg.l_max, cfg.parity), k,
                             cfg.avg_num_neighbors, first_v=True)
    ops = {
        "first": (ins["xT"], ins["pT"]),
        "middle": (x1, v1),
        "last": (x1, v1),
    }
    return ops, ins["Y_T"], ins["uT"], k


def k1_terms(w, form, bwd):
    """(operations per edge slot, rows read, rows written) of one K1 call
    of ``form`` (a FORMS name or a (first_v, last) pair):
    the operations of the function on these inputs (the backward includes
    its recompute of wz, env, inv and the latent forward), each input row
    read once and each output row written once."""
    from pair_allegro_tpu_torch.ops.fused_layer import _row_tables
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    first_v, last = FORMS[form] if isinstance(form, str) else form
    ns, c, cout, latd = w.dims
    rows = _row_tables(w.lmax, w.parity)
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    d = len(rows)
    used = rows[:1] if last else rows
    n_tp = sum(len(ents) for ents, _ in used)
    mlp = sum(2 * a * b for a, b in zip(latd[:-1], latd[1:]))
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


def k1_cost(w, e, k, form, bwd):
    """(flops, bytes) one K1 call needs at E edge slots (``k1_terms``; f32,
    weights included)."""
    per, io_in, io_out = k1_terms(w, form, bwd)
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, 4 * ((io_in + io_out) * e + n_w)


def k1_products(w, form, bwd):
    """Of ``k1_terms``'s operations per edge slot, those of the small
    matrix products, which the layer body runs on the tensor cores: wz =
    Wenv^T x, the mix and the latent MLP, and in the backward their
    transposes and the env backward's Wenv dwz."""
    from pair_allegro_tpu_torch.ops.fused_layer import _row_tables
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    first_v, last = FORMS[form] if isinstance(form, str) else form
    ns, c, cout, latd = w.dims
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    mlp = _mlp_ops(latd)
    mix = 0 if last else sum(2 * cout * P[l3] * c for _, l3 in _row_tables(w.lmax, w.parity))
    return 4 * ns * c + 2 * mlp + mix if bwd else 2 * ns * c + mlp + mix


def bounds(flops, prod, nbytes):
    """The least time of a call with ``flops`` operations, ``prod`` of them
    in small products, moving ``nbytes``: on the tensor cores (``bound_ms``:
    the products at PEAK_TF32_FLOPS / 3 and the rest at the f32 rate, the
    larger of the two, since the tensor and the f32 pipes run side by side)
    and on the CUDA cores alone (``bound_ms_f32``: every flop at the f32
    rate); each the larger of its operations' time and the bytes' time."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_tc = max(prod / (PEAK_TF32_FLOPS / 3), (flops - prod) / PEAK_F32_FLOPS) * 1e3
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_tc, t_b), bound_by="operations" if t_tc >= t_b else "bytes",
                bound_ms_f32=max(t_f32, t_b), bound_by_f32="operations" if t_f32 >= t_b else "bytes")


def n_tiles(e, k):
    """Edge tiles of 32 the layer body walks at E edge slots, K per center."""
    return e // k * -(-k // 32)


def k1_weight_bytes(w, form, bwd, tiles):
    """Bytes of weights one K1 call of ``form`` stages from L2 into its ring
    (csrc/allegro_layer.cuh), computed from the body's staging, not
    measured: per tile, Wenv in each pass over the center's edges, the
    latent MLP, and each mix l3 block once (it stays in the ring over its
    rows, as at the flagship widths); the backward adds the latent MLP's and
    the mix's transposes and Wenv^T."""
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    first_v, last = FORMS[form] if isinstance(form, str) else form
    ns, c, cout, latd = w.dims
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    lat = sum(a * b for a, b in zip(latd[:-1], latd[1:]))
    mix = 0 if last else sum(p * c * cout for p in P)
    words = 3 * ns * c + 2 * lat + mix if bwd else ns * c + lat + mix
    return 4 * words * tiles


def _mlp_ops(dims):
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def k6_cost(w, e, bwd):
    """(flops, bytes) one K6 call needs at E edge slots: K1's first form
    (``k1_terms``) with the prologue x = MLP2b(in) * u, pT = W_te^T x /
    sqrt(ns) (the backward adds its recompute, the two-body MLP's backward,
    W_te dpT and the du and dx * u terms); the input rows in place of x and
    pT, d(in) in place of dx and dpT (f32, weights included)."""
    ns, c = w.te.shape
    per, io_in, io_out = k1_terms(w.layer, "first", bwd)
    mlp = _mlp_ops(w.tb_dims)
    pro = mlp + ns + 2 * ns * c
    swap = w.n_in - ns - c
    if bwd:
        per += pro + mlp + 2 * ns * c + 3 * ns
        io_out += swap
    else:
        per += pro
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, 4 * ((io_in + swap + io_out) * e + n_w)


def k6_products(w, bwd):
    """``k1_products`` of K1's first form with the prologue's two-body MLP
    and tensor embed (the backward: their recompute and transposes)."""
    ns, c = w.te.shape
    pro = _mlp_ops(w.tb_dims) + 2 * ns * c
    return k1_products(w.layer, "first", bwd) + (2 * pro if bwd else pro)


def k6_weight_bytes(w, bwd, tiles):
    """``k1_weight_bytes`` of the first form with the prologue's weights:
    the two-body MLP (first layer padded to 4k rows) in each pass over the
    center's edges, W_te, and in the backward their transposes."""
    ns, c = w.te.shape
    dims = (-(-w.n_in // 4) * 4, *w.tb_dims[1:])
    tb = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    extra = 4 * tb + 2 * ns * c if bwd else 2 * tb + ns * c
    return k1_weight_bytes(w.layer, "first", bwd, tiles) + 4 * extra * tiles


def k7_products(w, bwd):
    """``k1_products`` of K1's last form with the heads' layers but their
    last (width 1, a row sum on the CUDA cores), twice in the backward."""
    heads = sum(_mlp_ops(h[:-1]) for h in w.heads_dims)
    return k1_products(w.layer, "last", bwd) + (2 * heads if bwd else heads)


def k7_weight_bytes(w, bwd, tiles):
    """``k1_weight_bytes`` of the last form with the heads' weights per
    tile (the backward: the heads' forward and backward)."""
    heads = sum(a * b for h in w.heads_dims for a, b in zip(h[:-1], h[1:]))
    return k1_weight_bytes(w.layer, "last", bwd, tiles) + 4 * (2 if bwd else 1) * heads * tiles


def k8_products(w, bwd):
    """``k1_products`` of each layer's form, summed over the stack (as
    ``k8_cost``, the backward's recompute not counted)."""
    n_l = len(w.k1)
    return sum(k1_products(lw, (li == 0, li == n_l - 1), bwd) for li, lw in enumerate(w.k1))


def k8_weight_bytes(w, bwd, tiles):
    """``k1_weight_bytes`` of each layer's form over the stack; the
    backward also recomputes layers 0 .. L-2 forward."""
    n_l = len(w.k1)
    forms = [(li == 0, li == n_l - 1) for li in range(n_l)]
    fwd = [k1_weight_bytes(lw, f, False, tiles) for lw, f in zip(w.k1, forms)]
    if not bwd:
        return sum(fwd)
    return sum(fwd[:-1]) + sum(k1_weight_bytes(lw, f, True, tiles) for lw, f in zip(w.k1, forms))


def k7_cost(w, e, bwd):
    """(flops, bytes) one K7 call needs at E edge slots: K1's last form
    (``k1_terms``) with the heads head(x') * u as epilogue (the backward adds
    x' and the heads' forward, their backward and du); the heads' rows in
    place of x' (forward), their cotangents in place of dx' (backward)
    (f32, weights included)."""
    ns = w.layer.env_w.shape[0]
    per, io_in, io_out = k1_terms(w.layer, "last", bwd)
    heads = sum(_mlp_ops(h) + 1 for h in w.heads_dims)
    nh = len(w.heads)
    if bwd:
        per += 2 * ns + 2 * heads + nh
        io_in += nh - ns
    else:
        per += heads
        io_out += nh - ns
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, 4 * ((io_in + io_out) * e + n_w)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


TOLS = {"fwd": (1e-4, 1e-4), "bwd": (1e-4, 1e-3)}  # atol, rtol on max|plain|


def check(kernel, label, kind, names, got, ref, tols=None):
    """Hold kernel results against the plain version's; returns the max
    abs error, raises beyond atol + rtol * max|plain| (``TOLS[kind]``
    unless ``tols`` is given)."""
    atol, rtol = tols or TOLS[kind]
    worst = 0.0
    for name, a, b in zip(names, got, ref):
        err = max_err(a, b)
        tol = atol + rtol * float(b.detach().abs().max())
        print(f"{kernel} parity {label} {kind} {name}: max|kernel-plain| {err:.3e} "
              f"(tolerance {tol:.3e} = {atol:g} + {rtol:g} max|plain|)")
        if not err <= tol:
            raise RuntimeError(f"{kernel} {kind} {label} {name} disagrees with its plain version")
        worst = max(worst, err)
    return worst


K1_NAMES = ("x", "V", "Y", "u")
K3_NAMES = ("hj", "bessel", "u", "Y")


def k1_parity(cfg, params, system, eng):
    """Phase 2: kernel against plain version for each form, fwd and bwd."""
    import torch

    from pair_allegro_tpu_torch.ops import fused_layer as fl

    ops, Y, u, k = layer_operands(cfg, params, system, eng)
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    errs = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator(device=Y.device).manual_seed(SEED)
    for li, (form, (first_v, last)) in enumerate(FORMS.items()):
        w = fl.k1_weights(params["layers"][li], cfg.l_max, cfg.parity)
        ins = [t.detach().clone().requires_grad_(True) for t in (*ops[form], Y, u)]
        out_k = fl.fused_layer(*ins, w, k, cfg.avg_num_neighbors, first_v=first_v, last=last)
        out_r = fl.fused_layer_reference(*ins, w, k, inv_avg, first_v, last)
        out_k, out_r = ((out_k,), (out_r,)) if last else (out_k, out_r)
        cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in out_r]
        g_k = torch.autograd.grad(out_k, ins, cots)
        g_r = torch.autograd.grad(out_r, ins, cots)
        torch.cuda.synchronize()
        for kind, got, ref in (("fwd", out_k, out_r), ("bwd", g_k, g_r)):
            errs[kind] = max(errs[kind], check("K1", f"{form:6s} 500 atoms", kind, K1_NAMES,
                                                 got, ref))
    return errs


def model_parity(env=None, want=None, tier=None):
    """Phases 4, 11 and 13: forces and charges, kernel path (card) vs plain
    path (CPU), under ``env`` (the K1 tier's embed/readout or non-positional
    form) and the config fields ``tier``; the card's launches per force
    evaluation must be ``want`` ({kernel: n}, fwd = bwd), by default 3
    K1."""
    from pair_allegro_tpu_torch.engine import AllegroEngine

    env = env or {}
    want = want or {"K1": 3}
    tier = tier or {}
    mods = kernel_modules()
    outs = []
    with env_vars(env):
        for dev in ("cuda", "cpu"):
            cfg, params, system = make_case(5, dev, output_charges=True, **tier)
            eng = AllegroEngine(cfg, params, system, device=dev)
            nb = eng.rebuild_fn(system, None)
            for m in mods.values():
                m.launches.reset()
            o = eng.force_fn(system, nb)
            if dev == "cuda":
                launched = {name: (m.launches.fwd, m.launches.bwd) for name, m in mods.items()
                            if m.launches.fwd or m.launches.bwd}
            outs.append((o.forces.cpu(), o.extras["charges"].cpu(), o.total_energy.cpu()))
    (f_k, q_k, e_k), (f_p, q_p, e_p) = outs
    df, dq = max_err(f_k, f_p), max_err(q_k, q_p)
    what = ", ".join(str(x) for x in (env, tier) if x)
    print(f"model parity (500 atoms, charges{', ' + what if what else ''}): max|dF| {df:.3e} "
          f"eV/A, max|dq| {dq:.3e}, E {float(e_k):.6f} vs {float(e_p):.6f} eV (gate 5e-4); "
          f"launches on the card {launched}")
    if not (df < 5e-4 and dq < 5e-4):
        raise RuntimeError(f"model parity gate failed {what}")
    if launched != {name: (n, n) for name, n in want.items() if n}:
        raise RuntimeError(f"model parity {what}: launched {launched}, want {want}")


# the main paths: (model, Allegro tier fields, the kernel that carries it
# (None: no kernel), steps per chunk, slab, environment); "perlayer" is
# bench.py's kernel-perlayer tier, "flat" the dense-strategy slab with K4,
# "embed" the K1 tier's embed/readout form (K6, K1, K7), "stack" the whole
# layer stack in one kernel (K8)
PATHS = {
    "allegro": ("allegro", {}, "K1", 60, False, {}),
    "nequip": ("nequip", {}, "K3", 60, False, {}),
    "perlayer": ("allegro", dict(layer_fused=False), "K2", 60, False, {}),
    "perlayer-mxu": ("allegro", dict(layer_fused=False, tp_mode="mxu_highest"), "K5", 60, False, {}),
    "flat": ("allegro", {}, "K4", 60, True, {}),
    "nequip-flat": ("nequip", {}, None, 10, True, {}),
    "embed": ("allegro", {}, "K6", 60, False, {"PAT_L1_EMBED": "1"}),
    "stack": ("allegro", dict(fused_stack=True), "K8", 60, False, {}),
    "allegro-chunked": ("allegro", {}, "K1", 60, False, {}),
}
# the paths that run the million-atom mode's windows: rows per window
ROW_CHUNK = {"allegro-chunked": 1331}
# steps/s of each main path run in this process (phase 17 reads phase 5's)
STEPS_PER_S = {}


def path_launches(path, cfg):
    """{kernel: launches per force evaluation, forward and backward alike}
    of a main path; every other kernel must launch no time."""
    kernel = PATHS[path][2]
    if path == "embed":
        return {"K6": 1, "K1": cfg.num_layers - 2, "K7": 1}
    if path == "stack":
        return {"K8": 1}
    return {kernel: cfg.num_layers} if kernel else {}


@contextlib.contextmanager
def env_vars(env):
    """The environment a path runs under, restored after it."""
    old = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def kernel_modules():
    """{kernel id: its wrapper module}, each with ``launches`` and ``LIB``."""
    from pair_allegro_tpu_torch.ops import (
        embed_layer,
        env_layer,
        env_layer_mxu,
        fused_layer,
        fused_stack,
        nequip_conv,
        readout_layer,
        tp_mix_fused,
    )

    return {"K1": fused_layer, "K3": nequip_conv, "K2": env_layer, "K5": env_layer_mxu,
            "K4": tp_mix_fused, "K6": embed_layer, "K7": readout_layer, "K8": fused_stack}


def build_path(path):
    """(cfg, params, system, engine) of a main path, on the card."""
    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine

    model, tier, _, _, slab, _ = PATHS[path]
    if model == "allegro":
        cfg, params, system = make_case(11, None, slab=slab, **tier)
        return cfg, params, system, AllegroEngine(cfg, params, system, skin=0.4,
                                                  row_chunk=ROW_CHUNK.get(path))
    cfg, params, system = make_nequip_case(11, None, slab=slab)
    return cfg, params, system, NequIPEngine(cfg, params, system, skin=0.4)


def main_path(path="allegro"):
    """Phases 5, 6, 8, 10, 12 and 14: the bench.py:main (Allegro, K1 tier
    and its embed/readout form, per-layer tier, or the fused stack) or
    bench.py:nequip_line (NequIP)
    workload on the port, on the bulk box or on the slab.  Every kernel's
    counts are set to 0 just before the run and read just after it; each
    kernel of the path must launch its count per force evaluation, forward
    and backward, and no other kernel may launch.  Returns (cfg, params,
    system, engine, {kernel: {"fwd": n, "bwd": n}})."""
    with env_vars(PATHS[path][5]):
        return _main_path(path)


def _main_path(path):
    import torch

    from pair_allegro_tpu_torch.engine import edge_slots
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    n_steps = PATHS[path][3]
    cfg, params, system, eng = build_path(path)
    mods = kernel_modules()
    n_eval = [0]
    n_build = [0]

    def force_fn(s, nb):
        n_eval[0] += 1
        return eng.force_fn(s, nb)

    def rebuild_fn(s, prev):  # counts the builds the skin check lets through
        nb = eng.rebuild_fn(s, prev)
        n_build[0] += nb is not prev
        return nb

    def grow_fn(**kw):
        eng.grow(**kw)
        return rebuild_fn

    for m in mods.values():
        m.launches.reset()
    dt_fs = 2.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim = Simulation(system, force_fn, rebuild_fn, dt=dt_fs * Units.fs, grow_fn=grow_fn)
    sim.init_velocities(50.0, seed=SEED)
    sim.run(n_steps, log_every=n_steps)  # warmup chunk
    torch.cuda.synchronize()
    peak_all = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    n_build[0] = 0
    t0 = time.perf_counter()
    rows = sim.run(n_steps, log_every=n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: {"fwd": m.launches.fwd, "bwd": m.launches.bwd} for name, m in mods.items()}
    per_eval = path_launches(path, cfg)
    # under row_chunk each window runs its kernels once forward, once more
    # in its checkpoint's recompute, and once backward
    windows = system.n_atoms // eng.row_chunk if eng.row_chunk else 0
    fwd_x, bwd_x = (2 * windows, windows) if windows else (1, 1)
    want = {name: {"fwd": n_eval[0] * per_eval.get(name, 0) * fwd_x,
                   "bwd": n_eval[0] * per_eval.get(name, 0) * bwd_x} for name in mods}
    launched = {name: (c["fwd"], c["bwd"]) for name, c in counts.items() if c["fwd"] or c["bwd"]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = sim.state
    finite = bool(torch.isfinite(st.forces).all()) and math.isfinite(rows[-1]["etotal"])
    steps_per_s = n_steps / wall
    STEPS_PER_S[path] = steps_per_s
    spec = eng.spec
    cap = (f"max_edges={spec.max_edges} ({len(spec.shifts_table)} image shifts)"
           if spec.strategy == "dense" else f"K={spec.max_neighbors}")
    print(f"{path} main path: {system.n_atoms} atoms, pbc {system.pbc}, strategy {spec.strategy}, "
          f"{cap}, E={edge_slots(spec, system.n_atoms)} edge slots, {rows[-1]['n_edges']} real "
          f"edges, regrows {sim.regrows}, neighbor builds in the timed chunk {n_build[0]}, force "
          f"evaluations {n_eval[0]}, launches fwd/bwd {launched} (per force evaluation "
          f"{per_eval}{f' in each of {windows} windows of {eng.row_chunk} rows, forward twice' if windows else ''})")
    print(f"{path} main path: {steps_per_s:.4f} steps/s, "
          f"{steps_per_s * dt_fs * 1e-6 * 86400.0:.4f} ns/day ({wall * 1e3 / n_steps:.3f} ms/step), "
          f"T {rows[-1]['temp']:.1f} K, etotal {rows[-1]['etotal']:.4f} eV, finite {finite}, "
          f"peak device memory of the timed chunk {peak:.2f} GiB, of the engine's first build "
          f"and the warmup chunk {peak_all:.2f} GiB")
    if not finite:
        raise RuntimeError(f"{path} main path produced non-finite values")
    if counts != want:
        raise RuntimeError(f"{path} main path launched {launched}, want {per_eval} per force "
                           f"evaluation ({n_eval[0]} evaluations)")
    return cfg, params, system, eng, counts


def regrow_gib(eng, system):
    from pair_allegro_tpu_torch.engine import regrow_bytes

    return regrow_bytes(eng.spec, system, eng.cfg) / 2**30


def rebuild_ms(system, eng, reps=3):
    """Wall time of one neighbor build from scratch (synchronised), and the
    peak device memory it reaches."""
    import torch

    eng.rebuild_fn(system, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for _ in range(reps):
        nb = eng.rebuild_fn(system, None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    del nb
    return ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def k1_timings(cfg, params, system, eng, errs):
    """Phase 5: per-form fwd/bwd time of kernel and plain version at the
    main path's shapes, with the bound; the kernel's results at these
    shapes are held against the plain version's too (into ``errs``)."""
    import torch

    from pair_allegro_tpu_torch.ops import fused_layer as fl

    ops, Y, u, k = layer_operands(cfg, params, system, eng)
    e = Y.shape[1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    gen = torch.Generator(device=Y.device).manual_seed(SEED)
    res = {}
    for li, (form, (first_v, last)) in enumerate(FORMS.items()):
        w = fl.k1_weights(params["layers"][li], cfg.l_max, cfg.parity)
        x, V = ops[form]
        dxo = torch.randn(x.shape, generator=gen, device=x.device)
        dvo = None if last else torch.randn((Y.shape[0], w.mix[0].shape[1], e), generator=gen,
                                            device=x.device)
        k_f = cuda_ms(lambda: fl._kernel_fwd(x, V, Y, u, w, k, inv_avg, first_v, last), 5)
        k_b = cuda_ms(lambda: fl._kernel_bwd(x, V, Y, u, w, k, inv_avg, first_v, last, dxo, dvo), 5)
        with torch.no_grad():
            p_f = cuda_ms(lambda: fl.fused_layer_reference(x, V, Y, u, w, k, inv_avg, first_v, last), 2)
        ins = [t.detach().clone().requires_grad_(True) for t in (x, V, Y, u)]
        out = fl.fused_layer_reference(*ins, w, k, inv_avg, first_v, last)
        outs, cots = ((out,), (dxo,)) if last else (out, (dxo, dvo))
        p_b = cuda_ms(lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True), 2)
        out_k = fl._kernel_fwd(x, V, Y, u, w, k, inv_avg, first_v, last)
        g_k = fl._kernel_bwd(x, V, Y, u, w, k, inv_avg, first_v, last, dxo, dvo)
        torch.cuda.synchronize()
        label = f"{form:6s} main path"
        errs["fwd"] = max(errs["fwd"], check("K1", label, "fwd", K1_NAMES,
                                             (out_k,) if last else out_k, outs))
        g_r = torch.autograd.grad(outs, ins, cots)
        errs["bwd"] = max(errs["bwd"], check("K1", label, "bwd", K1_NAMES, g_k, g_r))
        del out, outs, ins, out_k, g_k, g_r
        torch.cuda.empty_cache()
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            bwd = kind == "bwd"
            flops, nbytes = k1_cost(w, e, k, form, bwd)
            res[(form, kind)] = timing(ms, pms, flops, k1_products(w, form, bwd) * e, nbytes,
                                       k1_weight_bytes(w, form, bwd, n_tiles(e, k)))
            print_timing(f"K1 {kind} {form:6s} E={e}", res[(form, kind)])
    return res


def timing(ms, pms, flops, prod, nbytes, weight_bytes):
    """A kernel row: its time, its plain version's, both bounds
    (``bounds``), and the weights its tiles stage from L2 (computed)."""
    return dict(ms=ms, plain_ms=pms, **bounds(flops, prod, nbytes), gflop=flops / 1e9,
                mbytes=nbytes / 1e6, staged_weight_mb=weight_bytes / 1e6)


def print_timing(label, r):
    print(f"{label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms with the tensor cores ({r['bound_by']}), "
          f"{r['bound_ms_f32']:.4f} ms on the CUDA cores alone ({r['bound_by_f32']}); "
          f"{r['gflop']:.2f} GFLOP, {r['mbytes']:.1f} MB, weights staged from L2 "
          f"{r['staged_weight_mb']:.1f} MB (computed), {r['gflop'] / r['ms']:.2f} TFLOP/s "
          f"achieved")


def k3_operands(cfg, params, system, eng, seed=SEED):
    """K3 operands of the system's neighbor table: (hj, bessel, u, Y) on the
    edge-major layout, hj gathered through the table from seeded random node
    rows (the model's own rows are mostly zero in the first layer), and the
    first layer's kernel weights and K."""
    import torch

    from pair_allegro_tpu_torch.models.edges import table_edges
    from pair_allegro_tpu_torch.ops.nequip_conv import prepare_radial, radial_cl
    from pair_allegro_tpu_torch.ops.tp import tp_num_paths

    nb = eng.rebuild_fn(system, None)
    n, k = nb.edge_index.shape
    d = cfg.feature_dim
    with torch.no_grad():
        geo = table_edges(cfg, system.positions, system.types, nb.edge_index, cell=system.cell,
                          edge_shifts=nb.edge_shifts, edge_mask=nb.edge_mask)
        gen = torch.Generator(device=system.device).manual_seed(seed)
        h = torch.randn((n, d * cfg.n_tracks * cfg.num_features), generator=gen,
                        device=system.device)
        hj = h[nb.edge_index].reshape(n * k, -1)
    ops = (hj, geo["bessel"].reshape(n * k, -1), geo["u"].reshape(n * k, 1), geo["Y"].reshape(n * k, d))
    c, T = cfg.num_features, cfg.n_tracks
    ws = radial_cl(params["layers"][0]["radial_mlp"]["w"], c, tp_num_paths(cfg.l_max), T)
    return ops, prepare_radial(ws, c, T, cfg.l_max), k


def k3_cost(w, e, k, bwd):
    """(flops, prod, bytes) one K3 call needs at E edge slots, counted from
    the kernel's code: the radial MLP (recomputed in the backward), the TP
    entries (4 operations each in the forward, 9 in the backward), the
    backward's du, dw * u and the product back through the radial MLP; of
    them ``prod`` the last radial layer's products on the tensor cores
    (forward X Wlast, backward that again and gs Wlast^T); each input read
    once, each output written once (f32), weights included."""
    from pair_allegro_tpu_torch.ops.tp import tp_entry_table

    dims = w.dims
    c, T = w.C, w.n_tracks
    n_ent = sum(len(ents) for _, rows in tp_entry_table(w.lmax) for *_, ents in rows)
    d = (w.lmax + 1) ** 2
    df, tpc, b = d * T * c, dims[-1], dims[0]
    hidden = sum(2 * a * o + 5 * o for a, o in zip(dims[:-2], dims[1:-1]))
    last = 2 * dims[-2] * tpc
    radial = hidden + last + tpc
    if not bwd:
        per = radial + 4 * n_ent * T * c
        prod = last
        io = (df + b + 1 + d) * e + df * (e // k)
    else:
        back = last + sum(2 * a * o + 8 * o for a, o in zip(dims[:-2], dims[1:-1]))
        per = radial + 9 * n_ent * T * c + 3 * tpc + back
        prod = 2 * last
        io = 2 * (df + b + 1 + d) * e + df * (e // k)
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, prod * e, 4 * (io + n_w)


def k3_weight_bytes(w, e, k, bwd):
    """Bytes of the last radial weight one K3 call brings from L2 into its
    blocks (csrc/nequip_conv.cu), computed from the launcher's layout
    (``ops/nequip_conv.block_layout``), not measured: where it is resident,
    once per block of the persistent grid (132 SMs, blocks an SM as shared
    memory and the launch bounds allow); else the whole weight for each
    m16 edge tile and product (forward one, backward two)."""
    from pair_allegro_tpu_torch.ops import nequip_conv as k3

    nbytes, et, resident = k3.block_layout(w.C, w.n_tracks, w.lmax, w.dims, bwd)
    wbytes = 4 * w.dims[-2] * w.dims[-1]
    if resident:
        per_sm = min(233472 // (nbytes + 1024), 1 if bwd or w.lmax == 2 else 2)
        work = -(-e // et) if bwd else e // k
        return min(work, 132 * per_sm) * wbytes
    return e // 16 * wbytes * (2 if bwd else 1)


def k3_compare(label, ops, w, k, avg, gen):
    """K3 against its plain version on ``ops``, forward and backward (a
    random cotangent), also under ``tight_check`` with the plain version in
    cuBLAS TF32 (``tf32_control``: the radial MLP's products in one pass)
    as the control that must fail it; returns the max abs errors."""
    import torch

    from pair_allegro_tpu_torch.ops import nequip_conv as k3

    inv_avg = 1.0 / math.sqrt(avg)
    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k = k3.nequip_conv(*ins, w, k, avg)
    out_r = k3.nequip_conv_reference(*ins, w, k, inv_avg)
    cot = torch.randn(out_r.shape, generator=gen, device=out_r.device)
    g_k = torch.autograd.grad(out_k, ins, cot)
    g_r = torch.autograd.grad(out_r, ins, cot)
    torch.cuda.synchronize()
    errs = {"fwd": check("K3", label, "fwd", ("agg",), (out_k,), (out_r,)),
            "bwd": check("K3", label, "bwd", K3_NAMES, g_k, g_r)}

    def plain():
        xs = [t.detach().clone().requires_grad_(True) for t in ops]
        out = k3.nequip_conv_reference(*xs, w, k, inv_avg)
        return (out.detach(),), torch.autograd.grad(out, xs, cot)

    tight_check("K3", label, (("agg",), K3_NAMES), ((out_k.detach(),), g_k),
                ((out_r.detach(),), g_r),
                tf32_control(plain))
    del ins, out_k, out_r, g_k, g_r
    torch.cuda.empty_cache()
    return errs


def k3_parity():
    """Phase 3: K3 against its plain version for each (l_max, tracks) on the
    500-atom table, fwd and bwd."""
    import torch

    from pair_allegro_tpu_torch.engine import NequIPEngine

    errs = {"fwd": 0.0, "bwd": 0.0}
    for lmax in (1, 2):
        for parity in (False, True):
            cfg, params, system = make_nequip_case(5, None, l_max=lmax, parity=parity)
            eng = NequIPEngine(cfg, params, system)
            ops, w, k = k3_operands(cfg, params, system, eng)
            gen = torch.Generator(device=system.device).manual_seed(SEED)
            e = k3_compare(f"l_max={lmax} T={cfg.n_tracks} C={cfg.num_features} 500 atoms K={k}",
                           ops, w, k, cfg.avg_num_neighbors, gen)
            errs = {kind: max(errs[kind], e[kind]) for kind in errs}
    return errs


# tests/test_torch_cuda.py's K3_LAYOUT_CASES[18]: (l_max, tracks, C, K,
# centers, hidden widths, Bessels)
K3_SPREAD_CASE = (2, 1, 4, 18, 3, (768, 768), 8)


def k3_layout_operands(device, lmax, T, c, k, n, hidden, b, seed=4):
    """K3's weights and operands (hj, bessel, u, Y) at one layout case of
    the card legs, drawn from a seeded CPU generator (padded slots at the
    end of the last row)."""
    import torch

    from pair_allegro_tpu_torch.ops import nequip_conv as k3
    from pair_allegro_tpu_torch.ops.tp import tp_num_paths

    g = torch.Generator(device="cpu").manual_seed(seed)
    d, e = (lmax + 1) ** 2, n * k
    dims = (b, *hidden, T * tp_num_paths(lmax) * c)
    ws = [torch.randn(a, o, generator=g) for a, o in zip(dims[:-1], dims[1:])]
    w = k3.prepare_radial([t.to(device) for t in ws], c, T, lmax)
    u = torch.rand(e, 1, generator=g)
    u[-k // 3:] = 0.0
    ins = [torch.randn(e, d * T * c, generator=g), torch.randn(e, b, generator=g), u,
           torch.randn(e, d, generator=g)]
    return w, [t.to(device) for t in ins]


def k3_seed_grads(w, ins, k, avg, cot_seed):
    """K3's and its plain version's (f32 and f64) backward on ``ins`` for
    the cotangent drawn from a CPU generator seeded with ``cot_seed``:
    (kernel, plain f32, plain f64) gradient tuples."""
    import torch

    from pair_allegro_tpu_torch.ops import nequip_conv as k3

    inv_avg = 1.0 / math.sqrt(avg)
    dev = ins[0].device
    rows = ins[0].shape[0] // k
    d_out = ins[0].shape[1]
    g = torch.Generator(device="cpu").manual_seed(cot_seed)
    cot = torch.randn((rows, d_out), generator=g).to(dev)
    out = []
    for fn, dtype in ((k3.nequip_conv, torch.float32), (k3.nequip_conv_reference, torch.float32),
                      (k3.nequip_conv_reference, torch.float64)):
        wd = w if dtype == torch.float32 else k3.prepare_radial(
            [t.double() for t in w.ws], w.C, w.n_tracks, w.lmax)
        xs = [t.detach().to(dtype).requires_grad_(True) for t in ins]
        o = fn(*xs, wd, k, avg) if fn is k3.nequip_conv else fn(*xs, wd, k, inv_avg)
        out.append(torch.autograd.grad(o, xs, cot.to(dtype)))
    return tuple(out)


def k3_seed_spread(n_seeds=20):
    """``--k3-spread``: K3's backward at K3_SPREAD_CASE over ``n_seeds``
    cotangent seeds, the kernel's and the plain f32 version's error, each
    against the plain version at f64 on the card, as a share of the tight
    gate's tolerance (TIGHT_TOLS['bwd'], atol + rtol max|f64|), per input;
    and the card leg's own comparison (kernel against plain f32).  Prints
    one JSON line per seed and a summary; returns the worst shares."""
    import torch

    atol, rtol = TIGHT_TOLS["bwd"]
    lmax, T, c, k, n = K3_SPREAD_CASE[:5]
    w, ins = k3_layout_operands(torch.device("cuda"), *K3_SPREAD_CASE)
    worst = {"kernel_vs_f64": 0.0, "plain_vs_f64": 0.0, "kernel_vs_plain": 0.0}
    for seed in range(n_seeds):
        g_k, g_p, g_64 = k3_seed_grads(w, ins, k, 12.0, seed)
        row = {"seed": seed}
        for key, a, b in (("kernel_vs_f64", g_k, g_64), ("plain_vs_f64", g_p, g_64),
                          ("kernel_vs_plain", g_k, g_p)):
            shares = []
            for x, y in zip(a, b):
                tol = atol + rtol * float(y.double().abs().max())
                shares.append(float((x.double() - y.double()).abs().max()) / tol)
            row[key] = shares
            worst[key] = max(worst[key], max(shares))
        print("k3 spread", json.dumps(row))
    print("k3 spread worst err/tol over", n_seeds, "seeds:", json.dumps(worst))
    return worst


def nequip_model_parity():
    """Phase 4 (NequIP): forces, kernel path (card) vs plain path (CPU), one
    and two species."""
    from pair_allegro_tpu_torch.engine import NequIPEngine

    for species in (1, 2):
        outs = []
        for dev in ("cuda", "cpu"):
            cfg, params, system = make_nequip_case(5, dev, species=species)
            eng = NequIPEngine(cfg, params, system, device=dev)
            o = eng.force_fn(system, eng.rebuild_fn(system, None))
            outs.append((o.forces.cpu(), o.total_energy.cpu()))
        (f_k, e_k), (f_p, e_p) = outs
        df = max_err(f_k, f_p)
        print(f"NequIP model parity (500 atoms, {species} species): max|dF| {df:.3e} eV/A "
              f"(max|F| {float(f_p.abs().max()):.3f}), E {float(e_k):.6f} vs {float(e_p):.6f} eV, "
              f"dE {abs(float(e_k) - float(e_p)):.3e} eV (gate 5e-4 on dF)")
        if not df < 5e-4:
            raise RuntimeError("NequIP model parity gate failed")


def k3_timings(cfg, params, system, eng, errs):
    """Phase 7 (K3): fwd/bwd time of kernel and plain version at the NequIP
    main path's shapes, with the bound, and parity at those shapes (into
    ``errs``)."""
    import torch

    from pair_allegro_tpu_torch.ops import nequip_conv as k3

    ops, w, k = k3_operands(cfg, params, system, eng)
    e = ops[0].shape[0]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    dagg = torch.randn((e // k, ops[0].shape[1]), generator=gen, device=system.device)
    k_f = cuda_ms(lambda: k3._kernel_fwd(*ops, w, k, inv_avg), 10)
    k_b = cuda_ms(lambda: k3._kernel_bwd(*ops, w, k, inv_avg, dagg), 10)
    with torch.no_grad():
        p_f = cuda_ms(lambda: k3.nequip_conv_reference(*ops, w, k, inv_avg), 2)
    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out = k3.nequip_conv_reference(*ins, w, k, inv_avg)
    p_b = cuda_ms(lambda: torch.autograd.grad(out, ins, dagg, retain_graph=True), 2)
    del ins, out
    torch.cuda.empty_cache()
    e2 = k3_compare(f"l_max={w.lmax} T={w.n_tracks} C={w.C} main path E={e}", ops, w, k,
                    cfg.avg_num_neighbors, gen)
    errs = {kind: max(errs[kind], e2[kind]) for kind in errs}
    res = {}
    for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
        bwd = kind == "bwd"
        flops, prod, nbytes = k3_cost(w, e, k, bwd)
        nb, et, resident = k3.block_layout(w.C, w.n_tracks, w.lmax, w.dims, bwd)
        res[kind] = dict(timing(ms, pms, flops, prod, nbytes, k3_weight_bytes(w, e, k, bwd)),
                         edge_tile=et, weight_resident=resident, smem_bytes=nb)
        print_timing(f"K3 {kind} E={e} (edge tile {et}, last radial weight "
                     f"{'resident' if resident else 'read through the read-only cache'}, {nb} "
                     f"bytes of shared memory)", res[kind])
    return res, errs


ENV_MODES = ("paths", "mxu_highest", "mxu_bf16x3", "mxu_bf16")
K2_NAMES = ("V", "wz", "Y")
# forward (atol, rtol on max|plain|) of K2 and K5 against their plain
# versions: sum order only, except mxu_bf16, whose O elements near a bf16
# rounding boundary may round the other way (2^-8 of that element); the
# backward rounds the same dV' on both sides
ENV_FWD_TOLS = {"paths": (1e-4, 1e-4), "mxu_highest": (1e-4, 1e-4),
                "mxu_bf16x3": (1e-4, 1e-4), "mxu_bf16": (1e-4, 2e-3)}


# K2, K4 and K5's three-pass modes held tighter as well, between their
# sound reading and a one-pass product's, so that a dropped 3xTF32 or bf16x3
# correction term fails (ENV_FWD_TOLS, TOLS and the 1e-3 backward pass it):
# forward and backward (atol, rtol on max|plain|); each kernel's one-pass
# control (``k5_one_pass``, ``tf32_control``) must fail them
TIGHT_TOLS = {"fwd": (5e-7, 5e-5), "bwd": (1e-6, 1e-5)}


def env_weights(layer, cfg, mode):
    from pair_allegro_tpu_torch.ops import env_layer as k2
    from pair_allegro_tpu_torch.ops import env_layer_mxu as k5

    if mode == "paths":
        return k2.k2_weights(layer["mix"], cfg.l_max, cfg.parity)
    return k5.k5_weights(layer["mix"], cfg.l_max, cfg.parity, mode)


def env_operands(cfg, params, system, eng):
    """K2 / K5 operands (V, wz, Y) of the second layer of the system's
    neighbor table (its V is the first layer's K2 output, so it is not the
    rank-one V0 = pT Y), and K."""
    import torch

    from pair_allegro_tpu_torch.models.allegro import allegro_inputs, env_step

    nb = eng.rebuild_fn(system, None)
    k = nb.edge_index.shape[1]
    pcfg = dataclasses.replace(cfg, layer_fused=False, tp_mode="paths")
    with torch.no_grad():
        ins = allegro_inputs(params, cfg, system.positions, system.types, nb.edge_index,
                             cell=system.cell, edge_shifts=nb.edge_shifts, edge_mask=nb.edge_mask)
        V0 = ins["pT"].unsqueeze(0) * ins["Y_T"].unsqueeze(1)
        x1, V1 = env_step(params["layers"][0], pcfg, ins["xT"], V0, ins["Y_T"], ins["uT"], k)
        ns = x1.shape[0]
        wz = (params["layers"][1]["env_weight"].T @ x1) * (1.0 / math.sqrt(ns)) * ins["uT"]
    return (V1.contiguous(), wz.contiguous(), ins["Y_T"]), k


def env_call(mode):
    """(wrapper, plain forward, plain backward) of K2 (``paths``) or K5."""
    import torch

    from pair_allegro_tpu_torch.ops import env_layer as k2
    from pair_allegro_tpu_torch.ops import env_layer_mxu as k5

    if mode != "paths":
        return k5.env_layer_mxu, k5.env_layer_mxu_reference, k5.env_layer_mxu_reference_bwd

    def k2_bwd(V, wz, Y, w, k, inv_avg, dout, dinv):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (V, wz, Y)]
            return torch.autograd.grad(k2.env_layer_reference(*ins, w, k, inv_avg), ins, (dout, dinv))

    return k2.env_layer, k2.env_layer_reference, k2_bwd


def k5_one_pass(mode, ops, w, k, inv_avg, cots):
    """K5's plain version with one product pass in place of the mode's
    three, forward outputs and backward cotangents: cuBLAS in TF32 (one
    pass on the tensor cores) for mxu_highest, the bf16 hi parts alone
    (mxu_bf16's product) for mxu_bf16x3.  A control: the kernel with a
    correction term dropped would compute this."""
    import torch

    from pair_allegro_tpu_torch.ops import env_layer_mxu as k5

    if mode == "mxu_bf16x3":
        w = dataclasses.replace(w, mode="mxu_bf16", Mk_lo=None, Mt_lo=None)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "mxu_highest"
    try:
        with torch.no_grad():
            out = k5.env_layer_mxu_reference(*ops, w, k, inv_avg)
            return out, k5.env_layer_mxu_reference_bwd(*ops, w, k, inv_avg, *cots)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def tf32_control(fn):
    """fn() with cuBLAS in TF32 (one pass on the tensor cores): K2's and
    K4's plain versions so computed are the controls of their tight gate
    (the kernel with a 3xTF32 correction term dropped would compute this)."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def tight_check(kernel, label, names, got, ref, ctl):
    """The added gate of phases 3, 8, 9 and 10: the kernel's (forward
    outputs, backward cotangents) within ``TIGHT_TOLS`` of the plain
    version's, and the one-pass control's (``ctl``) outside it in some
    output each way, or the gate could not tell three passes from one."""
    for kind, nm, i in (("fwd", names[0], 0), ("bwd", names[1], 1)):
        tols = TIGHT_TOLS[kind]
        check(kernel, f"{label} (tight)", kind, nm, got[i], ref[i], tols)
        atol, rtol = tols
        ctl_errs = [(max_err(a, b), atol + rtol * float(b.abs().max())) for a, b in zip(ctl[i], ref[i])]
        print(f"{kernel} control {label} {kind}: one-pass product against the plain version "
              + ", ".join(f"{n} {e:.3e} (tolerance {t:.3e})" for n, (e, t) in zip(nm, ctl_errs)))
        if all(e <= t for e, t in ctl_errs):
            raise RuntimeError(f"{kernel} {kind} {label}: the tight gate passes a one-pass product")


def env_compare(label, mode, ops, w, k, avg, gen):
    """K2 / K5 against the plain version on ``ops``, forward and backward (a
    random cotangent); K2 and K5's three-pass modes also under
    ``tight_check``; returns the max abs errors."""
    import torch

    fn, ref, ref_bwd = env_call(mode)
    kernel = "K2" if mode == "paths" else f"K5 {mode}"
    inv_avg = 1.0 / math.sqrt(avg)
    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k = fn(*ins, w, k, avg)
    with torch.no_grad():
        out_r = ref(*ops, w, k, inv_avg)
    cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in out_r]
    g_k = torch.autograd.grad(out_k, ins, cots)
    g_r = ref_bwd(*ops, w, k, inv_avg, *cots)
    torch.cuda.synchronize()
    errs = {"fwd": check(kernel, label, "fwd", ("V'", "inv"), out_k, out_r, ENV_FWD_TOLS[mode]),
            "bwd": check(kernel, label, "bwd", K2_NAMES, g_k, g_r)}
    names = (("V'", "inv"), K2_NAMES)
    if mode in ("mxu_highest", "mxu_bf16x3"):
        tight_check(kernel, label, names, (out_k, g_k), (out_r, g_r),
                    k5_one_pass(mode, ops, w, k, inv_avg, cots))
    elif mode == "paths":
        def plain():
            with torch.no_grad():
                out = ref(*ops, w, k, inv_avg)
            return out, ref_bwd(*ops, w, k, inv_avg, *cots)

        tight_check(kernel, label, names, (out_k, g_k), (out_r, g_r), tf32_control(plain))
    del ins, out_k, out_r, g_k, g_r, cots
    torch.cuda.empty_cache()
    return errs


def env_parity():
    """Phase 3 (K2, K5): kernel against plain version on the 500-atom table
    at flagship widths, l_max 2 and 1 with parity; K5 in each mode."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine

    errs = {m: {"fwd": 0.0, "bwd": 0.0} for m in ENV_MODES}
    for lmax in (2, 1):
        cfg, params, system = make_case(5, None, l_max=lmax)
        ops, k = env_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        for mode in ENV_MODES:
            gen = torch.Generator(device=system.device).manual_seed(SEED)
            w = env_weights(params["layers"][1], cfg, mode)
            e = env_compare(f"l_max={lmax} C={cfg.num_tensor_features} 500 atoms K={k}", mode, ops, w,
                            k, cfg.avg_num_neighbors, gen)
            errs[mode] = {kind: max(errs[mode][kind], e[kind]) for kind in e}
    return errs


def perlayer_model_parity():
    """Phase 4 (per-layer tier): forces and charges, kernel path (card) vs
    plain path (CPU) for tp_mode paths, mxu_highest and mxu_bf16x3 (gate
    5e-4); mxu_bf16 against the exact path, printed."""
    from pair_allegro_tpu_torch.engine import AllegroEngine

    def run(dev, mode):
        cfg, params, system = make_case(5, dev, output_charges=True, layer_fused=False,
                                        tp_mode=mode)
        eng = AllegroEngine(cfg, params, system, device=dev)
        o = eng.force_fn(system, eng.rebuild_fn(system, None))
        return o.forces.cpu(), o.extras["charges"].cpu(), float(o.total_energy)

    exact = run("cpu", "paths")
    for mode in ENV_MODES:
        f_k, q_k, e_k = run("cuda", mode)
        if mode == "mxu_bf16":
            f_p, q_p, e_p = exact
            print(f"per-layer model, tp_mode {mode} (card) against the exact path (CPU, paths), "
                  f"500 atoms: max|dF| {max_err(f_k, f_p):.3e} eV/A, max|dq| {max_err(q_k, q_p):.3e}, "
                  f"E {e_k:.6f} vs {e_p:.6f} eV (not gated)")
            continue
        f_p, q_p, e_p = exact if mode == "paths" else run("cpu", mode)
        df, dq = max_err(f_k, f_p), max_err(q_k, q_p)
        print(f"per-layer model parity, tp_mode {mode} (500 atoms, charges): max|dF| {df:.3e} eV/A, "
              f"max|dq| {dq:.3e}, E {e_k:.6f} vs {e_p:.6f} eV (gate 5e-4)")
        if not (df < 5e-4 and dq < 5e-4):
            raise RuntimeError(f"per-layer model parity gate failed ({mode})")


def k2_cost(w, e, bwd):
    """(flops, bytes) one K2 call needs at E edge slots, counted from the
    function: the env sum (recomputed in the backward), 2 operations per
    channel and 3j entry (4 in the backward: dV and denv), the per-l3 mix
    (its transpose in the backward), and the backward's dwz and dY; each
    input read once, each output written once (f32), weights included."""
    from pair_allegro_tpu_torch.ops.fused_layer import _row_tables
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    rows = _row_tables(w.lmax, w.parity)
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    d, c, cout = len(rows), w.c, w.cout
    n_tp = sum(len(ents) for ents, _ in rows)
    mix = sum(2 * cout * P[l3] * c for _, l3 in rows)
    env = 2 * d * c
    per = env + mix + (4 * c * n_tp + 4 * d * c if bwd else 2 * c * n_tp)
    ins = d * c + c + d + (d * cout + c * P[0] if bwd else 0)
    outs = d * c + c + d if bwd else d * cout + c * P[0]
    n_w = sum(t.numel() for t in w.leaves)
    return per * e, 4 * ((ins + outs) * e + n_w)


def mix_products(w):
    """Of K2's and K4's operations per edge slot, those of the per-l3 mix
    (its transpose in the backward, as many), which they run on the tensor
    cores."""
    from pair_allegro_tpu_torch.ops.fused_layer import _row_tables
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    return sum(2 * w.cout * P[l3] * w.c for _, l3 in _row_tables(w.lmax, w.parity))


def mix_weight_bytes(w, bwd, tiles, ring):
    """Bytes of mix weights one K2 or K4 call stages from L2 (into its ring
    of ``ring`` words, or without one as the A fragments' loads, once per
    row), computed from the kernels' staging, not measured: per tile and
    output row the row's l3 block of the mix (mixT in the backward), unless
    the previous row left it in the ring (``mix_resident``)."""
    from pair_allegro_tpu_torch.ops.fused_layer import _row_tables, ring_holds
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    words, prev = 0, None
    for _, l3 in _row_tables(w.lmax, w.parity):
        kd = P[l3] * w.c
        if not (l3 == prev and ring_holds(*((w.cout, kd) if bwd else (kd, w.cout)), ring)):
            words += kd * w.cout
        prev = l3
    return 4 * words * tiles


def k5_cost(w, e, bwd):
    """(product flops, other flops, bytes) one K5 call needs at E edge
    slots: the dense product with the combined matrix (2 * D*D*C * D*Cout
    per edge, three passes in mxu_bf16x3), and the rest on f32: env, O (or
    in the backward dO's reductions into dV and denv), the invariants, dwz
    and dY; each input read once, each output written once, the mode's
    matrices included."""
    d, c, cout = (w.lmax + 1) ** 2, w.c, w.cout
    ddc = d * d * c
    p0 = max(p for p, *_ in w.inv_entries) + 1
    gemm = 2 * ddc * d * cout * (3 if w.mode == "mxu_bf16x3" else 1)
    env = 2 * d * c
    rest = env + (4 * ddc + 2 * c * len(w.inv_entries) + 4 * d * c if bwd
                  else ddc + 2 * c * len(w.inv_entries))
    ins = d * c + c + d + (d * cout + c * p0 if bwd else 0)
    outs = d * c + c + d if bwd else d * cout + c * p0
    n_m = w.Mk.numel() * (2 if w.Mk_lo is not None else 1)
    return gemm * e, rest * e, 4 * ((ins + outs) * e + n_m)


def k5_library(w, e, bwd, gen):
    """One PyTorch call (cuBLAS) of K5's bare product at the mode's
    precision on random operands of the call's shapes (O or dV' given, not
    built; no invariants), writing f32 as K5 does: f32 (allow_tf32 off) for
    mxu_highest; bf16 operands summed and written in f32 (``out_dtype``)
    for mxu_bf16, and for mxu_bf16x3 the three products as one of thrice
    the depth, [hi | hi | lo] x [hi; lo; hi]; its time in ms.  Timed as a
    yardstick only: the port never calls it."""
    import torch

    a = w.Mk if bwd else w.Mt
    b = torch.randn((a.shape[1], e), generator=gen, device=a.device)
    if w.mode == "mxu_highest":
        fn = lambda: a @ b  # noqa: E731
    else:
        ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if w.mode == "mxu_bf16x3":
            al = (w.Mk_lo if bwd else w.Mt_lo).to(torch.bfloat16)
            bl = (b - bh.float()).to(torch.bfloat16)
            ah, bh = torch.cat([ah, ah, al], 1), torch.cat([bh, bl, bh], 0)
            del al, bl
        del b
        fn = lambda: torch.mm(ah, bh, out_dtype=torch.float32)  # noqa: E731
    ms = cuda_ms(fn, 3)
    del fn
    torch.cuda.empty_cache()
    return ms


def env_timings(cfg, params, system, eng, errs):
    """Phase 8: per-call fwd/bwd time of K2 and of K5 in each mode, of
    their plain versions and the bound at the per-layer main path's shapes;
    K5's library time (``k5_library``); parity at those shapes (into
    ``errs``).  K2's bounds: ``bounds`` with its mix on the tensor cores
    (``bound_ms``) and on the CUDA cores (``bound_ms_f32``), beside the mix
    weights it stages (``mix_weight_bytes``).  K5's bound: its products on
    the tensor cores (3xTF32 at a third of the TF32 rate for mxu_highest,
    bf16 at the bf16 rate, three passes in mxu_bf16x3) and the rest at the
    f32 rate, the larger of the two, never below the bytes' time."""
    import torch

    from pair_allegro_tpu_torch.ops import env_layer as k2

    ops, k = env_operands(cfg, params, system, eng)
    e = ops[0].shape[-1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    print(f"phase 8 timings on {torch.cuda.get_device_name(0)}, cuBLAS TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    res = {}
    for mode in ENV_MODES:
        w = env_weights(params["layers"][1], cfg, mode)
        fn, ref, ref_bwd = env_call(mode)
        mod = kernel_modules()["K2" if mode == "paths" else "K5"]
        out, inv = mod._kernel_fwd(*ops, w, k, inv_avg)
        dout = torch.randn(out.shape, generator=gen, device=system.device)
        dinv = torch.randn(inv.shape, generator=gen, device=system.device)
        del out, inv
        k_f = cuda_ms(lambda: mod._kernel_fwd(*ops, w, k, inv_avg), 5)
        k_b = cuda_ms(lambda: mod._kernel_bwd(*ops, w, k, inv_avg, dout, dinv), 5)
        with torch.no_grad():
            p_f = cuda_ms(lambda: ref(*ops, w, k, inv_avg), 1)
        p_b = cuda_ms(lambda: ref_bwd(*ops, w, k, inv_avg, dout, dinv), 1)
        torch.cuda.empty_cache()
        e2 = env_compare(f"main path E={e}", mode, ops, w, k, cfg.avg_num_neighbors, gen)
        errs[mode] = {kind: max(errs[mode][kind], e2[kind]) for kind in e2}
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            bwd = kind == "bwd"
            if mode == "paths":
                flops, nbytes = k2_cost(w, e, bwd)
                _, lds, ring = k2.block_layout(w.c, w.cout, ops[0].shape[0], w.lmax, w.parity, bwd)
                r = res[(mode, kind)] = dict(
                    timing(ms, pms, flops, mix_products(w) * e, nbytes,
                           mix_weight_bytes(w, bwd, n_tiles(e, k), ring)),
                    library_ms=None, tile_stride=lds, ring_words=ring)
                print_timing(f"K2 {kind} E={e} (tile stride {lds}, ring {ring} words)", r)
                continue
            gemm, rest, nbytes = k5_cost(w, e, bwd)
            flops = gemm + rest
            peak = PEAK_TF32_FLOPS / 3 if mode == "mxu_highest" else PEAK_BF16_FLOPS
            t_ops = max(gemm / peak, rest / PEAK_F32_FLOPS) * 1e3
            lib = k5_library(w, e, bwd, gen)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            r = res[(mode, kind)] = dict(ms=ms, plain_ms=pms, bound_ms=max(t_ops, t_bytes),
                                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                                         library_ms=lib, gflop=flops / 1e9, mbytes=nbytes / 1e6)
            print(f"K5 {mode} {kind} E={e}: kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{r['gflop']:.2f} GFLOP, {r['mbytes']:.1f} MB), library {lib:.4f} ms, "
                  f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
        del dout, dinv
        torch.cuda.empty_cache()
    return res


K4_NAMES = ("V", "env")


def k4_operands(cfg, params, system, eng):
    """K4 operands (V, env) of the second layer on the system's FLAT edge
    list (its V is the first layer's K4 output, so it is not the rank-one
    V0 = pT Y), and the second layer's K4 weights."""
    import torch

    from pair_allegro_tpu_torch.models.allegro import flat_inputs, k4_env, k4_step
    from pair_allegro_tpu_torch.ops.tp_mix_fused import k4_weights

    nb = eng.rebuild_fn(system, None)
    with torch.no_grad():
        ins = flat_inputs(params, cfg, system.positions, system.types, nb.edge_index,
                          cell=system.cell, edge_shifts=nb.edge_shifts, edge_mask=nb.edge_mask)
        rest = (ins["Y"], ins["u"], ins["agg"], ins["spread"])
        x1, V1 = k4_step(params["layers"][0], cfg, ins["x"], ins["Vt"], *rest)
        env = k4_env(params["layers"][1], cfg, x1, *rest)
    return (V1.contiguous(), env), k4_weights(params["layers"][1]["mix"], cfg.l_max, cfg.parity)


def k4_cost(w, e, bwd):
    """(flops, bytes) one K4 call needs at E edges, counted from the
    function: 2 operations per channel and 3j entry (4 in the backward: dV
    and denv), the per-l3 mix (its transpose in the backward) and the
    backward's dinv; each input read once, each output written once (f32),
    weights included."""
    from pair_allegro_tpu_torch.ops.fused_layer import _row_tables
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    rows = _row_tables(w.lmax, w.parity)
    P = num_paths_per_l(w.lmax, w.lmax, w.lmax, w.parity)
    d, c, cout = len(rows), w.c, w.cout
    n_tp = sum(len(ents) for ents, _ in rows)
    mix = sum(2 * cout * P[l3] * c for _, l3 in rows)
    io = 2 * d * c + d * cout + c * P[0]
    per = mix + (4 * c * n_tp + c * P[0] if bwd else 2 * c * n_tp)
    if bwd:
        io += 2 * d * c
    n_w = sum(t.numel() for t in w.leaves)
    return per * e, 4 * (io * e + n_w)


def k4_plain(ops, w, cots):
    """K4's plain version: (forward outputs, backward cotangents of ``cots``)."""
    import torch

    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    with torch.no_grad():
        out = k4.tp_mix_fused_reference(*ops, w)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in ops]
        return out, torch.autograd.grad(k4.tp_mix_fused_reference(*ins, w), ins, cots)


def k4_compare(label, ops, w, gen, zero_dout=False):
    """K4 against its plain version on ``ops``, forward and backward (a
    random cotangent; ``zero_dout``: V' is dead, as in the last layer, and
    only inv's cotangent is random), with a random cotangent also under
    ``tight_check``; returns the max abs errors."""
    import torch

    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k = k4.tp_mix_fused_t(*ins, w)
    shapes = [o.shape for o in out_k]
    cots = [torch.randn(sh, generator=gen, device=ops[0].device) for sh in shapes]
    if zero_dout:
        cots[0] = torch.zeros_like(cots[0])
    g_k = torch.autograd.grad(out_k, ins, cots)
    out_r, g_r = k4_plain(ops, w, cots)
    torch.cuda.synchronize()
    errs = {"fwd": check("K4", label, "fwd", ("V'", "inv"), out_k, out_r),
            "bwd": check("K4", label, "bwd", K4_NAMES, g_k, g_r)}
    if not zero_dout:
        tight_check("K4", label, (("V'", "inv"), K4_NAMES), (out_k, g_k), (out_r, g_r),
                    tf32_control(lambda: k4_plain(ops, w, cots)))
    del ins, out_k, out_r, g_k, g_r, cots
    torch.cuda.empty_cache()
    return errs


def k4_parity():
    """Phase 9 (K4): kernel against plain version on the second layer's
    operands of a 256-atom dense build at flagship widths (l_max 2 with
    parity, C = Cout = 32) and at l_max 1: all edge slots, a tail that is
    no multiple of any edge tile, and (l_max 2) a zero dV'."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    errs = {"fwd": 0.0, "bwd": 0.0}
    for lmax in (2, 1):
        cfg, params, system = make_case(4, None, l_max=lmax)
        eng = AllegroEngine(cfg, params, system)
        if eng.spec.strategy != "dense":
            raise RuntimeError(f"256 atoms took the {eng.spec.strategy} strategy, not dense")
        (V, env), w = k4_operands(cfg, params, system, eng)
        e = V.shape[-1]
        cut = e - 13 if (e - 13) % 8 else e - 14
        print(f"K4 at l_max={lmax}: E={e}, edge tile fwd {k4.kernel_tile(w, V, False)} "
              f"bwd {k4.kernel_tile(w, V, True)}")
        gen = torch.Generator(device=system.device).manual_seed(SEED)
        label = f"l_max={lmax} C={w.c} Cout={w.cout} 256 atoms dense"
        cases = [(f"{label} E={e}", (V, env), False),
                 (f"{label} tail E={cut}", (V[..., :cut].contiguous(), env[..., :cut].contiguous()),
                  False)]
        if lmax == 2:
            cases.append((f"{label} zero dV'", (V, env), True))
        for name, ops, zero in cases:
            got = k4_compare(name, ops, w, gen, zero_dout=zero)
            errs = {kind: max(errs[kind], got[kind]) for kind in errs}
    return errs


def flat_model_parity():
    """Phase 9 (models on the FLAT layout): forces and charges, the card
    against the CPU, for Allegro with charges (two species, typed cutoffs)
    on the 256-atom box and on a 500-atom slab, and NequIP with one and two
    species on the 256 atoms; K4 carries the Allegro runs on the card, and
    NequIP launches no K3 (the reference gates K3 to the TABLE layout)."""
    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine

    mods = kernel_modules()

    def run(make, engine, dev):
        cfg, params, system = make(dev)
        eng = engine(cfg, params, system, device=dev)
        if eng.spec.strategy != "dense":
            raise RuntimeError(f"took the {eng.spec.strategy} strategy, not dense")
        for m in mods.values():
            m.launches.reset()
        o = eng.force_fn(system, eng.rebuild_fn(system, None))
        launched = {name: (m.launches.fwd, m.launches.bwd) for name, m in mods.items()}
        return o, launched, cfg

    cases = [
        ("Allegro, 256 atoms, 2 species, charges", AllegroEngine,
         lambda dev: make_case(4, dev, output_charges=True, species=2)),
        ("Allegro, 500-atom slab, 2 species, charges", AllegroEngine,
         lambda dev: make_case(5, dev, output_charges=True, species=2, slab=True)),
        ("NequIP, 256 atoms, 1 species", NequIPEngine, lambda dev: make_nequip_case(4, dev)),
        ("NequIP, 256 atoms, 2 species", NequIPEngine,
         lambda dev: make_nequip_case(4, dev, species=2)),
    ]
    for label, engine, make in cases:
        o_k, launched, cfg = run(make, engine, "cuda")
        o_p, _, _ = run(make, engine, "cpu")
        df = max_err(o_k.forces.cpu(), o_p.forces)
        dq = 0.0
        if "charges" in o_p.extras:
            dq = max_err(o_k.extras["charges"].cpu(), o_p.extras["charges"])
        want = {name: (0, 0) for name in mods}
        if engine is AllegroEngine:
            want["K4"] = (cfg.num_layers, cfg.num_layers)
        print(f"FLAT model parity ({label}): max|dF| {df:.3e} eV/A (max|F| "
              f"{float(o_p.forces.abs().max()):.3f}), max|dq| {dq:.3e}, E "
              f"{float(o_k.total_energy):.6f} vs {float(o_p.total_energy):.6f} eV (gate 5e-4); "
              f"launches on the card {launched}")
        if not (df < 5e-4 and dq < 5e-4):
            raise RuntimeError(f"FLAT model parity gate failed ({label})")
        if launched != want:
            raise RuntimeError(f"FLAT model ({label}) launched {launched}, want {want}")


def k4_timings(cfg, params, system, eng, errs):
    """Phase 10 (K4): fwd/bwd time of kernel and plain version at the FLAT
    main path's shapes (the second layer's operands), with ``bounds`` (the
    mix on the tensor cores, and on the CUDA cores) and the mix weights it
    stages (``mix_weight_bytes``), and parity at those shapes (into
    ``errs``)."""
    import torch

    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    (V, env), w = k4_operands(cfg, params, system, eng)
    e, d = V.shape[-1], V.shape[0]
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    out, inv = k4._kernel_fwd(V, env, w)
    dout = torch.randn(out.shape, generator=gen, device=system.device)
    dinv = torch.randn(inv.shape, generator=gen, device=system.device)
    del out, inv
    k_f = cuda_ms(lambda: k4._kernel_fwd(V, env, w), 10)
    k_b = cuda_ms(lambda: k4._kernel_bwd(V, env, w, dout, dinv), 10)
    with torch.no_grad():
        p_f = cuda_ms(lambda: k4.tp_mix_fused_reference(V, env, w), 2)
    ins = [t.detach().clone().requires_grad_(True) for t in (V, env)]
    outs = k4.tp_mix_fused_reference(*ins, w)
    p_b = cuda_ms(lambda: torch.autograd.grad(outs, ins, (dout, dinv), retain_graph=True), 2)
    del ins, outs, dout, dinv
    torch.cuda.empty_cache()
    e2 = k4_compare(f"l_max={w.lmax} C={w.c} FLAT main path E={e}", (V, env), w, gen)
    errs = {kind: max(errs[kind], e2[kind]) for kind in errs}
    res = {}
    for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
        bwd = kind == "bwd"
        flops, nbytes = k4_cost(w, e, bwd)
        nb, tile, ring = k4.block_layout(w.c, w.cout, d, w.lmax, w.parity, bwd)
        if tile != k4.kernel_tile(w, V, bwd):
            raise RuntimeError("K4's block_layout disagrees with its launcher's tile")
        r = res[kind] = dict(timing(ms, pms, flops, mix_products(w) * e, nbytes,
                                    mix_weight_bytes(w, bwd, -(-e // tile), ring)),
                             tile=tile, ring_words=ring, smem_bytes=nb)
        print_timing(f"K4 {kind} E={e} (edge tile {tile}, {nb} B of shared memory, ring {ring} "
                     f"words)", r)
    return res, errs


K6_NAMES = ("in", "Y", "u")


def er_operands(cfg, params, system, eng):
    """K6's operands (in_T, Y, u) of the system's neighbor table, K7's (x,
    V) of the last layer (made by K6 and K1's middle layers), and K."""
    import torch

    from pair_allegro_tpu_torch.models.allegro import embed_inputs
    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops.fused_layer import fused_layer, k1_weights

    nb = eng.rebuild_fn(system, None)
    k = nb.edge_index.shape[1]
    avg = cfg.avg_num_neighbors
    with torch.no_grad():
        ins = embed_inputs(cfg, system.positions, system.types, nb.edge_index, cell=system.cell,
                           edge_shifts=nb.edge_shifts, edge_mask=nb.edge_mask)
        ops6 = (ins["in_T"], ins["Y_T"], ins["uT"])
        x, V = k6.embed_layer(*ops6, k6.k6_weights(params, cfg.l_max, cfg.parity), k, avg)
        for layer in params["layers"][1:-1]:
            x, V = fused_layer(x, V, ins["Y_T"], ins["uT"], k1_weights(layer, cfg.l_max, cfg.parity),
                               k, avg)
    return ops6, (x, V, ins["Y_T"], ins["uT"]), k


def er_calls(cfg, params, k):
    """K6's and K7's weights and (wrapper, plain version) as functions of
    their operands."""
    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    avg, inv_avg = cfg.avg_num_neighbors, 1.0 / math.sqrt(cfg.avg_num_neighbors)
    w6 = k6.k6_weights(params, cfg.l_max, cfg.parity)
    w7 = k7.k7_weights(params, cfg.l_max, cfg.parity, cfg.output_charges)
    return w6, w7, {
        "K6": (lambda *a: k6.embed_layer(*a, w6, k, avg),
               lambda *a: k6.embed_layer_reference(*a, w6, k, inv_avg)),
        "K7": (lambda *a: k7.readout_layer(*a, w7, k, avg),
               lambda *a: k7.readout_layer_reference(*a, w7, k, inv_avg)),
    }


def _tup(o):
    return o if isinstance(o, tuple) else (o,)


def pair_compare(kernel, label, calls, ops, names, gen, outs=None):
    """A kernel's wrapper against its plain version on ``ops``, forward and
    backward (random cotangents); ``outs`` names the outputs (by default
    K6's or K7's); returns the max abs errors."""
    import torch

    fn, ref = calls
    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k, out_r = _tup(fn(*ins)), _tup(ref(*ins))
    cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in out_r]
    g_k = torch.autograd.grad(out_k, ins, cots)
    g_r = torch.autograd.grad(out_r, ins, cots)
    torch.cuda.synchronize()
    outs = outs or (("x'", "V'") if kernel == "K6" else ("e", "q")[:len(out_r)])
    errs = {"fwd": check(kernel, label, "fwd", outs, out_k, out_r),
            "bwd": check(kernel, label, "bwd", names, g_k, g_r)}
    del ins, out_k, out_r, cots, g_k, g_r
    torch.cuda.empty_cache()
    return errs


def er_parity():
    """Phase 11 (K6, K7): kernel against plain version on the 500-atom
    table at flagship widths, fwd and bwd; K7 with the charge head (two
    heads) and without it."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine

    errs = {name: {"fwd": 0.0, "bwd": 0.0} for name in ("K6", "K7")}
    for charges in (True, False):
        cfg, params, system = make_case(5, None, output_charges=charges)
        ops6, ops7, k = er_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        _, _, calls = er_calls(cfg, params, k)
        gen = torch.Generator(device=system.device).manual_seed(SEED)
        label = f"500 atoms K={k}" + (", charge head" if charges else "")
        got = {"K7": pair_compare("K7", label, calls["K7"], ops7, K1_NAMES, gen)}
        if charges:
            got["K6"] = pair_compare("K6", label, calls["K6"], ops6, K6_NAMES, gen)
        for name, e in got.items():
            errs[name] = {kind: max(errs[name][kind], e[kind]) for kind in e}
    return errs


def er_timings(cfg, params, system, eng, errs):
    """Phase 12 (K6, K7): fwd/bwd time of kernel and plain version at the
    embed main path's shapes, with the bound, and parity at those shapes
    (into ``errs``)."""
    import torch

    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    ops6, ops7, k = er_operands(cfg, params, system, eng)
    e = ops6[0].shape[1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    w6, w7, calls = er_calls(cfg, params, k)
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    res = {}
    for name, mod, ref, w, ops, cost, prods, wbytes, names in (
            ("K6", k6, k6.embed_layer_reference, w6, ops6, k6_cost, k6_products, k6_weight_bytes,
             K6_NAMES),
            ("K7", k7, k7.readout_layer_reference, w7, ops7, k7_cost, k7_products, k7_weight_bytes,
             K1_NAMES)):
        cots = [torch.randn(o.shape, generator=gen, device=system.device)
                for o in _tup(mod._kernel_fwd(*ops, w, k, inv_avg))]
        bwd_args = tuple(cots) if name == "K6" else (cots,)
        k_f = cuda_ms(lambda: mod._kernel_fwd(*ops, w, k, inv_avg), 5)
        k_b = cuda_ms(lambda: mod._kernel_bwd(*ops, w, k, inv_avg, *bwd_args), 5)
        with torch.no_grad():
            p_f = cuda_ms(lambda: ref(*ops, w, k, inv_avg), 2)
        ins = [t.detach().clone().requires_grad_(True) for t in ops]
        outs = _tup(ref(*ins, w, k, inv_avg))
        p_b = cuda_ms(lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True), 2)
        del ins, outs, cots, bwd_args
        torch.cuda.empty_cache()
        e2 = pair_compare(name, f"embed main path E={e}", calls[name], ops, names, gen)
        errs[name] = {kind: max(errs[name][kind], e2[kind]) for kind in e2}
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            bwd = kind == "bwd"
            flops, nbytes = cost(w, e, bwd)
            r = res[(name, kind)] = timing(ms, pms, flops, prods(w, bwd) * e, nbytes,
                                           wbytes(w, bwd, n_tiles(e, k)))
            print_timing(f"{name} {kind} E={e}", r)
    return res, errs


K8_NAMES = ("x0", "pT", "Y", "u")


def stack_operands(cfg, params, system, eng):
    """K8's operands (x0, pT, Y, u) of the system's neighbor table, and K."""
    import torch

    from pair_allegro_tpu_torch.models.allegro import allegro_inputs

    nb = eng.rebuild_fn(system, None)
    with torch.no_grad():
        ins = allegro_inputs(params, cfg, system.positions, system.types, nb.edge_index,
                             cell=system.cell, edge_shifts=nb.edge_shifts, edge_mask=nb.edge_mask)
    return (ins["xT"], ins["pT"], ins["Y_T"], ins["uT"]), nb.edge_index.shape[1]


def stack_calls(cfg, params, k):
    """K8's (wrapper, plain version) as functions of its operands."""
    from pair_allegro_tpu_torch.ops import fused_stack as k8

    args = (params["layers"], k, cfg.l_max, cfg.avg_num_neighbors, cfg.parity)
    return (lambda *o: k8.fused_stack(*o, *args), lambda *o: k8.allegro_stack_reference(*o, *args))


def k8_cost(w, e, bwd):
    """(flops, bytes) one K8 call needs at E edge slots: per layer K1's
    terms for that layer's form (``k1_terms``: the first builds V0, the
    last has no mix), with the forward's per-layer values taken as known to
    the backward (the kernel's recompute of layers 0 .. L-2 is not
    counted); the stack's own rows read and written once: x0, pT, Y, u
    (and dx_final) in, x_final (or dx0, dpT, dY, du) out (f32, weights
    included)."""
    n_l = len(w.k1)
    per = sum(k1_terms(lw, (li == 0, li == n_l - 1), bwd)[0] for li, lw in enumerate(w.k1))
    ns, c = w.k1[0].dims[:2]
    d = (w.lmax + 1) ** 2
    rows_in = ns + c + d + 1 + (ns if bwd else 0)
    rows_out = ns + c + d + 1 if bwd else ns
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, 4 * ((rows_in + rows_out) * e + n_w)


def stack_parity():
    """Phase 13 (K8): kernel against plain version on the 500-atom table,
    fwd and bwd, at flagship widths with 3 layers, at l_max 1 with parity,
    and with 1 and 2 layers; then the NaN weight cotangents."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.ops import fused_stack as k8
    from pair_allegro_tpu_torch.ops.fused_layer import layer_leaves

    errs = {"fwd": 0.0, "bwd": 0.0}
    for tier in (dict(), dict(l_max=1), dict(num_layers=1), dict(num_layers=2)):
        cfg, params, system = make_case(5, None, fused_stack=True, **tier)
        ops, k = stack_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        gen = torch.Generator(device=system.device).manual_seed(SEED)
        label = f"l_max={cfg.l_max} {cfg.num_layers} layers 500 atoms K={k}"
        e = pair_compare("K8", label, stack_calls(cfg, params, k), ops, K8_NAMES, gen, outs=("x",))
        errs = {kind: max(errs[kind], e[kind]) for kind in errs}
    leaves = [t.requires_grad_(True) for layer in params["layers"]
              for t in layer_leaves(layer, cfg.l_max)]
    grads = torch.autograd.grad(stack_calls(cfg, params, k)[0](*ops).sum(), leaves)
    nan = all(bool(torch.isnan(g).all()) for g in grads)
    print(f"K8 weight cotangents: {len(grads)} leaves, all NaN {nan}")
    if not nan:
        raise RuntimeError("K8's weight cotangents are not NaN-filled")
    return errs


def f64_parity():
    """Phase 13 (the dtype route): an f64 system on the card runs the plain
    path on the K1, per-layer, stack and NequIP paths, with no kernel
    launch, and gives the CPU f64 path's forces and energy to 1e-9
    relative (the 500-atom table, flagship widths, NequIP's config of
    record)."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine
    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy, allegro_params_from_numpy
    from pair_allegro_tpu_torch.models.nequip import nequip_init_numpy, nequip_params_from_numpy

    mods = kernel_modules()
    for label, tier in (("K1 tier", {}), ("per-layer tier", dict(layer_fused=False)),
                        ("stack tier", dict(fused_stack=True)), ("NequIP", None)):
        outs = []
        for dev in ("cuda", "cpu"):
            system = fcc_system(5, dev, dtype=torch.float64)
            if tier is None:
                cfg = nequip_cfg()
                params = nequip_params_from_numpy(nequip_init_numpy(cfg, SEED), cfg, device=dev,
                                                  dtype=torch.float64)
                eng = NequIPEngine(cfg, params, system, device=dev)
            else:
                cfg = flagship_cfg(**tier)
                params = allegro_params_from_numpy(allegro_init_numpy(cfg, SEED), cfg, device=dev,
                                                   dtype=torch.float64)
                eng = AllegroEngine(cfg, params, system, device=dev)
            nb = eng.rebuild_fn(system, None)
            for m in mods.values():
                m.launches.reset()
            o = eng.force_fn(system, nb)
            launched = sum(m.launches.fwd + m.launches.bwd for m in mods.values())
            outs.append((o.forces.cpu(), float(o.total_energy), launched, o.forces.dtype))
        (f_k, e_k, n_k, dt), (f_p, e_p, _, _) = outs
        df = float((f_k - f_p).abs().max())  # in f64, not max_err's f32
        rel, rel_e = df / float(f_p.abs().max()), abs(e_k - e_p) / abs(e_p)
        print(f"f64 on the card, {label} (500 atoms): max|dF| {df:.3e} eV/A (relative {rel:.3e}), "
              f"E {e_k:.12f} vs {e_p:.12f} eV (relative {rel_e:.3e}), forces {dt}, kernel "
              f"launches {n_k} (gate 1e-9 relative, 0 launches)")
        if not (rel <= 1e-9 and rel_e <= 1e-9 and n_k == 0 and dt == torch.float64):
            raise RuntimeError(f"f64 on the card, {label}, does not match the CPU f64 path")


def accuracy_system(device, dtype, slab=False):
    """benchmarks/accuracy.py:_setup's fixture: 500 FCC Cu atoms (N_REP = 5
    cells a side, a0 = 3.61 A) with __graft_entry__._fcc_cu's 0.05 A jitter
    (RandomState(0)) and _setup's own 0.05 A (RandomState(7)), one species;
    with ``slab`` the same atoms under SLAB_VACUUM with pbc (T, T, F)."""
    import numpy as np

    from pair_allegro_tpu_torch.system import System

    a0, n_rep = 3.61, 5
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a0
    pos = np.concatenate([base + np.array([i, j, k]) * a0 for i in range(n_rep)
                          for j in range(n_rep) for k in range(n_rep)])
    pos = pos + 0.05 * np.random.RandomState(0).randn(*pos.shape)
    pos = pos + np.random.RandomState(7).randn(*pos.shape) * 0.05
    n = pos.shape[0]
    cell = np.eye(3) * a0 * n_rep
    if slab:
        cell[2, 2] += SLAB_VACUUM
    return System.create(pos, np.zeros(n, np.int32), cell=cell, masses=np.full(n, 63.546),
                         pbc=(True, True, False) if slab else None, dtype=dtype, device=device)


# the tiers whose products run on the tensor cores: (label, model, config
# fields, environment, launches per force evaluation (fwd = bwd), gated,
# slab); the per-layer tier in mxu_bf16 rounds its operands to bf16 and is
# printed only; the FLAT slab is the fixture under pbc (T, T, F), on the
# dense build; NequIP runs benchmarks/accuracy.py:_setup_nequip's config
# of record (chip_smoke.nequip_cfg) on the same fixture
_K5 = {"K5": 3}
ACCURACY_TIERS = (("K1 tier", "allegro", {}, {}, {"K1": 3}, True, False),
                  ("k1-nopos", "allegro", {}, {"PAT_L1_POSITIONAL": "0"}, {"K1": 3}, True, False),
                  ("embed path", "allegro", {}, {"PAT_L1_EMBED": "1"},
                   {"K6": 1, "K1": 1, "K7": 1}, True, False),
                  ("stack path", "allegro", dict(fused_stack=True), {}, {"K8": 1}, True, False),
                  ("per-layer paths", "allegro", dict(layer_fused=False), {}, {"K2": 3}, True,
                   False),
                  ("per-layer mxu_highest", "allegro",
                   dict(layer_fused=False, tp_mode="mxu_highest"), {}, _K5, True, False),
                  ("per-layer mxu_bf16x3", "allegro",
                   dict(layer_fused=False, tp_mode="mxu_bf16x3"), {}, _K5, True, False),
                  ("per-layer mxu_bf16", "allegro", dict(layer_fused=False, tp_mode="mxu_bf16"),
                   {}, _K5, False, False),
                  ("FLAT slab", "allegro", {}, {}, {"K4": 3}, True, True),
                  ("NequIP (K3)", "nequip", {}, {}, {"K3": 3}, True, False))


def _accuracy_engine(model, tier, device, dtype, slab):
    """(system, engine) of a phase-15 tier on the fixture: the flagship
    Allegro config with ``tier``'s fields, or NequIP's config of record,
    weights from SEED."""
    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine
    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy, allegro_params_from_numpy
    from pair_allegro_tpu_torch.models.nequip import nequip_init_numpy, nequip_params_from_numpy

    system = accuracy_system(device, dtype, slab)
    if model == "nequip":
        cfg = nequip_cfg()
        params = nequip_params_from_numpy(nequip_init_numpy(cfg, SEED), cfg, device=device,
                                          dtype=dtype)
        return system, NequIPEngine(cfg, params, system, skin=0.4, device=device)
    cfg = flagship_cfg(**tier)
    params = allegro_params_from_numpy(allegro_init_numpy(flagship_cfg(), SEED), cfg,
                                       device=device, dtype=dtype)
    return system, AllegroEngine(cfg, params, system, skin=0.4, device=device)


def accuracy_phase():
    """Phase 15: the accurate tier's force gate on benchmarks/accuracy.py's
    fixture: each tier of ACCURACY_TIERS at f32 on the card against the
    port's plain path of the same model at f64 on the CPU (the oracle,
    which matches JAX to 1e-10 in the CPU tests); max|dF| <= 1e-4 eV/A,
    with rms|dF| and dE/atom printed; a tier marked not gated is printed
    only.  Returns {label: max|dF|}."""
    import torch

    mods = kernel_modules()
    refs = {}
    for model, slab in (("allegro", False), ("allegro", True), ("nequip", False)):
        ref_sys, ref_eng = _accuracy_engine(model, {}, "cpu", torch.float64, slab)
        ref = ref_eng.force_fn(ref_sys, ref_eng.rebuild_fn(ref_sys, None))
        refs[model, slab] = ref.forces.double(), float(ref.total_energy), ref_eng.spec.strategy
    n = ref_sys.n_atoms
    worst = {}
    for label, model, tier, env, want, gated, slab in ACCURACY_TIERS:
        f_ref, e_ref, strategy = refs[model, slab]
        with env_vars(env):
            system, eng = _accuracy_engine(model, tier, "cuda", torch.float32, slab)
            if eng.spec.strategy != strategy or (slab and strategy != "dense"):
                raise RuntimeError(f"accuracy {label}: the {eng.spec.strategy} strategy on the "
                                   f"card, {strategy} on the CPU")
            nb = eng.rebuild_fn(system, None)
            for m in mods.values():
                m.launches.reset()
            out = eng.force_fn(system, nb)
            torch.cuda.synchronize()
            launched = {name: (m.launches.fwd, m.launches.bwd) for name, m in mods.items()
                        if m.launches.fwd or m.launches.bwd}
        df = out.forces.double().cpu() - f_ref
        mx = float(df.abs().max())
        rms = float(df.norm(dim=1).pow(2).mean().sqrt())
        de = abs(float(out.total_energy) - e_ref) / n
        print(f"accuracy {label} ({n} perturbed FCC Cu atoms{', slab' if slab else ''}, f32 on "
              f"the card against the CPU "
              f"f64 plain path): max|dF| {mx:.3e} eV/A, rms|dF| {rms:.3e} eV/A, dE/atom {de:.3e} "
              f"eV, max|F| {float(f_ref.abs().max()):.3f} eV/A "
              f"({'gate max|dF| <= 1e-4 eV/A' if gated else 'not gated'}); launches {launched}")
        if gated and not mx <= 1e-4:
            raise RuntimeError(f"accuracy gate failed on the {label}")
        if launched != {name: (k, k) for name, k in want.items()}:
            raise RuntimeError(f"accuracy {label}: launched {launched}, want {want}")
        worst[label] = mx
    return worst


# phase 16: the legs of ``cli run`` (name, config over the base, steps,
# steps per chunk, the steps the rate is read over (from the chunk end at
# step start + the first, to the last), the model that runs)
CLI_BASE = dict(type_names=["Cu"], masses={"Cu": 63.546}, dt_fs=2.0, skin=0.4,
                dtype="float32")
CLI_AUX = dict(computes=[{"name": "dip", "quantity": "dipole", "style": "global", "length": 3},
                         {"name": "q", "quantity": "charges", "style": "atom", "ncols": 1}])


def _cli_legs(d):
    nvt = dict(integrator="nvt", temp_K=50.0, tdamp_ps=0.05, **CLI_AUX)
    npt = dict(temp_K=50.0, tdamp_ps=0.1, press_bar=0.0, pdamp_ps=1.0)
    return [
        ("nvt", dict(nvt, data=f"{d}/cu.xyz", model={"checkpoint": f"{d}/allegro.npz"},
                     dump={"path": f"{d}/nvt.dump", "every": 20},
                     restart={"path": f"{d}/nvt_state.npz"}), 120, 60, "allegro"),
        ("resume", dict(nvt, model={"checkpoint": f"{d}/allegro.npz"},
                        restart_from=f"{d}/nvt_state.npz",
                        dump={"path": f"{d}/resume.dump", "every": 20}), 60, 60, "allegro"),
        ("npt", dict(npt, integrator="npt", data=f"{d}/cu.xyz",
                     model={"checkpoint": f"{d}/allegro.npz"}), 40, 20, "allegro"),
        ("npt_berendsen", dict(npt, integrator="npt_berendsen", data=f"{d}/cu.xyz",
                               model={"checkpoint": f"{d}/allegro.npz"}), 40, 20, "allegro"),
        ("langevin", dict(integrator="langevin", temp_K=50.0, damp_ps=0.1, data=f"{d}/cu.xyz",
                          model={"checkpoint": f"{d}/nequip.npz"}), 120, 60, "nequip"),
        ("nve", dict(integrator="nve", temp_K=50.0, data=f"{d}/cu.xyz",
                     model={"checkpoint": f"{d}/allegro.npz"},
                     dump={"path": f"{d}/nve.dump", "every": 20},
                     restart={"path": f"{d}/nve_state.npz"}, **CLI_AUX), 120, 60, "allegro"),
    ]


def read_dump(path):
    """[(step, column names, (N, ncols) array)] of a LAMMPS dump-custom file."""
    import numpy as np

    lines = open(path).read().splitlines()
    frames, k = [], 0
    while k < len(lines):
        step, n = int(lines[k + 1]), int(lines[k + 3])
        n_box = 3
        cols = lines[k + 5 + n_box].split()[2:]
        start = k + 6 + n_box
        frames.append((step, cols, np.array([[float(x) for x in ln.split()]
                                             for ln in lines[start:start + n]])))
        k = start + n
    return frames


def cli_phase(card):
    """Phase 16: the CLI's run path at full width, in-process on the card:
    the 5,324-atom FCC Cu written as extxyz, the flagship Allegro (with the
    charge head) and bench.py:nequip_line's NequIP written as checkpoints,
    then ``pair_allegro_tpu_torch.cli.main(["run", ...])`` for the legs of
    ``_cli_legs``: NVT with dump, computes and restart (60 + 60 steps), its
    resume (60), MTK and Berendsen NPT (20 + 20 each), NequIP Langevin (60
    + 60) and the NVE control (NVT's config with nve, 60 + 60).  Checks:
    every leg launches K1 (Allegro) or K3 (NequIP) its per-evaluation count
    times its force evaluations and no other kernel; the dumps' frames and
    columns; the restart read back equals the NVT leg's final state; the
    resumed first force evaluation against the NVT leg's last dump frame
    (max|dF| < 5e-4); the cell moved under NPT.  Prints each leg's steps/s
    beside the NVE control's, and the dump's ms a frame."""
    import shutil

    import numpy as np
    import torch

    from pair_allegro_tpu_torch import checkpoint as ckpt
    from pair_allegro_tpu_torch import cli, engine
    from pair_allegro_tpu_torch.engine import PairEngine
    from pair_allegro_tpu_torch.io.dump import DumpWriter
    from pair_allegro_tpu_torch.io.extxyz import write_extxyz
    from pair_allegro_tpu_torch.md import integrate
    from pair_allegro_tpu_torch.md.thermo import npt_mtk_conserved, thermo_row
    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy
    from pair_allegro_tpu_torch.models.nequip import nequip_init_numpy
    from pair_allegro_tpu_torch.system import fcc_lattice

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli_phase")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    pos, cell = fcc_lattice(11)
    write_extxyz(f"{d}/cu.xyz", {"symbols": np.array(["Cu"] * len(pos)), "positions": pos,
                                 "cell": cell, "pbc": (True, True, True)})
    acfg, ncfg = flagship_cfg(output_charges=True), nequip_cfg()
    ckpt.save_params(f"{d}/allegro.npz", allegro_init_numpy(acfg, SEED), acfg, family="allegro")
    ckpt.save_params(f"{d}/nequip.npz", nequip_init_numpy(ncfg, SEED), ncfg, family="nequip")
    mods = kernel_modules()
    sims, firsts, n_eval, n_build = [], [], [0], [0]

    class Recorder(integrate.Simulation):
        """The CLI's Simulation, kept with the time of each chunk's end."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.start_state, self.ends = None, []
            sims.append(self)

        def run(self, n_steps, log_every=100, callback=None):
            self.start_state = self.state
            torch.cuda.synchronize()
            self.ends.append((self.state.step, time.perf_counter(), n_build[0]))

            def timed(state, row):  # the row read has synchronized the card
                self.ends.append((row["step"], time.perf_counter(), n_build[0]))
                callback(state, row)

            return super().run(n_steps, log_every, timed)

    force_fn = PairEngine.force_fn
    builders = engine.cell_list_neighbors, engine.dense_neighbors

    def counting(build):
        def built(*a, **kw):  # the builds the skin check lets through
            n_build[0] += 1
            return build(*a, **kw)

        return built

    def counted(self, system, neighbors):
        out = force_fn(self, system, neighbors)
        n_eval[0] += 1
        if n_eval[0] == 1:
            firsts.append(out.forces)
        return out

    plain_sim = integrate.Simulation
    integrate.Simulation, PairEngine.force_fn = Recorder, counted
    engine.cell_list_neighbors, engine.dense_neighbors = (counting(b) for b in builders)
    rates = {}
    try:
        for name, over, steps, log_every, model in _cli_legs(d):
            conf = dict(CLI_BASE, steps=steps, log_every=log_every, **over)
            path = f"{d}/{name}.yaml"
            with open(path, "w") as f:
                f.write(json.dumps(conf) + "\n")  # JSON on one line is a YAML flow mapping
            for m in mods.values():
                m.launches.reset()
            n_eval[0] = 0
            print(f"cli {name}: python -m pair_allegro_tpu_torch.cli run {name}.yaml "
                  f"({conf['integrator']}, {model}, {steps} steps)")
            if cli.main(["run", path]) != 0:
                raise RuntimeError(f"cli {name} returned non-zero")
            torch.cuda.synchronize()
            sim = sims[-1]
            # the rate of the chunks after the warmup chunk (all of a leg run in one)
            s0, t0, b0 = (next(e for e in sim.ends if e[0] - sim.ends[0][0] >= log_every)
                          if log_every < steps else sim.ends[0])
            s1, t1, b1 = sim.ends[-1]
            rates[name] = (s1 - s0) / (t1 - t0)
            per_eval = path_launches(model, acfg if model == "allegro" else ncfg)
            launched = {k: (m.launches.fwd, m.launches.bwd) for k, m in mods.items()
                        if m.launches.fwd or m.launches.bwd}
            want = {k: (n * n_eval[0], n * n_eval[0]) for k, n in per_eval.items()}
            st = sim.state
            finite = bool(torch.isfinite(st.forces).all()) and bool(torch.isfinite(
                st.system.positions).all())
            print(f"cli {name} on {card}: {rates[name]:.4f} steps/s over steps {s0}-{s1} "
                  f"({rates[name] * 2.0e-6 * 86400.0:.4f} ns/day), neighbor builds in those "
                  f"steps {b1 - b0}, T {thermo_row(st)['temp']:.1f} K, regrows {sim.regrows}, "
                  f"force evaluations {n_eval[0]}, launches fwd/bwd {launched} (per force "
                  f"evaluation {per_eval}), finite {finite}")
            if launched != want:
                raise RuntimeError(f"cli {name}: launched {launched}, want {want}")
            if not finite or st.step != (180 if name == "resume" else steps):
                raise RuntimeError(f"cli {name}: non-finite state or step {st.step}")
            if name == "nvt":
                nvt_state = st
                frames = read_dump(f"{d}/nvt.dump")
                cols = frames[-1][1]
                print(f"cli nvt: dump frames at steps {[f[0] for f in frames]}, columns "
                      f"{' '.join(cols)}")
                if ([f[0] for f in frames] != list(range(20, 121, 20))
                        or cols[-2:] != ["c_pe", "c_q"] or frames[-1][2].shape[0] != len(pos)):
                    raise RuntimeError("cli nvt: the dump's frames or columns are wrong")
                t_dump = time.perf_counter()
                with DumpWriter(f"{d}/timed.dump") as w:
                    for _ in range(3):
                        w.write_frame(st.step, st.system, forces=st.forces,
                                      atomic_energy=st.atomic_energy,
                                      extras={"q": st.extras["charges"]})
                dump_ms = (time.perf_counter() - t_dump) * 1e3 / 3
                print(f"cli nvt on {card}: one dump frame ({len(pos)} atoms, forces, c_pe, c_q) "
                      f"{dump_ms:.2f} ms on the host")
            if name == "resume":
                back, step, thermo, rng = ckpt.load_state(f"{d}/nvt_state.npz",
                                                          dtype=torch.float32)
                same = (step == nvt_state.step
                        and all(torch.equal(getattr(back, k), getattr(nvt_state.system, k))
                                for k in ("positions", "velocities", "cell", "masses"))
                        and all(torch.equal(thermo[k], v)
                                for k, v in nvt_state.thermostat.items())
                        and torch.equal(rng, nvt_state.generator.get_state()))
                f_dump = torch.as_tensor(frames[-1][2][:, 5:8], dtype=torch.float32)
                df = float((firsts[-1].cpu() - f_dump).abs().max())
                print(f"cli resume: the state read back equals the state written {same}; the "
                      f"resumed first force evaluation against the NVT leg's last dump frame "
                      f"max|dF| {df:.3e} eV/A (gate 5e-4)")
                if not same or not df < 5e-4:
                    raise RuntimeError("cli resume: the restart does not continue the NVT leg")
                del nvt_state
            if name == "npt":
                tk = dict(temp_K=50.0, tdamp=0.1, press_bar=0.0, pdamp=1.0)
                h0, h1 = (float(npt_mtk_conserved(s, **tk)) for s in (sim.start_state, st))
                print(f"cli npt: MTK conserved quantity {h0:.6f} -> {h1:.6f} eV (not gated: "
                      f"the random weights heat the bulk)")
            if name.startswith("npt"):
                dcell = float((st.system.cell - sim.start_state.system.cell).abs().max())
                print(f"cli {name}: the cell moved by max {dcell:.3e} A, volume "
                      f"{float(torch.linalg.det(st.system.cell.cpu().double())):.3f} A^3")
                if not dcell > 0.0:
                    raise RuntimeError(f"cli {name}: the cell did not move")
            sim.state = sim.start_state = None
            torch.cuda.empty_cache()
    finally:
        integrate.Simulation, PairEngine.force_fn = plain_sim, force_fn
        engine.cell_list_neighbors, engine.dense_neighbors = builders
    for name, r in rates.items():
        print(f"cli {name} on {card}: {r:.4f} steps/s against the NVE control's "
              f"{rates['nve']:.4f} ({r / rates['nve']:.3f}x)")
    shutil.rmtree(d, ignore_errors=True)
    return rates


def stack_timings(cfg, params, system, eng, errs):
    """Phase 14 (K8): fwd/bwd time of kernel and plain version at the stack
    main path's shapes, with the bound, and parity at those shapes (into
    ``errs``)."""
    import torch

    from pair_allegro_tpu_torch.ops import fused_stack as k8

    ops, k = stack_operands(cfg, params, system, eng)
    e = ops[0].shape[1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    w = k8.stack_weights(params["layers"], cfg.l_max, cfg.parity)
    calls = stack_calls(cfg, params, k)
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    dxo = torch.randn(ops[0].shape, generator=gen, device=system.device)
    k_f = cuda_ms(lambda: k8._kernel_fwd(*ops, w, k, inv_avg), 5)
    k_b = cuda_ms(lambda: k8._kernel_bwd(*ops, w, k, inv_avg, dxo), 5)
    with torch.no_grad():
        p_f = cuda_ms(lambda: calls[1](*ops), 2)
    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out = calls[1](*ins)
    p_b = cuda_ms(lambda: torch.autograd.grad(out, ins, dxo, retain_graph=True), 2)
    del ins, out, dxo
    torch.cuda.empty_cache()
    e2 = pair_compare("K8", f"stack main path E={e}", calls, ops, K8_NAMES, gen, outs=("x",))
    errs = {kind: max(errs[kind], e2[kind]) for kind in errs}
    res = {}
    for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
        bwd = kind == "bwd"
        flops, nbytes = k8_cost(w, e, bwd)
        res[kind] = timing(ms, pms, flops, k8_products(w, bwd) * e, nbytes,
                           k8_weight_bytes(w, bwd, n_tiles(e, k)))
        print_timing(f"K8 {kind} E={e} ({cfg.num_layers} layers)", res[kind])
    return res, errs


# bench.py:scale_line's run: FCC Cu of 63^3 cells (1,000,188 atoms, jitter
# 0.03 A), rows per window (189 windows)
SCALE_REP, SCALE_CHUNK = 63, 5292


def scale_case():
    """(cfg, params, system) of the scale path on the card: the flagship
    Allegro (l_max 2, 3 layers, 64 / 32 features, r_max 4.5, f32) on
    bench.py:scale_line's 1,000,188 atoms (``fcc_lattice`` is
    ``__graft_entry__._fcc_cu``'s formula)."""
    import numpy as np

    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy, allegro_params_from_numpy
    from pair_allegro_tpu_torch.system import System, fcc_lattice

    cfg = flagship_cfg()
    params = allegro_params_from_numpy(allegro_init_numpy(cfg, SEED), cfg)
    pos, cell = fcc_lattice(SCALE_REP, jitter=0.03)
    n = pos.shape[0]
    system = System.create(pos, np.zeros(n), cell=cell, masses=np.full(n, 63.546))
    return cfg, params, system


def reset_launches():
    for m in kernel_modules().values():
        m.launches.reset()


def launched_now():
    return {name: (m.launches.fwd, m.launches.bwd) for name, m in kernel_modules().items()
            if m.launches.fwd or m.launches.bwd}


def scale_path(card):
    """Phase 17a: the million-atom mode (bench.py:scale_line's run through
    the port).  ``AllegroEngine(row_chunk=5292)`` (189 windows), one
    rebuild, a first force evaluation and a steady one on positions moved
    by 1e-6 A; host seconds of the capacity estimate, seconds of the
    rebuild, s/force, K, counted edges, peak device memory and the resolved
    remat.  Gates: finite energy and forces, |sum F| <= 1e-6 N max|F|
    (translation invariance in f32), and exactly 3 x 189 K1 launches
    backward and 2 x 3 x 189 forward per evaluation (the forward and each
    window checkpoint's recompute; the layers inside a window take no
    checkpoint of their own), no other kernel.  Returns the K1 counts of
    the steady evaluation and the numbers printed."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine

    t0 = time.perf_counter()
    cfg, params, system = scale_case()
    t_case = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = AllegroEngine(cfg, params, system, row_chunk=SCALE_CHUNK)
    t_est = time.perf_counter() - t0
    n = system.n_atoms
    windows = n // SCALE_CHUNK
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nb = eng.rebuild_fn(system, None)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    overflow = bool(nb.overflow)
    edges = int(nb.edge_mask.sum())
    peak_build = torch.cuda.max_memory_allocated() / 2**30
    res = {"atoms": n, "windows": windows, "row_chunk": SCALE_CHUNK,
           "K": eng.spec.max_neighbors, "edge_slots": n * eng.spec.max_neighbors,
           "edges": edges, "remat": eng.cfg.remat, "host_estimate_s": t_est,
           "system_s": t_case, "rebuild_s": t_build, "rebuild_peak_gib": peak_build}
    want = {"K1": (2 * cfg.num_layers * windows, cfg.num_layers * windows)}
    counts = None
    for label, sys_ in (("first", system),
                        ("steady", system.replace(positions=system.positions + 1e-6))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.force_fn(sys_, nb)
        torch.cuda.synchronize()
        res[f"{label}_s_per_force"] = time.perf_counter() - t0
        res[f"{label}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        counts = launched_now()
        f = out.forces.double()
        finite = bool(torch.isfinite(f).all()) and bool(torch.isfinite(out.total_energy))
        net = float(f.sum(0).norm())
        fmax = float(f.abs().max())
        res[f"{label}_net_force_share"] = net / (n * fmax)
        print(f"scale path ({card}): {label} force evaluation {res[f'{label}_s_per_force']:.4f} s, "
              f"E {float(out.total_energy):.6f} eV, |sum F| {net:.4e} eV/A against N max|F| "
              f"{n * fmax:.4e} (share {res[f'{label}_net_force_share']:.3e}, gate 1e-6), "
              f"finite {finite}, peak {res[f'{label}_peak_gib']:.3f} GiB, launches fwd/bwd "
              f"{counts} (want {want})")
        if not finite or not res[f"{label}_net_force_share"] <= 1e-6:
            raise RuntimeError(f"scale path {label}: non-finite or net force too large")
        if counts != want or overflow:
            raise RuntimeError(f"scale path {label}: launched {counts}, want {want}; "
                               f"overflow {overflow}")
    print(f"scale path ({card}): {n} atoms, {windows} windows of {SCALE_CHUNK} rows, "
          f"K={res['K']}, {res['edge_slots']} edge slots, {edges} counted edges, remat resolved "
          f"{res['remat']}; host capacity estimate (numpy host_neighbor_stats) {t_est:.3f} s, "
          f"system on the card {t_case:.3f} s, rebuild {t_build:.3f} s (peak "
          f"{peak_build:.3f} GiB), s/force first {res['first_s_per_force']:.4f}, steady "
          f"{res['steady_s_per_force']:.4f}")
    print("scale path result", json.dumps(res))
    del eng, nb, out, system, params
    torch.cuda.empty_cache()
    return counts, res


def chunked_parity(card):
    """Phase 17b: the 5,324-atom bulk (phase 5's system and model) with
    ``row_chunk=1331`` against the unchunked engine on one neighbor build:
    forces within 1e-5 eV/A (the same kernel on the same rows, only the
    order of the window sums differs), per-atom energies and virial printed;
    then phase 5's run with the windows (60 + 60 steps), its steps/s beside
    phase 5's."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine

    cfg, params, system = make_case(11, None)
    eng0 = AllegroEngine(cfg, params, system)
    eng1 = AllegroEngine(cfg, params, system, row_chunk=ROW_CHUNK["allegro-chunked"])
    nb = eng0.rebuild_fn(system, None)
    nb1 = eng1.rebuild_fn(system, None)
    same = all(torch.equal(getattr(nb, k), getattr(nb1, k))
               for k in ("edge_index", "edge_shifts", "edge_mask", "edge_rev"))
    o0, o1 = eng0.force_fn(system, nb), eng1.force_fn(system, nb)
    df, de = max_err(o1.forces, o0.forces), max_err(o1.atomic_energy, o0.atomic_energy)
    dv = max_err(o1.virial, o0.virial)
    dE = abs(float(o1.total_energy) - float(o0.total_energy))
    print(f"chunked parity ({card}): 5,324 atoms, row_chunk=1331 against no windows: max|dF| "
          f"{df:.3e} eV/A (gate 1e-5), max|dE_i| {de:.3e} eV, |dE| {dE:.3e} eV, max|dW| "
          f"{dv:.3e} eV; windowed neighbor build equal to the full one: {same}")
    if not (df <= 1e-5 and same):
        raise RuntimeError("chunked parity gate failed")
    del eng0, eng1, nb, nb1
    torch.cuda.empty_cache()
    main_path("allegro-chunked")
    a, b = STEPS_PER_S.get("allegro"), STEPS_PER_S["allegro-chunked"]
    print(f"chunked path ({card}): {b:.4f} steps/s with 4 windows of 1331 rows against phase 5's "
          f"{a:.4f} steps/s in this call (ratio {b / a:.4f})" if a else
          f"chunked path ({card}): {b:.4f} steps/s")
    torch.cuda.empty_cache()
    return {"max_abs_dF": df, "chunked_steps_per_s": b, "phase5_steps_per_s": a}


# the kernel tiers of the remat legs: (label, config fields, environment,
# system kind, {kernel: launches per force evaluation each way})
REMAT_TIERS = [
    ("k1", {}, {}, "bulk", {"K1": 3}),
    ("embed", {}, {"PAT_L1_EMBED": "1"}, "bulk", {"K6": 1, "K1": 1, "K7": 1}),
    ("perlayer", dict(layer_fused=False), {}, "bulk", {"K2": 3}),
    ("perlayer-mxu_highest", dict(layer_fused=False, tp_mode="mxu_highest"), {}, "bulk",
     {"K5": 3}),
    ("flat", {}, {}, "slab", {"K4": 3}),
    ("nequip", {}, {}, "nequip", {"K3": 3}),
]
# the TABLE tiers of the row_chunk legs (500 atoms, 4 windows of 125 rows)
CHUNK_TIERS = [
    ("k1", {}, {}, {"K1": 3}),
    ("k1-nopos", {}, {"PAT_L1_POSITIONAL": "0"}, {"K1": 3}),
    ("embed", {}, {"PAT_L1_EMBED": "1"}, {"K6": 1, "K1": 1, "K7": 1}),
    ("perlayer", dict(layer_fused=False), {}, {"K2": 3}),
    ("perlayer-mxu_highest", dict(layer_fused=False, tp_mode="mxu_highest"), {}, {"K5": 3}),
    ("stack", dict(fused_stack=True), {}, {"K8": 1}),
]


def _remat_engine(kind, fields, remat, row_chunk=None):
    import dataclasses

    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine

    if kind == "nequip":
        cfg, params, system = make_nequip_case(5, None)
        return system, NequIPEngine(dataclasses.replace(cfg, remat=remat), params, system)
    cfg, params, system = make_case(5, None, output_charges=True, slab=kind == "slab", **fields)
    cfg = dataclasses.replace(cfg, remat=remat)
    return system, AllegroEngine(cfg, params, system, row_chunk=row_chunk)


def remat_legs(card):
    """Phase 17c: on the 500-atom table (the slab for K4), each kernel tier
    with ``remat=True`` against ``remat=False``: forces within the tight
    gate (TIGHT_TOLS['bwd'] on max|F|), whether they are bit-identical, and
    the launches (remat runs each layer's forward once more: twice the
    forward count, the same backward); then ``row_chunk=125`` on each TABLE
    tier against no windows, within the model gate (5e-4 eV/A), with each
    window's forward run twice."""
    import torch

    atol, rtol = TIGHT_TOLS["bwd"]
    out = {}
    for label, fields, env, kind, per_eval in REMAT_TIERS:
        with env_vars(env):
            res = {}
            for remat in (False, True):
                system, eng = _remat_engine(kind, fields, remat)
                nb = eng.rebuild_fn(system, None)
                reset_launches()
                o = eng.force_fn(system, nb)
                torch.cuda.synchronize()
                res[remat] = (o.forces, launched_now())
        (f0, c0), (f1, c1) = res[False], res[True]
        err, tol = max_err(f1, f0), atol + rtol * float(f0.abs().max())
        ident = bool(torch.equal(f1, f0))
        want0 = {k: (n, n) for k, n in per_eval.items()}
        want1 = {k: (2 * n, n) for k, n in per_eval.items()}
        print(f"remat ({card}) {label}: max|F(remat) - F| {err:.3e} eV/A (tight gate {tol:.3e}), "
              f"bit-identical {ident}; launches fwd/bwd without {c0}, with {c1} (extra forward "
              f"launches {({k: c1[k][0] - c0[k][0] for k in c1 if k in c0})})")
        if not err <= tol or c0 != want0 or c1 != want1:
            raise RuntimeError(f"remat leg {label}: err {err}, launches {c0} / {c1}")
        out[label] = {"max_abs_dF": err, "bit_identical": ident}
    for label, fields, env, per_eval in CHUNK_TIERS:
        with env_vars(env):
            res = {}
            for rc in (None, 125):
                system, eng = _remat_engine("bulk", fields, False, row_chunk=rc)
                nb = eng.rebuild_fn(system, None)
                reset_launches()
                o = eng.force_fn(system, nb)
                torch.cuda.synchronize()
                res[rc] = (o, launched_now())
        (o0, c0), (o1, c1) = res[None], res[125]
        df, dq = max_err(o1.forces, o0.forces), max_err(o1.extras["charges"], o0.extras["charges"])
        want1 = {k: (2 * 4 * n, 4 * n) for k, n in per_eval.items()}
        print(f"row_chunk ({card}) {label}: 4 windows of 125 rows against none: max|dF| {df:.3e} "
              f"eV/A, max|dq| {dq:.3e} (gate 5e-4); launches fwd/bwd {c1} (want {want1})")
        if not (df < 5e-4 and dq < 5e-4) or c1 != want1:
            raise RuntimeError(f"row_chunk leg {label}: dF {df}, launches {c1}")
        out[f"row_chunk {label}"] = {"max_abs_dF": df}
    return out


def scale_phase(card):
    """Phase 17: the million-atom mode and remat (scale_path,
    chunked_parity, remat_legs); every number beside the card's name and
    power limit."""
    print(f"phase 17 on {card}")
    counts, res = scale_path(card)
    res["chunked"] = chunked_parity(card)
    res["remat_legs"] = remat_legs(card)
    return counts, res


# phase 18: labelled frames of 500-atom FCC Cu (5^3 cells, jitter 0.1 A),
# split 12 train / 4 val, Adam, batch 4, 3 epochs; the card's gradient
# against the CPU's at f64, per leaf relative to the leaf's max
TRAIN_REP, TRAIN_FRAMES, TRAIN_VAL, TRAIN_BATCH, TRAIN_EPOCHS = 5, 16, 4, 4, 3
TRAIN_LR, TRAIN_JITTER, GRAD_GATE = 1e-4, 0.1, 1e-3


def perturbed(tree, scale=0.03):
    """The student: each leaf times 1 + scale * sin(its flat index), as the
    JAX package's tests/test_training.py:193-196 perturbs its teacher."""
    import numpy as np

    from pair_allegro_tpu_torch.train import tree_map

    return tree_map(lambda a: a * (1.0 + scale * np.sin(np.arange(a.size).reshape(a.shape))),
                    tree)


def train_frames(path, cfg, tree):
    """Write TRAIN_FRAMES frames of jittered FCC Cu labelled by the teacher
    ``tree`` (energy, forces and the quoted virial) on the engine's default
    tier (K1 on the card) to the extxyz file ``path``."""
    import numpy as np

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.io.extxyz import write_extxyz
    from pair_allegro_tpu_torch.models.allegro import allegro_params_from_numpy
    from pair_allegro_tpu_torch.system import System, fcc_lattice

    params = allegro_params_from_numpy(tree, cfg, device="cuda")
    frames = []
    for i in range(TRAIN_FRAMES):
        pos, cell = fcc_lattice(TRAIN_REP, jitter=TRAIN_JITTER, seed=SEED + 100 + i)
        system = System.create(pos, np.zeros(len(pos)), cell=cell, device="cuda")
        eng = AllegroEngine(cfg, params, system, device="cuda")
        out = eng.force_fn(system, eng.rebuild_fn(system, None))
        virial = " ".join(f"{x:.9g}" for x in out.virial.double().cpu().numpy().reshape(-1))
        frames.append({"symbols": np.array(["Cu"] * len(pos)), "positions": pos, "cell": cell,
                       "pbc": (True, True, True), "forces": out.forces.double().cpu().numpy(),
                       # the writer puts info values as they are: quote the 9 numbers
                       "info": {"energy": f"{float(out.total_energy):.9g}",
                                "virial": f'"{virial}"'}})
    write_extxyz(path, frames)


def batch_grads(cfg, energy_fn, tree, frames, device, dtype, w_virial=0.0):
    """{leaf key: d(batch loss)/d(leaf)} as f64 numpy (zeros where the loss
    does not reach the leaf), of ``tree`` on ``device`` at ``dtype``."""
    import numpy as np
    import torch

    from pair_allegro_tpu_torch.checkpoint import flatten, params_from_numpy
    from pair_allegro_tpu_torch.data import stack_frames
    from pair_allegro_tpu_torch.train import leaves, make_batched_loss_fn, make_loss_fn

    params = params_from_numpy(tree, cfg, device, dtype)
    tensors = leaves(params)
    for t in tensors:
        t.requires_grad_(True)
    loss_fn = make_batched_loss_fn(make_loss_fn(energy_fn, cfg.for_training(), w_virial=w_virial))
    loss, _ = loss_fn(params, stack_frames(frames))
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return {k: np.zeros(t.shape) if g is None else g.double().cpu().numpy()
            for k, t, g in zip(flatten(params), tensors, grads)}


def grad_errors(got, want):
    """{leaf: max|got - want| / max|want|} (0 where both are zero)."""
    import numpy as np

    out = {}
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        out[k] = err / scale if scale else (0.0 if err == 0.0 else float("inf"))
    return out


def train_loop(step, params, state, frames, val_batch, val_loss, epochs, rng, card, label):
    """``epochs`` of shuffled batches of TRAIN_BATCH frames; returns (params,
    state, losses, val rmse_F per epoch, seconds of each update)."""
    import torch

    from pair_allegro_tpu_torch.data import stack_frames
    from pair_allegro_tpu_torch.train import detached

    losses, val_rmse, secs = [], [], []
    for epoch in range(epochs):
        order = rng.permutation(len(frames))
        for b in range(len(order) // TRAIN_BATCH):
            batch = stack_frames([frames[i] for i in order[b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH]])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step.update(params, state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        if val_batch is not None:
            val_rmse.append(float(val_loss(detached(params), val_batch)[1]["rmse_f"]))
            print(f"{label} epoch {epoch}: train loss {losses[-1]:.6e}, val rmse_F "
                  f"{val_rmse[-1]:.6e} eV/A ({card})")
    return params, state, losses, val_rmse, secs


def lightning_checkpoint(path, tree, cfg):
    """A Lightning-style checkpoint of ``tree`` in the upstream naming:
    {'state_dict': {'model.' + dotted name: tensor}}, every 2-D leaf in
    torch ``nn.Linear`` (out, in) orientation."""
    import torch

    from pair_allegro_tpu_torch.checkpoint import flatten
    from pair_allegro_tpu_torch.import_torch import upstream_allegro_key_map

    key_map, transposed = upstream_allegro_key_map(cfg)
    sd = {"model." + key_map[k]: torch.tensor(a.T.copy() if k in transposed else a)
          for k, a in flatten(tree).items()}
    torch.save({"state_dict": sd, "epoch": 2, "global_step": 6}, path)


def train_phase(card):
    """Phase 18: training and import at full width on the card.
    (a) 16 frames of 500-atom FCC Cu labelled by the flagship Allegro
    (seeded weights, K1 tier: energy, forces, virial), written as extxyz
    and read by ``data.load_frames`` onto the card; (b) a perturbed student
    trained on ``for_training()`` with Adam, batch 4, 3 epochs (12 train /
    4 val frames): no kernel launch, every loss finite, the last epoch's
    val rmse_F below the first's; ms per update, frames/s, peak memory;
    (c) one batch's gradient on the card (f32) against the CPU's (f64) of
    the same tree and frames, per leaf, gate GRAD_GATE of the leaf's max;
    (d) the trained tree through AllegroEngine on the original config, whose
    K1 layouts were cached from the same leaves before training: exactly
    3 / 3 K1 launches a force evaluation, forces within 5e-4 of the plain
    path; (e) phase 6's NequIP, 4 updates with no K3 launch, then one
    NequIPEngine evaluation (3 / 3 K3 launches, forces within 5e-4 of the
    plain path); (f) ``cli train`` (2 epochs from a checkpoint), ``cli
    import`` of a Lightning-style checkpoint of the trained tree through the
    upstream key map (the imported tree equals the trained one exactly) and
    ``cli run`` (20 NVE steps) on the imported .npz: K1 3 / 3 a force
    evaluation, nothing else.  Validation runs without the forces' graph."""
    import functools
    import shutil

    import numpy as np
    import torch

    from pair_allegro_tpu_torch import checkpoint as ckpt
    from pair_allegro_tpu_torch import cli
    from pair_allegro_tpu_torch.data import load_frames, stack_frames
    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine, PairEngine
    from pair_allegro_tpu_torch.io.extxyz import write_extxyz
    from pair_allegro_tpu_torch.models.allegro import (
        allegro_energy,
        allegro_init_numpy,
        allegro_params_from_numpy,
    )
    from pair_allegro_tpu_torch.models.nequip import nequip_energy, nequip_init_numpy
    from pair_allegro_tpu_torch.system import System, fcc_lattice
    from pair_allegro_tpu_torch.train import (
        detached,
        make_batched_loss_fn,
        make_loss_fn,
        make_train_step,
    )

    print(f"phase 18 on {card}")
    device = "cuda"
    t_phase = time.perf_counter()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_phase")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cfg = flagship_cfg()
    teacher = allegro_init_numpy(cfg, SEED)
    student = perturbed(teacher)
    path = f"{d}/frames.xyz"
    t0 = time.perf_counter()
    train_frames(path, cfg, teacher)
    frames = load_frames(path, cfg.type_names, cfg.r_max, device=device)
    shapes = {k: tuple(v.shape) for k, v in frames[0].items() if v is not None}
    print(f"train frames: {len(frames)} of {int(frames[0]['n_atoms'])} atoms labelled on the K1 "
          f"tier and read back onto {frames[0]['positions'].device} in "
          f"{time.perf_counter() - t0:.2f} s; padded shapes {shapes}")
    train, val = frames[:TRAIN_FRAMES - TRAIN_VAL], frames[TRAIN_FRAMES - TRAIN_VAL:]
    val_batch = stack_frames(val)

    # (b) training, with the engine's view of the leaves made before it
    params = allegro_params_from_numpy(student, cfg, device=device)
    views = detached(params)
    pos, cell = fcc_lattice(TRAIN_REP, jitter=TRAIN_JITTER, seed=SEED + 99)
    probe = System.create(pos, np.zeros(len(pos)), cell=cell, device=device)
    eng = AllegroEngine(cfg, views, probe, device=device)
    nb = eng.rebuild_fn(probe, None)
    before = eng.force_fn(probe, nb)  # caches K1's layouts of these leaves
    batched = make_batched_loss_fn(make_loss_fn(allegro_energy, cfg.for_training()))
    val_loss = make_batched_loss_fn(make_loss_fn(allegro_energy, cfg.for_training(),
                                                 create_graph=False))
    step = make_train_step(batched, functools.partial(torch.optim.Adam, lr=TRAIN_LR))
    state = step.init(params)
    val0 = float(val_loss(views, val_batch)[1]["rmse_f"])
    print(f"train: the student's val rmse_F before training {val0:.6e} eV/A")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() / 2**30
    params, state, losses, val_rmse, secs = train_loop(
        step, params, state, train, val_batch, val_loss, TRAIN_EPOCHS,
        np.random.RandomState(SEED), card, "train")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = launched_now()
    steady = secs[1:]
    ms = 1e3 * sum(steady) / len(steady)
    print(f"train on {card}: {len(secs)} updates of batch {TRAIN_BATCH} ({TRAIN_BATCH} x "
          f"{int(frames[0]['n_atoms'])} atoms, E_pad {shapes['edge_index'][1]}), "
          f"{ms:.3f} ms per update over updates 2-{len(secs)} (first {secs[0] * 1e3:.3f} ms), "
          f"{TRAIN_BATCH * 1e3 / ms:.4f} frames/s, peak device memory {peak:.3f} GiB "
          f"({mem0:.3f} GiB before), launches during training {launched}, losses "
          f"{[f'{x:.4e}' for x in losses]}")
    if launched:
        raise RuntimeError(f"training launched kernels: {launched}")
    if not all(math.isfinite(x) for x in losses + val_rmse):
        raise RuntimeError("training produced a non-finite loss")
    if not val_rmse[-1] < val_rmse[0]:
        raise RuntimeError(f"val rmse_F did not fall: {val_rmse}")

    # (c) the card's gradient against the CPU's at f64, one batch
    cpu_frames = load_frames(path, cfg.type_names, cfg.r_max, dtype=torch.float64,
                             device="cpu")[:TRAIN_BATCH]
    t0 = time.perf_counter()
    g_card = batch_grads(cfg, allegro_energy, student, train[:TRAIN_BATCH], device,
                         torch.float32)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_cpu = batch_grads(cfg, allegro_energy, student, cpu_frames, "cpu", torch.float64)
    t_cpu = time.perf_counter() - t0
    errs = grad_errors(g_card, g_cpu)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    unreached = [k for k, g in g_cpu.items() if not np.any(g)]
    print(f"train gradient, card f32 against CPU f64 ({TRAIN_BATCH} frames, {len(errs)} leaves, "
          f"{t_card:.2f} s on the card, {t_cpu:.2f} s on the CPU): max error relative to the "
          f"leaf's max {worst[0][1]:.3e} ({worst[0][0]}; gate {GRAD_GATE:g}); next "
          f"{[(k, f'{e:.2e}') for k, e in worst[1:4]]}; leaves the loss does not reach "
          f"(zero on both) {unreached}")
    if not worst[0][1] <= GRAD_GATE:
        raise RuntimeError(f"the card's training gradient is off: {worst[:4]}")

    # (d) the trained tree in the engine: the same views, updated in place
    reset_launches()
    after = eng.force_fn(probe, nb)
    torch.cuda.synchronize()
    launched_k1 = launched_now()
    plain = AllegroEngine(cfg.for_training(), views, probe, device=device)
    ref = plain.force_fn(probe, plain.rebuild_fn(probe, None))
    df = float((after.forces - ref.forces).abs().max())
    de = abs(float(after.total_energy) - float(ref.total_energy))
    moved = float((after.forces - before.forces).abs().max())
    print(f"trained tree on the K1 tier ({probe.n_atoms} atoms): launches {launched_k1} for one "
          f"force evaluation, max|dF| {df:.3e} eV/A against the plain path (gate 5e-4), |dE| "
          f"{de:.3e} eV of {float(ref.total_energy):.4f}, forces moved {moved:.3e} eV/A by "
          f"training")
    if launched_k1 != {"K1": (cfg.num_layers, cfg.num_layers)}:
        raise RuntimeError(f"the trained tree's evaluation launched {launched_k1}")
    if not df < 5e-4 or not moved > 0.0:
        raise RuntimeError("the trained tree on the K1 tier is off the plain path, or stale")
    del eng, plain, before, after, ref, params, state, views
    torch.cuda.empty_cache()

    # (e) NequIP: 4 updates on the plain message path, then K3 in the engine
    ncfg = nequip_cfg()
    nparams = ckpt.params_from_numpy(nequip_init_numpy(ncfg, SEED), ncfg, device)
    nbatched = make_batched_loss_fn(make_loss_fn(nequip_energy, ncfg.for_training()))
    nstep = make_train_step(nbatched, functools.partial(torch.optim.Adam, lr=TRAIN_LR))
    nstate = nstep.init(nparams)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    nparams, nstate, nlosses, _, nsecs = train_loop(
        nstep, nparams, nstate, frames, None, None, 1,
        np.random.RandomState(SEED), card, "nequip train")
    launched = launched_now()
    npeak = torch.cuda.max_memory_allocated() / 2**30
    nms = 1e3 * sum(nsecs[1:]) / len(nsecs[1:])
    print(f"nequip train on {card}: {len(nsecs)} updates of batch {TRAIN_BATCH}, {nms:.3f} ms per "
          f"update over updates 2-{len(nsecs)}, {TRAIN_BATCH * 1e3 / nms:.4f} frames/s, peak "
          f"{npeak:.3f} GiB, launches {launched}, losses {[f'{x:.4e}' for x in nlosses]}")
    if launched or not all(math.isfinite(x) for x in nlosses):
        raise RuntimeError(f"NequIP training launched {launched} or lost finiteness")
    reset_launches()
    neng = NequIPEngine(ncfg, detached(nparams), probe, device=device)
    nout = neng.force_fn(probe, neng.rebuild_fn(probe, None))
    torch.cuda.synchronize()
    launched_k3 = launched_now()
    nplain = NequIPEngine(ncfg.for_training(), detached(nparams), probe, device=device)
    nref = nplain.force_fn(probe, nplain.rebuild_fn(probe, None))
    ndf = float((nout.forces - nref.forces).abs().max())
    print(f"trained NequIP in NequIPEngine: launches {launched_k3}, max|dF| {ndf:.3e} eV/A "
          f"against the plain path (gate 5e-4)")
    if launched_k3 != {"K3": (ncfg.num_layers, ncfg.num_layers)} or not ndf < 5e-4:
        raise RuntimeError(f"the trained NequIP's evaluation: {launched_k3}, max|dF| {ndf}")
    del nparams, nstate, neng, nplain, nout, nref
    torch.cuda.empty_cache()

    # (f) the CLI: train, import, run
    ckpt.save_params(f"{d}/student.npz", student, cfg, family="allegro")
    train_conf = {"model": {"checkpoint": f"{d}/student.npz"}, "dataset": path,
                  "val_fraction": TRAIN_VAL / TRAIN_FRAMES,
                  "optimizer": {"name": "adam", "lr": TRAIN_LR}, "batch_size": TRAIN_BATCH,
                  "epochs": 2, "log_every": 1, "seed": SEED, "out": f"{d}/trained.npz"}
    conf_path = f"{d}/train.yaml"
    with open(conf_path, "w") as f:
        f.write(json.dumps(train_conf) + "\n")  # JSON on one line is a YAML flow mapping
    reset_launches()
    t0 = time.perf_counter()
    if cli.main(["train", conf_path]) != 0:
        raise RuntimeError("cli train returned non-zero")
    torch.cuda.synchronize()
    launched = launched_now()
    print(f"cli train: 2 epochs in {time.perf_counter() - t0:.2f} s, launches {launched}")
    if launched:
        raise RuntimeError(f"cli train launched kernels: {launched}")
    trained, _, _ = ckpt.load_params(f"{d}/trained.npz")
    lightning_checkpoint(f"{d}/last.ckpt", trained, cfg)
    model_conf = {"family": "allegro", "key_map": "upstream",
                  "config": {k: v for k, v in dataclasses.asdict(cfg).items() if v is not None}}
    with open(f"{d}/model.yaml", "w") as f:
        f.write(json.dumps(model_conf) + "\n")
    if cli.main(["import", f"{d}/last.ckpt", f"{d}/model.yaml", f"{d}/imported.npz"]) != 0:
        raise RuntimeError("cli import returned non-zero")
    with np.load(f"{d}/trained.npz") as a, np.load(f"{d}/imported.npz") as b:
        leaves_a, leaves_b = ([k for k in z.files if not k.startswith("__")] for z in (a, b))
        same = sorted(leaves_a) == sorted(leaves_b) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in leaves_a)
    print(f"cli import: the imported tree equals the trained one exactly: {same}")
    if not same:
        raise RuntimeError("cli import does not give back the trained tree")
    write_extxyz(f"{d}/cu.xyz", {"symbols": np.array(["Cu"] * len(pos)), "positions": pos,
                                 "cell": cell, "pbc": (True, True, True)})
    run_conf = dict(CLI_BASE, data=f"{d}/cu.xyz", model={"checkpoint": f"{d}/imported.npz"},
                    integrator="nve", temp_K=50.0, steps=20, log_every=10)
    with open(f"{d}/run.yaml", "w") as f:
        f.write(json.dumps(run_conf) + "\n")
    n_eval = [0]
    force_fn = PairEngine.force_fn

    def counted(self, system, neighbors):
        n_eval[0] += 1
        return force_fn(self, system, neighbors)

    PairEngine.force_fn = counted
    reset_launches()
    try:
        if cli.main(["run", f"{d}/run.yaml"]) != 0:
            raise RuntimeError("cli run returned non-zero")
    finally:
        PairEngine.force_fn = force_fn
    torch.cuda.synchronize()
    launched = launched_now()
    want = {"K1": (cfg.num_layers * n_eval[0],) * 2}
    print(f"cli run on the imported tree: {n_eval[0]} force evaluations, launches {launched} "
          f"(want {want})")
    if launched != want:
        raise RuntimeError(f"cli run launched {launched}, want {want}")
    shutil.rmtree(d, ignore_errors=True)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")


def _kind_of(name):
    """A coarse class of a device kernel's name, for the profile's summary."""
    n = name.lower()
    if "k1_" in n and ("<1," in n or "ili1e" in n):  # the K1 body's forms 1 and 2
        return "K6 (embed_layer)"
    if "k1_" in n and ("<2," in n or "ili2e" in n):
        return "K7 (readout_layer)"
    for key, kind in (("k8_", "K8 (fused_stack)"), ("k3_", "K3 (nequip_conv)"),
                      ("k1_", "K1 (fused_layer)"),
                      ("k2_", "K2 (env_layer)"), ("k5_", "K5 (env_layer_mxu)"),
                      ("k4_", "K4 (tp_mix_fused)"), ("indexfunc", "segment_sum (index_add)"),
                      ("scan", "neighbor build (cumsum)"), ("index", "gather / index_select"),
                      ("gather", "gather / index_select"),
                      ("scatter", "scatter"), ("gemm", "matmul (torch)"), ("xmma", "matmul (torch)"),
                      ("cutlass", "matmul (torch)"), ("reduce", "reductions (sum)"),
                      ("memcpy", "copies"), ("copy", "copies"), ("cat", "copies"),
                      ("fill", "fills"), ("sort", "neighbor build (sort/topk)"),
                      ("topk", "neighbor build (sort/topk)")):
        if key in n:
            return kind
    return "elementwise and other glue"


def profile_steps(model="allegro", integrator="nve", n_steps=10):
    """``--profile [nequip | perlayer | perlayer-mxu | flat | embed | stack |
    allegro-chunked] [nve | nvt]``: where one main-path MD step's device
    time goes (``allegro-chunked``: phase 5's in 4 windows), under
    NVE or phase 16's NVT (50 K, tdamp 0.05 ps).  torch.profiler over
    n_steps after a 20-step warmup; kernel time summed by name and by class
    per step, and the device's idle share of the wall time."""
    with env_vars(PATHS[model][5]):
        return _profile_steps(model, integrator, n_steps)


def _profile_steps(model, integrator, n_steps):
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    cfg, params, system, eng = build_path(model)
    kw = dict(temp_K=50.0, tdamp=0.05) if integrator == "nvt" else {}
    sim = Simulation(system, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs, grow_fn=eng.grow,
                     integrator=integrator, **kw)
    sim.init_velocities(50.0, seed=SEED)
    sim.run(20, log_every=20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(n_steps, log_every=n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    build_ms = None
    if eng.spec.strategy == "dense":
        build_ms, _ = rebuild_ms(system, eng)
    per = collections.Counter()
    calls = collections.Counter()
    kinds = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3 / n_steps
            per[ev.name] += ms
            calls[ev.name] += 1
            kinds[_kind_of(ev.name)] += ms
    busy = sum(per.values())
    step_ms = wall * 1e3 / n_steps
    model = f"{model} {integrator}"
    print(f"profile {model}: {step_ms:.3f} ms/step wall (profiler on), device busy {busy:.3f} "
          f"ms/step, idle share {1.0 - busy / step_ms:.3f}, {sum(calls.values()) / n_steps:.0f} "
          f"device events/step, regrows {sim.regrows}, strategy {eng.spec.strategy}, "
          f"K={eng.spec.max_neighbors}, max_edges={eng.spec.max_edges}")
    if build_ms is not None:
        print(f"profile {model}: one dense rebuild {build_ms:.3f} ms wall (not in the profiled "
              f"steps unless an atom moved skin/2)")
    for kind, ms in kinds.most_common():
        print(f"profile {model} by class: {ms:8.3f} ms/step {100 * ms / busy:5.1f}%  {kind}")
    for name, ms in per.most_common(20):
        print(f"profile {model}: {ms:8.3f} ms/step {100 * ms / busy:5.1f}%  "
              f"x{calls[name] / n_steps:5.1f}  {name[:110]}")
    return 0


def profile_scale():
    """``--profile scale``: where one steady force evaluation of the
    million-atom mode (phase 17a's engine) spends its device time:
    torch.profiler over one evaluation after a warm one, kernel time by
    class and by name, the device's idle share; beside it the host clock of
    the evaluation's forward alone (the 189 windows, no backward) and of the
    rebuild."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pair_allegro_tpu_torch.engine import AllegroEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    kernel_modules()["K1"].LIB.load()
    cfg, params, system = scale_case()
    t0 = time.perf_counter()
    eng = AllegroEngine(cfg, params, system, row_chunk=SCALE_CHUNK)
    t_est = time.perf_counter() - t0
    nb = eng.rebuild_fn(system, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nb = eng.rebuild_fn(system, None)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    eng.force_fn(system, nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.force_fn(system, nb)
    torch.cuda.synchronize()
    t_force = time.perf_counter() - t0
    with torch.no_grad():  # the windows' forward alone: no checkpoint saves, no backward
        t0 = time.perf_counter()
        eng.energy_fn(system.positions, system.types, nb.edge_index, cell=system.cell,
                      edge_shifts=nb.edge_shifts, atom_mask=system.valid_mask(),
                      edge_mask=nb.edge_mask, edge_rev=nb.edge_rev)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.force_fn(system, nb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per, calls, kinds = collections.Counter(), collections.Counter(), collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            per[ev.name] += ms
            calls[ev.name] += 1
            kinds[_kind_of(ev.name)] += ms
    busy = sum(per.values())
    print(f"profile scale: {system.n_atoms} atoms, {system.n_atoms // SCALE_CHUNK} windows, "
          f"K={eng.spec.max_neighbors}; host capacity estimate {t_est:.3f} s, rebuild "
          f"{t_build:.3f} s, force evaluation {t_force:.4f} s without the profiler, of which "
          f"the windows' forward alone (no_grad) {t_fwd:.4f} s")
    print(f"profile scale: {wall * 1e3:.3f} ms wall (profiler on), device busy {busy:.3f} ms, "
          f"idle share {1.0 - busy / (wall * 1e3):.3f}, {sum(calls.values())} device events")
    for kind, ms in kinds.most_common():
        print(f"profile scale by class: {ms:10.3f} ms {100 * ms / busy:5.1f}%  {kind}")
    for name, ms in per.most_common(20):
        print(f"profile scale: {ms:10.3f} ms {100 * ms / busy:5.1f}%  x{calls[name]:6d}  "
              f"{name[:110]}")
    return 0


TIMINGS = {"body": ("K1", "K6", "K8"), "env": ("K2", "K5"), "flat": ("K4",), "nequip": ("K3",)}


def timings(which):
    """``--timings body``: K1, K6 / K7 and K8 timed (and held against their
    plain versions) at the allegro, embed and stack main paths' shapes;
    ``--timings env``: K2 and K5 (phase 8) at the per-layer path's;
    ``--timings flat``: K4 (phase 10) at the FLAT slab's; ``--timings
    nequip``: K3 (phase 7) at the NequIP path's."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    mods = kernel_modules()
    libs = [mods[name].LIB for name in TIMINGS[which]]
    for lib in libs:
        lib.start()
    for lib in libs:
        lib.load()
    zero = {"fwd": 0.0, "bwd": 0.0}
    paths = {"body": ("allegro", "embed", "stack"), "env": ("perlayer",), "flat": ("flat",),
             "nequip": ("nequip",)}
    for path in paths[which]:
        with env_vars(PATHS[path][5]):
            cfg, params, system, eng = build_path(path)
            if path == "allegro":
                k1_timings(cfg, params, system, eng, dict(zero))
            elif path == "embed":
                er_timings(cfg, params, system, eng, {"K6": dict(zero), "K7": dict(zero)})
            elif path == "stack":
                stack_timings(cfg, params, system, eng, dict(zero))
            elif path == "flat":
                k4_timings(cfg, params, system, eng, dict(zero))
            elif path == "nequip":
                k3_timings(cfg, params, system, eng, dict(zero))
            else:
                env_timings(cfg, params, system, eng, {m: dict(zero) for m in ENV_MODES})
        del cfg, params, system, eng
        torch.cuda.empty_cache()
    return 0


def kernel_entry(name, source, replaces, counts, kind, err, r, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[kind], "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--profile"]:
        model = sys.argv[2] if len(sys.argv) > 2 else "allegro"
        integrator = sys.argv[3] if len(sys.argv) > 3 else "nve"
        if model == "scale":
            return profile_scale()
        if model not in PATHS or model == "nequip-flat":
            raise SystemExit(f"--profile takes allegro, nequip, perlayer, perlayer-mxu, flat, embed, "
                             f"stack, allegro-chunked or scale, not {model}")
        if integrator not in ("nve", "nvt"):
            raise SystemExit(f"--profile's integrator is nve or nvt, not {integrator}")
        return profile_steps(model, integrator)
    if sys.argv[1:2] == ["--timings"]:
        which = sys.argv[2] if len(sys.argv) > 2 else ""
        if which not in TIMINGS:
            raise SystemExit(f"--timings takes body, env, flat or nequip, not {which!r}")
        return timings(which)
    if sys.argv[1:2] == ["--scale"]:  # phase 5 (for its steps/s) and phase 17 alone
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        libs = {id(m.LIB): m.LIB for m in kernel_modules().values()}.values()
        for lib in libs:
            lib.start()
        for lib in libs:
            lib.load()
        main_path("allegro")
        scale_phase(card)
        return 0
    if sys.argv[1:2] == ["--train"]:  # phase 18 alone
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        for name in ("K1", "K3"):
            kernel_modules()[name].LIB.start()
        for name in ("K1", "K3"):
            kernel_modules()[name].LIB.load()
        train_phase(card)
        return 0
    if sys.argv[1:2] == ["--k3-spread"]:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0])
        from pair_allegro_tpu_torch.ops import nequip_conv

        lib = nequip_conv.LIB.load()
        for line in nequip_conv.LIB.paths()[1].read_text().splitlines():
            if "registers" in line or "Function properties for" in line or "spill" in line:
                print("ptxas K3:", line.strip())
        del lib
        k3_seed_spread(int(sys.argv[2]) if len(sys.argv) > 2 else 20)
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = {}
    for name, mod in kernel_modules().items():  # K6 and K7 share one library
        libs.setdefault(id(mod.LIB), (name, mod.LIB))
    libs = list(libs.values())
    for _, lib in libs:
        lib.start()  # one nvcc per source, all started together
    for name, lib in libs:
        lib.load()
        print(f"{name} build: nvcc {lib.build_seconds or 0.0:.1f} s, all builds + load "
              f"{time.perf_counter() - t0:.1f} s")
        for line in lib.paths()[1].read_text().splitlines():
            if "registers" in line or "Function properties for" in line or "spill" in line:
                print(f"ptxas {name}:", line.strip())

    from pair_allegro_tpu_torch.engine import AllegroEngine

    cfg, params, system = make_case(5, None)
    errs = k1_parity(cfg, params, system, AllegroEngine(cfg, params, system))
    errs3 = k3_parity()
    errs_env = env_parity()
    model_parity()
    perlayer_model_parity()
    nequip_model_parity()
    errs4 = k4_parity()
    flat_model_parity()
    errs_er = er_parity()
    model_parity({"PAT_L1_EMBED": "1"}, {"K6": 1, "K1": 1, "K7": 1})
    model_parity({"PAT_L1_POSITIONAL": "0"})
    errs8 = stack_parity()
    model_parity(want={"K8": 1}, tier=dict(fused_stack=True))
    f64_parity()
    cfg, params, system, eng, counts = main_path("allegro")
    counts = counts["K1"]
    times = k1_timings(cfg, params, system, eng, errs)
    del cfg, params, system, eng
    torch.cuda.empty_cache()
    ncfg, nparams, nsystem, neng, counts3 = main_path("nequip")
    counts3 = counts3["K3"]
    times3, errs3 = k3_timings(ncfg, nparams, nsystem, neng, errs3)
    del nparams, nsystem, neng
    torch.cuda.empty_cache()
    pcfg, pparams, psystem, peng, counts2 = main_path("perlayer")
    counts2 = counts2["K2"]
    times_env = env_timings(pcfg, pparams, psystem, peng, errs_env)
    del pparams, psystem, peng
    torch.cuda.empty_cache()
    counts5 = main_path("perlayer-mxu")[-1]["K5"]
    torch.cuda.empty_cache()
    fcfg, fparams, fsystem, feng, counts4 = main_path("flat")
    counts4 = counts4["K4"]
    b_ms, b_gib = rebuild_ms(fsystem, feng)
    print(f"flat main path: one dense rebuild {b_ms:.3f} ms wall, peak {b_gib:.2f} GiB above the "
          f"resident tensors; the engine's regrow check counts "
          f"{regrow_gib(feng, fsystem):.2f} GiB for a rebuild and force evaluation")
    times4, errs4 = k4_timings(fcfg, fparams, fsystem, feng, errs4)
    del fparams, fsystem, feng
    torch.cuda.empty_cache()
    main_path("nequip-flat")
    torch.cuda.empty_cache()
    ecfg, eparams, esystem, eeng, counts_e = main_path("embed")
    times_er, errs_er = er_timings(ecfg, eparams, esystem, eeng, errs_er)
    del eparams, esystem, eeng
    torch.cuda.empty_cache()
    scfg, sparams, ssystem, seng, counts_s = main_path("stack")
    times8, errs8 = stack_timings(scfg, sparams, ssystem, seng, errs8)
    del sparams, ssystem, seng
    torch.cuda.empty_cache()
    accuracy_phase()
    card = smi.stdout.strip().splitlines()[0]
    cli_phase(card)
    counts17, _ = scale_phase(card)
    train_phase(card)

    kernels = []
    for kind, line in (("fwd", 1094), ("bwd", 1139)):
        per = {f: times[(f, kind)] for f in FORMS}
        # one call of each form: the kernel's time per force evaluation
        total = {key: sum(r[key] for r in per.values())
                 for key in ("ms", "plain_ms", "bound_ms")}
        total["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in per.values())
                             else "bytes")
        kernels.append(kernel_entry(
            f"k1_fused_layer_{kind}", "pair_allegro_tpu_torch/csrc/fused_layer.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts, kind, errs[kind], total,
            ms_by_form={f: r["ms"] for f, r in per.items()},
            plain_ms_by_form={f: r["plain_ms"] for f, r in per.items()},
            bound_ms_by_form={f: r["bound_ms"] for f, r in per.items()},
            scale_path_launches=counts17["K1"][0 if kind == "fwd" else 1],
        ))
    for kind, line in (("fwd", 289), ("bwd", 401)):
        # one call (one message-passing layer); num_layers calls per force evaluation
        kernels.append(kernel_entry(
            f"k3_nequip_conv_{kind}", "pair_allegro_tpu_torch/csrc/nequip_conv.cu",
            f"pair_allegro_tpu/ops/pallas_nequip.py:{line}", counts3, kind, errs3[kind],
            times3[kind], per="call", calls_per_force_evaluation=ncfg.num_layers,
            edge_tile=times3[kind]["edge_tile"], weight_resident=times3[kind]["weight_resident"],
        ))
    for kind, line in (("fwd", 803), ("bwd", 823)):
        # one call (one layer); num_layers calls per force evaluation
        kernels.append(kernel_entry(
            f"k2_env_layer_{kind}", "pair_allegro_tpu_torch/csrc/env_layer.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts2, kind,
            errs_env["paths"][kind], times_env[("paths", kind)], per="call",
            calls_per_force_evaluation=pcfg.num_layers,
        ))
    k5_modes = ENV_MODES[1:]
    for kind, line in (("fwd", 1913), ("bwd", 1946)):
        # mxu_highest, the mode of the K5 run; every mode by name beside it
        kernels.append(kernel_entry(
            f"k5_env_layer_mxu_{kind}", "pair_allegro_tpu_torch/csrc/env_layer_mxu.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts5, kind,
            errs_env["mxu_highest"][kind], times_env[("mxu_highest", kind)], per="call",
            calls_per_force_evaluation=pcfg.num_layers, mode="mxu_highest",
            max_abs_err_by_mode={m: errs_env[m][kind] for m in k5_modes},
            library_ms=times_env[("mxu_highest", kind)]["library_ms"],
            **{f"{key}_by_mode": {m: times_env[(m, kind)][key] for m in k5_modes}
               for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        ))
    for kind, line in (("fwd", 117), ("bwd", 153)):
        # one call (one layer); num_layers calls per force evaluation
        kernels.append(kernel_entry(
            f"k4_tp_mix_fused_{kind}", "pair_allegro_tpu_torch/csrc/tp_mix_fused.cu",
            f"pair_allegro_tpu/ops/pallas_tp.py:{line}", counts4, kind, errs4[kind], times4[kind],
            per="call", calls_per_force_evaluation=fcfg.num_layers, edge_tile=times4[kind]["tile"],
        ))
    for kind, line6, line7 in (("fwd", 1404, 1538), ("bwd", 1439, 1572)):
        # one call each (the first and the last layer) per force evaluation
        for name, stem, line in (("K6", "k6_embed_layer", line6), ("K7", "k7_readout_layer", line7)):
            kernels.append(kernel_entry(
                f"{stem}_{kind}", "pair_allegro_tpu_torch/csrc/embed_readout_layer.cu",
                f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts_e[name], kind,
                errs_er[name][kind], times_er[(name, kind)], per="call",
                calls_per_force_evaluation=1, k1_launches_on_the_path=counts_e["K1"][kind],
            ))
    for kind, line in (("fwd", 538), ("bwd", 572)):
        # one call (the whole stack) per force evaluation
        kernels.append(kernel_entry(
            f"k8_fused_stack_{kind}", "pair_allegro_tpu_torch/csrc/fused_stack.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts_s["K8"], kind, errs8[kind],
            times8[kind], per="call", calls_per_force_evaluation=1, layers=scfg.num_layers,
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
