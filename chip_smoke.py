#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pair_allegro_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; the builds of K1 (csrc/fused_layer.cu),
     K3 (csrc/nequip_conv.cu), K2 (csrc/env_layer.cu), K5
     (csrc/env_layer_mxu.cu), K4 (csrc/tp_mix_fused.cu), K6 / K7
     (csrc/embed_readout_layer.cu), K8 (csrc/fused_stack.cu) and the bf16
     builds of K1, K2 (csrc/fused_layer_bf16.cu, csrc/env_layer_bf16.cu),
     K3 (csrc/nequip_conv_bf16.cu, a bf16 hj), K6 / K7
     (csrc/embed_readout_layer_bf16.cu) and K8 (csrc/fused_stack_bf16.cu),
     and the bf16x3 and one-pass builds of K1, K6 / K7, K8, K2, K4 and K3
     (K3 with an f32 and a bf16 hj) on f32 operands (csrc/*_bf16x3.cu,
     csrc/*_onepass.cu: the precision policy's kernel_high / high and
     default modes), with nvcc for sm_90a, as many
     at once as the host has cores, K1's first; phases 2-14 start once
     K1's is built, each other library loads at its first use, and every
     build's ptxas report prints after phase 14;
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
     dE/atom printed); mxu_bf16 is printed, not gated; the fast bf16 tiers
     of phase 20 (the K1 tier, its embed/readout form, the stack and the
     per-layer paths tier at interior="bf16", NequIP under
     PAT_NEQUIP_HJ=bf16) gated at twice the
     distance from the same oracle of the port's CPU path at that setting
     (f32 positions, the same bf16 casts), both distances printed;
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
     (equal to it exactly) and ``cli run`` (20 NVE steps, K1 its count);
 19. the multi-device engines with 4 shards sharing the card, at full
     width: the C++ host runtime built (``native.available()``); the
     replicated engine (``ShardedAllegroEngine``) against AllegroEngine on
     the K1 and per-layer (K2) tiers, and the halo engine (4 z-slabs of
     ~9.9 A, one hop) on the K1 tier: max|dF| <= 1e-5 eV/A, energy within
     1e-6 relative, exactly 4 x 3 launches each way an evaluation; the
     replicated engine at 2 shards on a 256-atom box that takes the dense
     strategy, the same gates with 2 x 3 K4 launches; the halo
     engine's NVE run with migration against AllegroEngine's on the same
     run (40 + 40 steps in chunks of 5: steps/s of both and phase 5's,
     migrations, regrows, the energy drift, K1 12 / 12 an evaluation; the
     final positions, taken back to the original order through
     ``atom_perm``, and the last etotal against the single engine's);
     ShardedNequIPEngine against NequIPEngine (K3) within 5e-4
     eV/A, with no K3 launch; data-parallel gradients (a batch of 4 frames
     over 2 shards) within 1e-3 of each leaf's max of the unsharded batch's;
     ``cli run --device cuda:0`` with ``sharding: {n_devices: 1}`` and
     ``{n_devices: 4, mode: halo}`` (the card counted 4 times) and ``cli
     train`` with ``sharding: {n_devices: 1}``; a second process with PAT_COMPILE_CACHE
     loading every library from a copy of this run's builds with no nvcc
     (or host compiler) run.
 20. the bf16 tiers (run before phase 15, which gates them too): K1's
     bf16 build (interior="bf16") in its three forms, K2's at l_max 2 and 1
     with parity, K3's bf16-hj build (PAT_NEQUIP_HJ=bf16) at (l_max,
     tracks) in {1, 2} x {1, 2}, K6's and K7's (K7 with and without the
     charge head) and K8's (3 layers at l_max 2 and 1, 1 and 2 layers),
     forward and backward on the 500-atom table, each against its plain
     version fed the same bf16-rounded inputs and weights at f32 with the
     outputs rounded to bf16 (BF16_TOLS; K3's f32 outputs within TOLS; K8's
     plain version rounds x and V to bf16 between the layers, as the
     build's stores do: ``fused_stack.stack_rounded_reference``); K1's
     and K8's bf16 builds also reproduce the share of their plain
     version's departure from the same with f32 constants, JAX's weak
     typing rounding them (``constants_share``, with a control); the K1
     tier, its embed/readout form, the stack and the per-layer paths tier
     at interior="bf16" on the card and at bf16 on the CPU, each against
     the CPU f32 path (the card within twice the CPU's distance; the bf16
     launches only); phase 5's run at interior="bf16" (3 + 3 K1-bf16
     launches per force evaluation and no other kernel), the per-layer
     paths tier at bf16 (3 + 3 K2-bf16), phase 6's run under
     PAT_NEQUIP_HJ=bf16 (3 + 3 K3-bf16), the embed/readout form at bf16
     (embed-bf16: 1 K6-bf16, 1 K1-bf16, 1 K7-bf16 each way) and the stack
     at bf16 (stack-bf16: 1 + 1 K8-bf16), 60 + 60 steps each, their steps/s
     and peak memory beside their f32 paths'; the bf16 builds' timings and
     parity at those paths' shapes, with bounds at the bf16 tensor-core
     rate and 2-byte numbers, beside their plain versions' times at bf16.
 21. the matmul precision policy (ops/prec.py; run after phase 14, and
     every other phase runs under 'highest': the 3xTF32 builds and exact
     f32 glue): the bf16x3 and one-pass builds of K1 (three forms), K6
     (also under PAT_EMBED_PREC=highest), K7 (charge head) and K8 (3
     layers) on the 500-atom table, K2 (the per-layer tier's second layer)
     and K3 (f32 and bf16 hj) there at l_max 2 and 1, and K4 on a
     256-atom dense build at l_max 2 and 1 (all edges and a tail that is no
     multiple of any edge tile), each under its policy (kernel_high,
     default) against its plain version at its mode (prec.kmm), forward
     and backward, one launch each way of that build and no other; the
     bf16x3 builds within TOLS and reproducing 0.75-1.25 of the bf16x3
     plain version's departure from the 3xTF32 one (``mode_share``), the
     one-pass builds within MODE_TOLS; the controls must fail: the 3xTF32
     build's share, the one-pass build against the bf16x3 gate and against
     TOLS on the 3xTF32 plain version; the glue leg (a make_potential
     evaluation on cuBLAS: TF32-size error forward and backward under
     'high', f32 under 'highest' and after the context, exact_mm exact);
     the K1, embed, stack, per-layer (K2), FLAT slab (K4), NequIP (K3) and
     NequIP bf16-hj main paths under kernel_high (the default policy: 3 + 3
     K1-bf16x3; 1 K6-bf16x3, 1 K1-bf16x3, 1 K7-bf16x3; 1 + 1 K8-bf16x3;
     3 + 3 K2-bf16x3, K4-bf16x3, K3-bf16x3, K3hj-bf16x3 launches per force
     evaluation and no other kernel) and under default (the one-pass
     builds), 60 + 60 steps each, steps/s beside phases 5, 6, 8, 10, 12
     and 14's (and 20's bf16-hj path) under 'highest'; the new builds'
     timings and parity at those paths' shapes (K2, K4 and K3 beside their
     3xTF32 builds timed alternately in the same call; bounds: three bf16
     passes at 989 TFLOP/s for bf16x3, one for one-pass).  Phase 15 runs
     its tiers under 'highest' and 'kernel_high' (the K1, K2, K3, K4, K6,
     K7 and K8 launches the policy's builds), gated at 1e-4 eV/A, and one tier each
     under 'mixed', 'high' and 'default' (every tier with --policy), within
     the largest gate of the fast bf16 tiers (twice their CPU paths'
     distance).
A "phase clock" line after each phase gives its wall seconds.
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
``--scale`` runs phase 5 and phase 17 alone, ``--train`` phase 18 alone, ``--sharded``
phase 19 alone, ``--policy`` phase 21 (with the 'highest' runs of its
paths) and 15 (the precision policy); ``--profile scale`` prints
where one steady 1,000,188-atom force evaluation's device time goes;
``--profile allegro-chunked`` profiles phase 5's step in 4 windows;
``--k3-spread [n]`` prints K3's backward error (and the plain f32
version's) against the plain version at f64 over n cotangent seeds on
the card leg's 768-wide case.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

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


def k1_cost(w, e, k, form, bwd, nb=4):
    """(flops, bytes) one K1 call needs at E edge slots (``k1_terms``;
    ``nb`` bytes a number: 4 at f32, 2 for the bf16 build, whose
    activations and packed weights are bf16; weights included)."""
    per, io_in, io_out = k1_terms(w, form, bwd)
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, nb * ((io_in + io_out) * e + n_w)


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


def bounds(flops, prod, nbytes, prod_rate=PEAK_TF32_FLOPS / 3):
    """The least time of a call with ``flops`` operations, ``prod`` of them
    in small products, moving ``nbytes``: on the tensor cores (``bound_ms``:
    the products at ``prod_rate``, PEAK_TF32_FLOPS / 3 for the 3xTF32
    kernels and PEAK_BF16_FLOPS for the bf16 builds, and the rest at the f32
    rate, the larger of the two, since the tensor and the f32 pipes run
    side by side) and on the CUDA cores alone (``bound_ms_f32``: every flop
    at the f32 rate); each the larger of its operations' time and the
    bytes' time."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_tc = max(prod / prod_rate, (flops - prod) / PEAK_F32_FLOPS) * 1e3
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


def k6_cost(w, e, bwd, nb=4):
    """(flops, bytes) one K6 call needs at E edge slots: K1's first form
    (``k1_terms``) with the prologue x = MLP2b(in) * u, pT = W_te^T x /
    sqrt(ns) (the backward adds its recompute, the two-body MLP's backward,
    W_te dpT and the du and dx * u terms); the input rows in place of x and
    pT, d(in) in place of dx and dpT (``nb`` bytes a number: 4 at f32, 2 for
    the bf16 build; weights included)."""
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
    return per * e, nb * ((io_in + swap + io_out) * e + n_w)


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


def k7_cost(w, e, bwd, nb=4):
    """(flops, bytes) one K7 call needs at E edge slots: K1's last form
    (``k1_terms``) with the heads head(x') * u as epilogue (the backward adds
    x' and the heads' forward, their backward and du); the heads' rows in
    place of x' (forward), their cotangents in place of dx' (backward)
    (``nb`` bytes a number, as ``k6_cost``; weights included)."""
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
    return per * e, nb * ((io_in + io_out) * e + n_w)


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
    # phase 20: the bf16 tiers (K1's and K2's bf16 builds at interior="bf16",
    # K3's bf16-hj build under PAT_NEQUIP_HJ=bf16)
    "allegro-bf16": ("allegro", dict(interior="bf16"), "K1-bf16", 60, False, {}),
    "perlayer-bf16": ("allegro", dict(layer_fused=False, interior="bf16"), "K2-bf16", 60, False,
                      {}),
    "nequip-hj-bf16": ("nequip", {}, "K3-bf16", 60, False, {"PAT_NEQUIP_HJ": "bf16"}),
    # K6's, K7's and K8's bf16 builds: the embed/readout form and the stack
    # at interior="bf16"
    "embed-bf16": ("allegro", dict(interior="bf16"), "K6-bf16", 60, False, {"PAT_L1_EMBED": "1"}),
    "stack-bf16": ("allegro", dict(fused_stack=True, interior="bf16"), "K8-bf16", 60, False, {}),
    # phase 21: the K1, embed, stack, per-layer, FLAT slab, NequIP and
    # NequIP bf16-hj paths under the precision policies kernel_high (the
    # default: the bf16x3 builds) and default (the one-pass builds), run
    # under POLICY_PATHS' policy
    **{f"{path}-{b}": (m, tier, f"{kern}-{b}", 60, slab, env)
       for path, (m, tier, kern, slab, env) in (
           ("allegro", ("allegro", {}, "K1", False, {})),
           ("embed", ("allegro", {}, "K6", False, {"PAT_L1_EMBED": "1"})),
           ("stack", ("allegro", dict(fused_stack=True), "K8", False, {})),
           ("perlayer", ("allegro", dict(layer_fused=False), "K2", False, {})),
           ("flat", ("allegro", {}, "K4", True, {})),
           ("nequip", ("nequip", {}, "K3", False, {})),
           ("nequip-hj", ("nequip", {}, "K3hj", False, {"PAT_NEQUIP_HJ": "bf16"})))
       for b in ("bf16x3", "1pass")},
}
# phase 21's paths, each with its 'highest' path (whose steps/s it prints
# beside its own) and the kernel whose builds it times
POLICY_BASE = {"allegro": ("allegro", "K1"), "embed": ("embed", "K6"), "stack": ("stack", "K8"),
               "perlayer": ("perlayer", "K2"), "flat": ("flat", "K4"),
               "nequip": ("nequip", "K3"), "nequip-hj": ("nequip-hj-bf16", "K3hj")}
# the policy each phase-21 path runs under (the others: the script's,
# "highest")
POLICY_PATHS = {f"{path}-{b}": pol for path in POLICY_BASE
                for b, pol in (("bf16x3", "kernel_high"), ("1pass", "default"))}
# the paths that run the million-atom mode's windows: rows per window
ROW_CHUNK = {"allegro-chunked": 1331}
# steps/s and the timed chunk's peak device memory (GiB) of each main path
# run in this process (phases 17 and 20 read phase 5's and 6's)
STEPS_PER_S = {}
PEAK_GIB = {}


def path_launches(path, cfg):
    """{kernel: launches per force evaluation, forward and backward alike}
    of a main path; every other kernel must launch no time."""
    kernel = PATHS[path][2]
    if path.startswith("embed"):
        b = kernel[len("K6"):]  # the build's suffix
        return {"K6" + b: 1, "K1" + b: cfg.num_layers - 2, "K7" + b: 1}
    if path.startswith("stack"):
        return {kernel: 1}
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
    """{kernel id: its wrapper module}, each with ``launches`` and ``LIB``;
    the bf16 builds as 'K1-bf16', 'K2-bf16', 'K3-bf16', 'K6-bf16',
    'K7-bf16' and 'K8-bf16' (K6's and K7's in one library); the f32 builds
    of the policy's other product modes (phase 21) as 'K1-bf16x3',
    'K1-1pass', and so on for K6, K7, K8, K2, K4 and K3, and K3's with a
    bf16 hj as 'K3hj-bf16x3' and 'K3hj-1pass' (its 3xTF32 one is
    'K3-bf16')."""
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
            "K4": tp_mix_fused, "K6": embed_layer, "K7": readout_layer, "K8": fused_stack,
            # the bf16 builds, counted apart (their wrappers' launches_bf16)
            **{f"{name}-bf16": SimpleNamespace(launches=mod.launches_bf16, LIB=mod.LIB_BF16)
               for name, mod in (("K1", fused_layer), ("K2", env_layer), ("K3", nequip_conv),
                                 ("K6", embed_layer), ("K7", readout_layer),
                                 ("K8", fused_stack))},
            # the bf16x3 and one-pass builds on f32 operands, counted apart
            **{f"{name}-{b}": SimpleNamespace(launches=getattr(mod, f"launches_{attr}"),
                                             LIB=getattr(lib_of, f"LIB_{attr.upper()}"))
               for name, mod, lib_of in (("K1", fused_layer, fused_layer),
                                         ("K6", embed_layer, embed_layer),
                                         ("K7", readout_layer, embed_layer),
                                         ("K8", fused_stack, fused_stack),
                                         ("K2", env_layer, env_layer),
                                         ("K4", tp_mix_fused, tp_mix_fused),
                                         ("K3", nequip_conv, nequip_conv))
               for b, attr in (("bf16x3", "bf16x3"), ("1pass", "onepass"))},
            **{f"K3hj-{b}": SimpleNamespace(launches=getattr(nequip_conv, f"launches_bf16_{attr}"),
                                            LIB=getattr(nequip_conv, f"LIB_BF16_{attr.upper()}"))
               for b, attr in (("bf16x3", "bf16x3"), ("1pass", "onepass"))}}


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
    from pair_allegro_tpu_torch.ops.prec import get_precision_policy, matmul_precision

    with env_vars(PATHS[path][5]), matmul_precision(POLICY_PATHS.get(path,
                                                                      get_precision_policy())):
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
    PEAK_GIB[path] = peak
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


def k1_timings(cfg, params, system, eng, errs, prod_rate=None, tag="K1", tols=None):
    """Phase 5: per-form fwd/bwd time of kernel and plain version at the
    main path's shapes, with the bound; the kernel's results at these
    shapes are held against the plain version's too (into ``errs``).  The
    build and the plain version's products follow the policy in force
    (phase 21: ``tag`` names the build, ``prod_rate`` its product rate for
    the bound, by default 3xTF32's, ``tols`` its parity gate, by default
    TOLS)."""
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
        tol = tols or TOLS
        errs["fwd"] = max(errs["fwd"], check(tag, label, "fwd", K1_NAMES,
                                             (out_k,) if last else out_k, outs, tol["fwd"]))
        g_r = torch.autograd.grad(outs, ins, cots)
        errs["bwd"] = max(errs["bwd"], check(tag, label, "bwd", K1_NAMES, g_k, g_r, tol["bwd"]))
        del out, outs, ins, out_k, g_k, g_r
        torch.cuda.empty_cache()
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            bwd = kind == "bwd"
            flops, nbytes = k1_cost(w, e, k, form, bwd)
            res[(form, kind)] = timing(ms, pms, flops, k1_products(w, form, bwd) * e, nbytes,
                                       k1_weight_bytes(w, form, bwd, n_tiles(e, k)),
                                       prod_rate or PEAK_TF32_FLOPS / 3)
            print_timing(f"{tag} {kind} {form:6s} E={e}", res[(form, kind)])
    return res


def timing(ms, pms, flops, prod, nbytes, weight_bytes, prod_rate=PEAK_TF32_FLOPS / 3):
    """A kernel row: its time, its plain version's, both bounds
    (``bounds``), and the weights its tiles stage from L2 (computed)."""
    return dict(ms=ms, plain_ms=pms, **bounds(flops, prod, nbytes, prod_rate),
                gflop=flops / 1e9, mbytes=nbytes / 1e6, staged_weight_mb=weight_bytes / 1e6)


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


def k2_cost(w, e, bwd, nb=4):
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
    return per * e, nb * ((ins + outs) * e + n_w)


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


def pair_compare(kernel, label, calls, ops, names, gen, outs=None, tols=None):
    """A kernel's wrapper against its plain version on ``ops``, forward and
    backward (random cotangents), within ``tols`` (by default TOLS);
    ``outs`` names the outputs (by default K6's or K7's); returns the max
    abs errors."""
    import torch

    fn, ref = calls
    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k, out_r = _tup(fn(*ins)), _tup(ref(*ins))
    cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in out_r]
    g_k = torch.autograd.grad(out_k, ins, cots)
    g_r = torch.autograd.grad(out_r, ins, cots)
    torch.cuda.synchronize()
    outs = outs or (("x'", "V'") if kernel == "K6" else ("e", "q")[:len(out_r)])
    tols = tols or TOLS
    errs = {"fwd": check(kernel, label, "fwd", outs, out_k, out_r, tols["fwd"]),
            "bwd": check(kernel, label, "bwd", names, g_k, g_r, tols["bwd"])}
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


def er_timings(cfg, params, system, eng, errs, prod_rate=None, suffix="", tols=None):
    """Phase 12 (K6, K7): fwd/bwd time of kernel and plain version at the
    embed main path's shapes, with the bound, and parity at those shapes
    (into ``errs``); under the policy in force (phase 21: ``suffix`` names
    the build, ``prod_rate`` its product rate, as ``k1_timings``)."""
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
        e2 = pair_compare(name + suffix, f"embed main path E={e}", calls[name], ops, names, gen,
                          outs=(("x'", "V'") if name == "K6" else ("e", "q")[:cfg.output_charges + 1]),
                          tols=tols)
        errs[name] = {kind: max(errs[name][kind], e2[kind]) for kind in e2}
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            bwd = kind == "bwd"
            flops, nbytes = cost(w, e, bwd)
            r = res[(name, kind)] = timing(ms, pms, flops, prods(w, bwd) * e, nbytes,
                                           wbytes(w, bwd, n_tiles(e, k)),
                                           prod_rate or PEAK_TF32_FLOPS / 3)
            print_timing(f"{name}{suffix} {kind} E={e}", r)
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


def k8_cost(w, e, bwd, nb=4):
    """(flops, bytes) one K8 call needs at E edge slots: per layer K1's
    terms for that layer's form (``k1_terms``: the first builds V0, the
    last has no mix), with the forward's per-layer values taken as known to
    the backward (the kernel's recompute of layers 0 .. L-2 is not
    counted); the stack's own rows read and written once: x0, pT, Y, u
    (and dx_final) in, x_final (or dx0, dpT, dY, du) out (``nb`` bytes a
    number, as ``k6_cost``; weights included)."""
    n_l = len(w.k1)
    per = sum(k1_terms(lw, (li == 0, li == n_l - 1), bwd)[0] for li, lw in enumerate(w.k1))
    ns, c = w.k1[0].dims[:2]
    d = (w.lmax + 1) ** 2
    rows_in = ns + c + d + 1 + (ns if bwd else 0)
    rows_out = ns + c + d + 1 if bwd else ns
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, nb * ((rows_in + rows_out) * e + n_w)


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
# the fast bf16 tiers (phase 20's builds): (label, model, config fields,
# environment, launches per force evaluation); each gated at twice the
# distance from the f64 oracle of the port's CPU path at the same setting
# (f32 positions, the same bf16 casts), not at 1e-4
BF16_ACCURACY_TIERS = (("K1 tier, interior bf16", "allegro", dict(interior="bf16"), {},
                        {"K1-bf16": 3}),
                       ("embed path, interior bf16", "allegro", dict(interior="bf16"),
                        {"PAT_L1_EMBED": "1"}, {"K6-bf16": 1, "K1-bf16": 1, "K7-bf16": 1}),
                       ("stack path, interior bf16", "allegro",
                        dict(fused_stack=True, interior="bf16"), {}, {"K8-bf16": 1}),
                       ("per-layer paths, interior bf16", "allegro",
                        dict(layer_fused=False, interior="bf16"), {}, {"K2-bf16": 3}),
                       ("NequIP, hj bf16", "nequip", {}, {"PAT_NEQUIP_HJ": "bf16"},
                        {"K3-bf16": 3}))


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


# phase 15's tier for each policy with TF32 glue, where the glue's error
# hides the kernels' mode (``accuracy_phase(every_tier=True)`` runs them all)
GLUE_POLICY_TIERS = {"mixed": "K1 tier", "high": "embed path", "default": "stack path"}


def accuracy_phase(every_tier=False):
    """Phase 15: the accurate tier's force gate on benchmarks/accuracy.py's
    fixture: each tier of ACCURACY_TIERS at f32 on the card against the
    port's plain path of the same model at f64 on the CPU (the oracle,
    which matches JAX to 1e-10 in the CPU tests), under each matmul
    precision policy (every launch but K5's is the policy's build):
    under 'highest' and 'kernel_high' max|dF| <= 1e-4 eV/A on every
    tier, under 'mixed', 'high' and 'default' (on GLUE_POLICY_TIERS' tier
    unless ``every_tier``) within the bf16 model gate (the largest of the
    fast bf16 tiers' gates below, each twice its CPU path's distance), with
    rms|dF| and dE/atom printed; a tier marked not gated is printed only.
    Returns {(policy, label): max|dF|}."""
    import torch

    from pair_allegro_tpu_torch.ops.prec import kernel_mode, matmul_precision

    mods = kernel_modules()
    refs = {}
    for model, slab in (("allegro", False), ("allegro", True), ("nequip", False)):
        ref_sys, ref_eng = _accuracy_engine(model, {}, "cpu", torch.float64, slab)
        ref = ref_eng.force_fn(ref_sys, ref_eng.rebuild_fn(ref_sys, None))
        refs[model, slab] = ref.forces.double(), float(ref.total_energy), ref_eng.spec.strategy
    n = ref_sys.n_atoms
    worst = {}
    bf16_gate = 0.0
    for label, model, tier, env, want in BF16_ACCURACY_TIERS:
        f_ref = refs[model, False][0]
        dist = {}
        with env_vars(env):
            for dev in ("cuda", "cpu"):
                system, eng = _accuracy_engine(model, tier, dev, torch.float32, False)
                nb = eng.rebuild_fn(system, None)
                for m in mods.values():
                    m.launches.reset()
                out = eng.force_fn(system, nb)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launched = {name: (m.launches.fwd, m.launches.bwd) for name, m in mods.items()
                                if m.launches.fwd or m.launches.bwd}
                df = out.forces.double().cpu() - f_ref
                dist[dev] = (float(df.abs().max()), float(df.norm(dim=1).pow(2).mean().sqrt()))
        gate = 2.0 * dist["cpu"][0]
        bf16_gate = max(bf16_gate, gate)
        print(f"accuracy {label} ({n} perturbed FCC Cu atoms, f32 positions, against the CPU f64 "
              f"plain path): the card max|dF| {dist['cuda'][0]:.3e} eV/A (rms "
              f"{dist['cuda'][1]:.3e}), the port's CPU path at the same setting "
              f"{dist['cpu'][0]:.3e} (rms {dist['cpu'][1]:.3e}); gate max|dF| <= 2 x the CPU's "
              f"= {gate:.3e} eV/A (a fast tier: the accurate tiers' 1e-4 eV/A line is "
              f"{'met' if dist['cuda'][0] <= 1e-4 else 'not met'}); launches {launched}")
        if not dist["cuda"][0] <= gate:
            raise RuntimeError(f"accuracy gate failed on the {label}")
        if launched != {name: (k, k) for name, k in want.items()}:
            raise RuntimeError(f"accuracy {label}: launched {launched}, want {want}")
        worst["bf16", label] = dist["cuda"][0]
    for pol in POLICIES:
        exact = pol in ("highest", "kernel_high")
        with matmul_precision(pol):
            b = MODES[kernel_mode(torch.float32)][1]
            for label, model, tier, env, want, gated, slab in ACCURACY_TIERS:
                if not (exact or every_tier or GLUE_POLICY_TIERS[pol] == label):
                    continue
                want = {(k if k == "K5" else k + b): v for k, v in want.items()}
                f_ref, e_ref, strategy = refs[model, slab]
                with env_vars(env):
                    system, eng = _accuracy_engine(model, tier, "cuda", torch.float32, slab)
                    if eng.spec.strategy != strategy or (slab and strategy != "dense"):
                        raise RuntimeError(f"accuracy {label}: the {eng.spec.strategy} strategy "
                                           f"on the card, {strategy} on the CPU")
                    nb = eng.rebuild_fn(system, None)
                    for m in mods.values():
                        m.launches.reset()
                    out = eng.force_fn(system, nb)
                    torch.cuda.synchronize()
                    launched = {name: (m.launches.fwd, m.launches.bwd)
                                for name, m in mods.items() if m.launches.fwd or m.launches.bwd}
                df = out.forces.double().cpu() - f_ref
                mx = float(df.abs().max())
                rms = float(df.norm(dim=1).pow(2).mean().sqrt())
                de = abs(float(out.total_energy) - e_ref) / n
                gate = (1e-4 if exact else bf16_gate) if gated else None
                print(f"accuracy [{pol}] {label} ({n} perturbed FCC Cu atoms"
                      f"{', slab' if slab else ''}, f32 on the card against the CPU f64 plain "
                      f"path): max|dF| {mx:.3e} eV/A, rms|dF| {rms:.3e} eV/A, dE/atom {de:.3e} "
                      f"eV, max|F| {float(f_ref.abs().max()):.3f} eV/A "
                      f"({f'gate max|dF| <= {gate:.3e} eV/A' if gated else 'not gated'}); "
                      f"launches {launched}")
                if gated and not mx <= gate:
                    raise RuntimeError(f"accuracy gate failed on the {label} under {pol}")
                if launched != {name: (k, k) for name, k in want.items()}:
                    raise RuntimeError(f"accuracy {label} under {pol}: launched {launched}, "
                                       f"want {want}")
                worst[pol, label] = mx
    tiers = [t[0] for t in ACCURACY_TIERS]
    print("accuracy by policy (max|dF| eV/A against the f64 oracle): " + "; ".join(
        f"{pol}: " + ", ".join(f"{t} {worst[pol, t]:.3e}" for t in tiers if (pol, t) in worst)
        for pol in POLICIES))
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


def stack_timings(cfg, params, system, eng, errs, prod_rate=None, tag="K8", tols=None):
    """Phase 14 (K8): fwd/bwd time of kernel and plain version at the stack
    main path's shapes, with the bound, and parity at those shapes (into
    ``errs``); under the policy in force (phase 21, as ``k1_timings``)."""
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
    e2 = pair_compare(tag, f"stack main path E={e}", calls, ops, K8_NAMES, gen, outs=("x",),
                      tols=tols)
    errs = {kind: max(errs[kind], e2[kind]) for kind in errs}
    res = {}
    for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
        bwd = kind == "bwd"
        flops, nbytes = k8_cost(w, e, bwd)
        res[kind] = timing(ms, pms, flops, k8_products(w, bwd) * e, nbytes,
                           k8_weight_bytes(w, bwd, n_tiles(e, k)),
                           prod_rate or PEAK_TF32_FLOPS / 3)
        print_timing(f"{tag} {kind} E={e} ({cfg.num_layers} layers)", res[kind])
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

    from pair_allegro_tpu_torch import native
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
           "host_estimate_native": native.available(),
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
          f"{res['remat']}; host capacity estimate (host_neighbor_stats, C++ host runtime "
          f"{native.available()}) {t_est:.3f} s, "
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


def train_frames(path, cfg, tree, n=TRAIN_FRAMES):
    """Write ``n`` frames of jittered FCC Cu (TRAIN_REP^3 cells) labelled by the
    teacher ``tree`` (energy, forces and the quoted virial) on the engine's
    default tier (K1 on the card) to the extxyz file ``path``."""
    import numpy as np

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.io.extxyz import write_extxyz
    from pair_allegro_tpu_torch.models.allegro import allegro_params_from_numpy
    from pair_allegro_tpu_torch.system import System, fcc_lattice

    params = allegro_params_from_numpy(tree, cfg, device="cuda")
    frames = []
    for i in range(n):
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


def batch_grads(cfg, energy_fn, tree, frames, device, dtype, w_virial=0.0, mesh=None):
    """{leaf key: d(batch loss)/d(leaf)} as f64 numpy (zeros where the loss
    does not reach the leaf), of ``tree`` on ``device`` at ``dtype``; with
    ``mesh`` the batch is split over it (``data.shard_batch``)."""
    import numpy as np
    import torch

    from pair_allegro_tpu_torch.checkpoint import flatten, params_from_numpy
    from pair_allegro_tpu_torch.data import shard_batch, stack_frames
    from pair_allegro_tpu_torch.train import leaves, make_batched_loss_fn, make_loss_fn

    params = params_from_numpy(tree, cfg, device, dtype)
    tensors = leaves(params)
    for t in tensors:
        t.requires_grad_(True)
    loss_fn = make_batched_loss_fn(make_loss_fn(energy_fn, cfg.for_training(), w_virial=w_virial))
    batch = stack_frames(frames)
    loss, _ = loss_fn(params, batch if mesh is None else shard_batch(batch, mesh, "dp"))
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


# phase 19: the multi-device engines with SHARDS shards sharing the one card
SHARDS = 4
# halo NVE: 40 + 40 steps in chunks of 5.  The random weights heat the
# bulk (~3,400 K at step 80) and blow it up near step 85 (the
# single-device run's etotal jumps by ~2,800 eV within 5 steps): an atom
# then crosses the halo's margin within one chunk, which no re-sort can
# follow, so the run stops short of it
SHARD_STEPS, SHARD_CHUNK = 40, 5
SHARD_GATE_F, SHARD_GATE_E = 1e-5, 1e-6  # eV/A; relative
# the halo NVE run against the single engine's on the same protocol: the
# largest difference of an atom's final position (A) and the last etotal's
# relative difference.  An H100 read 6.1e-5 A and 1.1e-7 (f32 sums in
# another order, grown over 80 steps of a ~3,400 K bulk); a lost velocity
# or a wrong permutation moves atoms by tenths of an A or more
HALO_MD_GATE_X, HALO_MD_GATE_E = 1e-3, 1e-6


def shard_mesh(n, axis="atoms"):
    """n shards all on cuda:0."""
    from pair_allegro_tpu_torch.parallel import make_mesh

    return make_mesh(n, axis, devices="cuda:0")


def sharded_parity(card, mode, kernel="K1", n_rep=11, n_shards=SHARDS):
    """Phase 19a: the flagship Allegro on n_rep^3 FCC cells through the
    replicated (``mode`` "replicated") or halo engine at ``n_shards``
    shards on the card, against ``AllegroEngine`` on the same sorted
    system: energy, max|dF|, max|dW|, and the launches of one evaluation,
    exactly n_shards x 3 of ``kernel`` each way (K1 on the fused tier, K2
    on the per-layer tier, K4 where the box is small enough for the dense
    strategy).  Returns the numbers and (cfg, params, system, engine)."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.parallel import HaloShardedAllegroEngine, ShardedAllegroEngine

    cfg, params, system = make_case(n_rep, None, **({"layer_fused": False} if kernel == "K2"
                                                      else {}))
    cls = HaloShardedAllegroEngine if mode == "halo" else ShardedAllegroEngine
    system, _ = cls.prepare_system(system, n_shards)
    single = AllegroEngine(cfg, params, system, skin=0.4)
    o0 = single.force_fn(system, single.rebuild_fn(system, None))
    eng = cls(cfg, params, system, shard_mesh(n_shards), skin=0.4)
    nb = eng.rebuild_fn(system, None)
    eng.force_fn(system, nb)  # warm: the weight layouts of this tree
    torch.cuda.synchronize()
    reset_launches()
    o1 = eng.force_fn(system, nb)
    torch.cuda.synchronize()
    counts = launched_now()
    want = {kernel: (n_shards * cfg.num_layers,) * 2}
    e0, e1 = float(o0.total_energy), float(o1.total_energy)
    res = {"mode": mode, "tier": kernel, "strategy": eng.spec.strategy, "shards": n_shards,
           "atoms": system.n_atoms, "energy": e1, "energy_single": e0,
           "rel_dE": abs(e1 - e0) / abs(e0), "max_abs_dF": max_err(o1.forces, o0.forces),
           "max_abs_dW": max_err(o1.virial, o0.virial), "launches": counts}
    extra = ""
    if mode == "halo":
        res.update(hops=eng.hops, n_ext=eng.n_ext, cov_min=eng.cov_min, K=eng.max_neighbors)
        extra = (f", {eng.hops} hop(s), n_ext {eng.n_ext}, coverage {eng.cov_min:.3f} A, "
                 f"K {eng.max_neighbors}")
    print(f"sharded {mode} ({kernel} tier, {eng.spec.strategy} strategy, {card}): "
          f"{system.n_atoms} atoms in {n_shards} shards on one device{extra}; E {e1:.6f} eV "
          f"against {e0:.6f} (rel {res['rel_dE']:.3e}, gate {SHARD_GATE_E:g}), max|dF| "
          f"{res['max_abs_dF']:.3e} eV/A (gate {SHARD_GATE_F:g}), max|dW| "
          f"{res['max_abs_dW']:.3e} eV; launches fwd/bwd of one evaluation {counts} "
          f"(want {want}); overflow {bool(nb.overflow)}")
    if not (res["max_abs_dF"] <= SHARD_GATE_F and res["rel_dE"] <= SHARD_GATE_E
            and counts == want and not bool(nb.overflow)):
        raise RuntimeError(f"sharded {mode} ({kernel}) parity or launch gate failed: {res}")
    del single, o0, o1, nb
    torch.cuda.empty_cache()
    return res, (cfg, params, system, eng)


def _md_rate(eng, system, steps, chunk, migrate):
    """NVE at 2 fs from 50 K through ``eng``: a warmup run of ``steps``, then
    a timed run of ``steps``, in chunks of ``chunk``.  Returns (simulation,
    rows of the timed run, its wall seconds, its force evaluations, its
    launches, migrations and regrows before it)."""
    import torch

    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    n_eval = [0]

    def force_fn(s, nb):
        n_eval[0] += 1
        return eng.force_fn(s, nb)

    sim = Simulation(system, force_fn, eng.rebuild_fn, dt=2.0 * Units.fs, grow_fn=eng.grow,
                     migrate_fn=eng.maybe_migrate if migrate else None)
    sim.init_velocities(50.0, seed=SEED)
    sim.run(steps, log_every=chunk)
    torch.cuda.synchronize()
    before = (sim.migrations, sim.regrows)
    reset_launches()
    n_eval[0] = 0
    t0 = time.perf_counter()
    rows = sim.run(steps, log_every=chunk)
    torch.cuda.synchronize()
    return sim, rows, time.perf_counter() - t0, n_eval[0], launched_now(), before


def halo_md(card, case, steps=SHARD_STEPS, chunk=SHARD_CHUNK):
    """Phase 19b: NVE at 2 fs from 50 K through the halo engine with
    ``migrate_fn`` (and regrow), and through AllegroEngine on the same
    sorted system with the same protocol, in turns: a warmup run of
    ``steps`` and a timed run of ``steps`` each, in chunks of ``chunk``
    (migrations happen at chunk ends).  Steps/s of both, migrations,
    regrows, the energy drift over the timed run, and the launches: K1
    3 x shards (halo) or 3 (single) per force evaluation.  The halo run
    must end where the single engine's does: its last etotal, and its
    final positions taken back to the original order through
    ``atom_perm`` (modulo the cell, since a migration re-wraps them),
    within HALO_MD_GATE_E and HALO_MD_GATE_X."""
    import numpy as np
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine

    cfg, params, system, eng = case
    single = AllegroEngine(cfg, params, system, skin=0.4)
    res, final = {}, {}
    for name, e, shards in (("single", single, 1), ("halo", eng, eng.n_shards)):
        sim, rows, wall, n_eval, counts, (mig0, reg0) = _md_rate(e, system, steps, chunk,
                                                                  name == "halo")
        want = {"K1": (3 * shards * n_eval,) * 2}
        finite = bool(torch.isfinite(sim.state.forces).all()) and math.isfinite(
            rows[-1]["etotal"])
        r = {"steps_per_s": steps / wall, "ms_per_step": wall * 1e3 / steps,
             "migrations_timed": sim.migrations - mig0, "migrations_total": sim.migrations,
             "regrows_total": sim.regrows, "regrows_timed": sim.regrows - reg0,
             "etotal_first": rows[0]["etotal"], "etotal_last": rows[-1]["etotal"],
             "temp_last": rows[-1]["temp"], "force_evaluations": n_eval, "launches": counts}
        print(f"{name} md ({card}): {shards} shard(s) on one device, {steps} + {steps} NVE "
              f"steps in chunks of {chunk}: {r['steps_per_s']:.4f} steps/s "
              f"({r['ms_per_step']:.3f} ms/step); migrations {r['migrations_timed']} in the "
              f"timed run ({r['migrations_total']} in all), regrows {r['regrows_total']}; etotal "
              f"over the timed run {r['etotal_first']:.4f} -> {r['etotal_last']:.4f} eV (drift "
              f"{r['etotal_last'] - r['etotal_first']:.4f} eV, T {r['temp_last']:.1f} K); "
              f"{n_eval} force evaluations, launches {counts} (want {want}); finite {finite}")
        if not finite or counts != want:
            raise RuntimeError(f"{name} md: non-finite state or launches {counts}, want {want}")
        res[name] = r
        x = sim.state.system.positions.double().cpu().numpy()
        if sim.atom_perm is not None:  # row i of x is original atom atom_perm[i]
            back = np.empty_like(x)
            back[sim.atom_perm] = x
            x = back
        final[name] = x
        del sim
    cell = system.cell.double().cpu().numpy()
    frac = (final["halo"] - final["single"]) @ np.linalg.inv(cell)
    dx = float(np.abs((frac - np.round(frac)) @ cell).max())
    e_s, e_h = res["single"]["etotal_last"], res["halo"]["etotal_last"]
    de = abs(e_h - e_s) / abs(e_s)
    res["halo_vs_single"] = {"max_abs_dx_A": dx, "rel_d_etotal": de}
    print(f"halo md against single md ({card}): after {2 * steps} steps the final positions in "
          f"the original order differ by max {dx:.3e} A (gate {HALO_MD_GATE_X:g}), the last "
          f"etotal by {de:.3e} relative (gate {HALO_MD_GATE_E:g})")
    if not (dx <= HALO_MD_GATE_X and de <= HALO_MD_GATE_E):
        raise RuntimeError(f"halo md does not follow the single engine: {res['halo_vs_single']}")
    ratio = res["halo"]["steps_per_s"] / res["single"]["steps_per_s"]
    res["halo_over_single"] = ratio
    phase5 = STEPS_PER_S.get("allegro")
    print(f"halo md ({card}): {eng.n_shards} shards {res['halo']['steps_per_s']:.4f} steps/s "
          f"against one device's {res['single']['steps_per_s']:.4f} on the same run "
          f"({ratio:.4f}x)" + (f"; phase 5's K1 main path {phase5:.4f} steps/s in this call"
                               if phase5 else "") + " (four shards' launches on one card: "
          "what the mode costs there, not a multi-GPU number)")
    if phase5:
        res["phase5_steps_per_s"] = phase5
    return res


def sharded_nequip(card):
    """Phase 19c: bench.py:nequip_line's NequIP through ShardedNequIPEngine
    at SHARDS shards on the card against NequIPEngine (K3): forces within
    the 5e-4 eV/A bench gate and no K3 launch in the sharded engine (its
    plain message path, as in JAX)."""
    import torch

    from pair_allegro_tpu_torch.engine import NequIPEngine
    from pair_allegro_tpu_torch.parallel import ShardedNequIPEngine

    cfg, params, system = make_nequip_case(11, None)
    system, _ = ShardedNequIPEngine.prepare_system(system, SHARDS)
    single = NequIPEngine(cfg, params, system, skin=0.4)
    reset_launches()
    o0 = single.force_fn(system, single.rebuild_fn(system, None))
    torch.cuda.synchronize()
    single_counts = launched_now()
    eng = ShardedNequIPEngine(cfg, params, system, shard_mesh(SHARDS), skin=0.4)
    nb = eng.rebuild_fn(system, None)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o1 = eng.force_fn(system, nb)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launched_now()
    df = max_err(o1.forces, o0.forces)
    want0 = {"K3": (cfg.num_layers,) * 2}
    res = {"atoms": system.n_atoms, "max_abs_dF": df,
           "rel_dE": abs(float(o1.total_energy - o0.total_energy)) / abs(float(o0.total_energy)),
           "launches": counts, "single_launches": single_counts, "sharded_force_s": secs}
    print(f"sharded nequip ({card}): {system.n_atoms} atoms in {SHARDS} shards on one device "
          f"against NequIPEngine: max|dF| {df:.3e} eV/A (gate 5e-4), rel dE {res['rel_dE']:.3e}; "
          f"launches of the sharded evaluation {counts} (want none), of the single engine's "
          f"{single_counts} (want {want0}); one sharded force evaluation {secs:.3f} s")
    if not df < 5e-4 or counts or single_counts != want0:
        raise RuntimeError(f"sharded nequip gate failed: {res}")
    del single, eng, o0, o1, nb
    return res


def dp_train(card, d):
    """Phase 19d: data-parallel training: one batch of 4 frames (phase 18's
    labelled FCC Cu) split over 2 shards on the card (``data.shard_batch``)
    against the unsharded batch, each leaf's gradient within GRAD_GATE of
    the leaf's max, with no kernel launch."""
    import numpy as np
    import torch

    from pair_allegro_tpu_torch.data import load_frames
    from pair_allegro_tpu_torch.models.allegro import allegro_energy, allegro_init_numpy

    cfg = flagship_cfg()
    teacher = allegro_init_numpy(cfg, SEED)
    path = f"{d}/frames.xyz"
    train_frames(path, cfg, teacher, n=4)
    frames = load_frames(path, cfg.type_names, cfg.r_max, device="cuda")
    student = perturbed(teacher)
    reset_launches()
    g1 = batch_grads(cfg, allegro_energy, student, frames, "cuda", torch.float32)
    g2 = batch_grads(cfg, allegro_energy, student, frames, "cuda", torch.float32,
                     mesh=shard_mesh(2, "dp"))
    torch.cuda.synchronize()
    launched = launched_now()
    errs = grad_errors(g2, g1)
    worst = max(errs, key=errs.get)
    print(f"dp train ({card}): {len(frames)} frames of {len(frames[0]['positions'])} atoms, "
          f"batch split over 2 shards on one device against the unsharded batch: worst leaf "
          f"{worst} {errs[worst]:.3e} of its max (gate {GRAD_GATE:g}); launches {launched}")
    if not errs[worst] <= GRAD_GATE or launched or not np.isfinite(list(errs.values())).all():
        raise RuntimeError(f"dp train gate failed: {errs[worst]} ({worst}), launches {launched}")
    return {"worst_leaf": worst, "worst_rel_err": errs[worst]}, path


def sharded_cli(card, d, frames_path):
    """Phase 19e: the CLI's own sharded paths at full width: ``cli run
    --device cuda:0`` with ``sharding: {n_devices: 1}`` (replicated, one
    shard) and ``{n_devices: SHARDS, mode: halo}`` (the card counted SHARDS
    times), 20 NVE steps each with a restart, and ``cli train`` with
    ``sharding: {n_devices: 1}``.  Each run leg launches K1 3 x its shards
    per force evaluation and nothing else; its restart holds the atoms in
    their original order (each within 1 A of its start, modulo the cell);
    training launches nothing."""
    import numpy as np
    import torch

    from pair_allegro_tpu_torch import checkpoint as ckpt
    from pair_allegro_tpu_torch import cli
    from pair_allegro_tpu_torch.io.extxyz import write_extxyz
    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy
    from pair_allegro_tpu_torch.parallel import HaloShardedAllegroEngine, ShardedAllegroEngine
    from pair_allegro_tpu_torch.system import fcc_lattice

    steps = 20
    pos, cell = fcc_lattice(11)
    write_extxyz(f"{d}/cu.xyz", {"symbols": np.array(["Cu"] * len(pos)), "positions": pos,
                                 "cell": cell, "pbc": (True, True, True)})
    cfg = flagship_cfg()
    ckpt.save_params(f"{d}/allegro.npz", allegro_init_numpy(cfg, SEED), cfg, family="allegro")
    n_eval = [0]
    originals = {cls: cls.force_fn for cls in (ShardedAllegroEngine, HaloShardedAllegroEngine)}

    def counting(fn):
        def counted(self, system, neighbors):
            n_eval[0] += 1
            return fn(self, system, neighbors)
        return counted

    res = {}
    # "--device cuda:0" counts the one card n_devices times
    dev_args = ["--device", "cuda:0"]
    legs = [("replicated", {"n_devices": 1}, 1),
            ("halo", {"n_devices": SHARDS, "mode": "halo"}, SHARDS)]
    for cls, fn in originals.items():
        cls.force_fn = counting(fn)
    try:
        for name, sharding, shards in legs:
            conf = dict(CLI_BASE, data=f"{d}/cu.xyz", model={"checkpoint": f"{d}/allegro.npz"},
                        integrator="nve", temp_K=50.0, steps=steps, log_every=steps // 2,
                        sharding=sharding, restart={"path": f"{d}/{name}.npz"})
            with open(f"{d}/{name}.yaml", "w") as f:
                f.write(json.dumps(conf) + "\n")
            n_eval[0] = 0
            reset_launches()
            t0 = time.perf_counter()
            if cli.main(["run", f"{d}/{name}.yaml", *dev_args]) != 0:
                raise RuntimeError(f"cli sharded {name} returned non-zero")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = launched_now()
            want = {"K1": (3 * shards * n_eval[0],) * 2}
            back, step, _, _ = ckpt.load_state(f"{d}/{name}.npz", device="cpu")
            disp = back.positions.double().numpy() - pos
            frac = disp @ np.linalg.inv(cell)
            moved = float(np.abs((frac - np.round(frac)) @ cell).max())
            res[name] = {"shards": shards, "force_evaluations": n_eval[0], "launches": launched,
                         "seconds": secs, "max_move_A": moved}
            print(f"cli sharded {name} ({card}): {shards} shard(s), {steps} NVE steps in "
                  f"{secs:.2f} s with the set-up, {n_eval[0]} force evaluations, launches "
                  f"{launched} (want {want}); restart at step {step}, {back.n_atoms} atoms in the "
                  f"original order (largest move from the start {moved:.4f} A, modulo the cell)")
            if launched != want or step != steps or back.n_atoms != len(pos) or not moved < 1.0:
                raise RuntimeError(f"cli sharded {name} failed: {res[name]}")
    finally:
        for cls, fn in originals.items():
            cls.force_fn = fn
    conf = {"model": {"checkpoint": f"{d}/allegro.npz"}, "dataset": frames_path,
            "val_fraction": 0.25, "batch_size": 2, "epochs": 1, "log_every": 1,
            "optimizer": {"name": "adam", "lr": TRAIN_LR}, "out": f"{d}/trained.npz",
            "sharding": {"n_devices": 1}}
    with open(f"{d}/train.yaml", "w") as f:
        f.write(json.dumps(conf) + "\n")
    reset_launches()
    if cli.main(["train", f"{d}/train.yaml", *dev_args]) != 0:
        raise RuntimeError("cli train with sharding returned non-zero")
    launched = launched_now()
    trained = ckpt.load_params(f"{d}/trained.npz")[0]
    finite = all(np.isfinite(a).all() for a in ckpt.flatten(trained).values())
    print(f"cli train with sharding {{n_devices: 1}} ({card}): launches {launched} (want none), "
          f"trained tree finite {finite}")
    if launched or not finite:
        raise RuntimeError("cli train with sharding failed")
    res["train"] = {"launches": launched}
    torch.cuda.empty_cache()
    return res


def compile_cache_leg(card, d):
    """Phase 19f: every kernel library this process built or loaded, and the
    host runtime, copied to a fresh directory; a subprocess with
    PAT_COMPILE_CACHE set to it loads each of them from there and runs no
    compiler (nvcc or the host's)."""
    import shutil

    from pair_allegro_tpu_torch import native

    cache = f"{d}/compile_cache"
    os.makedirs(cache)
    # the libraries this process loaded (all of them in a full run)
    loaded = {name: m.LIB for name, m in kernel_modules().items() if m.LIB._lib is not None}
    for lib in loaded.values():
        for p in lib.paths():
            shutil.copy2(p, cache)
    shutil.copy2(native.LIB.path(), cache)
    code = (
        "import json, sys\n"
        "from pair_allegro_tpu_torch import native\n"
        "from pair_allegro_tpu_torch.compile_cache import maybe_enable_from_env\n"
        "import chip_smoke\n"
        "assert maybe_enable_from_env()\n"
        "mods = chip_smoke.kernel_modules()\n"
        "libs = {id(mods[k].LIB): mods[k].LIB for k in json.loads(sys.argv[1])}.values()\n"
        "paths = []\n"
        "for lib in libs:\n"
        "    lib.load()\n"
        "    paths.append(str(lib.paths()[0]))\n"
        "assert native.available()\n"
        "paths.append(str(native.LIB.path()))\n"
        "print(json.dumps({'nvcc_runs': sum(lib.build_seconds is not None for lib in libs),\n"
        "                  'host_compiler_runs': int(native.LIB.build_seconds is not None),\n"
        "                  'paths': paths}))\n"
    )
    env = dict(os.environ, PAT_COMPILE_CACHE=cache)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(sorted(loaded))],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"compile cache subprocess failed:\n{proc.stdout}\n{proc.stderr}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    inside = all(os.path.dirname(p) == os.path.abspath(cache) for p in res["paths"])
    print(f"compile cache ({card}): a second process with PAT_COMPILE_CACHE loaded "
          f"{len(res['paths'])} libraries (those of {', '.join(sorted(loaded))} and the host "
          f"runtime) from the cache in {secs:.2f} s: nvcc runs {res['nvcc_runs']}, host compiler "
          f"runs {res['host_compiler_runs']}, every path in the cache {inside}")
    if res["nvcc_runs"] or res["host_compiler_runs"] or not inside:
        raise RuntimeError(f"compile cache leg failed: {res}")
    return {"nvcc_runs": res["nvcc_runs"], "host_compiler_runs": res["host_compiler_runs"],
            "libraries": len(res["paths"]), "seconds": secs}


def sharded_phase(card):
    """Phase 19: the multi-device engines on the one card, every leg at
    full width (the flagship Allegro and bench.py:nequip_line's NequIP on
    5,324-atom FCC Cu): the host runtime built (``native.available()``);
    the replicated engine at SHARDS shards against the single-device engine
    on the K1 and per-layer (K2) tiers, and at 2 shards on a 256-atom box
    that takes the dense strategy (K4); the halo engine at SHARDS slabs, the
    same parity, then its NVE run with migration; sharded NequIP against
    K3's engine; data-parallel gradients; the CLI's sharded ``run`` and
    ``train``; the compile cache's second process.  Writes and removes
    ``build/sharded_phase/``."""
    import shutil

    from pair_allegro_tpu_torch import native

    print(f"phase 19 on {card}")
    t_phase = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"the C++ host runtime is unavailable: {native.LIB.error}")
    print(f"native host runtime: {native.LIB.path().name}, built in this process in "
          f"{native.LIB.build_seconds or 0.0:.2f} s with {native.LIB.flags}")
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sharded_phase")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    res = {}
    res["replicated_k1"], _ = sharded_parity(card, "replicated")
    res["replicated_k2"], _ = sharded_parity(card, "replicated", "K2")
    # 256 atoms resolve to the dense strategy: FLAT center windows and K4
    res["replicated_k4"], _ = sharded_parity(card, "replicated", "K4", n_rep=4, n_shards=2)
    res["halo"], case = sharded_parity(card, "halo")
    res["halo_md"] = halo_md(card, case)
    del case
    res["nequip"] = sharded_nequip(card)
    res["dp_train"], frames_path = dp_train(card, d)
    res["cli"] = sharded_cli(card, d, frames_path)
    res["compile_cache"] = compile_cache_leg(card, d)
    shutil.rmtree(d, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print("sharded phase result", json.dumps(res))
    print(f"phase 19: {res['seconds']:.1f} s")
    return res


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


# ---------------------------------------------------------------------------
# Phase 20: the bf16 tiers
# ---------------------------------------------------------------------------

# a bf16 build against its plain version fed the same bf16-rounded inputs and
# weights, computed in f32 and rounded to bf16 at the outputs (atol, rtol on
# max|plain|): the kernels round their product operands to bf16 where the
# plain version keeps f32
BF16_TOLS = {"fwd": (1e-3, 8e-3), "bwd": (2e-3, 1.6e-2)}


def rounded(tree):
    """``tree`` (nested dicts / lists of tensors) with every leaf rounded to
    bf16 and back to f32."""
    import torch

    if isinstance(tree, dict):
        return {key: rounded(v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rounded(v) for v in tree]
    return tree.detach().to(torch.bfloat16).float()


# the weak-typing repair's gate (``constants_share``): the build lies
# nearer the rounded-constant plain version than the f32-constant one along
# the line between them.  A rounded constant moves a value ~1e-4, under a
# bf16 ulp, so where the build rounds a carried value (K8's x, V, dx, dV
# between the layers) the departure survives only as ulp jumps, which the
# two sides' other differences (an operand that an f32 sum-order difference
# rounds the other way) undo in part: K8's 3-layer backward at 6 centers
# read 0.750-0.861 on an H100, a mutant body with f32 constants -0.05-0.22
CONSTANTS_GATE = (0.5, 1.5)


def constants_share(kernel, label, got, want, base):
    """The weak-typing repair's gate on a bf16 build: ``got`` (its outputs
    and gradients) must reproduce the share (``mode_share``) of ``want``'s
    departure from ``base`` within CONSTANTS_GATE, where ``want`` is the
    plain version with its constants rounded to bf16 (the build's
    function) and ``base`` the same with f32 constants (the body before the
    repair); a max-norm cannot hold the two apart (~1e-4 of a value, under
    the outputs' bf16 rounding).  The control: ``base`` rounded to bf16 at
    its outputs, what a build with f32 constants would give up to its sum
    order, must lie outside the gate.  Returns (fwd, bwd) shares."""
    import torch

    shares, ctl = [], []
    for kind, g, w, b in zip(("fwd", "bwd"), got, want, base):
        shares.append(mode_share(g, w, b))
        ctl.append(mode_share([t.to(torch.bfloat16) for t in b], w, b))
        print(f"{kernel} {label} {kind}: share of the rounded-constant plain version's departure "
              f"from the f32-constant one {shares[-1]:.4f} (gate {CONSTANTS_GATE}); control, the "
              f"f32-constant version rounded to bf16: {ctl[-1]:.4f} (must lie outside)")
    if not all(CONSTANTS_GATE[0] <= x <= CONSTANTS_GATE[1] for x in shares):
        raise RuntimeError(f"{kernel} {label} does not round its constants as JAX's kernel does")
    if any(CONSTANTS_GATE[0] <= x <= CONSTANTS_GATE[1] for x in ctl):
        raise RuntimeError(f"{kernel} control {label}: the f32-constant version passed the gate")
    return tuple(shares)


def k1_bf16_compare(label, form, ins32, layer, cfg, k, gen, share=False):
    """K1's bf16 build on ``ins32`` rounded to bf16 against the plain
    version at f32 on the same values with the layer's weights rounded,
    forward and backward (a bf16 cotangent); with ``share`` also the
    repair's gate (``constants_share``).  Returns the max abs errors."""
    import torch

    from pair_allegro_tpu_torch.ops import fused_layer as fl

    first_v, last = FORMS[form]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    w = fl.k1_weights(layer, cfg.l_max, cfg.parity)
    w_r = fl.prepare_layer(rounded(layer), cfg.l_max, cfg.parity)
    ins = [t.detach().to(torch.bfloat16).requires_grad_(True) for t in ins32]
    ref = [t.detach().float().requires_grad_(True) for t in ins]
    out_k = fl.fused_layer(*ins, w, k, cfg.avg_num_neighbors, first_v=first_v, last=last)
    # the build's function: one-pass products, constants rounded to bf16
    out_r = fl.fused_layer_reference(*ref, w_r, k, inv_avg, first_v, last, "bf16", torch.bfloat16)
    out_k, out_r = ((out_k,), (out_r,)) if last else (out_k, out_r)
    cots = [torch.randn(o.shape, generator=gen, device=o.device).to(torch.bfloat16)
            for o in out_r]
    g_k = torch.autograd.grad(out_k, ins, cots)
    g_r = torch.autograd.grad(out_r, ref, [c.float() for c in cots])
    torch.cuda.synchronize()
    errs = {}
    for kind, got, want in (("fwd", out_k, out_r), ("bwd", g_k, g_r)):
        errs[kind] = check("K1 bf16", f"{form:6s} {label}", kind, K1_NAMES, got,
                           [t.to(torch.bfloat16) for t in want], BF16_TOLS[kind])
    if share:
        base = [t.detach().float().requires_grad_(True) for t in ins]
        out_b = fl.fused_layer_reference(*base, w_r, k, inv_avg, first_v, last, "bf16",
                                         torch.float32)
        out_b = (out_b,) if last else out_b
        g_b = torch.autograd.grad(out_b, base, [c.float() for c in cots])
        constants_share("K1 bf16", f"{form:6s} {label}", (out_k, g_k), (out_r, g_r),
                        (out_b, g_b))
        del base, out_b, g_b
    del ins, ref, out_k, out_r, g_k, g_r
    torch.cuda.empty_cache()
    return errs


def k2_bf16_compare(label, ops32, mix, cfg, k, gen):
    """K2's bf16 build against its plain version as ``k1_bf16_compare``."""
    import torch

    from pair_allegro_tpu_torch.ops import env_layer as k2

    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    w = k2.k2_weights(mix, cfg.l_max, cfg.parity)
    w_r = k2.prepare_mix(rounded(mix), cfg.l_max, cfg.parity)
    ins = [t.detach().to(torch.bfloat16).requires_grad_(True) for t in ops32]
    ref = [t.detach().float().requires_grad_(True) for t in ins]
    out_k = k2.env_layer(*ins, w, k, cfg.avg_num_neighbors)
    out_r = k2.env_layer_reference(*ref, w_r, k, inv_avg)
    cots = [torch.randn(o.shape, generator=gen, device=o.device).to(torch.bfloat16)
            for o in out_r]
    g_k = torch.autograd.grad(out_k, ins, cots)
    g_r = torch.autograd.grad(out_r, ref, [c.float() for c in cots])
    torch.cuda.synchronize()
    errs = {}
    for kind, names, got, want in (("fwd", ("V'", "inv"), out_k, out_r),
                                   ("bwd", K2_NAMES, g_k, g_r)):
        errs[kind] = check("K2 bf16", label, kind, names, got,
                           [t.to(torch.bfloat16) for t in want], BF16_TOLS[kind])
    del ins, ref, out_k, out_r, g_k, g_r
    torch.cuda.empty_cache()
    return errs


def k3_bf16_compare(label, ops32, w, k, avg, gen):
    """K3's bf16-hj build on ``ops32`` with hj rounded to bf16, against the
    plain version on the same hj values at f32: agg, dbessel, du and dY
    within the f32 build's gates (TOLS), dhj (bf16) within the bf16 backward
    gate against the plain version's rounded to bf16."""
    import torch

    from pair_allegro_tpu_torch.ops import nequip_conv as k3

    inv_avg = 1.0 / math.sqrt(avg)
    hj = ops32[0].detach().to(torch.bfloat16).requires_grad_(True)
    rest = [t.detach().clone().requires_grad_(True) for t in ops32[1:]]
    ref = [hj.detach().float().requires_grad_(True)] + [t.detach().clone().requires_grad_(True)
                                                        for t in rest]
    out_k = k3.nequip_conv(hj, *rest, w, k, avg)
    out_r = k3.nequip_conv_reference(*ref, w, k, inv_avg)
    cot = torch.randn(out_r.shape, generator=gen, device=out_r.device)
    g_k = torch.autograd.grad(out_k, [hj, *rest], cot)
    g_r = torch.autograd.grad(out_r, ref, cot)
    torch.cuda.synchronize()
    if out_k.dtype != torch.float32 or g_k[0].dtype != torch.bfloat16:
        raise RuntimeError(f"K3 bf16-hj: agg {out_k.dtype}, dhj {g_k[0].dtype}")
    errs = {"fwd": check("K3 bf16-hj", label, "fwd", ("agg",), (out_k,), (out_r,)),
            "bwd": max(check("K3 bf16-hj", label, "bwd", K3_NAMES[:1], g_k[:1],
                             [g_r[0].to(torch.bfloat16)], BF16_TOLS["bwd"]),
                       check("K3 bf16-hj", label, "bwd", K3_NAMES[1:], g_k[1:], g_r[1:]))}
    del hj, rest, ref, out_k, out_r, g_k, g_r
    torch.cuda.empty_cache()
    return errs


def bf16_pair(kernel, label, fn, ref, ops32, outs, names, gen, base=None):
    """A bf16 build (``fn``) on ``ops32`` rounded to bf16 against its plain
    version (``ref``, on weights rounded to bf16) at f32 on the same values,
    forward and backward (bf16 cotangents), within BF16_TOLS; with ``base``
    (the plain version with f32 constants) also the repair's gate
    (``constants_share``).  Returns the max abs errors."""
    import torch

    bf = torch.bfloat16
    ins = [t.detach().to(bf).requires_grad_(True) for t in ops32]
    refs = [t.detach().float().requires_grad_(True) for t in ins]
    out_k, out_r = _tup(fn(*ins)), _tup(ref(*refs))
    cots = [torch.randn(o.shape, generator=gen, device=o.device).to(bf) for o in out_r]
    g_k = torch.autograd.grad(out_k, ins, cots)
    g_r = torch.autograd.grad(out_r, refs, [c.float() for c in cots])
    torch.cuda.synchronize()
    if any(t.dtype != bf for t in (*out_k, *g_k)):
        raise RuntimeError(f"{kernel} {label}: the bf16 build returned another dtype")
    errs = {kind: check(kernel, label, kind, nm, got, [t.to(bf) for t in want], BF16_TOLS[kind])
            for kind, nm, got, want in (("fwd", outs, out_k, out_r), ("bwd", names, g_k, g_r))}
    if base is not None:
        bases = [t.detach().float().requires_grad_(True) for t in ins]
        out_b = _tup(base(*bases))
        g_b = torch.autograd.grad(out_b, bases, [c.float() for c in cots])
        constants_share(kernel, label, (out_k, g_k), (out_r, g_r), (out_b, g_b))
        del bases, out_b, g_b
    del ins, refs, out_k, out_r, cots, g_k, g_r
    torch.cuda.empty_cache()
    return errs


def er_bf16_calls(cfg, params, k):
    """K6's and K7's bf16 builds (wrapper, plain version on the tree
    rounded to bf16 with its constants rounded as the build rounds them,
    output names, operand names) as functions of their operands."""
    import torch

    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    avg, inv_avg = cfg.avg_num_neighbors, 1.0 / math.sqrt(cfg.avg_num_neighbors)
    lmax, parity, charges = cfg.l_max, cfg.parity, cfg.output_charges
    w6, w7 = k6.k6_weights(params, lmax, parity), k7.k7_weights(params, lmax, parity, charges)
    w6_r = k6.prepare_embed(rounded(params), lmax, parity)
    w7_r = k7.prepare_readout(rounded(params), lmax, parity, charges)
    return {"K6-bf16": (lambda *a: k6.embed_layer(*a, w6, k, avg),
                        lambda *a: k6.embed_layer_reference(*a, w6_r, k, inv_avg,
                                                            scalars=torch.bfloat16, mode="bf16"),
                        ("x'", "V'"), K6_NAMES),
            "K7-bf16": (lambda *a: k7.readout_layer(*a, w7, k, avg),
                        lambda *a: k7.readout_layer_reference(*a, w7_r, k, inv_avg,
                                                              scalars=torch.bfloat16, mode="bf16"),
                        ("e", "q")[:1 + charges], K1_NAMES)}


def stack_bf16_calls(cfg, params, k):
    """K8's bf16 build (wrapper, plain version: ``stack_rounded_reference``
    on the layers rounded to bf16, and the same with f32 constants) as
    functions of its operands."""
    import torch

    from pair_allegro_tpu_torch.ops import fused_stack as k8

    layers_r = rounded(params["layers"])
    args = (k, cfg.l_max, cfg.avg_num_neighbors, cfg.parity)
    return (lambda *o: k8.fused_stack(*o, params["layers"], *args),
            lambda *o: k8.stack_rounded_reference(*o, layers_r, *args),
            lambda *o: k8.stack_rounded_reference(*o, layers_r, *args, torch.float32))


def bf16_parity():
    """Phase 20's kernel parity on the 500-atom table: K1's bf16 build in its
    three forms at flagship widths, K2's at l_max 2 and 1 with parity, K3's
    bf16-hj build at (l_max, tracks) in {1, 2} x {1, 2}, K6's and K7's
    (K7 with and without the charge head) and K8's (3 layers at l_max 2 and
    1, 1 and 2 layers); returns {kernel: {"fwd": err, "bwd": err}}."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine

    errs = {name: {"fwd": 0.0, "bwd": 0.0} for name in ("K1-bf16", "K2-bf16", "K3-bf16",
                                                         "K6-bf16", "K7-bf16", "K8-bf16")}

    def keep(name, e):
        errs[name] = {kind: max(errs[name][kind], e[kind]) for kind in e}

    cfg, params, system = make_case(5, None, interior="bf16")
    eng = AllegroEngine(cfg, params, system)
    ops, Y, u, k = layer_operands(cfg, params, system, eng)
    gen = torch.Generator(device=Y.device).manual_seed(SEED)
    for li, form in enumerate(FORMS):
        keep("K1-bf16", k1_bf16_compare("500 atoms", form, (*ops[form], Y, u),
                                        params["layers"][li], cfg, k, gen, share=True))
    for lmax in (2, 1):
        cfg, params, system = make_case(5, None, l_max=lmax, interior="bf16")
        ops, k = env_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        keep("K2-bf16", k2_bf16_compare(f"l_max={lmax} 500 atoms K={k}", ops,
                                        params["layers"][1]["mix"], cfg, k, gen))
    for lmax in (1, 2):
        for parity in (False, True):
            cfg, params, system = make_nequip_case(5, None, l_max=lmax, parity=parity)
            ops, w, k = k3_operands(cfg, params, system, NequIPEngine(cfg, params, system))
            keep("K3-bf16", k3_bf16_compare(f"l_max={lmax} T={cfg.n_tracks} 500 atoms K={k}",
                                            ops, w, k, cfg.avg_num_neighbors, gen))
    for charges in (True, False):
        cfg, params, system = make_case(5, None, output_charges=charges, interior="bf16")
        ops6, ops7, k = er_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        calls = er_bf16_calls(cfg, params, k)
        label = f"500 atoms K={k}" + (", charge head" if charges else "")
        for name, ops in (("K6-bf16", ops6), ("K7-bf16", ops7)):
            if name == "K7-bf16" or charges:
                keep(name, bf16_pair(name, label, *calls[name][:2], ops, *calls[name][2:], gen))
    for tier in (dict(), dict(l_max=1), dict(num_layers=1), dict(num_layers=2)):
        cfg, params, system = make_case(5, None, fused_stack=True, interior="bf16", **tier)
        ops, k = stack_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        fn, ref, base = stack_bf16_calls(cfg, params, k)
        keep("K8-bf16", bf16_pair("K8-bf16", f"l_max={cfg.l_max} {cfg.num_layers} layers 500 "
                                  f"atoms K={k}", fn, ref, ops, ("x",), K8_NAMES, gen, base))
    return errs


def bf16_model_parity(tier, want, env=None, ref=None):
    """Phase 20: forces and charges of an ``interior="bf16"`` model on the
    card (the bf16 build) and of the same model at bf16 on the CPU (the
    plain versions), each against the model at f32 on the CPU: the card's
    distance within twice the CPU bf16 path's (the two round at bf16 in
    places of their own, so their distance from each other is no gate;
    it is printed), with ``want`` launches per force evaluation; ``env``
    the environment of the tier (the embed/readout form's); ``ref`` the CPU
    f32 path's (forces, charges, energy) from an earlier call, which every
    tier shares: each computes that function at f32.  Returns ``ref``."""
    with env_vars(env or {}):
        return _bf16_model_parity(tier, want, env, ref)


def _bf16_model_parity(tier, want, env, ref):
    from pair_allegro_tpu_torch.engine import AllegroEngine

    mods = kernel_modules()
    outs = {}
    for dev, interior in (("cuda", "bf16"), ("cpu", "bf16"), ("cpu", "working")):
        if (dev, interior) == ("cpu", "working") and ref is not None:
            outs[dev, interior] = ref
            continue
        cfg, params, system = make_case(5, dev, output_charges=True, interior=interior, **tier)
        eng = AllegroEngine(cfg, params, system, device=dev)
        nb = eng.rebuild_fn(system, None)
        for m in mods.values():
            m.launches.reset()
        o = eng.force_fn(system, nb)
        if dev == "cuda":
            launched = {name: (m.launches.fwd, m.launches.bwd) for name, m in mods.items()
                        if m.launches.fwd or m.launches.bwd}
        outs[dev, interior] = (o.forces.cpu(), o.extras["charges"].cpu(), float(o.total_energy))
    (f_k, q_k, e_k), (f_p, q_p, e_p), (f_32, q_32, e_32) = outs.values()
    dk = (max_err(f_k, f_32), max_err(q_k, q_32))
    dp = (max_err(f_p, f_32), max_err(q_p, q_32))
    print(f"bf16 model parity ({tier or env or 'K1 tier'}, interior bf16, 500 atoms, charges; against "
          f"the CPU f32 path): the card max|dF| {dk[0]:.3e} eV/A, max|dq| {dk[1]:.3e}; the CPU "
          f"bf16 path {dp[0]:.3e}, {dp[1]:.3e} (gate 2 x the CPU's); card against CPU at bf16 "
          f"{max_err(f_k, f_p):.3e}, {max_err(q_k, q_p):.3e}; max|F| {float(f_32.abs().max()):.3f}; "
          f"E {e_k:.6f}, {e_p:.6f}, {e_32:.6f} eV; launches on the card {launched}")
    if not (dk[0] <= 2 * dp[0] and dk[1] <= 2 * dp[1]):
        raise RuntimeError(f"bf16 model parity gate failed ({tier or env})")
    if launched != {name: (n, n) for name, n in want.items()}:
        raise RuntimeError(f"bf16 model parity ({tier or env}): launched {launched}, want {want}")
    return outs["cpu", "working"]


def bf16_timings(path, cfg, params, system, eng, all_errs):
    """Phase 20's timings at the bf16 main paths' shapes (CUDA events, warm):
    K1's bf16 build per form (allegro-bf16), K2's (perlayer-bf16), K3's
    bf16-hj build (nequip-hj-bf16), K6's and K7's (embed-bf16), K8's
    (stack-bf16), beside the plain version's time on the same bf16 inputs
    and the bound with the products at PEAK_BF16_FLOPS and the bf16 numbers
    at 2 bytes; parity at those shapes (into ``all_errs``, {kernel: errs}).
    Returns {kernel: {(form, kind) or kind: row}}."""
    import torch

    gen = torch.Generator(device=system.device).manual_seed(SEED)
    res = {}
    bf = torch.bfloat16
    errs = all_errs[PATHS[path][2]]
    if path in ("embed-bf16", "stack-bf16"):
        return (er_bf16_timings if path == "embed-bf16" else stack_bf16_timings)(
            cfg, params, system, eng, all_errs, gen)
    if path == "allegro-bf16":
        from pair_allegro_tpu_torch.ops import fused_layer as fl

        ops, Y, u, k = layer_operands(cfg, params, system, eng)
        e = Y.shape[1]
        inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
        for li, (form, (first_v, last)) in enumerate(FORMS.items()):
            layer = params["layers"][li]
            w = fl.k1_weights(layer, cfg.l_max, cfg.parity)
            x, V, Yb, ub = (t.to(bf) for t in (*ops[form], Y, u))
            dxo = torch.randn(x.shape, generator=gen, device=x.device).to(bf)
            dvo = None if last else torch.randn((Y.shape[0], w.mix[0].shape[1], e),
                                                generator=gen, device=x.device).to(bf)
            k_f = cuda_ms(lambda: fl._kernel_fwd(x, V, Yb, ub, w, k, inv_avg, first_v, last), 5)
            k_b = cuda_ms(lambda: fl._kernel_bwd(x, V, Yb, ub, w, k, inv_avg, first_v, last, dxo,
                                                 dvo), 5)
            with torch.no_grad():
                p_f = cuda_ms(lambda: fl.fused_layer_reference(x, V, Yb, ub, w, k, inv_avg,
                                                               first_v, last), 2)
            ins = [t.detach().clone().requires_grad_(True) for t in (x, V, Yb, ub)]
            out = fl.fused_layer_reference(*ins, w, k, inv_avg, first_v, last)
            outs, cots = ((out,), (dxo,)) if last else (out, (dxo, dvo))
            p_b = cuda_ms(lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True), 2)
            del ins, out, outs
            torch.cuda.empty_cache()
            e2 = k1_bf16_compare(f"main path E={e}", form, (*ops[form], Y, u), layer, cfg, k, gen)
            errs.update({kind: max(errs[kind], e2[kind]) for kind in e2})
            for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
                bwd = kind == "bwd"
                flops, nbytes = k1_cost(w, e, k, form, bwd, nb=2)
                res[(form, kind)] = timing(ms, pms, flops, k1_products(w, form, bwd) * e, nbytes,
                                           k1_weight_bytes(w, form, bwd, n_tiles(e, k)) // 2,
                                           PEAK_BF16_FLOPS)
                print_timing(f"K1 bf16 {kind} {form:6s} E={e}", res[(form, kind)])
    elif path == "perlayer-bf16":
        from pair_allegro_tpu_torch.ops import env_layer as k2

        ops, k = env_operands(cfg, params, system, eng)
        e = ops[0].shape[-1]
        inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
        w = k2.k2_weights(params["layers"][1]["mix"], cfg.l_max, cfg.parity)
        opb = [t.to(bf) for t in ops]
        out, inv = k2._kernel_fwd(*opb, w, k, inv_avg)
        dout = torch.randn(out.shape, generator=gen, device=out.device).to(bf)
        dinv = torch.randn(inv.shape, generator=gen, device=out.device).to(bf)
        del out, inv
        k_f = cuda_ms(lambda: k2._kernel_fwd(*opb, w, k, inv_avg), 5)
        k_b = cuda_ms(lambda: k2._kernel_bwd(*opb, w, k, inv_avg, dout, dinv), 5)
        with torch.no_grad():
            p_f = cuda_ms(lambda: k2.env_layer_reference(*opb, w, k, inv_avg), 2)
        ins = [t.detach().clone().requires_grad_(True) for t in opb]
        outs = k2.env_layer_reference(*ins, w, k, inv_avg)
        p_b = cuda_ms(lambda: torch.autograd.grad(outs, ins, (dout, dinv), retain_graph=True), 2)
        del ins, outs
        torch.cuda.empty_cache()
        e2 = k2_bf16_compare(f"main path E={e}", ops, params["layers"][1]["mix"], cfg, k, gen)
        errs.update({kind: max(errs[kind], e2[kind]) for kind in e2})
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            bwd = kind == "bwd"
            flops, nbytes = k2_cost(w, e, bwd, nb=2)
            _, _, ring = k2.block_layout(w.c, w.cout, ops[0].shape[0], w.lmax, w.parity, bwd)
            # the f32 build's staging halved (packed words): an upper estimate,
            # as a packed l3 block may stay in the ring where an f32 one does not
            staged = mix_weight_bytes(w, bwd, n_tiles(e, k), ring) // 2
            res[kind] = timing(ms, pms, flops, mix_products(w) * e, nbytes, staged,
                               PEAK_BF16_FLOPS)
            print_timing(f"K2 bf16 {kind} E={e}", res[kind])
    else:
        from pair_allegro_tpu_torch.ops import nequip_conv as k3

        ops, w, k = k3_operands(cfg, params, system, eng)
        e = ops[0].shape[0]
        inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
        opb = (ops[0].to(bf), *ops[1:])
        dagg = torch.randn((e // k, ops[0].shape[1]), generator=gen, device=system.device)
        k_f = cuda_ms(lambda: k3._kernel_fwd(*opb, w, k, inv_avg), 10)
        k_b = cuda_ms(lambda: k3._kernel_bwd(*opb, w, k, inv_avg, dagg), 10)
        with torch.no_grad():
            p_f = cuda_ms(lambda: k3.nequip_conv_reference(*opb, w, k, inv_avg), 2)
        ins = [t.detach().clone().requires_grad_(True) for t in opb]
        out = k3.nequip_conv_reference(*ins, w, k, inv_avg)
        p_b = cuda_ms(lambda: torch.autograd.grad(out, ins, dagg, retain_graph=True), 2)
        del ins, out
        torch.cuda.empty_cache()
        e2 = k3_bf16_compare(f"l_max={w.lmax} T={w.n_tracks} main path E={e}", ops, w, k,
                             cfg.avg_num_neighbors, gen)
        errs.update({kind: max(errs[kind], e2[kind]) for kind in e2})
        df = ops[0].shape[1]
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            bwd = kind == "bwd"
            flops, prod, nbytes = k3_cost(w, e, k, bwd)
            nbytes -= 2 * df * e * (2 if bwd else 1)  # hj (and dhj) at 2 bytes
            res[kind] = timing(ms, pms, flops, prod, nbytes, k3_weight_bytes(w, e, k, bwd))
            print_timing(f"K3 bf16-hj {kind} E={e}", res[kind])
    return {PATHS[path][2]: res}


def _time_pair(fn_k, fn_kb, ref, ins_b, cots):
    """(kernel fwd, kernel bwd, plain fwd, plain bwd) ms of a bf16 build and
    its plain version at bf16 on ``ins_b``, the plain backward from
    ``cots``."""
    import torch

    k_f = cuda_ms(fn_k, 5)
    k_b = cuda_ms(fn_kb, 5)
    with torch.no_grad():
        p_f = cuda_ms(lambda: ref(*ins_b), 2)
    ins = [t.detach().clone().requires_grad_(True) for t in ins_b]
    outs = _tup(ref(*ins))
    p_b = cuda_ms(lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True), 2)
    del ins, outs
    torch.cuda.empty_cache()
    return k_f, k_b, p_f, p_b


def er_bf16_timings(cfg, params, system, eng, all_errs, gen):
    """Phase 20 (embed-bf16): K6's and K7's bf16 builds timed at the embed
    main path's shapes beside their plain versions at bf16 (the
    ``interior="bf16"`` CPU path's functions), bounds at PEAK_BF16_FLOPS and
    2-byte numbers; parity at those shapes."""
    import torch

    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    bf = torch.bfloat16
    ops6, ops7, k = er_operands(cfg, params, system, eng)
    e = ops6[0].shape[1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    calls = er_bf16_calls(cfg, params, k)
    w6 = k6.k6_weights(params, cfg.l_max, cfg.parity)
    w7 = k7.k7_weights(params, cfg.l_max, cfg.parity, cfg.output_charges)
    res = {}
    for name, mod, ref, w, ops, cost, prods, wbytes in (
            ("K6-bf16", k6, k6.embed_layer_reference, w6, ops6, k6_cost, k6_products,
             k6_weight_bytes),
            ("K7-bf16", k7, k7.readout_layer_reference, w7, ops7, k7_cost, k7_products,
             k7_weight_bytes)):
        opb = [t.to(bf) for t in ops]
        cots = [torch.randn(o.shape, generator=gen, device=system.device).to(bf)
                for o in _tup(mod._kernel_fwd(*opb, w, k, inv_avg))]
        bwd_args = tuple(cots) if name == "K6-bf16" else (cots,)
        times = _time_pair(lambda: mod._kernel_fwd(*opb, w, k, inv_avg),
                           lambda: mod._kernel_bwd(*opb, w, k, inv_avg, *bwd_args),
                           lambda *a: ref(*a, w, k, inv_avg), opb, cots)
        del opb, cots, bwd_args
        e2 = bf16_pair(name, f"embed-bf16 main path E={e}", *calls[name][:2], ops,
                       *calls[name][2:], gen)
        all_errs[name] = {kind: max(all_errs[name][kind], e2[kind]) for kind in e2}
        res[name] = {}
        for kind, ms, pms in (("fwd", times[0], times[2]), ("bwd", times[1], times[3])):
            bwd = kind == "bwd"
            flops, nbytes = cost(w, e, bwd, nb=2)
            res[name][kind] = timing(ms, pms, flops, prods(w, bwd) * e, nbytes,
                                     wbytes(w, bwd, n_tiles(e, k)) // 2, PEAK_BF16_FLOPS)
            print_timing(f"{name} {kind} E={e}", res[name][kind])
    return res


def stack_bf16_timings(cfg, params, system, eng, all_errs, gen):
    """Phase 20 (stack-bf16): K8's bf16 build timed at the stack main path's
    shapes beside its plain version at bf16 (``allegro_stack_reference``,
    the CPU path's function), bounds at PEAK_BF16_FLOPS and 2-byte numbers;
    parity at those shapes (against ``stack_rounded_reference``)."""
    import torch

    from pair_allegro_tpu_torch.ops import fused_stack as k8

    bf = torch.bfloat16
    ops, k = stack_operands(cfg, params, system, eng)
    e = ops[0].shape[1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    w = k8.stack_weights(params["layers"], cfg.l_max, cfg.parity)
    opb = [t.to(bf) for t in ops]
    dxo = torch.randn(ops[0].shape, generator=gen, device=system.device).to(bf)
    times = _time_pair(lambda: k8._kernel_fwd(*opb, w, k, inv_avg),
                       lambda: k8._kernel_bwd(*opb, w, k, inv_avg, dxo),
                       lambda *a: k8.allegro_stack_reference(*a, params["layers"], k, cfg.l_max,
                                                             cfg.avg_num_neighbors, cfg.parity),
                       opb, (dxo,))
    del opb, dxo
    e2 = bf16_pair("K8-bf16", f"stack-bf16 main path E={e}", *stack_bf16_calls(cfg, params, k)[:2],
                   ops, ("x",), K8_NAMES, gen)
    all_errs["K8-bf16"] = {kind: max(all_errs["K8-bf16"][kind], e2[kind]) for kind in e2}
    res = {}
    for kind, ms, pms in (("fwd", times[0], times[2]), ("bwd", times[1], times[3])):
        bwd = kind == "bwd"
        flops, nbytes = k8_cost(w, e, bwd, nb=2)
        res[kind] = timing(ms, pms, flops, k8_products(w, bwd) * e, nbytes,
                           k8_weight_bytes(w, bwd, n_tiles(e, k)) // 2, PEAK_BF16_FLOPS)
        print_timing(f"K8-bf16 {kind} E={e} ({cfg.num_layers} layers)", res[kind])
    return {"K8-bf16": res}


def bf16_phase(card):
    """Phase 20: the bf16 tiers.  Kernel parity of the three bf16 builds
    (``bf16_parity``); model parity of the K1 tier and the per-layer paths
    tier at interior="bf16" (``bf16_model_parity``); the main paths at full
    width (``main_path``): phase 5's run at interior="bf16" (3 + 3 K1-bf16
    launches per force evaluation and no other kernel), the per-layer paths
    tier at bf16 (3 + 3 K2-bf16) and phase 6's NequIP run under
    PAT_NEQUIP_HJ=bf16 (3 + 3 K3-bf16), the embed/readout form under
    PAT_L1_EMBED=1 (1 K6-bf16, 1 K1-bf16 and 1 K7-bf16 each way) and the
    stack (1 + 1 K8-bf16) at interior="bf16", each beside its f32 path's
    steps/s and peak memory from this run; the bf16 kernels' timings at
    those paths' shapes.  Returns (errs, times, counts)."""
    import torch

    errs = bf16_parity()
    ref = bf16_model_parity({}, {"K1-bf16": 3})
    bf16_model_parity(dict(layer_fused=False), {"K2-bf16": 3}, ref=ref)
    bf16_model_parity({}, {"K6-bf16": 1, "K1-bf16": 1, "K7-bf16": 1}, {"PAT_L1_EMBED": "1"}, ref)
    bf16_model_parity(dict(fused_stack=True), {"K8-bf16": 1}, ref=ref)
    times, counts = {}, {}
    for path, f32_path in (("allegro-bf16", "allegro"), ("perlayer-bf16", "perlayer"),
                           ("nequip-hj-bf16", "nequip"), ("embed-bf16", "embed"),
                           ("stack-bf16", "stack")):
        with env_vars(PATHS[path][5]):
            cfg, params, system, eng, c = main_path(path)
            kernel = PATHS[path][2]
            for name in path_launches(path, cfg):
                counts.setdefault(path, {})[name] = c[name]
            counts.setdefault(kernel, c[kernel])
            print(f"{path} main path on {card}: {STEPS_PER_S[path]:.4f} steps/s against "
                  f"{f32_path}'s {STEPS_PER_S.get(f32_path, float('nan')):.4f} in this run "
                  f"({STEPS_PER_S[path] / STEPS_PER_S.get(f32_path, float('nan')):.3f}x); peak "
                  f"device memory of the timed chunk {PEAK_GIB[path]:.2f} GiB against "
                  f"{PEAK_GIB.get(f32_path, float('nan')):.2f} GiB")
            times.update(bf16_timings(path, cfg, params, system, eng, errs))
        del cfg, params, system, eng
        torch.cuda.empty_cache()
    return errs, times, counts


# ---------------------------------------------------------------------------
# Phase 21: the matmul precision policy (ops/prec.py)
# ---------------------------------------------------------------------------

# each kernel mode of the layer body on f32 operands: the policy that picks
# it, its build's id suffix, and its products' rate for the bound (bf16x3:
# three bf16 passes at PEAK_BF16_FLOPS; one pass: one)
MODES = {"tf32x3": ("highest", "", PEAK_TF32_FLOPS / 3),
         "bf16x3": ("kernel_high", "-bf16x3", PEAK_BF16_FLOPS / 3),
         "bf16": ("default", "-1pass", PEAK_BF16_FLOPS)}
# a build against its plain version at its mode (atol, rtol on
# max|plain|): bf16x3 as the 3xTF32 builds (TOLS); one pass half of
# BF16_TOLS (an activation near a bf16 rounding boundary rounds the other
# way on the two sides, and the flip carries through the layer's later
# products: an H100 read 1.9e-3 of max|V'| on K1's first form)
MODE_TOLS = {"bf16x3": TOLS, "bf16": {"fwd": (1e-4, 4e-3), "bwd": (1e-4, 8e-3)}}
# the share of the bf16x3 plain version's departure from the 3xTF32 one
# that a build reproduces (``mode_share``): ~1 for the bf16x3 build, ~0 for
# the 3xTF32 build, which must fail this gate; the mode's departure is
# ~1e-5 of max, below any max-norm gate the kernels' own sum order passes
SHARE_GATE = (0.75, 1.25)
POLICIES = ("highest", "mixed", "kernel_high", "high", "default")


def mode_share(got, ref, base):
    """<got - base, ref - base> / |ref - base|^2 over every f32 output:
    the share of ``ref``'s departure from ``base`` that ``got`` reproduces.
    A bf16 output (K3's dhj with a bf16 hj) is left out: both sides round
    it to bf16, and its one-ulp flips would outweigh the mode's departure."""
    import torch

    num = den = 0.0
    for a, b, c in zip(got, ref, base):
        if b.dtype == torch.bfloat16:
            continue
        d = b.detach().double() - c.detach().double()
        num += float(((a.detach().double() - c.detach().double()) * d).sum())
        den += float((d * d).sum())
    return num / den


def must_fail(kernel, label, kind, got, ref, tols):
    """A control: ``got`` must be farther from ``ref`` than ``tols`` allow
    (atol + rtol max|ref|) for at least one output."""
    atol, rtol = tols
    worst = max(max_err(a, b) / (atol + rtol * float(b.detach().abs().max()))
                for a, b in zip(got, ref))
    print(f"{kernel} control {label} {kind}: {worst:.2f} x its gate (must exceed 1)")
    if not worst > 1.0:
        raise RuntimeError(f"{kernel} control {label} {kind} passed a gate it must fail")
    return worst


def mode_check(tag, label, kind, names, got, want, tols):
    """``check`` of each output at ``tols``, a bf16 output (K3's dhj with a
    bf16 hj, rounded to bf16 on both sides: a one-ulp flip of an element
    near max exceeds the f32 gates) at BF16_TOLS."""
    import torch

    return max(check(tag, label, kind, (nm,), (a,), (b,),
                     BF16_TOLS[kind] if b.dtype == torch.bfloat16 else tols)
               for nm, a, b in zip(names, got, want))


# the builds K3 with a bf16 hj launches in each mode
K3HJ_IDS = {"tf32x3": "K3-bf16", "bf16x3": "K3hj-bf16x3", "bf16": "K3hj-1pass"}


def policy_compare(kernel, label, fn, ref, ops, names, outs, ids=None):
    """Phase 21: a kernel's wrapper ``fn`` under each mode's policy against
    its plain version ``ref(mode)`` at that mode, forward and backward
    (seeded cotangents), with exactly one launch each way of the mode's
    build (``ids[mode]``, by default ``kernel`` and the mode's suffix); the
    bf16x3 build within TOLS, the one-pass build within MODE_TOLS (a bf16
    output within BF16_TOLS: ``mode_check``), each build's share of its
    mode's departure within SHARE_GATE; the controls: the 3xTF32 build's
    share outside SHARE_GATE, the one-pass build beyond the bf16x3 gate and
    beyond TOLS against the 3xTF32 plain version.  Returns {mode: {"fwd":
    err, "bwd": err, "share": (f, b)}}."""
    import torch

    from pair_allegro_tpu_torch.ops.prec import matmul_precision

    mods = kernel_modules()
    ids = ids or {mode: kernel + b for mode, (_, b, _) in MODES.items()}
    res, cots = {}, None
    for mode, (pol, b, _) in MODES.items():
        ins = [t.detach().clone().requires_grad_(True) for t in ops]
        before = {n: (m.launches.fwd, m.launches.bwd) for n, m in mods.items()}
        with matmul_precision(pol):
            out_k = _tup(fn(*ins))
            if cots is None:
                g = torch.Generator(device="cpu").manual_seed(SEED)
                cots = [torch.randn(o.shape, generator=g).to(o.device) for o in out_k]
            g_k = torch.autograd.grad(out_k, ins, cots)
        torch.cuda.synchronize()
        grew = {n: (m.launches.fwd - before[n][0], m.launches.bwd - before[n][1])
                for n, m in mods.items() if (m.launches.fwd, m.launches.bwd) != before[n]}
        if grew != {ids[mode]: (1, 1)}:
            raise RuntimeError(f"{kernel} {label} under {pol}: launched {grew}, want "
                               f"{{{ids[mode]!r}: (1, 1)}}")
        refs = [t.detach().clone().requires_grad_(True) for t in ops]
        out_r = _tup(ref(mode)(*refs))
        g_r = torch.autograd.grad(out_r, refs, cots)
        res[mode] = ((out_k, g_k), (out_r, g_r))
    errs = {}
    base = res["tf32x3"][1]
    for mode in ("bf16x3", "bf16"):
        (out_k, g_k), (out_r, g_r) = res[mode]
        tag = ids[mode]
        errs[mode] = {kind: mode_check(tag, label, kind, nm, got, want, MODE_TOLS[mode][kind])
                      for kind, nm, got, want in (("fwd", outs, out_k, out_r),
                                                  ("bwd", names, g_k, g_r))}
        shares = tuple(mode_share(got, want, b0) for got, want, b0 in
                       ((out_k, out_r, base[0]), (g_k, g_r, base[1])))
        errs[mode]["share"] = shares
        print(f"{tag} {label}: share of the {mode} plain version's departure from the tf32x3 "
              f"one {shares[0]:.4f} fwd, {shares[1]:.4f} bwd (gate {SHARE_GATE})")
        if not all(SHARE_GATE[0] <= x <= SHARE_GATE[1] for x in shares):
            raise RuntimeError(f"{tag} {label} does not compute the {mode} products")
    (k32, g32), _ = res["tf32x3"]
    (kx3, gx3), (rx3, grx3) = res["bf16x3"]
    shares = (mode_share(k32, rx3, base[0]), mode_share(g32, grx3, base[1]))
    print(f"{kernel} control {label}: the 3xTF32 build's share of the bf16x3 departure "
          f"{shares[0]:.4f} fwd, {shares[1]:.4f} bwd (must lie outside {SHARE_GATE})")
    if all(SHARE_GATE[0] <= x <= SHARE_GATE[1] for x in shares):
        raise RuntimeError(f"{kernel} control {label}: the 3xTF32 build passed the bf16x3 gate")
    (k1p, g1p), _ = res["bf16"]
    for kind, got, want_x3, want_32 in (("fwd", k1p, rx3, base[0]), ("bwd", g1p, grx3, base[1])):
        must_fail(kernel + "-1pass", f"{label} against the bf16x3 plain", kind, got, want_x3,
                  MODE_TOLS["bf16x3"][kind])
        must_fail(kernel + "-1pass", f"{label} against the tf32x3 plain", kind, got, want_32,
                  TOLS[kind])
    del res
    torch.cuda.empty_cache()
    return errs


def policy_parity():
    """Phase 21's kernel legs on the 500-atom table at flagship widths
    (``policy_compare``): K1 in its three forms, K6, K7 with the charge head
    and K8 (3 layers), and K6 under PAT_EMBED_PREC=highest (its prologue
    3xTF32 in the bf16x3 and one-pass builds); K2 (the per-layer tier's
    second layer) and K3 with an f32 and a bf16 hj (the NequIP path's first
    layer) on the 500-atom table, and K4 (the second layer) on a 256-atom
    dense build, all edges and a tail that is no multiple of any edge tile,
    each at l_max 2 and 1.  Returns {kernel id: {"fwd": err, "bwd": err}} of
    each build."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine
    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import env_layer as k2
    from pair_allegro_tpu_torch.ops import fused_layer as fl
    from pair_allegro_tpu_torch.ops import fused_stack as k8
    from pair_allegro_tpu_torch.ops import nequip_conv as k3
    from pair_allegro_tpu_torch.ops import readout_layer as k7
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    errs = {}

    def keep(kernel, e):
        for mode, b in (("bf16x3", "-bf16x3"), ("bf16", "-1pass")):
            cur = errs.setdefault(kernel + b, {"fwd": 0.0, "bwd": 0.0})
            for kind in ("fwd", "bwd"):
                cur[kind] = max(cur[kind], e[mode][kind])

    cfg, params, system = make_case(5, None, output_charges=True)
    eng = AllegroEngine(cfg, params, system)
    ops, Y, u, k = layer_operands(cfg, params, system, eng)
    avg = cfg.avg_num_neighbors
    inv_avg = 1.0 / math.sqrt(avg)
    for li, (form, (first_v, last)) in enumerate(FORMS.items()):
        w = fl.k1_weights(params["layers"][li], cfg.l_max, cfg.parity)
        keep("K1", policy_compare(
            "K1", f"{form:6s} 500 atoms",
            lambda *a, fv=first_v, la=last, w=w: fl.fused_layer(*a, w, k, avg, first_v=fv, last=la),
            lambda m, fv=first_v, la=last, w=w: (
                lambda *a: fl.fused_layer_reference(*a, w, k, inv_avg, fv, la, m)),
            (*ops[form], Y, u), K1_NAMES, ("x'",) if last else ("x'", "V'")))
    ops6, ops7, k = er_operands(cfg, params, system, eng)
    w6 = k6.k6_weights(params, cfg.l_max, cfg.parity)
    w7 = k7.k7_weights(params, cfg.l_max, cfg.parity, cfg.output_charges)
    for env in ({}, {"PAT_EMBED_PREC": "highest"}):
        with env_vars(env):
            keep("K6", policy_compare(
                "K6", f"500 atoms K={k}{' PAT_EMBED_PREC=highest' if env else ''}",
                lambda *a: k6.embed_layer(*a, w6, k, avg),
                lambda m: (lambda *a: k6.embed_layer_reference(*a, w6, k, inv_avg, mode=m)),
                ops6, K6_NAMES, ("x'", "V'")))
    keep("K7", policy_compare(
        "K7", f"500 atoms K={k}, charge head", lambda *a: k7.readout_layer(*a, w7, k, avg),
        lambda m: (lambda *a: k7.readout_layer_reference(*a, w7, k, inv_avg, mode=m)),
        ops7, K1_NAMES, ("e", "q")))
    cfg, params, system = make_case(5, None, fused_stack=True)
    ops8, k = stack_operands(cfg, params, system, AllegroEngine(cfg, params, system))
    args = (params["layers"], k, cfg.l_max, cfg.avg_num_neighbors, cfg.parity)
    keep("K8", policy_compare(
        "K8", f"{cfg.num_layers} layers 500 atoms K={k}", lambda *o: k8.fused_stack(*o, *args),
        lambda m: (lambda *o: k8.allegro_stack_reference(*o, *args, mode=m)),
        ops8, K8_NAMES, ("x",)))
    for lmax in (2, 1):
        cfg, params, system = make_case(5, None, l_max=lmax)
        ops2, k = env_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        w2 = k2.k2_weights(params["layers"][1]["mix"], cfg.l_max, cfg.parity)
        avg = cfg.avg_num_neighbors
        keep("K2", policy_compare(
            "K2", f"l_max={lmax} 500 atoms K={k}", lambda *a: k2.env_layer(*a, w2, k, avg),
            lambda m: (lambda *a: k2.env_layer_reference(*a, w2, k, 1.0 / math.sqrt(avg), m)),
            ops2, K2_NAMES, ("V'", "inv")))
        cfg, params, system = make_case(4, None, l_max=lmax)
        (V, env), w4 = k4_operands(cfg, params, system, AllegroEngine(cfg, params, system))
        e = V.shape[-1]
        cut = e - 13 if (e - 13) % 8 else e - 14
        for lab, ops4 in ((f"E={e}", (V, env)),
                          (f"tail E={cut}", (V[..., :cut].contiguous(),
                                             env[..., :cut].contiguous()))):
            keep("K4", policy_compare(
                "K4", f"l_max={lmax} 256 atoms dense {lab}", lambda *a: k4.tp_mix_fused_t(*a, w4),
                lambda m: (lambda *a: k4.tp_mix_fused_reference(*a, w4, m)),
                ops4, K4_NAMES, ("V'", "inv")))
        cfg, params, system = make_nequip_case(5, None, l_max=lmax)
        ops3, w3, k = k3_operands(cfg, params, system, NequIPEngine(cfg, params, system))
        avg = cfg.avg_num_neighbors
        for hj, kid, ids in ((torch.float32, "K3", None), (torch.bfloat16, "K3hj", K3HJ_IDS)):
            keep(kid, policy_compare(
                "K3", f"{'bf16' if ids else 'f32'} hj l_max={lmax} T={w3.n_tracks} 500 atoms "
                f"K={k}", lambda *a: k3.nequip_conv(*a, w3, k, avg),
                lambda m: (lambda *a: k3.nequip_conv_reference(*a, w3, k, 1.0 / math.sqrt(avg),
                                                               m)),
                (ops3[0].to(hj), *ops3[1:]), K3_NAMES, ("agg",), ids))
        del ops2, ops3, V, env
        torch.cuda.empty_cache()
    return errs


def glue_leg():
    """Phase 21's glue leg: a potential (``potential.make_potential``) whose
    energy is a cuBLAS product of the port's glue (``ops/mlp.mlp_apply``'s
    first layer, 192 -> 256 features of 4,096 atoms) and whose forces are
    its backward (features sin(pos * a) with arguments below 3, so that
    their own f32 rounding stays at ~1e-7), on the card at f32 against the
    same at f64: under 'high' the product and the forces show TF32-size
    error (> 5e-5 of max), under
    'highest' and after the context exits f32 error (< 5e-6), and the
    strain's pinned products (``prec.exact_mm``) stay f32 under 'high'.
    Returns {policy: (product error, force error)}."""
    import torch

    from pair_allegro_tpu_torch.ops import prec
    from pair_allegro_tpu_torch.ops.mlp import mlp_apply
    from pair_allegro_tpu_torch.potential import make_potential

    g = torch.Generator(device="cpu").manual_seed(SEED)
    pos64 = torch.rand(4096, 3, generator=g, dtype=torch.float64) * 20.0
    w64 = torch.randn(192, 256, generator=g, dtype=torch.float64)
    c64 = torch.randn(4096, 256, generator=g, dtype=torch.float64)
    cell64 = torch.eye(3, dtype=torch.float64) * 20.0 + torch.randn(3, 3, generator=g,
                                                                     dtype=torch.float64)

    def energy_fn(pos, types, edge_index, cell=None, **kw):
        feat = torch.cat([torch.sin(pos * ((j + 1) / 448.0)) for j in range(64)], -1)
        h = mlp_apply({"w": [w.to(pos.dtype)]}, feat)  # one glue product, times 1/sqrt(192)
        e_atom = (h * c.to(pos.dtype)).sum(-1) + (cell * cell).sum() / pos.shape[0]
        return {"total_energy": e_atom.sum(), "atomic_energy": e_atom, "h": h}

    def run(dev, dtype):
        nonlocal w, c
        w, c = w64.to(dev, dtype), c64.to(dev, dtype)
        pot = make_potential(energy_fn)
        out = pot(pos64.to(dev, dtype), None, None, cell=cell64.to(dev, dtype))
        return out.extras["h"].double().cpu(), out.forces.double().cpu(), out.virial.double().cpu()

    w = c = None
    h_ref, f_ref, v_ref = run("cpu", torch.float64)
    flag = torch.backends.cuda.matmul.allow_tf32
    errs = {}
    for label, pol in (("high", "high"), ("highest", "highest"), ("after the context", None)):
        if pol:
            with prec.matmul_precision(pol):
                h, f, v = run("cuda", torch.float32)
        else:
            h, f, v = run("cuda", torch.float32)
        eh = float((h - h_ref).abs().max() / h_ref.abs().max())
        ef = float((f - f_ref).abs().max() / f_ref.abs().max())
        ev = float((v - v_ref).abs().max() / v_ref.abs().max())
        errs[label] = (eh, ef)
        tf32 = pol == "high"
        print(f"glue leg under {label}: the product's error {eh:.3e} of max, the forces' (its "
              f"backward) {ef:.3e}, the virial's {ev:.3e} ({'TF32' if tf32 else 'f32'} expected: "
              f"{'> 5e-5' if tf32 else '< 5e-6'}); cuBLAS TF32 flag after the call "
              f"{torch.backends.cuda.matmul.allow_tf32}")
        if tf32 and not (eh > 5e-5 and ef > 5e-5):
            raise RuntimeError("glue leg: 'high' did not reach cuBLAS's TF32 both ways")
        if not tf32 and not (eh < 5e-6 and ef < 5e-6):
            raise RuntimeError(f"glue leg: f32 error expected under {label}")
        if torch.backends.cuda.matmul.allow_tf32 != flag:
            raise RuntimeError("glue leg: the TF32 flag was not restored")
    # the pinned products: exact both ways under 'high'
    a64 = torch.randn(2048, 512, generator=g, dtype=torch.float64)
    b64 = torch.randn(512, 384, generator=g, dtype=torch.float64)
    g64 = torch.randn(2048, 384, generator=g, dtype=torch.float64)
    a = a64.cuda().float().requires_grad_(True)
    with prec.matmul_precision("high"), prec.glue_scope():
        y = prec.exact_mm(a, b64.cuda().float())
    (ga,) = torch.autograd.grad(y, a, g64.cuda().float())
    ey = float((y.double().cpu() - a64 @ b64).abs().max() / (a64 @ b64).abs().max())
    eg = float((ga.double().cpu() - g64 @ b64.T).abs().max() / (g64 @ b64.T).abs().max())
    print(f"glue leg: exact_mm under 'high' {ey:.3e} of max, its backward {eg:.3e} (< 5e-6)")
    if not (ey < 5e-6 and eg < 5e-6):
        raise RuntimeError("glue leg: exact_mm is not exact under 'high'")
    errs["exact_mm"] = (ey, eg)
    return errs


def policy_timings(kid, cfg, params, system, eng, mode, errs):
    """Phase 21's timings of K2, K4, K3 or K3hj (K3 with a bf16 hj) at the
    main path's shapes (CUDA events, warm): fwd / bwd ms of the build of
    ``mode`` and of the 3xTF32 build, timed alternately in this call, the
    plain version's at ``mode``, and the bound with the products at the
    mode's rate; the build held against the plain version there
    (MODE_TOLS; a bf16 dhj at BF16_TOLS), into ``errs``.  Returns {kind:
    row}, each row with ``ms_tf32x3`` beside ``ms``."""
    import torch

    from pair_allegro_tpu_torch.ops import env_layer as k2
    from pair_allegro_tpu_torch.ops import nequip_conv as k3
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    gen = torch.Generator(device=system.device).manual_seed(SEED)
    rate = MODES[mode][2]
    tag = K3HJ_IDS[mode] if kid == "K3hj" else kid + MODES[mode][1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    if kid == "K2":
        ops, k = env_operands(cfg, params, system, eng)
        w = k2.k2_weights(params["layers"][1]["mix"], cfg.l_max, cfg.parity)
        e, names, outs = ops[0].shape[-1], K2_NAMES, ("V'", "inv")

        def fwd(m):
            return k2._kernel_fwd(*ops, w, k, inv_avg, m)

        def bwd(m):
            return k2._kernel_bwd(*ops, w, k, inv_avg, *cots, m)

        def plain(*a):
            return k2.env_layer_reference(*a, w, k, inv_avg, mode)

        def cost(b):
            flops, nbytes = k2_cost(w, e, b)
            _, _, ring = k2.block_layout(w.c, w.cout, ops[0].shape[0], w.lmax, w.parity, b)
            return flops, mix_products(w) * e, nbytes, mix_weight_bytes(w, b, n_tiles(e, k), ring)
    elif kid == "K4":
        ops, w = k4_operands(cfg, params, system, eng)
        e, names, outs = ops[0].shape[-1], K4_NAMES, ("V'", "inv")

        def fwd(m):
            return k4._kernel_fwd(*ops, w, m)

        def bwd(m):
            return k4._kernel_bwd(*ops, w, *cots, m)

        def plain(*a):
            return k4.tp_mix_fused_reference(*a, w, mode)

        def cost(b):
            flops, nbytes = k4_cost(w, e, b)
            _, tile, ring = k4.block_layout(w.c, w.cout, ops[0].shape[0], w.lmax, w.parity, b)
            return flops, mix_products(w) * e, nbytes, mix_weight_bytes(w, b, -(-e // tile), ring)
    else:
        ops, w, k = k3_operands(cfg, params, system, eng)
        hj_bf16 = kid == "K3hj"
        ops = (ops[0].to(torch.bfloat16), *ops[1:]) if hj_bf16 else ops
        e, names, outs = ops[0].shape[0], K3_NAMES, ("agg",)
        df = ops[0].shape[1]

        def fwd(m):
            return k3._kernel_fwd(*ops, w, k, inv_avg, m)

        def bwd(m):
            return k3._kernel_bwd(*ops, w, k, inv_avg, *cots, m)

        def plain(*a):
            return k3.nequip_conv_reference(*a, w, k, inv_avg, mode)

        def cost(b):
            flops, prod, nbytes = k3_cost(w, e, k, b)
            if hj_bf16:
                nbytes -= 2 * df * e * (2 if b else 1)  # hj (and dhj) at 2 bytes
            return flops, prod, nbytes, k3_weight_bytes(w, e, k, b)
    out = _tup(fwd(mode))
    cots = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype) for o in out]
    got = (out, bwd(mode))
    ms = {}
    for kind, call in (("fwd", fwd), ("bwd", bwd)):
        runs = {m: [] for m in (mode, "tf32x3")}
        for _ in range(2):  # the mode's build and the 3xTF32 one, alternately
            for m in runs:
                runs[m].append(cuda_ms(lambda: call(m), 5))
        ms[kind] = {m: sum(r) / len(r) for m, r in runs.items()}
    with torch.no_grad():
        p_f = cuda_ms(lambda: plain(*ops), 2)
    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    ref = _tup(plain(*ins))
    p_b = cuda_ms(lambda: torch.autograd.grad(ref, ins, cots, retain_graph=True), 2)
    want = (ref, torch.autograd.grad(ref, ins, cots))
    torch.cuda.synchronize()
    label = f"main path E={e}"
    for i, (kind, nm) in enumerate((("fwd", outs), ("bwd", names))):
        errs[kind] = max(errs[kind], mode_check(tag, label, kind, nm, got[i], want[i],
                                                MODE_TOLS[mode][kind]))
    del ins, ref, want, got, out
    torch.cuda.empty_cache()
    res = {}
    for kind, pms in (("fwd", p_f), ("bwd", p_b)):
        flops, prod, nbytes, staged = cost(kind == "bwd")
        res[kind] = dict(timing(ms[kind][mode], pms, flops, prod, nbytes, staged, rate),
                         ms_tf32x3=ms[kind]["tf32x3"])
        print_timing(f"{tag} {kind} E={e}", res[kind])
        print(f"{tag} {kind} E={e}: {ms[kind][mode]:.4f} ms against the 3xTF32 build's "
              f"{ms[kind]['tf32x3']:.4f} ms in this call "
              f"({ms[kind][mode] / ms[kind]['tf32x3']:.3f}x)")
    return res


def policy_phase(card):
    """Phase 21: the matmul precision policy.  The bf16x3 and one-pass
    builds of K1, K6, K7, K8, K2, K4 and K3 against their plain versions at
    each mode with the wrong-mode controls (``policy_parity``); the glue leg
    (``glue_leg``); the K1, embed, stack, per-layer, FLAT, NequIP and
    NequIP bf16-hj main paths under kernel_high (the default: the bf16x3
    builds, exact launch counts) and default (the one-pass builds), their
    steps/s beside the same paths' under highest (POLICY_BASE); the new
    builds' timings at those paths' shapes (bounds at the mode's product
    rate; K2, K4 and K3 beside their 3xTF32 builds in this call).  Returns
    (errs, times, counts, glue)."""
    import torch

    from pair_allegro_tpu_torch.ops.prec import matmul_precision

    errs = policy_parity()
    glue = glue_leg()
    times, counts = {}, {}
    for path, (f32_path, kid) in POLICY_BASE.items():
        if f32_path not in STEPS_PER_S:  # its 'highest' run, where no earlier phase made it
            main_path(f32_path)
            torch.cuda.empty_cache()
        for mode in ("bf16x3", "bf16"):
            pol, b, rate = MODES[mode]
            name = f"{path}-{b[1:]}"
            cfg, params, system, eng, c = main_path(name)
            for kern in path_launches(name, cfg):
                counts.setdefault(name, {})[kern] = c[kern]
            print(f"{name} main path on {card} under policy {pol}: {STEPS_PER_S[name]:.4f} "
                  f"steps/s against {f32_path}'s {STEPS_PER_S.get(f32_path, float('nan')):.4f} "
                  f"under highest in this run "
                  f"({STEPS_PER_S[name] / STEPS_PER_S.get(f32_path, float('nan')):.3f}x); peak "
                  f"{PEAK_GIB[name]:.2f} GiB against {PEAK_GIB.get(f32_path, float('nan')):.2f}")
            tag = K3HJ_IDS[mode] if kid == "K3hj" else kid + b
            with env_vars(PATHS[name][5]), matmul_precision(pol):
                zero = {"fwd": 0.0, "bwd": 0.0}
                tols = MODE_TOLS[mode]
                if path == "allegro":
                    times[tag] = k1_timings(cfg, params, system, eng, errs[tag], rate, tag, tols)
                elif path == "embed":
                    r, e = er_timings(cfg, params, system, eng,
                                      {"K6": errs["K6" + b], "K7": errs["K7" + b]}, rate, b, tols)
                    errs["K6" + b], errs["K7" + b] = e["K6"], e["K7"]
                    times["K6" + b] = {kind: r[("K6", kind)] for kind in ("fwd", "bwd")}
                    times["K7" + b] = {kind: r[("K7", kind)] for kind in ("fwd", "bwd")}
                elif path == "stack":
                    times[tag], errs[tag] = stack_timings(
                        cfg, params, system, eng, dict(errs.get(tag, zero)), rate, tag, tols)
                else:
                    times[tag] = policy_timings(kid, cfg, params, system, eng, mode, errs[tag])
            del cfg, params, system, eng
            torch.cuda.empty_cache()
    for path, (f32_path, _) in POLICY_BASE.items():
        print(f"{path} steps/s by policy on {card}: highest "
              f"{STEPS_PER_S.get(f32_path, float('nan')):.4f}, kernel_high "
              f"{STEPS_PER_S[path + '-bf16x3']:.4f}, default {STEPS_PER_S[path + '-1pass']:.4f}")
    return errs, times, counts, glue


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


class PhaseClock:
    """Prints each phase's wall seconds and the script's so far."""

    def __init__(self, t0):
        self.t0 = self.last = t0

    def __call__(self, label):
        now = time.perf_counter()
        print(f"phase clock: phase {label} {now - self.last:.1f} s, script {now - self.t0:.1f} s",
              flush=True)
        self.last = now


def kernel_entry(name, source, replaces, counts, kind, err, r, kid=None, **extra):
    """One kernel of the last line's list; ``kernel`` is its id (K1 .. K8,
    a bf16 build with -bf16), read from ``name`` unless ``kid`` gives it."""
    kid = kid or name.split("_")[0].upper() + ("-bf16" if "_bf16_" in name else "")
    return {"name": name, "kernel": kid, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[kind], "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from pair_allegro_tpu_torch.ops.prec import set_matmul_precision

    # every phase but 21 (and 15's policy loop) holds the 3xTF32 builds and
    # exact f32 glue: the 'highest' policy; phase 21 sets each policy itself
    set_matmul_precision("highest")
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
    if sys.argv[1:2] == ["--sharded"]:  # phase 19 alone
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        for name in ("K1", "K2", "K3", "K4"):
            kernel_modules()[name].LIB.start()
        for name in ("K1", "K2", "K3", "K4"):
            kernel_modules()[name].LIB.load()
        sharded_phase(card)
        return 0
    if sys.argv[1:2] == ["--policy"]:  # phases 21 and 15 alone
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
        policy_phase(card)  # runs each path's 'highest' run beside its own
        accuracy_phase(every_tier=True)
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
    t0_wall = time.time()
    libs = {}
    for name, mod in kernel_modules().items():  # K6 and K7 share one library
        libs.setdefault(id(mod.LIB), (name, mod.LIB))
    libs = list(libs.values())
    # one nvcc per source, as many at once as the host has cores, in the
    # order the phases first use them (K1 first): phase 2 waits on K1's
    # build alone, and each later library is loaded at its first use (a
    # library's load waits on its build); load_all reports them all
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 8)
    builds = [pool.submit(lib.load) for _, lib in libs]
    pool.shutdown(wait=False)
    kernel_modules()["K1"].LIB.load()
    clock = PhaseClock(t0)
    clock("1 (K1 built; the other builds continue)")

    def load_all():
        for (name, lib), build in zip(libs, builds):
            build.result()
            started = f"{lib.started - t0_wall:.1f} s" if lib.build_seconds else "(cached)"
            print(f"{name} build: nvcc {lib.build_seconds or 0.0:.1f} s, started at {started}")
            for line in lib.paths()[1].read_text().splitlines():
                if "registers" in line or "Function properties for" in line or "spill" in line:
                    print(f"ptxas {name}:", line.strip())

    from pair_allegro_tpu_torch.engine import AllegroEngine

    cfg, params, system = make_case(5, None)
    errs = k1_parity(cfg, params, system, AllegroEngine(cfg, params, system))
    clock("2")
    errs3 = k3_parity()
    errs_env = env_parity()
    clock("3")
    model_parity()
    perlayer_model_parity()
    nequip_model_parity()
    clock("4")
    errs4 = k4_parity()
    flat_model_parity()
    clock("9 (parity)")
    errs_er = er_parity()
    model_parity({"PAT_L1_EMBED": "1"}, {"K6": 1, "K1": 1, "K7": 1})
    model_parity({"PAT_L1_POSITIONAL": "0"})
    clock("11")
    errs8 = stack_parity()
    model_parity(want={"K8": 1}, tier=dict(fused_stack=True))
    f64_parity()
    clock("13")
    cfg, params, system, eng, counts = main_path("allegro")
    counts = counts["K1"]
    times = k1_timings(cfg, params, system, eng, errs)
    del cfg, params, system, eng
    torch.cuda.empty_cache()
    clock("5 and 7 (K1)")
    ncfg, nparams, nsystem, neng, counts3 = main_path("nequip")
    counts3 = counts3["K3"]
    times3, errs3 = k3_timings(ncfg, nparams, nsystem, neng, errs3)
    del nparams, nsystem, neng
    torch.cuda.empty_cache()
    clock("6 and 7 (K3)")
    pcfg, pparams, psystem, peng, counts2 = main_path("perlayer")
    counts2 = counts2["K2"]
    times_env = env_timings(pcfg, pparams, psystem, peng, errs_env)
    del pparams, psystem, peng
    torch.cuda.empty_cache()
    counts5 = main_path("perlayer-mxu")[-1]["K5"]
    torch.cuda.empty_cache()
    clock("8")
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
    clock("10")
    ecfg, eparams, esystem, eeng, counts_e = main_path("embed")
    times_er, errs_er = er_timings(ecfg, eparams, esystem, eeng, errs_er)
    del eparams, esystem, eeng
    torch.cuda.empty_cache()
    clock("12")
    scfg, sparams, ssystem, seng, counts_s = main_path("stack")
    times8, errs8 = stack_timings(scfg, sparams, ssystem, seng, errs8)
    del sparams, ssystem, seng
    torch.cuda.empty_cache()
    clock("14")
    # phases 9-14 ran while the last builds finished, each loading its own
    # library at first use; every build's report prints here
    load_all()
    clock("1 (every build loaded)")
    card = smi.stdout.strip().splitlines()[0]
    errs21, times21, counts21, _ = policy_phase(card)
    clock("21")
    errs20, times20, counts20 = bf16_phase(card)
    clock("20")
    accuracy_phase()
    clock("15")
    cli_phase(card)
    clock("16")
    counts17, _ = scale_phase(card)
    clock("17")
    train_phase(card)
    clock("18")
    sharded = sharded_phase(card)
    clock("19")

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
            halo_path_launches=sharded["halo_md"]["halo"]["launches"]["K1"][0 if kind == "fwd" else 1],
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
    # the bf16 builds (phase 20): the bound with the bf16 products at
    # PEAK_BF16_FLOPS (K3's products stay 3xTF32) and the bf16 numbers at 2 bytes
    for kind, line in (("fwd", 1094), ("bwd", 1139)):
        per = {f: times20["K1-bf16"][(f, kind)] for f in FORMS}
        total = {key: sum(r[key] for r in per.values()) for key in ("ms", "plain_ms", "bound_ms")}
        total["bound_by"] = ("operations" if all(r["bound_by"] == "operations"
                                                 for r in per.values()) else "bytes")
        kernels.append(kernel_entry(
            f"k1_fused_layer_bf16_{kind}", "pair_allegro_tpu_torch/csrc/fused_layer_bf16.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts20["K1-bf16"], kind,
            errs20["K1-bf16"][kind], total, dtype="bf16",
            ms_by_form={f: r["ms"] for f, r in per.items()},
            plain_ms_by_form={f: r["plain_ms"] for f, r in per.items()},
            bound_ms_by_form={f: r["bound_ms"] for f, r in per.items()},
        ))
    for kind, line in (("fwd", 803), ("bwd", 823)):
        kernels.append(kernel_entry(
            f"k2_env_layer_bf16_{kind}", "pair_allegro_tpu_torch/csrc/env_layer_bf16.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts20["K2-bf16"], kind,
            errs20["K2-bf16"][kind], times20["K2-bf16"][kind], per="call",
            calls_per_force_evaluation=pcfg.num_layers, dtype="bf16",
        ))
    for kind, line in (("fwd", 289), ("bwd", 401)):
        kernels.append(kernel_entry(
            f"k3_nequip_conv_bf16_{kind}", "pair_allegro_tpu_torch/csrc/nequip_conv_bf16.cu",
            f"pair_allegro_tpu/ops/pallas_nequip.py:{line}", counts20["K3-bf16"], kind,
            errs20["K3-bf16"][kind], times20["K3-bf16"][kind], per="call",
            calls_per_force_evaluation=ncfg.num_layers, dtype="bf16 hj",
        ))
    for kind, line6, line7 in (("fwd", 1404, 1538), ("bwd", 1439, 1572)):
        # one call each (the first and the last layer) per force evaluation
        for name, stem, line in (("K6-bf16", "k6_embed_layer_bf16", line6),
                                 ("K7-bf16", "k7_readout_layer_bf16", line7)):
            kernels.append(kernel_entry(
                f"{stem}_{kind}", "pair_allegro_tpu_torch/csrc/embed_readout_layer_bf16.cu",
                f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts20["embed-bf16"][name], kind,
                errs20[name][kind], times20[name][kind], per="call", calls_per_force_evaluation=1,
                k1_launches_on_the_path=counts20["embed-bf16"]["K1-bf16"][kind], dtype="bf16",
            ))
    for kind, line in (("fwd", 538), ("bwd", 572)):
        kernels.append(kernel_entry(
            f"k8_fused_stack_bf16_{kind}", "pair_allegro_tpu_torch/csrc/fused_stack_bf16.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts20["K8-bf16"], kind,
            errs20["K8-bf16"][kind], times20["K8-bf16"][kind], per="call",
            calls_per_force_evaluation=1, layers=scfg.num_layers, dtype="bf16",
        ))
    # the layer body's bf16x3 and one-pass builds on f32 operands (phase
    # 21): bounds with the products at PEAK_BF16_FLOPS / 3 (three passes)
    # and PEAK_BF16_FLOPS (one); launches from the policy's main paths
    for b, stem in (("-bf16x3", "bf16x3"), ("-1pass", "onepass")):
        path = {"-bf16x3": "%s-bf16x3", "-1pass": "%s-1pass"}[b]
        for kind, line in (("fwd", 1094), ("bwd", 1139)):
            per = {f: times21["K1" + b][(f, kind)] for f in FORMS}
            total = {key: sum(r[key] for r in per.values())
                     for key in ("ms", "plain_ms", "bound_ms")}
            total["bound_by"] = ("operations" if all(r["bound_by"] == "operations"
                                                     for r in per.values()) else "bytes")
            kernels.append(kernel_entry(
                f"k1_fused_layer_{stem}_{kind}", f"pair_allegro_tpu_torch/csrc/fused_layer_{stem}.cu",
                f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts21[path % "allegro"]["K1" + b],
                kind, errs21["K1" + b][kind], total, kid="K1" + b,
                ms_by_form={f: r["ms"] for f, r in per.items()},
                plain_ms_by_form={f: r["plain_ms"] for f, r in per.items()},
                bound_ms_by_form={f: r["bound_ms"] for f, r in per.items()},
            ))
        for kind, line6, line7 in (("fwd", 1404, 1538), ("bwd", 1439, 1572)):
            for name, stem6, line in (("K6", "k6_embed_layer", line6),
                                      ("K7", "k7_readout_layer", line7)):
                kernels.append(kernel_entry(
                    f"{stem6}_{stem}_{kind}",
                    f"pair_allegro_tpu_torch/csrc/embed_readout_layer_{stem}.cu",
                    f"pair_allegro_tpu/ops/pallas_stack.py:{line}",
                    counts21[path % "embed"][name + b], kind, errs21[name + b][kind],
                    times21[name + b][kind], kid=name + b, per="call",
                    calls_per_force_evaluation=1,
                    k1_launches_on_the_path=counts21[path % "embed"]["K1" + b][kind],
                ))
        for kind, line in (("fwd", 538), ("bwd", 572)):
            kernels.append(kernel_entry(
                f"k8_fused_stack_{stem}_{kind}", f"pair_allegro_tpu_torch/csrc/fused_stack_{stem}.cu",
                f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts21[path % "stack"]["K8" + b],
                kind, errs21["K8" + b][kind], times21["K8" + b][kind], kid="K8" + b, per="call",
                calls_per_force_evaluation=1, layers=scfg.num_layers,
            ))
        # K2, K4 and K3 (f32 and bf16 hj): one call (one layer); num_layers
        # calls per force evaluation; the 3xTF32 build's ms of this call beside
        for kid, stem_k, src, lines, run, layers in (
                ("K2", "k2_env_layer", "env_layer", ("pallas_stack.py", 803, 823),
                 "perlayer", pcfg.num_layers),
                ("K4", "k4_tp_mix_fused", "tp_mix_fused", ("pallas_tp.py", 117, 153), "flat",
                 fcfg.num_layers),
                ("K3", "k3_nequip_conv", "nequip_conv", ("pallas_nequip.py", 289, 401), "nequip",
                 ncfg.num_layers),
                ("K3hj", "k3_nequip_conv_bf16", "nequip_conv_bf16", ("pallas_nequip.py", 289, 401),
                 "nequip-hj", ncfg.num_layers)):
            tag = K3HJ_IDS["bf16x3" if b == "-bf16x3" else "bf16"] if kid == "K3hj" else kid + b
            for kind, line in (("fwd", lines[1]), ("bwd", lines[2])):
                kernels.append(kernel_entry(
                    f"{stem_k}_{stem}_{kind}", f"pair_allegro_tpu_torch/csrc/{src}_{stem}.cu",
                    f"pair_allegro_tpu/ops/{lines[0]}:{line}", counts21[path % run][tag], kind,
                    errs21[tag][kind], times21[tag][kind], kid=tag, per="call",
                    calls_per_force_evaluation=layers,
                    ms_tf32x3=times21[tag][kind]["ms_tf32x3"],
                    **({"dtype": "bf16 hj"} if kid == "K3hj" else {}),
                ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
