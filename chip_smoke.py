#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pair_allegro_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; the builds of K1 (csrc/fused_layer.cu),
     K3 (csrc/nequip_conv.cu), K2 (csrc/env_layer.cu) and K5
     (csrc/env_layer_mxu.cu) with nvcc for sm_90a, started together;
  2. K1 parity: the CUDA kernel against its plain PyTorch version, f32,
     forward and backward, for the first / middle / last forms, at flagship
     widths (ns=64, C=32, l_max=2) on a 500-atom FCC Cu neighbor table;
  3. K3 parity: the same for the NequIP convolution at (l_max, tracks) in
     {1, 2} x {1, 2}, C=64, on the 500-atom table at the engine's K;
     K2 and K5 parity: the same for the per-layer tier's kernels (K5 in its
     three precision modes) at flagship widths, l_max 2 and 1 with parity;
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
     (bound), and kernel parity at those shapes as in phases 2 and 3;
  8. the per-layer main path (bench.py's kernel-perlayer tier): phase 5's
     run with layer_fused=False (K2); K2 and K5 (each mode) timings and
     parity at its shapes; a short run (10 + 10 steps) with
     tp_mode=mxu_highest (K5);
  9. K4 (csrc/tp_mix_fused.cu) parity against its plain version, f32,
     forward and backward, on operands of a 256-atom dense (FLAT) build at
     flagship widths and at l_max 1, with a tail tile and a zero dV'; FLAT
     model parity, card against the CPU: Allegro with charges on the
     256-atom box and on a 500-atom slab (two species, typed cutoffs),
     NequIP with one and two species on the 256 atoms (no K3 launch);
 10. the FLAT main path: a 5,324-atom Cu slab (FCC 11^3 cells, 20 A of
     vacuum along z, pbc (T, T, F)) on the dense strategy, Allegro at phase
     5's widths, 60 + 60 NVE steps: 3 + 3 K4 launches per force evaluation
     and no other kernel; K4 timings and parity at its shapes; a NequIP run
     (10 + 10 steps) on the same slab, which launches no kernel.
The launch counts of each main path are read from its phase alone (every
count is set to 0 just before it).  The line before the last is a JSON
object of the kernels; the last line is {"ok": true, "device": {...}}.
Weights are random, made from a seed.

``python3 chip_smoke.py --profile`` instead prints where the device time of
an Allegro main-path MD step goes (torch.profiler); ``--profile nequip``,
``--profile perlayer`` and ``--profile flat`` the same for the NequIP,
per-layer and FLAT slab main paths.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

# H100 SXM: f32 outside the tensor cores, dense bf16 on the tensor cores and
# HBM3 rate (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
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


def fcc_system(n_rep, device, species=1, slab=False):
    """FCC Cu of n_rep^3 cells (types drawn from a seed with two species),
    or, with ``slab``, the same atoms under SLAB_VACUUM with pbc (T, T, F)."""
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
                         pbc=pbc, dtype=torch.float32, device=device)


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


def k1_cost(w, e, k, form, bwd):
    """(flops, bytes) one K1 call needs at E edge slots: the operations of
    the function on these inputs (the backward includes its recompute of
    wz, env, inv and the latent forward) and each input read once, each
    output written once (f32), weights included."""
    from pair_allegro_tpu_torch.ops.fused_layer import _row_tables
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    first_v, last = FORMS[form]
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


def model_parity():
    """Phase 3: forces and charges, kernel path (card) vs plain path (CPU)."""
    from pair_allegro_tpu_torch.engine import AllegroEngine

    outs = []
    for dev in ("cuda", "cpu"):
        cfg, params, system = make_case(5, dev, output_charges=True)
        eng = AllegroEngine(cfg, params, system, device=dev)
        o = eng.force_fn(system, eng.rebuild_fn(system, None))
        outs.append((o.forces.cpu(), o.extras["charges"].cpu(), o.total_energy.cpu()))
    (f_k, q_k, e_k), (f_p, q_p, e_p) = outs
    df, dq = max_err(f_k, f_p), max_err(q_k, q_p)
    print(f"model parity (500 atoms, charges): max|dF| {df:.3e} eV/A, max|dq| {dq:.3e}, "
          f"E {float(e_k):.6f} vs {float(e_p):.6f} eV (gate 5e-4)")
    if not (df < 5e-4 and dq < 5e-4):
        raise RuntimeError("model parity gate failed")


# the main paths: (model, Allegro tier fields, the kernel that carries it
# (None: no kernel), steps per chunk, slab); "perlayer" is bench.py's
# kernel-perlayer tier, "flat" the dense-strategy slab with K4
PATHS = {
    "allegro": ("allegro", {}, "K1", 60, False),
    "nequip": ("nequip", {}, "K3", 60, False),
    "perlayer": ("allegro", dict(layer_fused=False), "K2", 60, False),
    "perlayer-mxu": ("allegro", dict(layer_fused=False, tp_mode="mxu_highest"), "K5", 10, False),
    "flat": ("allegro", {}, "K4", 60, True),
    "nequip-flat": ("nequip", {}, None, 10, True),
}


def kernel_modules():
    """{kernel id: its wrapper module}, each with ``launches`` and ``LIB``."""
    from pair_allegro_tpu_torch.ops import (
        env_layer,
        env_layer_mxu,
        fused_layer,
        nequip_conv,
        tp_mix_fused,
    )

    return {"K1": fused_layer, "K3": nequip_conv, "K2": env_layer, "K5": env_layer_mxu,
            "K4": tp_mix_fused}


def build_path(path):
    """(cfg, params, system, engine) of a main path, on the card."""
    from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine

    model, tier, _, _, slab = PATHS[path]
    if model == "allegro":
        cfg, params, system = make_case(11, None, slab=slab, **tier)
        return cfg, params, system, AllegroEngine(cfg, params, system, skin=0.4)
    cfg, params, system = make_nequip_case(11, None, slab=slab)
    return cfg, params, system, NequIPEngine(cfg, params, system, skin=0.4)


def main_path(path="allegro"):
    """Phases 5, 6, 8 and 10: the bench.py:main (Allegro, K1 or per-layer
    tier) or bench.py:nequip_line (NequIP) workload on the port, on the
    bulk box or on the slab.  Every kernel's counts are set to 0 just before
    the run and read just after it."""
    import torch

    from pair_allegro_tpu_torch.engine import edge_slots
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    _, _, kernel, n_steps, _ = PATHS[path]
    cfg, params, system, eng = build_path(path)
    mods = kernel_modules()
    mod = mods.get(kernel)
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
    counts = {"fwd": mod.launches.fwd, "bwd": mod.launches.bwd} if mod else {"fwd": 0, "bwd": 0}
    others = {name: (m.launches.fwd, m.launches.bwd) for name, m in mods.items() if m is not mod}
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = sim.state
    finite = bool(torch.isfinite(st.forces).all()) and math.isfinite(rows[-1]["etotal"])
    steps_per_s = n_steps / wall
    spec = eng.spec
    cap = (f"max_edges={spec.max_edges} ({len(spec.shifts_table)} image shifts)"
           if spec.strategy == "dense" else f"K={spec.max_neighbors}")
    print(f"{path} main path: {system.n_atoms} atoms, pbc {system.pbc}, strategy {spec.strategy}, "
          f"{cap}, E={edge_slots(spec, system.n_atoms)} edge slots, {rows[-1]['n_edges']} real "
          f"edges, regrows {sim.regrows}, neighbor builds in the timed chunk {n_build[0]}, force "
          f"evaluations {n_eval[0]}, {kernel} launches fwd "
          f"{counts['fwd']} bwd {counts['bwd']} (other kernels fwd/bwd {others})")
    print(f"{path} main path: {steps_per_s:.4f} steps/s, "
          f"{steps_per_s * dt_fs * 1e-6 * 86400.0:.4f} ns/day ({wall * 1e3 / n_steps:.3f} ms/step), "
          f"T {rows[-1]['temp']:.1f} K, etotal {rows[-1]['etotal']:.4f} eV, finite {finite}, "
          f"peak device memory of the timed chunk {peak:.2f} GiB, of the engine's first build "
          f"and the warmup chunk {peak_all:.2f} GiB")
    if not finite:
        raise RuntimeError(f"{path} main path produced non-finite values")
    want = cfg.num_layers * n_eval[0] if mod else 0
    if not (counts["fwd"] == want and counts["bwd"] == want):
        raise RuntimeError(f"{kernel} launches {counts} != {cfg.num_layers} per force evaluation")
    if any(sum(v) for v in others.values()):
        raise RuntimeError(f"{path} main path launched other kernels than {kernel}: {others}")
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
            flops, nbytes = k1_cost(w, e, k, form, kind == "bwd")
            t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            res[(form, kind)] = dict(ms=ms, plain_ms=pms, bound_ms=max(t_ops, t_bytes),
                                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                                     gflop=flops / 1e9, mbytes=nbytes / 1e6)
            r = res[(form, kind)]
            print(f"K1 {kind} {form:6s} E={e}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['gflop']:.2f} GFLOP, "
                  f"{r['mbytes']:.1f} MB), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    return res


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
    """(flops, bytes) one K3 call needs at E edge slots, counted from the
    kernel's code: the radial MLP (recomputed in the backward), the TP
    entries (4 operations each in the forward, 9 in the backward), the
    backward's du, dw * u and the product back through the radial MLP; each
    input read once, each output written once (f32), weights included."""
    from pair_allegro_tpu_torch.ops.tp import tp_entry_table

    dims = w.dims
    c, T = w.C, w.n_tracks
    n_ent = sum(len(ents) for _, rows in tp_entry_table(w.lmax) for *_, ents in rows)
    d = (w.lmax + 1) ** 2
    df, tpc, b = d * T * c, dims[-1], dims[0]
    hidden = sum(2 * a * o + 5 * o for a, o in zip(dims[:-2], dims[1:-1]))
    radial = hidden + 2 * dims[-2] * tpc + tpc
    if not bwd:
        per = radial + 4 * n_ent * T * c
        io = (df + b + 1 + d) * e + df * (e // k)
    else:
        back = 2 * tpc * dims[-2] + sum(2 * a * o + 8 * o for a, o in zip(dims[:-2], dims[1:-1]))
        per = radial + 9 * n_ent * T * c + 3 * tpc + back
        io = 2 * (df + b + 1 + d) * e + df * (e // k)
    n_w = sum(t.numel() for t in w.tensors())
    return per * e, 4 * (io + n_w)


def k3_compare(label, ops, w, k, avg, gen):
    """K3 against its plain version on ``ops``, forward and backward (a
    random cotangent); returns the max abs errors."""
    import torch

    from pair_allegro_tpu_torch.ops import nequip_conv as k3

    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k = k3.nequip_conv(*ins, w, k, avg)
    out_r = k3.nequip_conv_reference(*ins, w, k, 1.0 / math.sqrt(avg))
    cot = torch.randn(out_r.shape, generator=gen, device=out_r.device)
    g_k = torch.autograd.grad(out_k, ins, cot)
    g_r = torch.autograd.grad(out_r, ins, cot)
    torch.cuda.synchronize()
    errs = {"fwd": check("K3", label, "fwd", ("agg",), (out_k,), (out_r,)),
            "bwd": check("K3", label, "bwd", K3_NAMES, g_k, g_r)}
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
        flops, nbytes = k3_cost(w, e, k, kind == "bwd")
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        res[kind] = dict(ms=ms, plain_ms=pms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         gflop=flops / 1e9, mbytes=nbytes / 1e6)
        r = res[kind]
        print(f"K3 {kind} E={e}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['gflop']:.2f} GFLOP, {r['mbytes']:.1f} MB), "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved")
    return res, errs


ENV_MODES = ("paths", "mxu_highest", "mxu_bf16x3", "mxu_bf16")
K2_NAMES = ("V", "wz", "Y")
# forward (atol, rtol on max|plain|) of K2 and K5 against their plain
# versions: sum order only, except mxu_bf16, whose O elements near a bf16
# rounding boundary may round the other way (2^-8 of that element); the
# backward rounds the same dV' on both sides
ENV_FWD_TOLS = {"paths": (1e-4, 1e-4), "mxu_highest": (1e-4, 1e-4),
                "mxu_bf16x3": (1e-4, 1e-4), "mxu_bf16": (1e-4, 2e-3)}


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


def env_compare(label, mode, ops, w, k, avg, gen):
    """K2 / K5 against the plain version on ``ops``, forward and backward (a
    random cotangent); returns the max abs errors."""
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


def env_timings(cfg, params, system, eng, errs):
    """Phase 8: per-call fwd/bwd time of K2 and of K5 in each mode, of
    their plain versions and the bound at the per-layer main path's shapes;
    parity at those shapes (into ``errs``).  Also, as context only, the
    cuBLAS f32 time of the bare (D*Cout x D*D*C) (D*D*C x E) product."""
    import torch

    ops, k = env_operands(cfg, params, system, eng)
    e = ops[0].shape[-1]
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    res = {}
    for mode in ENV_MODES:
        w = env_weights(params["layers"][1], cfg, mode)
        fn, ref, ref_bwd = env_call(mode)
        mod = kernel_modules()["K2" if mode == "paths" else "K5"]
        out, inv = mod._kernel_fwd(*ops, w, k, inv_avg)
        dout = torch.randn(out.shape, generator=gen, device=system.device)
        dinv = torch.randn(inv.shape, generator=gen, device=system.device)
        del out, inv
        reps = 5 if mode == "paths" else 3
        k_f = cuda_ms(lambda: mod._kernel_fwd(*ops, w, k, inv_avg), reps)
        k_b = cuda_ms(lambda: mod._kernel_bwd(*ops, w, k, inv_avg, dout, dinv), reps)
        with torch.no_grad():
            p_f = cuda_ms(lambda: ref(*ops, w, k, inv_avg), 1)
        p_b = cuda_ms(lambda: ref_bwd(*ops, w, k, inv_avg, dout, dinv), 1)
        torch.cuda.empty_cache()
        e2 = env_compare(f"main path E={e}", mode, ops, w, k, cfg.avg_num_neighbors, gen)
        errs[mode] = {kind: max(errs[mode][kind], e2[kind]) for kind in e2}
        for kind, ms, pms in (("fwd", k_f, p_f), ("bwd", k_b, p_b)):
            if mode == "paths":
                flops, nbytes = k2_cost(w, e, kind == "bwd")
                t_ops = flops / PEAK_F32_FLOPS * 1e3
            else:
                gemm, rest, nbytes = k5_cost(w, e, kind == "bwd")
                flops = gemm + rest
                peak = PEAK_F32_FLOPS if mode == "mxu_highest" else PEAK_BF16_FLOPS
                t_ops = (gemm / peak + rest / PEAK_F32_FLOPS) * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            r = res[(mode, kind)] = dict(ms=ms, plain_ms=pms, bound_ms=max(t_ops, t_bytes),
                                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                                         gflop=flops / 1e9, mbytes=nbytes / 1e6)
            print(f"{'K2' if mode == 'paths' else 'K5 ' + mode} {kind} E={e}: kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{r['gflop']:.2f} GFLOP, {r['mbytes']:.1f} MB), "
                  f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
        del dout, dinv
        torch.cuda.empty_cache()
    w = env_weights(params["layers"][1], cfg, "mxu_highest")
    O = torch.randn((w.Mt.shape[1], e), generator=gen, device=system.device)
    res["cublas_ms"] = cuda_ms(lambda: w.Mt @ O, 3)
    print(f"context: cuBLAS f32 ({w.Mt.shape[0]} x {w.Mt.shape[1]}) @ ({O.shape[0]} x {e}) alone "
          f"{res['cublas_ms']:.4f} ms (TF32 {torch.backends.cuda.matmul.allow_tf32}); not in the port")
    del O
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


def k4_compare(label, ops, w, gen, zero_dout=False):
    """K4 against its plain version on ``ops``, forward and backward (a
    random cotangent; ``zero_dout``: V' is dead, as in the last layer, and
    only inv's cotangent is random); returns the max abs errors."""
    import torch

    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k = k4.tp_mix_fused_t(*ins, w)
    with torch.no_grad():
        out_r = k4.tp_mix_fused_reference(*ops, w)
    cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in out_r]
    if zero_dout:
        cots[0] = torch.zeros_like(cots[0])
    g_k = torch.autograd.grad(out_k, ins, cots)
    with torch.enable_grad():
        ref_in = [t.detach().requires_grad_(True) for t in ops]
        g_r = torch.autograd.grad(k4.tp_mix_fused_reference(*ref_in, w), ref_in, cots)
    torch.cuda.synchronize()
    errs = {"fwd": check("K4", label, "fwd", ("V'", "inv"), out_k, out_r),
            "bwd": check("K4", label, "bwd", K4_NAMES, g_k, g_r)}
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
    main path's shapes (the second layer's operands), with the bound, and
    parity at those shapes (into ``errs``)."""
    import torch

    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    (V, env), w = k4_operands(cfg, params, system, eng)
    e = V.shape[-1]
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
        flops, nbytes = k4_cost(w, e, kind == "bwd")
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        r = res[kind] = dict(ms=ms, plain_ms=pms, bound_ms=max(t_ops, t_bytes),
                             bound_by="operations" if t_ops >= t_bytes else "bytes",
                             gflop=flops / 1e9, mbytes=nbytes / 1e6,
                             tile=k4.kernel_tile(w, V, kind == "bwd"))
        print(f"K4 {kind} E={e} (edge tile {r['tile']}): kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['gflop']:.2f} GFLOP, "
              f"{r['mbytes']:.1f} MB), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved")
    return res, errs


def _kind_of(name):
    """A coarse class of a device kernel's name, for the profile's summary."""
    n = name.lower()
    for key, kind in (("k3_", "K3 (nequip_conv)"), ("k1_", "K1 (fused_layer)"),
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


def profile_steps(model="allegro", n_steps=10):
    """``--profile [nequip | perlayer | flat]``: where one main-path MD step's
    device time goes.  torch.profiler over n_steps after a 20-step warmup;
    kernel time summed by name and by class per step, and the device's idle
    share of the wall time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    cfg, params, system, eng = build_path(model)
    sim = Simulation(system, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs, grow_fn=eng.grow)
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
        if model not in ("allegro", "nequip", "perlayer", "flat"):
            raise SystemExit(f"--profile takes allegro, nequip, perlayer or flat, not {model}")
        return profile_steps(model)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = [(name, mod.LIB) for name, mod in kernel_modules().items()]
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
    cfg, params, system, eng, counts = main_path("allegro")
    times = k1_timings(cfg, params, system, eng, errs)
    del cfg, params, system, eng
    torch.cuda.empty_cache()
    ncfg, nparams, nsystem, neng, counts3 = main_path("nequip")
    times3, errs3 = k3_timings(ncfg, nparams, nsystem, neng, errs3)
    del nparams, nsystem, neng
    torch.cuda.empty_cache()
    pcfg, pparams, psystem, peng, counts2 = main_path("perlayer")
    times_env = env_timings(pcfg, pparams, psystem, peng, errs_env)
    del pparams, psystem, peng
    torch.cuda.empty_cache()
    *_, counts5 = main_path("perlayer-mxu")
    torch.cuda.empty_cache()
    fcfg, fparams, fsystem, feng, counts4 = main_path("flat")
    b_ms, b_gib = rebuild_ms(fsystem, feng)
    print(f"flat main path: one dense rebuild {b_ms:.3f} ms wall, peak {b_gib:.2f} GiB above the "
          f"resident tensors; the engine's regrow check counts "
          f"{regrow_gib(feng, fsystem):.2f} GiB for a rebuild and force evaluation")
    times4, errs4 = k4_timings(fcfg, fparams, fsystem, feng, errs4)
    del fparams, fsystem, feng
    torch.cuda.empty_cache()
    main_path("nequip-flat")

    kernels = []
    for kind, line in (("fwd", 1094), ("bwd", 1139)):
        per = {f: times[(f, kind)] for f in FORMS}
        # one call of each form: the kernel's time per force evaluation
        total = {key: sum(r[key] for r in per.values()) for key in ("ms", "plain_ms", "bound_ms")}
        total["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in per.values())
                             else "bytes")
        kernels.append(kernel_entry(
            f"k1_fused_layer_{kind}", "pair_allegro_tpu_torch/csrc/fused_layer.cu",
            f"pair_allegro_tpu/ops/pallas_stack.py:{line}", counts, kind, errs[kind], total,
            ms_by_form={f: r["ms"] for f, r in per.items()},
            plain_ms_by_form={f: r["plain_ms"] for f, r in per.items()},
            bound_ms_by_form={f: r["bound_ms"] for f, r in per.items()},
        ))
    for kind, line in (("fwd", 289), ("bwd", 401)):
        # one call (one message-passing layer); num_layers calls per force evaluation
        kernels.append(kernel_entry(
            f"k3_nequip_conv_{kind}", "pair_allegro_tpu_torch/csrc/nequip_conv.cu",
            f"pair_allegro_tpu/ops/pallas_nequip.py:{line}", counts3, kind, errs3[kind],
            times3[kind], per="call", calls_per_force_evaluation=ncfg.num_layers,
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
            **{f"{key}_by_mode": {m: times_env[(m, kind)][key] for m in k5_modes}
               for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
            context_cublas_f32_product_ms=times_env["cublas_ms"] if kind == "fwd" else None,
        ))
    for kind, line in (("fwd", 117), ("bwd", 153)):
        # one call (one layer); num_layers calls per force evaluation
        kernels.append(kernel_entry(
            f"k4_tp_mix_fused_{kind}", "pair_allegro_tpu_torch/csrc/tp_mix_fused.cu",
            f"pair_allegro_tpu/ops/pallas_tp.py:{line}", counts4, kind, errs4[kind], times4[kind],
            per="call", calls_per_force_evaluation=fcfg.num_layers, edge_tile=times4[kind]["tile"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
