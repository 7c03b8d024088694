#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pair_allegro_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit; the build of K1 (csrc/fused_layer.cu)
     with nvcc for sm_90a;
  2. K1 parity: the CUDA kernel against its plain PyTorch version, f32,
     forward and backward, for the first / middle / last forms, at flagship
     widths (ns=64, C=32, l_max=2) on a 500-atom FCC Cu neighbor table;
  3. model parity on the same 500 atoms with the charge head: the kernel
     path on the card against the plain path (the CPU), max|dF| and max|dq|
     below 5e-4;
  4. the main path: 5,324-atom FCC Cu, Allegro l_max=2 / 3 layers / 64
     scalar and 32 tensor features, AllegroEngine(skin=0.4) with regrow, NVE
     at 2 fs from 50 K, a 60-step warmup chunk and a timed 60-step chunk;
     K1's launch counts are read from this phase alone;
  5. K1 timings at the main path's shapes (CUDA events, warm), beside the
     plain version's and the least time the card could take (bound), and
     K1 parity at those shapes as in phase 2.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.  Weights are random, made from a seed.

``python3 chip_smoke.py --profile`` instead prints where the device time of
a main-path MD step goes (torch.profiler).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# H100 SXM: f32 outside the tensor cores and HBM3 rate (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FORMS = {"first": (True, False), "middle": (False, False), "last": (False, True)}
SEED = 0


def flagship_cfg(output_charges=False):
    from pair_allegro_tpu_torch.models.allegro import AllegroConfig

    return AllegroConfig(
        type_names=("Cu",), r_max=4.5, l_max=2, num_layers=3, num_scalar_features=64,
        num_tensor_features=32, avg_num_neighbors=12.0, output_charges=output_charges,
    )


def make_case(n_rep, device, output_charges=False):
    """(cfg, params, system) for FCC Cu of n_rep^3 cells on ``device``."""
    import numpy as np
    import torch

    from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy, allegro_params_from_numpy
    from pair_allegro_tpu_torch.system import System, fcc_lattice

    cfg = flagship_cfg(output_charges)
    params = allegro_params_from_numpy(allegro_init_numpy(cfg, SEED), cfg, device=device)
    pos, cell = fcc_lattice(n_rep)
    n = pos.shape[0]
    system = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=np.full(n, 63.546),
                           dtype=torch.float32, device=device)
    return cfg, params, system


def layer_operands(cfg, params, system, eng):
    """The main path's K1 operands for each form, from one neighbor build:
    (x, pT, Y, u) of the first layer, (x, V) of the layers after it."""
    import torch

    from pair_allegro_tpu_torch.models.allegro import allegro_inputs
    from pair_allegro_tpu_torch.ops.fused_layer import fused_layer

    nb = eng.rebuild_fn(system, None)
    with torch.no_grad():
        ins = allegro_inputs(params, cfg, system.positions, system.types, nb.edge_index,
                             cell=system.cell, edge_shifts=nb.edge_shifts,
                             edge_mask=nb.edge_mask)
        k = nb.edge_index.shape[1]
        x1, v1 = fused_layer(ins["xT"], ins["pT"], ins["Y_T"], ins["uT"],
                             params["layers"][0]["k1"], k, cfg.avg_num_neighbors, first_v=True)
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


def check(label, kind, got, ref):
    """Hold kernel results against the plain version's; returns the max
    abs error, raises beyond atol + rtol * max|plain|."""
    atol, rtol = TOLS[kind]
    worst = 0.0
    for name, a, b in zip(("x", "V", "Y", "u"), got, ref):
        err = max_err(a, b)
        tol = atol + rtol * float(b.detach().abs().max())
        print(f"K1 parity {label} {kind} {name}: max|kernel-plain| {err:.3e} "
              f"(tolerance {tol:.3e} = {atol:g} + {rtol:g} max|plain|)")
        if not err <= tol:
            raise RuntimeError(f"K1 {kind} {label} {name} disagrees with its plain version")
        worst = max(worst, err)
    return worst


def k1_parity(cfg, params, system, eng):
    """Phase 2: kernel against plain version for each form, fwd and bwd."""
    import torch

    from pair_allegro_tpu_torch.ops import fused_layer as fl

    ops, Y, u, k = layer_operands(cfg, params, system, eng)
    inv_avg = 1.0 / math.sqrt(cfg.avg_num_neighbors)
    errs = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator(device=Y.device).manual_seed(SEED)
    for li, (form, (first_v, last)) in enumerate(FORMS.items()):
        w = params["layers"][li]["k1"]
        ins = [t.detach().clone().requires_grad_(True) for t in (*ops[form], Y, u)]
        out_k = fl.fused_layer(*ins, w, k, cfg.avg_num_neighbors, first_v=first_v, last=last)
        out_r = fl.fused_layer_reference(*ins, w, k, inv_avg, first_v, last)
        out_k, out_r = ((out_k,), (out_r,)) if last else (out_k, out_r)
        cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in out_r]
        g_k = torch.autograd.grad(out_k, ins, cots)
        g_r = torch.autograd.grad(out_r, ins, cots)
        torch.cuda.synchronize()
        for kind, got, ref in (("fwd", out_k, out_r), ("bwd", g_k, g_r)):
            errs[kind] = max(errs[kind], check(f"{form:6s} 500 atoms", kind, got, ref))
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


def main_path():
    """Phase 4: the bench.py:main workload on the port."""
    import torch

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.ops import fused_layer as fl
    from pair_allegro_tpu_torch.system import Units

    fl.launches.reset()
    cfg, params, system = make_case(11, None)
    eng = AllegroEngine(cfg, params, system, skin=0.4)
    n_eval = [0]

    def force_fn(s, nb):
        n_eval[0] += 1
        return eng.force_fn(s, nb)

    dt_fs, n_steps = 2.0, 60
    sim = Simulation(system, force_fn, eng.rebuild_fn, dt=dt_fs * Units.fs, grow_fn=eng.grow)
    sim.init_velocities(50.0, seed=SEED)
    sim.run(n_steps, log_every=n_steps)  # warmup chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = sim.run(n_steps, log_every=n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fwd": fl.launches.fwd, "bwd": fl.launches.bwd}
    st = sim.state
    finite = bool(torch.isfinite(st.forces).all()) and math.isfinite(rows[-1]["etotal"])
    steps_per_s = n_steps / wall
    print(f"main path: {system.n_atoms} atoms, K={eng.spec.max_neighbors}, regrows {sim.regrows}, "
          f"force evaluations {n_eval[0]}, K1 launches fwd {counts['fwd']} bwd {counts['bwd']}")
    print(f"main path: {steps_per_s:.4f} steps/s, {steps_per_s * dt_fs * 1e-6 * 86400.0:.4f} ns/day "
          f"({wall * 1e3 / n_steps:.3f} ms/step), T {rows[-1]['temp']:.1f} K, "
          f"etotal {rows[-1]['etotal']:.4f} eV, finite {finite}")
    if not finite:
        raise RuntimeError("main path produced non-finite values")
    want = cfg.num_layers * n_eval[0]
    if not (counts["fwd"] == want and counts["bwd"] == want):
        raise RuntimeError(f"K1 launches {counts} != {cfg.num_layers} per force evaluation")
    return cfg, params, system, eng, counts


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
        w = params["layers"][li]["k1"]
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
        errs["fwd"] = max(errs["fwd"], check(label, "fwd", (out_k,) if last else out_k, outs))
        g_r = torch.autograd.grad(outs, ins, cots)
        errs["bwd"] = max(errs["bwd"], check(label, "bwd", g_k, g_r))
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


def profile_steps(n_steps=10):
    """``--profile``: where one main-path MD step's device time goes.
    torch.profiler over n_steps after a 20-step warmup; kernel time summed by
    name per step, and the device's idle share of the wall time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pair_allegro_tpu_torch.engine import AllegroEngine
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    cfg, params, system = make_case(11, None)
    eng = AllegroEngine(cfg, params, system, skin=0.4)
    sim = Simulation(system, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs, grow_fn=eng.grow)
    sim.init_velocities(50.0, seed=SEED)
    sim.run(20, log_every=20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(n_steps, log_every=n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = collections.Counter()
    calls = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name] += ev.time_range.elapsed_us() / 1e3 / n_steps
            calls[ev.name] += 1
    busy = sum(per.values())
    step_ms = wall * 1e3 / n_steps
    print(f"profile: {step_ms:.3f} ms/step wall (profiler on), device busy {busy:.3f} ms/step, "
          f"idle share {1.0 - busy / step_ms:.3f}, {sum(calls.values()) / n_steps:.0f} "
          f"device events/step")
    for name, ms in per.most_common(15):
        print(f"profile: {ms:8.3f} ms/step {100 * ms / busy:5.1f}%  x{calls[name] / n_steps:5.1f}  "
              f"{name[:110]}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--profile"]:
        return profile_steps()
    from pair_allegro_tpu_torch.ops import fused_layer as fl

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    fl._library()
    print(f"K1 build: nvcc {fl.build_seconds if fl.build_seconds is not None else 0.0:.1f} s, "
          f"build + load {time.perf_counter() - t0:.1f} s")
    for line in sorted(fl._BUILD_DIR.glob("*.ptxas.txt")):
        for s in line.read_text().splitlines():
            if "registers" in s or "Function properties for" in s:
                print("ptxas:", s.strip())

    cfg, params, system = make_case(5, None)
    from pair_allegro_tpu_torch.engine import AllegroEngine

    errs = k1_parity(cfg, params, system, AllegroEngine(cfg, params, system))
    model_parity()
    cfg, params, system, eng, counts = main_path()
    times = k1_timings(cfg, params, system, eng, errs)

    kernels = []
    for kind, line in (("fwd", 1094), ("bwd", 1139)):
        per = {f: times[(f, kind)] for f in FORMS}
        kernels.append({
            "name": f"k1_fused_layer_{kind}",
            "route": "cuda",
            "source": "pair_allegro_tpu_torch/csrc/fused_layer.cu",
            "replaces": f"pair_allegro_tpu/ops/pallas_stack.py:{line}",
            "launches": counts[kind],
            "max_abs_err": errs[kind],
            # one call of each form: the kernel's time per force evaluation
            "ms": sum(r["ms"] for r in per.values()),
            "plain_ms": sum(r["plain_ms"] for r in per.values()),
            "bound_ms": sum(r["bound_ms"] for r in per.values()),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in per.values())
            else "bytes",
            "library_ms": None,
            "ms_by_form": {f: r["ms"] for f, r in per.items()},
            "plain_ms_by_form": {f: r["plain_ms"] for f, r in per.items()},
            "bound_ms_by_form": {f: r["bound_ms"] for f, r in per.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
