"""Readings that set a cell's limits: the compared numbers of sound runs
of the program and of the control, seed by seed, at the cell's own size.

    python -m gpubench.control --workload <name> --seeds 1,2,3 [--seconds 1] [--control 3]

For each seed, in one process: the cell's set-up and a short window at its
own load (whole episodes, at least the ones checked), then the check's numbers for the
program and for the control, the reference at TF32 put in the program's
place (``check.compare(control=True)``), on the first ``--control`` seeds
(all by default).  With ``--policy`` the program
runs under that matmul precision policy instead (``high``: its own TF32
path, the other control) and only its numbers are read.  One JSON line a
seed, then the largest program reading and the smallest control reading
of each number.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch


def readings(name: str, seed: int, seconds: float, device="cuda", policy=None,
             with_control: bool = True, **override) -> dict:
    """The program's and the control's numbers on ``seed`` (with ``policy``,
    the program's under it, and no control); ``override`` replaces keys of
    the cell's file (a test's smaller lattice)."""
    from gpubench import check, harness

    wl = {**harness.load("workloads", name), **override}
    cf = harness.load("configs", wl["config"])
    if policy:
        cf["precision_policy"] = policy
    system, eng, rec, fam, sim_kw = harness.setup(wl, cf, seed, device, trace=False)
    _, _, failed, points = harness.window(rec, system, wl, seed, seconds, sim_kw)
    del eng, rec
    gc.collect()
    chosen = [points[e] for e in sorted(points)]
    ref = harness.reference_fn(fam, cf, seed, system)
    dt = wl["dt_fs"] * 1e-3
    out = {"seed": seed, "failed": failed, "points": len(chosen),
           "program": check.compare(chosen, ref, system.masses, dt)}
    if with_control and not policy:
        out["control"] = check.compare(chosen, ref, system.masses, dt, control=True)
    del ref, chosen, points, system
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    from gpubench import check

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--policy", default=None, help="run the program under this policy")
    ap.add_argument("--control", type=int, default=None, help="the control on this many seeds")
    args = ap.parse_args(argv)
    rows = []
    for n, s in enumerate(args.seeds.split(",")):
        t0 = time.perf_counter()
        rows.append(readings(args.workload, int(s), args.seconds, policy=args.policy,
                             with_control=args.control is None or n < args.control))
        print(json.dumps({**rows[-1], "s": time.perf_counter() - t0}), flush=True)
    summary = {"workload": args.workload, "policy": args.policy, "seeds": len(rows)}
    for side, pick in (("program", max), ("control", min)):
        if side in rows[0]:
            summary[f"{side}_{pick.__name__}"] = {k: pick(r[side][k] for r in rows if side in r)
                                                  for k in check.READ}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
