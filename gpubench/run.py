"""Run one cell of the benchmark once.

    python -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (``BENCHMARK.json``).  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` and, traced, ``breakdown``, then the
compared numbers under ``compared``); the last lines of standard error are
the compared numbers beside their limits.  Without the devices, or with a
JAX module loaded once the window has closed, it exits with 1 or 2 and
prints no result.  The program builds its kernels into ``build/`` inside
the checkout, once per version of their sources.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def process_start() -> float:
    """When this process started (seconds since the epoch), from /proc;
    the time of this call where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpubench import harness

    wl = harness.load("workloads", args.workload)
    chips = wl["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    cf = harness.load("configs", wl["config"])
    res = harness.run_cell(args.workload, wl, cf, args.seed, args.seconds, bool(args.trace),
                           "cuda", t_start)
    # after the window, the trace's readers and the check: all that this
    # process loaded before its result line
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules loaded that the run may not load: {bad}", file=sys.stderr)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": res["peak_bytes"]}
    if args.trace:
        device.update(busy_s=res.get("busy_s", 0.0), window_s=res.get("window_s", 0.0))
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["compared"] = res["compared"]
    for k, v in res["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
