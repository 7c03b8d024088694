"""One run of one cell: set-up, the measured window of MD episodes, the
trace's per-layer numbers, and the check against the plain reference.

A cell (``workloads/<name>.json``) names its configuration
(``configs/<config>.json``: the model family, its widths, the precision
policy, the counting module), its engine (``engines/<engine>.py``) and its
traffic: ``n_rep`` cells of a lattice ``basis`` with a Gaussian jitter
drawn from the seed, its species in the proportions of ``composition``
with their ``masses``, periodic along ``pbc``; NVE at ``dt_fs`` from
``temperature_K`` in episodes of ``episode_steps`` steps.  Every episode
starts from the seeded lattice with a fresh neighbor build and velocities
drawn from (seed, episode); the window runs whole episodes until
``seconds`` have passed.  The weights are drawn on the device from the
seed (``families.leaves_from_seed``); the reference draws them again.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pair_allegro_tpu")


def load(kind: str, name: str) -> dict:
    """``gpubench/<kind>/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def lattice(wl: dict, type_names, seed: int):
    """(positions, cell, types, masses, pbc) as numpy: ``n_rep`` cells (one
    count, or one a side) of the ``basis`` (fractions of the cubic side
    ``a0``), jittered by ``jitter`` A (Gaussian) from the seed; the species
    in the proportions of ``composition`` (exact counts, placed by the
    seed), indexed by the model's ``type_names``, with their ``masses``;
    ``vacuum`` A added to each side that ``pbc`` leaves open."""
    reps, a0 = np.broadcast_to(np.asarray(wl["n_rep"]), 3), wl["a0"]
    base = np.asarray(wl["basis"], dtype=np.float64) * a0
    g = np.stack(np.meshgrid(*[np.arange(n) for n in reps], indexing="ij"), -1).reshape(-1, 1, 3)
    pos = (base[None] + g * a0).reshape(-1, 3)
    rng = np.random.default_rng([int(seed), 0])
    pos = pos + wl["jitter"] * rng.standard_normal(pos.shape)
    n, names = len(pos), list(wl["composition"])
    frac = np.asarray([wl["composition"][k] for k in names], dtype=np.float64)
    counts = np.floor(frac / frac.sum() * n).astype(np.int64)
    counts[0] += n - counts.sum()
    species = np.repeat(np.arange(len(names)), counts)
    if len(names) > 1:
        species = np.random.default_rng([int(seed), 3]).permutation(species)
    types = np.asarray([list(type_names).index(k) for k in names], np.int64)[species]
    masses = np.asarray([wl["masses"][k] for k in names], np.float64)[species]
    pbc = tuple(bool(p) for p in wl["pbc"])
    side = reps * a0 + np.where(pbc, 0.0, wl.get("vacuum", 0.0))
    return pos, np.diag(side), types, masses, pbc


def episode_seed(seed: int, ep: int) -> int:
    return (int(seed) * 1_000_003 + ep) % 2**63


def check_points(wl: dict, seed: int) -> dict:
    """{episode: s}: the window's first ``check_points`` episodes, each
    with the step s, drawn from the seed, whose pair (s - 1, s) is
    checked."""
    return {ep: int(np.random.default_rng([int(seed), 1, ep]).integers(1, wl["episode_steps"]))
            for ep in range(wl["check_points"])}


class Recorder:
    """The engine's callables with the bench spans around them, the host
    time of each skin check, and, in an episode that is checked, the states
    of the evaluations the check reads (kept by reference: the program
    never updates a state in place)."""

    def __init__(self, eng, trace: bool):
        self.eng = eng
        self.trace = trace
        self.evals = 0
        self.regrows = 0
        self.migrations = 0
        self.step_s = []
        self.captures = {}
        self._want = ()
        self._k = 0
        self._n = 0
        self._last = None

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.trace else contextlib.nullcontext()

    def start_episode(self, n_steps: int, want=()):
        self._want, self._k, self._n, self._last = set(want), 0, n_steps, None
        self.captures = {}

    def rebuild_fn(self, system, prev):
        with self.span("bench.rebuild"):
            nb = self.eng.rebuild_fn(system, prev)
        if prev is not None:  # a step's skin check, which read one flag
            t = time.perf_counter()
            if self._last is not None:
                self.step_s.append(t - self._last)
            self._last = t
        return nb

    def force_fn(self, system, nb):
        with self.span("bench.force"):
            out = self.eng.force_fn(system, nb)
        if self._k in self._want:
            self.captures[self._k] = (system.positions, system.velocities, out.forces,
                                      out.atomic_energy)
        self._k += 1
        self.evals += 1
        return out

    def grow_fn(self, **kw):
        """A regrow re-runs the chunk from its start, so the episode's
        evaluations count from 0 again."""
        self.eng.grow(**kw)
        self.regrows += 1
        self._k = 0
        self.captures = {}
        return self.rebuild_fn

    def migrate_fn(self, system):
        """The engine's re-sort of atoms into its slabs.  Within the
        episode's chunk (a re-run after drift past the halo's margin) the
        evaluations count from 0 again; at its end the states kept stay
        valid in their own order."""
        new_sys, perm, new_rebuild = self.eng.maybe_migrate(system=system)
        if new_sys is None:
            return None, None, None
        self.migrations += 1
        if self._k <= self._n:
            self._k = 0
            self.captures = {}
        return new_sys, perm, (self.rebuild_fn if new_rebuild is not None else None)


def run_episode(rec: Recorder, system0, wl: dict, seed: int, ep: int, n_steps: int,
                s: int | None = None, migrate: bool = False):
    """One episode of ``n_steps`` from ``system0``: (its last thermo row,
    and, where ``s`` is given, the states its check reads or None)."""
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    want = (0, 1, s - 1, s, s + 1) if s is not None else ()
    rec.start_episode(n_steps, want)
    with rec.span("bench.episode"):
        sim = Simulation(system0, rec.force_fn, rec.rebuild_fn, dt=wl["dt_fs"] * Units.fs,
                         integrator=wl["integrator"], seed=episode_seed(seed, ep),
                         grow_fn=rec.grow_fn, migrate_fn=rec.migrate_fn if migrate else None)
        sim.init_velocities(wl["temperature_K"], seed=episode_seed(seed, ep))
        rows = sim.run(n_steps, log_every=n_steps)
    point = None
    if want and set(rec.captures) == set(want):
        c = rec.captures
        point = {"x_prev": c[s - 1][0], "v_prev": c[s][1], "F_prev": c[s - 1][2],
                 "e_prev": c[s - 1][3], "F": c[s][2], "e": c[s][3], "v": c[s + 1][1],
                 "x0": c[0][0], "F0": c[0][2], "e0": c[0][3], "v0": c[1][1],
                 "start": (episode_seed(seed, ep), wl["temperature_K"])}
    rec.captures = {}
    return rows[-1], point


def setup(wl: dict, cf: dict, seed: int, device, trace: bool):
    """(system, engine, recorder, family, simulation keywords) ready for
    the window: weights and lattice from the seed, the engine's first
    build, and one short episode at the cell's shapes, which builds and
    loads every kernel it runs."""
    from pair_allegro_tpu_torch.ops.prec import set_matmul_precision
    from pair_allegro_tpu_torch.system import System

    t0 = time.perf_counter()
    fam = importlib.import_module(f"gpubench.families.{cf['family']}")
    engines = importlib.import_module(f"gpubench.engines.{wl['engine']}")
    set_matmul_precision(cf["precision_policy"])
    cfg = fam.model_config(cf["model"])
    dtype = getattr(torch, cf["dtype"])
    pos, cell, types, masses, pbc = lattice(wl, cf["model"]["type_names"], seed)
    system = System.create(pos, types, cell=cell, masses=masses, pbc=pbc, dtype=dtype,
                           device=device)
    params = fam.make_tree(cf["model"], seed, device, dtype)
    t1 = time.perf_counter()
    system, eng, sim_kw = engines.make(fam, cfg, params, system, wl, device)
    t2 = time.perf_counter()
    rec = Recorder(eng, trace)
    run_episode(rec, system, wl, seed, 0, wl["warmup_steps"], **sim_kw)
    synchronize(system.device, wl["chips"])
    print(f"setup: system and weights {t1 - t0:.3f} s, engine {t2 - t1:.3f} s, warm-up episode "
          f"{time.perf_counter() - t2:.3f} s, K={getattr(eng.spec, 'max_neighbors', 0)}, "
          f"remat {eng.cfg.remat}", file=sys.stderr)
    return system, eng, rec, fam, sim_kw


def synchronize(device, chips: int) -> None:
    """Wait for every card the cell uses."""
    if torch.device(device).type == "cuda":
        for i in range(chips):
            torch.cuda.synchronize(i)


def peak_bytes(device, chips: int) -> int:
    """The allocator's peak over the run on the fullest of the cell's cards."""
    if torch.device(device).type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(chips))


def window(rec: Recorder, system, wl: dict, seed: int, seconds: float, sim_kw: dict):
    """Whole episodes until ``seconds`` have passed and the episodes that
    are checked have run: (steps, wall seconds, failed steps, the check's
    states by episode)."""
    checked = check_points(wl, seed)
    points, steps, failed, ep = {}, 0, 0, 0
    rec.regrows = 0
    rec.migrations = 0
    rec.evals = 0
    rec.step_s = []
    t0 = time.perf_counter()
    while True:
        row, point = run_episode(rec, system, wl, seed, ep, wl["episode_steps"],
                                 checked.get(ep), **sim_kw)
        steps += wl["episode_steps"]
        if not math.isfinite(row["etotal"]):
            failed += wl["episode_steps"]
        if point is not None:
            points[ep] = point
        ep += 1
        if time.perf_counter() - t0 >= seconds and ep >= len(checked):
            break
    synchronize(system.device, wl["chips"])
    return steps, time.perf_counter() - t0, failed, points


def reference_fn(fam, cf: dict, seed: int, system):
    """``x -> outputs`` of the plain reference on the weights drawn again
    from the seed, at the system's types and cell."""
    ref = importlib.import_module(f"gpubench.reference.{cf['family']}")
    tree = fam.make_tree(cf["model"], seed, system.device, getattr(torch, cf["dtype"]))
    return lambda x: ref.energy_forces(tree, cf["model"], x, system.types, system.cell,
                                       system.pbc)


def run_cell(name: str, wl: dict, cf: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run; returns the result line's fields (without ``device``'s
    name), and the compared numbers and limits under 'compared'.  It
    leaves the look at ``sys.modules`` to its caller, after everything the
    run loads."""
    from gpubench import check

    cuda = torch.device(device).type == "cuda"
    system, eng, rec, fam, sim_kw = setup(wl, cf, seed, device, trace)
    setup_s = time.time() - t_start
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    with prof if prof is not None else contextlib.nullcontext():
        with rec.span("bench.window"):
            steps, wall, failed, points = window(rec, system, wl, seed, seconds, sim_kw)
    peak = peak_bytes(device, wl["chips"])
    evals, step_s, regrows, migrations = rec.evals, rec.step_s, rec.regrows, rec.migrations
    del eng, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    metrics = {}
    extra = {}
    if trace:
        from gpubench import trace as tr

        t_red = time.perf_counter()
        t = tr.reduce(prof, wl["chips"]) if cuda else None
        del prof
        print(f"trace: reduced in {time.perf_counter() - t_red:.3f} s", file=sys.stderr)
        if t is not None:
            extra = trace_fields(name, wl, cf, t, steps, evals, step_s, system)
            metrics = extra.pop("metrics")
    else:
        metrics = {
            "ns_per_day": {"value": steps * wl["dt_fs"] * 1e-6 * 86400.0 / wall, "unit": "ns/day"},
            "peak_gib": {"value": peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    chosen = [points[e] for e in sorted(points)]
    t_check = time.perf_counter()
    numbers = check.compare(chosen, reference_fn(fam, cf, seed, system), system.masses,
                            wl["dt_fs"] * 1e-3)
    print(f"run: setup {setup_s:.3f} s, window {wall:.3f} s, {steps} steps, {evals} force "
          f"evaluations, {regrows} regrows, {migrations} migrations, peak {peak / 2**30:.3f} "
          f"GiB, check of {len(chosen)} points {time.perf_counter() - t_check:.3f} s, "
          f"energy_gap_peak {numbers['energy_gap_peak']!r} (read, not compared)",
          file=sys.stderr)
    limits = wl["limits"]
    ok = (len(chosen) == wl["check_points"] and failed == 0
          and all(numbers[k] <= limits[k] for k in check.NUMBERS))
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    return {"correct": ok, "attempted": steps, "failed": failed, "metrics": metrics,
            "peak_bytes": peak, "compared": compared, **extra}


def trace_fields(name, wl, cf, t, steps, evals, step_s, system) -> dict:
    """The per-layer metrics of the cell (``BENCHMARK.json``'s ``per_layer``
    entries that list it, or list no cells), the device's busy and window
    seconds, and the breakdown."""
    from gpubench.reference.neighbors import pairs

    counts = importlib.import_module(f"gpubench.counts.{cf['counts']}")
    i, _, _ = pairs(system.positions, system.cell, cf["model"]["r_max"], system.pbc)
    work = counts.evaluation(cf["model"], int(system.valid_mask().sum()), int(i.numel()))
    ctx = SimpleNamespace(trace=t, steps=steps, evals=evals, step_s=step_s, work=work,
                          policy=cf["precision_policy"], chips=wl["chips"])
    metrics = {}
    for m in benchmark()["per_layer"]:
        if name in m.get("workloads", [name]):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    print(f"trace: {dict(t.links)} device operations placed (runtime call / host op / none) "
          f"on cards {t.cards}; own kernels: {t.own_names}", file=sys.stderr)
    return {"metrics": metrics, "busy_s": t.busy_s, "window_s": t.window_s,
            "breakdown": {"device_ops": [[n, s] for n, s in t.by_name.most_common(10)],
                          "idle_gaps": [[n, s] for n, s in t.idle.most_common(10)]}}
