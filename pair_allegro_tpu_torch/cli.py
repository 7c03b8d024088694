"""Command-line runner (counterpart of ``pair_allegro_tpu/cli.py``), the
LAMMPS input-script analog.  One YAML config describes the run:

    data: structure.xyz            # extxyz or LAMMPS data file
    model:
      checkpoint: model.npz        # written by either package's save_params
      # or a random model: family: allegro, seed: 0, config: {r_max: 4.5, ...}
    type_names: [Cu]               # pair_coeff type-name mapping
    masses: {Cu: 63.546}
    integrator: nve                # nve | nvt | npt (MTK) | npt_berendsen | langevin
    dt_fs: 2.0
    steps: 200
    temp_K: 300.0                  # velocity creation (and thermostat target)
    velocity_seed: 1
    tdamp_ps: 0.1                  # nvt / npt thermostat time constant
    damp_ps: 0.1                   # langevin time constant
    press_bar: 0.0                 # npt target pressure
    pdamp_ps: 1.0                  # npt barostat time constant
    bulk_modulus_bar: 1.0e6        # npt_berendsen
    log_every: 50
    skin: 0.4
    dtype: float32
    dump: {path: traj.dump, every: 100}
    restart: {path: state.npz, every: 0}   # 0: only at the end
    restart_from: state.npz        # resume: positions, velocities, cell,
                                   # step, thermostat and noise generator
                                   # come from the file; data: and the
                                   # velocity creation are skipped
    computes:                      # compute allegro / allegro/atom analogs
      - {name: dip, quantity: dipole, style: global, length: 3}   # thermo columns
      - {name: q, quantity: charges, style: atom, ncols: 1}       # dump columns
    profile: {phases: true, trace_dir: trace/}  # rebuild / force ms; a torch.profiler
                                   # trace of the run with the port's pat.* spans
                                   # (tracing.py); any profile: block prints the
                                   # run's counters, "# counter <name> <value>"
    sharding: {n_devices: 8, mode: replicated, row_chunk: 0}
                                   # multi-device run (the mpirun -np N analog):
                                   # replicated (positions replicated, work sharded)
                                   # | halo (z-slabs, ghost exchange; Allegro only);
                                   # with --device cuda:0 (or cpu) the shards share
                                   # that one device
    compile_cache: /path/to/cache  # build and load the compiled libraries there

The config is read by ``io/config.py`` (a YAML subset), never by a YAML
package.  ``run`` and ``train`` run on the CUDA device unless ``--device
cpu`` is given; without a GPU and without it, they raise
``resolve_device``'s error.

``train config.yaml`` trains or fine-tunes a model on an extxyz dataset
(energy= and a forces column, optionally a quoted 9-value virial=), on the
plain path (``for_training()``, no kernel), with the JAX CLI's keys:

    model: {family: allegro, config: {...}} | {checkpoint: in.npz}
    dataset: frames.xyz
    val_dataset: other.xyz       # optional; default: val_fraction split
    val_fraction: 0.1
    loss: {energy: 1.0, force: 1.0, virial: 0.0, per_atom_energy: true}
    optimizer: {name: adam, lr: 1e-3, weight_decay: 0.0}   # adam | adamw | sgd
    ema_decay: 0.99              # optional EMA weights, evaluated and saved
    batch_size: 4
    epochs: 50
    log_every: 5
    seed: 0
    dtype: float32
    out: trained.npz
    sharding: {n_devices: 2}     # data parallel: each batch's frames split
                                 # over the devices (batch_size a multiple)

The split and each epoch's order come from the JAX CLI's
``np.random.RandomState(seed)`` calls, so both CLIs see the same batches.

``import ckpt model.yaml [out.npz] [--inspect] [--lenient]`` converts a
torch checkpoint (Lightning .ckpt, .pth, or a TorchScript package whose
metadata fills r_max / type_names / per_edge_type_cutoff) to a ``.npz``;
model.yaml holds ``family``, ``config`` and ``key_map: upstream | e3nn |
{ours: theirs}`` (default upstream).

Differences from the JAX package's CLI:
* a random model (``model: {family, seed, config}``) is drawn with numpy
  (``allegro_init_numpy`` / ``nequip_init_numpy``), so its weights differ
  from the ``jax.random`` ones of the same seed: compare the two packages
  through ``model: {checkpoint: ...}``; velocities made from ``temp_K``
  differ in the same way;
* a JAX state file's ``rng_key`` is not continued: the noise generator is
  seeded from the key's words and prints a ``#`` line saying so;
* a mesh is the devices of one process (``parallel/mesh.py``): without
  ``--device`` the GPUs ``cuda:0 ..``; ``--device cpu`` or ``--device
  cuda:0`` counts that one device ``n_devices`` times (several shards
  share it, as the JAX suite's virtual devices share the CPU); a sharded
  run writes its dumps and restarts with the atoms in their original order
  (the JAX CLI writes them in the sorted order), the halo mode's positions
  wrapped into the box;
* ``import --lenient`` fills a missing key from the numpy init, not from
  ``jax.random``; ``compile_cache:`` and ``PAT_COMPILE_CACHE`` hold the
  compiled kernel and host libraries (``compile_cache.py``), not XLA
  executables.

Usage: python -m pair_allegro_tpu_torch.cli run config.yaml [--device cpu]
       python -m pair_allegro_tpu_torch.cli train config.yaml [--device cpu]
       python -m pair_allegro_tpu_torch.cli import last.ckpt model.yaml model.npz
       python -m pair_allegro_tpu_torch.cli info model.npz
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
import sys
import time

import numpy as np
import torch

from pair_allegro_tpu_torch import checkpoint as ckpt
from pair_allegro_tpu_torch import import_torch as imp
from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.compile_cache import cache_dir as compile_cache_dir
from pair_allegro_tpu_torch.compile_cache import enable_compile_cache, maybe_enable_from_env
from pair_allegro_tpu_torch.computes import GlobalCompute, PerAtomCompute
from pair_allegro_tpu_torch.data import load_frames, shard_batch, stack_frames
from pair_allegro_tpu_torch.debug import debug_enabled, dump_edges
from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine, TypeMapper
from pair_allegro_tpu_torch.io.config import load_config
from pair_allegro_tpu_torch.io.dump import DumpWriter, host
from pair_allegro_tpu_torch.io.extxyz import read_extxyz
from pair_allegro_tpu_torch.io.lammps_data import read_lammps_data
from pair_allegro_tpu_torch.md import integrate
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_energy,
    allegro_init_numpy,
)
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, nequip_energy, nequip_init_numpy
from pair_allegro_tpu_torch.parallel import (
    HaloShardedAllegroEngine,
    ShardedAllegroEngine,
    ShardedNequIPEngine,
    make_mesh,
)
from pair_allegro_tpu_torch.system import System, Units, resolve_device
from pair_allegro_tpu_torch.train import (
    detached,
    make_batched_loss_fn,
    make_loss_fn,
    make_train_step,
)

DTYPES = {"float32": torch.float32, "float64": torch.float64}
THERMO_COLS = ["step", "pe", "ke", "etotal", "temp", "press", "n_edges"]


def _load_structure(path: str):
    """(positions, symbols or None, cell, pbc, numeric 0-based types or None)."""
    if path.endswith((".xyz", ".extxyz")):
        fr = read_extxyz(path, index=0)
        return fr["positions"], list(fr["symbols"]), fr["cell"], fr["pbc"], None
    d = read_lammps_data(path)
    return d["positions"], None, d["cell"], (True, True, True), d["types"]


def _build_model(mcfg: dict, dtype, device):
    """(cfg, params on ``device``, family) of the ``model:`` section."""
    if "checkpoint" in mcfg:
        return ckpt.load_model(mcfg["checkpoint"], device, dtype)
    family = mcfg.get("family", "allegro")
    cfg_kw = {k: ckpt.as_tuples(v) for k, v in (mcfg.get("config") or {}).items()}
    cfg_kw.setdefault("type_names", tuple(mcfg.get("type_names", ())))
    seed = int(mcfg.get("seed", 0))
    if family == "allegro":
        cfg = AllegroConfig(**cfg_kw)
        tree = allegro_init_numpy(cfg, seed)
    elif family == "nequip":
        cfg = NequIPConfig(**cfg_kw)
        tree = nequip_init_numpy(cfg, seed)
    else:
        raise SystemExit(f"unknown model family {family!r}")
    return cfg, ckpt.params_from_numpy(tree, cfg, device, dtype), family


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase_timings(system, eng, device) -> dict:
    """Wall ms of a neighbor build from scratch and of a force evaluation,
    the least of three after a warmup, each ended by a synchronize."""
    nb = eng.rebuild_fn(system, None)
    calls = {"neighbor_rebuild_ms": lambda: eng.rebuild_fn(system, None),
             "force_eval_ms": lambda: eng.force_fn(system, nb)}
    out = {}
    for name, fn in calls.items():
        fn()
        _sync(device)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            ts.append(time.perf_counter() - t0)
        out[name] = min(ts) * 1000
    return out


def _integrator_kwargs(conf: dict, integrator: str) -> dict:
    if integrator == "nvt":
        return dict(temp_K=float(conf.get("temp_K", 300.0)),
                    tdamp=float(conf.get("tdamp_ps", 0.1)))
    if integrator == "langevin":
        return dict(temp_K=float(conf.get("temp_K", 300.0)),
                    damp=float(conf.get("damp_ps", 0.1)))
    if integrator in ("npt", "npt_berendsen"):
        kw = dict(temp_K=float(conf.get("temp_K", 300.0)), tdamp=float(conf.get("tdamp_ps", 0.1)),
                  press_bar=float(conf.get("press_bar", 0.0)),
                  pdamp=float(conf.get("pdamp_ps", 1.0)))
        if integrator == "npt_berendsen" and "bulk_modulus_bar" in conf:
            kw["bulk_modulus_bar"] = float(conf["bulk_modulus_bar"])
        return kw
    return {}


def cmd_run(args) -> int:
    conf = load_config(args.config) or {}
    if conf.get("compile_cache"):
        enable_compile_cache(str(conf["compile_cache"]))
    if maybe_enable_from_env():
        print(f"# compile_cache: the kernel and host libraries build and load in "
              f"{compile_cache_dir()}")
    device = resolve_device(args.device)
    dtype = DTYPES[conf.get("dtype", "float32")]
    cfg, params, family = _build_model(conf.get("model") or {}, dtype, device)

    resume_from = conf.get("restart_from")
    if resume_from:
        # the state file holds the whole dynamical state: no data:, and the
        # velocities are not created anew
        system, resume_step, resume_thermo, resume_rng = ckpt.load_state(
            resume_from, dtype=dtype, device=device)
        print(f"# resuming from {resume_from} at step {resume_step}")
    else:
        pos, symbols, cell, pbc, numeric_types = _load_structure(conf["data"])
        # the pair_coeff contract: file type t -> model type index
        type_names = conf.get("type_names") or list(cfg.type_names)
        mapper = TypeMapper(cfg.type_names)
        types = (mapper.map_names(type_names)[numeric_types] if numeric_types is not None
                 else mapper.map_names(symbols))
        masses_conf = conf.get("masses") or {}
        masses = np.asarray([masses_conf.get(cfg.type_names[t], 1.0) for t in types])
        system = System.create(pos, types, cell=cell, masses=masses, pbc=pbc, dtype=dtype,
                               device=device)

    skin = float(conf.get("skin", 0.0))
    order = None  # the sharded run's sorted order: NEW index -> ORIGINAL (-1: padding)
    if conf.get("sharding"):
        system, eng, order = _sharded_engine(conf["sharding"], cfg, params, system, family,
                                             args.device, skin)
    else:
        engine_cls = NequIPEngine if family == "nequip" else AllegroEngine
        eng = engine_cls(cfg, params, system, device=device, skin=skin)
    integrator = conf.get("integrator", "nve")
    sim = integrate.Simulation(
        system, eng.force_fn, eng.rebuild_fn, dt=float(conf.get("dt_fs", 1.0)) * Units.fs,
        integrator=integrator, grow_fn=eng.grow, shrink_fn=getattr(eng, "maybe_shrink", None),
        migrate_fn=getattr(eng, "maybe_migrate", None),
        **_integrator_kwargs(conf, integrator),
    )
    if resume_from:
        # thermostat values are cast into the freshly created scalars, so
        # that their dtype and device stay the run's
        thermostat = {k: resume_thermo[k].to(dtype=v.dtype, device=v.device)
                      if k in resume_thermo else v for k, v in sim.state.thermostat.items()}
        generator = sim.state.generator
        if resume_rng is not None:
            generator, from_jax = ckpt.generator_from_rng(resume_rng, device)
            if from_jax:
                print("# the state file carries a JAX rng_key, which this package cannot "
                      "continue: the noise generator is seeded from the key's words, so the "
                      "noise stream is this package's own")
        sim.state = dataclasses.replace(sim.state, step=resume_step, thermostat=thermostat,
                                        generator=generator)
    if debug_enabled():
        dump_edges(sim.state.neighbors, system.positions, system.cell)
    if conf.get("temp_K") and not resume_from:
        sim.init_velocities(float(conf["temp_K"]), seed=int(conf.get("velocity_seed", 1)))

    dump_conf = conf.get("dump")
    global_computes, atom_computes = [], []
    for cc in conf.get("computes") or []:
        name = cc.get("name", cc["quantity"])
        if cc.get("style", "global") == "atom":
            atom_computes.append((name, PerAtomCompute(cc["quantity"], int(cc.get("ncols", 1)))))
        else:
            length = int(cc["length"])
            global_computes.append((name, GlobalCompute(cc["quantity"], length), length))

    steps = int(conf.get("steps", 0))
    log_every = int(conf.get("log_every", max(1, steps // 10 or 1)))
    dump_every = int(dump_conf.get("every") or 0) if dump_conf else 0
    if dump_every:
        # the callback sees the state only at chunk ends: never skip a dump
        log_every = min(log_every, dump_every)
    rst = conf.get("restart")
    rst_every = int(rst.get("every") or 0) if rst else 0
    if rst_every:
        log_every = min(log_every, rst_every)
    gcols = [f"c_{name}" if length == 1 else f"c_{name}[{j + 1}]"
             for name, _, length in global_computes for j in range(length)]
    print(" ".join(f"{c:>14s}" for c in THERMO_COLS + gcols))

    def original(state, *per_atom):
        """The state's system (and per-atom arrays) in the original atom
        order, padding dropped: the identity for an unsharded run."""
        if order is None:
            return (state.system, *per_atom)
        cur = order if sim.atom_perm is None else order[sim.atom_perm]
        idx = np.empty(int((cur >= 0).sum()), np.int64)
        idx[cur[cur >= 0]] = np.flatnonzero(cur >= 0)
        rows = torch.as_tensor(idx, device=state.system.device)
        sys_ = state.system
        sys_ = sys_.replace(positions=sys_.positions[rows], velocities=sys_.velocities[rows],
                            types=sys_.types[rows], masses=sys_.masses[rows],
                            valid=sys_.valid_mask()[rows])
        return (sys_, *(a[rows] for a in per_atom))

    def write_restart(state):
        ckpt.save_state(rst["path"], original(state)[0], step=state.step,
                        thermostat=state.thermostat, rng_state=state.generator.get_state())

    with contextlib.ExitStack() as stack:
        writer = stack.enter_context(DumpWriter(dump_conf["path"])) if dump_conf else None

        def callback(state, row):
            line = " ".join(f"{float(row[c]):14.6g}" for c in THERMO_COLS)
            for _, comp, _ in global_computes:
                line += " " + " ".join(f"{v:14.6g}" for v in
                                       np.atleast_1d(host(comp(state, state.system))))
            print(line, flush=True)
            if dump_every and row["step"] % dump_every == 0:
                names = [n for n, _ in atom_computes]
                sys_, forces, e_atom, *cols = original(
                    state, state.forces, state.atomic_energy,
                    *(comp(state, state.system) for _, comp in atom_computes))
                writer.write_frame(row["step"], sys_, forces=forces, atomic_energy=e_atom,
                                   extras=dict(zip(names, cols)))
            if rst_every and row["step"] % rst_every == 0:
                write_restart(state)

        prof = conf.get("profile") or {}
        if prof.get("phases"):
            for k, v in _phase_timings(sim.state.system, eng, device).items():
                print(f"# phase {k}: {v:.2f}")
        trace_dir = prof.get("trace_dir")
        tracer = None
        if trace_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            tracer = torch.profiler.profile(activities=activities)
            stack.callback(tracing.enable, tracing.enabled())
            tracing.enable(True)
            tracer.start()
        counts0 = tracing.counters()
        t0 = time.perf_counter()
        sim.run(steps, log_every=log_every, callback=callback)
        _sync(device)
        wall = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
            os.makedirs(trace_dir, exist_ok=True)
            tracer.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            print(f"# torch.profiler trace -> {os.path.join(trace_dir, 'trace.json')}")
        if "profile" in conf:
            for name, v in tracing.counters().items():
                if v != counts0[name]:
                    print(f"# counter {name} {v - counts0[name]}")
        sps = steps / wall if wall > 0 else float("inf")
        print(f"# {steps} steps in {wall:.1f} s ({sps:.2f} steps/s, "
              f"{sps * float(conf.get('dt_fs', 1.0)) * 1e-6 * 86400:.3f} ns/day)")
        if rst:
            write_restart(sim.state)
            print(f"# restart written to {rst['path']}")
    return 0


def cmd_info(args) -> int:
    params, cfg, family = ckpt.load_params(args.model)
    print(f"family: {family}")
    for k, v in sorted((cfg or {}).items()):
        print(f"  {k}: {v}")
    print(f"parameters: {sum(a.size for a in ckpt.flatten(params).values())}")
    return 0


def _mesh(shard_conf: dict, device_arg, axis_name: str):
    """The mesh of a ``sharding:`` section: ``n_devices`` devices (0 or
    absent: all GPUs); ``--device cpu`` or a device with an index
    (``--device cuda:0``) counts that one device ``n_devices`` times."""
    return make_mesh(int(shard_conf.get("n_devices", 0)) or None, axis_name, devices=device_arg)


def _check_batch(bsz: int, mesh) -> None:
    """A data-parallel batch must split evenly over the mesh (JAX's check)."""
    if mesh is not None and bsz % mesh.size:
        raise SystemExit(f"batch_size {bsz} must divide n_devices {mesh.size}")


def _sharded_engine(shard_conf: dict, cfg, params, system, family: str, device_arg,
                    skin: float):
    """(system sorted for the mesh, engine, order): ``sharding:``'s
    ``mode`` replicated (positions replicated, work sharded) or halo (z-slab
    ghost exchange, Allegro only), as the JAX CLI picks them; order maps
    each row of the sorted system to its original atom (-1: padding)."""
    mesh = _mesh(shard_conf, device_arg, "atoms")
    s = mesh.shape["atoms"]
    mode = shard_conf.get("mode", "replicated")
    row_chunk = int(shard_conf.get("row_chunk", 0)) or None
    if mode not in ("replicated", "halo"):
        raise SystemExit(f"sharding mode {mode!r} is not replicated or halo")
    if family == "nequip":
        if mode == "halo":
            raise SystemExit(
                "halo sharding requires strict locality; NequIP message "
                "passing shards via mode: replicated (per-layer gather)"
            )
        system, perm = ShardedNequIPEngine.prepare_system(system, s)
        eng = ShardedNequIPEngine(cfg, params, system, mesh, skin=skin)
    elif mode == "halo":
        system, perm = HaloShardedAllegroEngine.prepare_system(system, s)
        eng = HaloShardedAllegroEngine(cfg, params, system, mesh, skin=skin, row_chunk=row_chunk)
    else:
        system, perm = ShardedAllegroEngine.prepare_system(system, s)
        eng = ShardedAllegroEngine(cfg, params, system, mesh, skin=skin, row_chunk=row_chunk)
    order = np.concatenate([perm, np.full(system.n_atoms - len(perm), -1)])
    print(f"# sharding: {mode}, {s} shards on {', '.join(str(d) for d in mesh.devices)}")
    return system, eng, order


def _optimizer(oconf: dict):
    """The ``torch.optim`` constructor of an ``optimizer:`` section, as the
    JAX CLI picks its optax one: adamw (or adam with weight_decay), adam,
    sgd."""
    lr = float(oconf.get("lr", 1e-3))
    wd = float(oconf.get("weight_decay", 0.0))
    name = oconf.get("name", "adam")
    if name == "adamw" or (name == "adam" and wd):
        return functools.partial(torch.optim.AdamW, lr=lr, weight_decay=wd)
    if name == "adam":
        return functools.partial(torch.optim.Adam, lr=lr)
    if name == "sgd":
        return functools.partial(torch.optim.SGD, lr=lr)
    raise SystemExit(f"unknown optimizer {name!r}")


def cmd_train(args) -> int:
    """Train or fine-tune on an extxyz dataset (the module docstring lists
    the keys); writes the best validation epoch's tree to ``out``."""
    conf = load_config(args.config) or {}
    device = resolve_device(args.device)
    mesh = _mesh(conf["sharding"], args.device, "dp") if conf.get("sharding") else None
    if "batch_size" in conf:  # refuse before any loading
        _check_batch(int(conf["batch_size"]), mesh)
    dtype = DTYPES[conf.get("dtype", "float32")]
    cfg, params, family = _build_model(conf.get("model") or {}, dtype, device)
    tcfg = cfg.for_training()
    energy_fn = nequip_energy if family == "nequip" else allegro_energy

    frames = load_frames(conf["dataset"], cfg.type_names, cfg.r_max, dtype=dtype,
                         device=device)
    rng = np.random.RandomState(int(conf.get("seed", 0)))
    if conf.get("val_dataset"):
        val_frames = load_frames(conf["val_dataset"], cfg.type_names, cfg.r_max, dtype=dtype,
                                 device=device)
    else:
        n_val = max(1, int(len(frames) * float(conf.get("val_fraction", 0.1))))
        idx = rng.permutation(len(frames))
        val_frames = [frames[i] for i in idx[:n_val]]
        frames = [frames[i] for i in idx[n_val:]]
        if not frames:
            raise SystemExit("val_fraction leaves no training frames")

    lconf = conf.get("loss") or {}
    loss_kw = dict(w_energy=float(lconf.get("energy", 1.0)),
                   w_force=float(lconf.get("force", 1.0)),
                   w_virial=float(lconf.get("virial", 0.0)),
                   per_atom_energy=bool(lconf.get("per_atom_energy", True)))
    batched = make_batched_loss_fn(make_loss_fn(energy_fn, tcfg, **loss_kw))
    # validation takes no weight gradient: no graph through the forces
    val_loss = make_batched_loss_fn(make_loss_fn(energy_fn, tcfg, **loss_kw,
                                                 create_graph=False))
    ema_decay = conf.get("ema_decay")
    step = make_train_step(batched, _optimizer(conf.get("optimizer") or {}), ema_decay=ema_decay)
    state = step.init(params)
    bsz = int(conf.get("batch_size", min(4, len(frames))))
    _check_batch(bsz, mesh)
    val_batch = stack_frames(val_frames)

    def val_metrics(p):
        m = val_loss(detached(p), val_batch)[1]
        return float(m["rmse_f"]), float(m["mae_e_per_atom"])

    epochs = int(conf.get("epochs", 10))
    log_every = int(conf.get("log_every", max(1, epochs // 20)))
    best = (np.inf, None)
    print(f"# training {family}: {len(frames)} train / {len(val_frames)} val frames, "
          f"batch {bsz}, {epochs} epochs" + (f", DP over {mesh.size} devices" if mesh else ""))
    for epoch in range(epochs):
        order = rng.permutation(len(frames))
        # wrap-around fill keeps every batch at the same size
        n_batches = max(1, (len(order) + bsz - 1) // bsz)
        pad = n_batches * bsz - len(order)
        order = np.concatenate([order, order[:pad]]) if pad else order
        last = {}
        for b in range(n_batches):
            batch = stack_frames([frames[i] for i in order[b * bsz:(b + 1) * bsz]])
            if mesh is not None:
                batch = shard_batch(batch, mesh, "dp")
            params, state, last = step.update(params, state, batch)
        eval_params = step.ema(state) if ema_decay else params
        rmse_f, mae_e = val_metrics(eval_params)
        if rmse_f < best[0]:  # a copy: the optimizer updates the leaves in place
            best = (rmse_f, {k: np.array(v) for k, v in ckpt.flatten(eval_params).items()})
        if epoch % log_every == 0 or epoch == epochs - 1:
            print(f"epoch {epoch:4d}  loss {float(last['loss']):.4e}  "
                  f"val rmse_F {rmse_f:.4e} eV/A  val mae_E/atom {mae_e:.4e} eV")

    out = conf.get("out", "trained.npz")
    saved = best[1] if best[1] is not None else ckpt.flatten(eval_params)
    ckpt.save_params(out, ckpt._unflatten(saved), cfg, family=family)
    print(f"# best val rmse_F {best[0]:.4e} eV/A -> {out}")
    return 0


def cmd_import(args) -> int:
    """torch checkpoint -> ``.npz`` (the module docstring has the model
    YAML); ``--inspect`` prints the checkpoint's tensors and a shape-matched
    key-map proposal and writes nothing."""
    mconf = load_config(args.model_config) or {}
    family = mconf.get("family", "allegro")
    cfg_kw = {k: ckpt.as_tuples(v) for k, v in (mconf.get("config") or {}).items()}
    key_map = mconf.get("key_map", "upstream")
    # a TorchScript package describes itself: its metadata fills r_max,
    # type_names and per_edge_type_cutoff where the YAML does not set them
    if imp._is_torchscript(args.ckpt):
        _, meta = imp.load_torchscript_artifact(args.ckpt)
        meta_kw = imp.config_kwargs_from_metadata(meta)
        if meta_kw:
            print(f"# artifact metadata: {meta_kw}")
        for k, v in meta_kw.items():
            cfg_kw.setdefault(k, v)
    if family not in ("allegro", "nequip"):
        raise SystemExit(f"unknown model family {family!r}")
    cfg = AllegroConfig(**cfg_kw) if family == "allegro" else NequIPConfig(**cfg_kw)
    if args.inspect:
        print(imp.inspect_state_dict(imp.load_torch_state_dict(args.ckpt), imp.template(cfg)))
        return 0
    if args.out is None:
        raise SystemExit("out path required (or pass --inspect)")
    load = imp.import_allegro_checkpoint if family == "allegro" else imp.import_nequip_checkpoint
    params, missing = load(args.ckpt, cfg, key_map=key_map, strict=not args.lenient)
    if missing:
        # every key: a silently half-initialised model is --lenient's worst outcome
        print(f"# WARNING: {len(missing)} params kept at init values:")
        for k in missing:
            print(f"#   missing: {k}")
    ckpt.save_params(args.out, params, cfg, family=family)
    n = sum(a.size for a in ckpt.flatten(params).values())
    print(f"# imported {n} parameters ({family}) -> {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pair_allegro_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="run an MD simulation from a YAML config")
    pr.add_argument("config")
    pr.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device; 'cpu' runs the "
                    "plain PyTorch path)")
    pr.set_defaults(fn=cmd_run)
    pi = sub.add_parser("info", help="describe a saved model checkpoint")
    pi.add_argument("model")
    pi.set_defaults(fn=cmd_info)
    pt = sub.add_parser("train", help="train/fine-tune on an extxyz dataset")
    pt.add_argument("config")
    pt.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA device)")
    pt.set_defaults(fn=cmd_train)
    pim = sub.add_parser("import", help="import a torch training checkpoint to a .npz")
    pim.add_argument("ckpt", help="torch .ckpt/.pth checkpoint or TorchScript package")
    pim.add_argument("model_config", help="YAML with family + config (+ key_map)")
    pim.add_argument("out", nargs="?", default=None, help="output .npz path")
    pim.add_argument("--lenient", action="store_true",
                     help="keep init values for params missing from the checkpoint")
    pim.add_argument("--inspect", action="store_true",
                     help="print the checkpoint's tensors and a shape-matched key-map "
                     "proposal (refusing ambiguity) and exit without writing")
    pim.set_defaults(fn=cmd_import)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
