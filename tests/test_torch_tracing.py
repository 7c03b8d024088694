"""The port's spans and counters (``pair_allegro_tpu_torch/tracing.py``) on
the CPU: off, a span is the shared null context and a profiler sees no
``pat.`` event; on, a short NVE run of a small Allegro and a small NequIP
model opens every span of the single-device path, each step's force and
skin check inside its ``md.step``; the halo engine on four shards of the
CPU opens the exchange and the gather; ``host_reads`` and
``neighbors.builds`` count the skin check, the thermo row and the builds;
``counters()`` names every kernel build's launch counts."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine
from pair_allegro_tpu_torch.io.dump import host
from pair_allegro_tpu_torch.md.integrate import Simulation
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_init_numpy,
    allegro_params_from_numpy,
)
from pair_allegro_tpu_torch.models.nequip import (
    NequIPConfig,
    nequip_init_numpy,
    nequip_params_from_numpy,
)
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
from pair_allegro_tpu_torch.parallel import HaloShardedAllegroEngine, make_mesh
from pair_allegro_tpu_torch.system import System, Units, fcc_lattice

torch.set_num_threads(2)
F64 = torch.float64
ALLEGRO = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=2, num_scalar_features=8,
               num_tensor_features=4, avg_num_neighbors=12.0)
NEQUIP = dict(type_names=("Cu",), r_max=4.0, l_max=1, num_layers=2, num_features=4,
              avg_num_neighbors=12.0)
SINGLE_SPANS = {"md.step", "md.chunk_end", "neighbors.check", "neighbors.build",
                "force.forward", "force.backward", "model.inputs", "model.layers",
                "model.readout"}
IN_EACH_STEP = ("force.forward", "force.backward", "neighbors.check")


@pytest.fixture(autouse=True)
def restore_tracing():
    was = tracing.enabled()
    yield
    tracing.enable(was)


def _engine(family: str, skin: float, n_rep: int = 2, **over):
    pos, cell = fcc_lattice(n_rep, jitter=0.05, seed=0)
    system = System.create(pos, np.zeros(len(pos), np.int64), cell=cell,
                           masses=np.full(len(pos), 63.546), dtype=F64, device="cpu")
    if family == "allegro":
        cfg = AllegroConfig(**{**ALLEGRO, **over})
        params = allegro_params_from_numpy(allegro_init_numpy(cfg, seed=0), cfg, device="cpu",
                                           dtype=F64)
        return system, AllegroEngine(cfg, params, system, device="cpu", skin=skin)
    cfg = NequIPConfig(**{**NEQUIP, **over})
    params = nequip_params_from_numpy(nequip_init_numpy(cfg, seed=0), cfg, device="cpu",
                                      dtype=F64)
    return system, NequIPEngine(cfg, params, system, device="cpu", skin=skin)


def _simulation(family: str, skin: float) -> Simulation:
    system, eng = _engine(family, skin)
    sim = Simulation(system, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs,
                     grow_fn=eng.grow)
    sim.init_velocities(50.0, seed=1)
    return sim


def _spans(prof) -> list:
    """(name without 'pat.', start, end, thread) of each pat. span."""
    return [(e.name[len(tracing.PREFIX):], e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith(tracing.PREFIX)]


def test_off_span_is_the_shared_null_context():
    tracing.enable(False)
    assert tracing.span("md.step") is tracing.span("force.forward")
    with tracing.span("md.step") as got:
        assert got is None
    system, eng = _engine("allegro", skin=0.4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nb = eng.rebuild_fn(system, None)
        eng.force_fn(system, eng.rebuild_fn(system, nb))
    assert any(e.name.startswith("aten::") for e in prof.events())
    assert _spans(prof) == []


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_on_a_run_opens_every_span_nested(family):
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _simulation(family, skin=0.4).run(4, log_every=2)  # built and evaluated once first
    tracing.enable(False)
    spans = _spans(prof)
    assert {s[0] for s in spans} == SINGLE_SPANS
    steps = [s for s in spans if s[0] == "md.step"]
    assert len(steps) == 4 and sum(s[0] == "md.chunk_end" for s in spans) == 2
    for _, a, b, thread in steps:
        inner = [s[0] for s in spans if s[3] == thread and a <= s[1] and s[2] <= b]
        for name in IN_EACH_STEP:
            assert inner.count(name) == 1, (name, inner)
        for name in ("model.inputs", "model.layers", "model.readout"):
            assert inner.count(name) == 1, (name, inner)
    # Simulation's first build and evaluation come before the run, outside a step
    assert sum(s[0] == "force.forward" for s in spans) == 5
    assert sum(s[0] == "neighbors.build" for s in spans) >= 1


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_host_reads_with_a_skin(family):
    """n steps in chunks of c: one skin read a step, one thermo row a chunk."""
    sim = _simulation(family, skin=0.4)
    n, c = 6, 3
    before = tracing.counters()
    sim.run(n, log_every=c)
    after = tracing.counters()
    assert after["host_reads"] - before["host_reads"] == n + n // c
    # the skin check lets builds through only when an atom moved skin / 2
    assert 0 <= after["neighbors.builds"] - before["neighbors.builds"] <= n


def test_no_skin_builds_every_step_and_reads_only_the_thermo_row():
    system, eng = _engine("allegro", skin=0.0)
    before = tracing.counters()
    n, c = 6, 2
    Simulation(system, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs).run(n, log_every=c)
    after = tracing.counters()
    assert after["neighbors.builds"] - before["neighbors.builds"] == n + 1
    assert after["host_reads"] - before["host_reads"] == n // c


def test_host_counts_tensor_reads_only():
    before = tracing.counters()["host_reads"]
    host(np.zeros(3))
    host([1.0, 2.0])
    assert tracing.counters()["host_reads"] == before
    host(torch.zeros(3))
    assert tracing.counters()["host_reads"] == before + 1


def test_halo_engine_opens_the_exchange_and_the_gather():
    """Four slabs on one CPU device, one hop a side: a build and an
    evaluation exchange each shard's frame once each (two blocks moved a
    shard), and the evaluation gathers the shards' outputs once."""
    cfg = AllegroConfig(**{**ALLEGRO, "r_max": 3.0})
    params = allegro_params_from_numpy(allegro_init_numpy(cfg, seed=0), cfg, device="cpu",
                                       dtype=F64)
    pos, cell = fcc_lattice(5, jitter=0.05, seed=0)
    system = System.create(pos, np.zeros(len(pos), np.int64), cell=cell,
                           masses=np.full(len(pos), 63.546), dtype=F64, device="cpu")
    system, _ = HaloShardedAllegroEngine.prepare_system(system, 4)
    eng = HaloShardedAllegroEngine(cfg, params, system, make_mesh(4, devices="cpu"), skin=0.4)
    assert eng.hops == 1
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nb = eng.rebuild_fn(system, None)
        eng.force_fn(system, nb)
    tracing.enable(False)
    names = [s[0] for s in _spans(prof)]
    assert names.count("halo.exchange") == 8 and names.count("halo.gather") == 1
    assert names.count("neighbors.build") == 1 and names.count("model.layers") == 4


KERNEL_MODULES = {"K1": fused_layer, "K2": env_layer, "K3": nequip_conv, "K4": tp_mix_fused,
                  "K6": embed_layer, "K7": readout_layer, "K8": fused_stack}


@pytest.mark.parametrize("kernel", sorted(KERNEL_MODULES))
def test_counters_name_every_build(kernel):
    mod = KERNEL_MODULES[kernel]
    counts = [c for _, c in mod.BUILDS.values()]
    assert len({c.name for c in counts}) == len(counts)
    for c in counts:
        assert c.name.startswith(kernel + ".")
        c.fwd += 2
        c.bwd += 1
        snap = tracing.counters()
        c.fwd -= 2
        c.bwd -= 1
        assert (snap[c.name + ".fwd"], snap[c.name + ".bwd"]) == (c.fwd + 2, c.bwd + 1)


def test_counters_hold_k5_and_the_two_counts():
    snap = tracing.counters()
    assert env_layer_mxu.launches.name == "K5.mxu" and "K5.mxu.fwd" in snap
    assert {"host_reads", "neighbors.builds"} <= set(snap)
    assert all(isinstance(v, int) for v in snap.values())
    with pytest.raises(ValueError, match="registered"):
        tracing.LaunchCounts("K1.tf32x3")
