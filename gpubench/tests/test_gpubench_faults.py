"""A whole run on the CPU, past the harness's look for a card, with the
timed path broken underneath: ``correct`` comes out false for each fault a
cell of this benchmark can have, and true without one."""

import dataclasses
import time

import pytest
import torch

from cells import small_cell


def _run(family="allegro", **wl_over):
    from gpubench import harness

    wl, cf = small_cell(family, **wl_over)
    return harness.run_cell(f"small-{family}", wl, cf, 2**31 + 13, 0.0, False, "cpu", time.time())


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_gpubench_sound_run_is_correct(family):
    res = _run(family)
    assert res["correct"], res["compared"]
    assert res["attempted"] == 4 and res["failed"] == 0


HALO = {"engine": "halo", "shards": 4, "chips": 1, "n_rep": [5, 5, 8]}


def test_gpubench_sound_halo_run_is_correct():
    """The halo engine's cell, four z-slabs sharing the CPU: a box of 5 x 5
    x 8 cells, so that each slab is thicker than the cutoff."""
    res = _run("allegro", **HALO)
    assert res["correct"], res["compared"]
    assert res["attempted"] == 4 and res["failed"] == 0


def _broken_forces(monkeypatch, change):
    from pair_allegro_tpu_torch import engine

    real = engine.PairEngine.force_fn

    def force_fn(self, system, neighbors):
        return change(real(self, system, neighbors))

    monkeypatch.setattr(engine.PairEngine, "force_fn", force_fn)


def test_gpubench_fault_state_unchanged(monkeypatch):
    """The integrator's step evaluates the forces and returns its state
    unchanged."""
    from pair_allegro_tpu_torch.md import integrate

    def stuck(state, force_fn, rebuild_fn, dt):
        nb = rebuild_fn(state.system, state.neighbors)
        force_fn(state.system, nb)
        return dataclasses.replace(state, step=state.step + 1)

    monkeypatch.setitem(integrate._INTEGRATORS, "nve", stuck)
    res = _run()
    assert not res["correct"], res["compared"]


def test_gpubench_fault_half_the_atoms_left_out(monkeypatch):
    """Half the atoms left out: their forces zero, their energies the mean
    of the rest's."""
    def half(out):
        n = out.forces.shape[0] // 2
        forces = torch.cat([out.forces[:n], torch.zeros_like(out.forces[n:])])
        e = torch.cat([out.atomic_energy[:n], out.atomic_energy[:n].mean().expand(
            out.atomic_energy.shape[0] - n)])
        return dataclasses.replace(out, forces=forces, atomic_energy=e, total_energy=e.sum())

    _broken_forces(monkeypatch, half)
    assert not _run()["correct"]


def test_gpubench_fault_one_answer_altered(monkeypatch):
    """One atom's force moved by a hundredth of the largest force."""
    def nudge(out):
        f = out.forces.clone()
        f[7, 1] += 0.01 * f.abs().max()
        return dataclasses.replace(out, forces=f)

    _broken_forces(monkeypatch, nudge)
    res = _run()
    assert not res["correct"], res["compared"]


def test_gpubench_fault_start_velocities_altered(monkeypatch):
    """The episode's velocities drawn at twice the temperature asked."""
    from pair_allegro_tpu_torch.md import integrate

    real = integrate.Simulation.init_velocities

    def hot(self, temp_K, seed=1):
        return real(self, 2.0 * temp_K, seed)

    monkeypatch.setattr(integrate.Simulation, "init_velocities", hot)
    res = _run()
    assert not res["correct"], res["compared"]


def test_gpubench_fault_exchange_left_out(monkeypatch):
    """The halo cell's exchange between slabs left out: every shard's halo
    rows arrive masked, so each slab sees only its own atoms."""
    from pair_allegro_tpu_torch.parallel import halo

    real = halo.HaloShardedAllegroEngine._ext_gather

    def own_slab_only(self, arr, r):
        out = real(self, arr, r)
        if out.dtype == torch.bool:  # the build's mask of the frame's rows
            out = out.clone()
            out[self.n_local:] = False
        return out

    monkeypatch.setattr(halo.HaloShardedAllegroEngine, "_ext_gather", own_slab_only)
    res = _run("allegro", **HALO)
    assert not res["correct"], res["compared"]
