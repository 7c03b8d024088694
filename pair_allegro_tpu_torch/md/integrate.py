"""NVE integration and the Simulation driver (counterpart of
``pair_allegro_tpu/md/integrate.py:31-134, 323-519``).

Steps run eagerly in chunks of ``log_every``; after each chunk the host reads
one thermo row, including the neighbor-capacity overflow flag, and regrows
and re-runs the chunk when capacity ran out.  State tensors are never
updated in place, so the state before a chunk is its own snapshot.  Only the
NVE integrator is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pair_allegro_tpu_torch.md.thermo import thermo_row
from pair_allegro_tpu_torch.neighbors.device import NeighborData
from pair_allegro_tpu_torch.system import System, Units


@dataclasses.dataclass
class MDState:
    system: System
    neighbors: NeighborData
    forces: torch.Tensor
    potential_energy: torch.Tensor
    atomic_energy: torch.Tensor
    virial: torch.Tensor
    step: int
    # () bool: some neighbor build since the chunk started overflowed
    overflow: torch.Tensor
    extras: dict = dataclasses.field(default_factory=dict)


def create_velocities(masses, temp_K: float, generator: torch.Generator | None = None,
                      valid=None, zero_momentum: bool = True):
    """Maxwell-Boltzmann velocities at temp_K [A/ps], COM drift removed and
    rescaled to the exact target temperature (n_dof = 3N - 3)."""
    n = masses.shape[0]
    dev = masses.device if generator is None else generator.device
    sigma = torch.sqrt(Units.kB * temp_K / (masses * Units.mvv2e))[:, None]
    v = torch.randn((n, 3), generator=generator, dtype=masses.dtype, device=dev)
    v = v.to(masses.device) * sigma
    mask = torch.ones(n, dtype=torch.bool, device=masses.device) if valid is None else valid
    m = (masses * mask)[:, None]
    if zero_momentum:
        v = v - torch.sum(m * v, dim=0) / torch.sum(m)
    nv = torch.clamp_min(mask.sum(), 1).to(masses.dtype)
    ndof = torch.clamp_min(3.0 * nv - 3.0, 1.0) if zero_momentum else 3.0 * nv
    ke = 0.5 * Units.mvv2e * torch.sum(m * v * v)
    t_now = 2.0 * ke / (ndof * Units.kB)
    return v * torch.sqrt(temp_K / torch.clamp_min(t_now, 1e-12)) * mask[:, None]


def _accel(forces, masses):
    return forces * (Units.ftm2a / masses)[:, None]


def _evaluate(force_fn, system, neighbors) -> dict:
    out = force_fn(system, neighbors)
    return dict(
        forces=out.forces,
        potential_energy=out.total_energy,
        atomic_energy=out.atomic_energy,
        virial=out.virial,
        extras=out.extras,
    )


def nve_step(state: MDState, force_fn, rebuild_fn, dt: float) -> MDState:
    """Velocity Verlet (fix nve)."""
    sys_ = state.system
    v_half = sys_.velocities + (0.5 * dt) * _accel(state.forces, sys_.masses)
    sys_ = sys_.replace(positions=sys_.positions + dt * v_half)
    neighbors = rebuild_fn(sys_, state.neighbors)
    out = _evaluate(force_fn, sys_, neighbors)
    v_new = v_half + (0.5 * dt) * _accel(out["forces"], sys_.masses)
    return dataclasses.replace(
        state,
        system=sys_.replace(velocities=v_new),
        neighbors=neighbors,
        step=state.step + 1,
        overflow=state.overflow | neighbors.overflow,
        **out,
    )


class Simulation:
    """NVE MD driver: ``force_fn(system, neighbors) -> ModelOutputs``,
    ``rebuild_fn(system, prev) -> NeighborData``.  With ``grow_fn``
    (``engine.grow``) a capacity overflow regrows and re-runs the chunk;
    without it the overflow raises (the chunk's results are invalid)."""

    MAX_CHUNK = 2000

    def __init__(self, system: System, force_fn, rebuild_fn, dt: float = 1.0e-3,
                 grow_fn: Callable[..., Callable] | None = None):
        self.force_fn = force_fn
        self.rebuild_fn = rebuild_fn
        self.dt = float(dt)
        self.grow_fn = grow_fn
        self.regrows = 0
        neighbors = rebuild_fn(system, None)
        self.state = MDState(
            system=system, neighbors=neighbors, step=0, overflow=neighbors.overflow,
            **_evaluate(force_fn, system, neighbors),
        )

    def init_velocities(self, temp_K: float, seed: int = 1):
        sys_ = self.state.system
        gen = torch.Generator(device=sys_.device).manual_seed(seed)
        v = create_velocities(sys_.masses, temp_K, gen, valid=sys_.valid_mask())
        self.state = dataclasses.replace(self.state, system=sys_.replace(velocities=v))

    def _regrow(self, backup: MDState) -> None:
        self.rebuild_fn = self.grow_fn(system=backup.system)
        self.regrows += 1
        neighbors = self.rebuild_fn(backup.system, None)
        self.state = dataclasses.replace(
            backup, neighbors=neighbors, overflow=neighbors.overflow,
            **_evaluate(self.force_fn, backup.system, neighbors),
        )

    def run(self, n_steps: int, log_every: int = 100, callback=None) -> list[dict]:
        """Run n_steps; returns one thermo row per chunk of ``log_every``."""
        log_every = max(1, min(log_every, n_steps, self.MAX_CHUNK))
        rows = []
        done = 0
        while done < n_steps:
            n_sub = min(log_every, n_steps - done)
            backup = self.state
            state = dataclasses.replace(backup, overflow=backup.neighbors.overflow)
            for _ in range(n_sub):
                state = nve_step(state, self.force_fn, self.rebuild_fn, self.dt)
            self.state = state
            row = thermo_row(state)
            if row["overflow"]:
                if self.grow_fn is None:
                    raise RuntimeError(
                        "neighbor capacity overflow during chunk: pass grow_fn "
                        "(results in this chunk are invalid)"
                    )
                self._regrow(backup)
                continue
            rows.append(row)
            if callback is not None:
                callback(self.state, row)
            done += n_sub
        return rows
