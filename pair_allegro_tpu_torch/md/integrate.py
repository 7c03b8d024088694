"""Integrators and the Simulation driver (counterpart of
``pair_allegro_tpu/md/integrate.py``).

Integrators, in LAMMPS metal units: NVE velocity Verlet ("nve"), Langevin
BAOAB ("langevin"), Nosé-Hoover with one chain ("nvt"), isotropic
Nosé-Hoover/MTK NPT ("npt", the ``fix npt`` family) and Berendsen NPT
("npt_berendsen").  Each keeps the JAX package's order of operations, and
each keeps its thermostat scalars as 0-d tensors on the state's device, so
that a step reads nothing back to the host (the skin check's one read per
step is the neighbor build's).  Langevin draws its noise from the state's
``torch.Generator``, on the state's device.

Steps run eagerly in chunks of ``log_every``; after each chunk the host
reads one thermo row, including the neighbor-capacity overflow flag, and
regrows and re-runs the chunk (from its snapshot and the generator state it
started with) when capacity ran out.  State tensors are never updated in
place, so the state before a chunk is its own snapshot.  Every
``shrink_every`` chunks ``shrink_fn`` may hand back a smaller capacity.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from typing import Callable

import numpy as np
import torch

from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.md.thermo import pressure_tensor, thermo_row
from pair_allegro_tpu_torch.neighbors.device import NeighborData
from pair_allegro_tpu_torch.ops.geometry import det3x3
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
    # the noise stream of 'langevin', on the system's device
    generator: torch.Generator
    # 0-d tensors: 'xi', 'xi_int' ('nvt', 'npt', 'npt_berendsen'), 'eta' ('npt')
    thermostat: dict = dataclasses.field(default_factory=dict)
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


def _advance(state: MDState, system: System, neighbors: NeighborData, out: dict,
             **kw) -> MDState:
    return dataclasses.replace(state, system=system, neighbors=neighbors, step=state.step + 1,
                               overflow=state.overflow | neighbors.overflow, **out, **kw)


def _n_dof(sys_: System):
    """3 max(N, 1) - 3 as a 0-d tensor of the positions' dtype (the
    integrators' count; ``thermo.n_dof`` clamps it at 1)."""
    return 3.0 * torch.clamp_min(sys_.n_valid, 1).to(sys_.positions.dtype) - 3.0


def _scalar(state: MDState, name: str):
    old = state.thermostat.get(name)
    if old is None:
        return torch.zeros((), dtype=state.system.positions.dtype, device=state.system.device)
    return old


def _ke2(masses, mask, v):
    """2 KE in eV."""
    return Units.mvv2e * torch.sum((masses * mask)[:, None] * v * v)


def nve_step(state: MDState, force_fn, rebuild_fn, dt: float) -> MDState:
    """Velocity Verlet (fix nve)."""
    sys_ = state.system
    v_half = sys_.velocities + (0.5 * dt) * _accel(state.forces, sys_.masses)
    sys_ = sys_.replace(positions=sys_.positions + dt * v_half)
    neighbors = rebuild_fn(sys_, state.neighbors)
    out = _evaluate(force_fn, sys_, neighbors)
    v_new = v_half + (0.5 * dt) * _accel(out["forces"], sys_.masses)
    return _advance(state, sys_.replace(velocities=v_new), neighbors, out)


def langevin_step(state: MDState, force_fn, rebuild_fn, dt: float, temp_K: float,
                  damp: float) -> MDState:
    """BAOAB Langevin (fix langevin analog); ``damp`` is the time constant
    [ps].  The noise comes from ``state.generator``."""
    sys_ = state.system
    m = sys_.masses
    v = sys_.velocities + (0.5 * dt) * _accel(state.forces, m)
    pos = sys_.positions + (0.5 * dt) * v
    # O: Ornstein-Uhlenbeck
    c1 = math.exp(-dt / damp)
    sigma = torch.sqrt((1.0 - c1**2) * Units.kB * temp_K / (m * Units.mvv2e))[:, None]
    noise = torch.randn(v.shape, generator=state.generator, dtype=v.dtype, device=v.device)
    v = c1 * v + sigma * noise
    v = v * sys_.valid_mask()[:, None]
    sys_ = sys_.replace(positions=pos + (0.5 * dt) * v)
    neighbors = rebuild_fn(sys_, state.neighbors)
    out = _evaluate(force_fn, sys_, neighbors)
    v = v + (0.5 * dt) * _accel(out["forces"], m)
    return _advance(state, sys_.replace(velocities=v), neighbors, out)


def nose_hoover_step(state: MDState, force_fn, rebuild_fn, dt: float, temp_K: float,
                     tdamp: float) -> MDState:
    """Nosé-Hoover thermostat (fix nvt analog), one chain, velocity-Verlet
    split: half thermostat, half kick, drift, force, half kick, half
    thermostat.  ``xi_int`` (the integral of xi dt) feeds only the
    conserved quantity (``thermo.nose_hoover_conserved``)."""
    sys_ = state.system
    n_dof = _n_dof(sys_)
    q = n_dof * Units.kB * temp_K * tdamp**2  # the thermostat's mass
    mask = sys_.valid_mask()
    xi, xi_int = _scalar(state, "xi"), _scalar(state, "xi_int")

    def thermo_half(v, xi, xi_int):
        # symmetric quarter steps (xi kick, scale, xi kick): kick-then-scale
        # alone is first order and drifts the extended Hamiltonian
        kbt = n_dof * Units.kB * temp_K
        xi = xi + (0.25 * dt) * (_ke2(sys_.masses, mask, v) - kbt) / q
        v = v * torch.exp(-xi * 0.5 * dt)
        xi_int = xi_int + xi * (0.5 * dt)
        xi = xi + (0.25 * dt) * (_ke2(sys_.masses, mask, v) - kbt) / q
        return v, xi, xi_int

    v, xi, xi_int = thermo_half(sys_.velocities, xi, xi_int)
    v = v + (0.5 * dt) * _accel(state.forces, sys_.masses)
    sys_ = sys_.replace(positions=sys_.positions + dt * v)
    neighbors = rebuild_fn(sys_, state.neighbors)
    out = _evaluate(force_fn, sys_, neighbors)
    v = v + (0.5 * dt) * _accel(out["forces"], sys_.masses)
    v, xi, xi_int = thermo_half(v, xi, xi_int)
    return _advance(state, sys_.replace(velocities=v), neighbors, out,
                    thermostat={"xi": xi, "xi_int": xi_int})


def npt_berendsen_step(state: MDState, force_fn, rebuild_fn, dt: float, temp_K: float,
                       tdamp: float, press_bar: float, pdamp: float,
                       bulk_modulus_bar: float = 1.0e6) -> MDState:
    """Berendsen NPT: Nosé-Hoover on the temperature, then an isotropic
    Berendsen rescale of cell and positions toward the target pressure."""
    st = nose_hoover_step(state, force_fn, rebuild_fn, dt, temp_K, tdamp)
    sys_ = st.system
    p_now = torch.trace(pressure_tensor(sys_, st.virial)) / 3.0
    eta = (1.0 - dt / pdamp * (press_bar - p_now) / bulk_modulus_bar) ** (1.0 / 3.0)
    return dataclasses.replace(
        st, system=sys_.replace(positions=sys_.positions * eta, cell=sys_.cell * eta))


def npt_mtk_step(state: MDState, force_fn, rebuild_fn, dt: float, temp_K: float,
                 tdamp: float, press_bar: float, pdamp: float) -> MDState:
    """Isotropic Nosé-Hoover/MTK NPT (Martyna-Tobias-Klein with the
    Tuckerman velocity-Verlet split, one thermostat chain).  The thermostat
    velocity ``xi`` and the barostat strain rate ``eta`` live in
    ``state.thermostat``; the cell scales by exp(eta dt) per step.  The
    first half-step reads the cell before the drift, the second the cell
    after it, as in the JAX package."""
    sys_ = state.system
    m = sys_.masses
    mask = sys_.valid_mask()
    n_dof = _n_dof(sys_)
    kT = Units.kB * temp_K
    q = n_dof * kT * tdamp**2
    w = (n_dof + 3.0) * kT * pdamp**2
    p_ext = press_bar / Units.nktv2p  # bar -> eV/A^3
    xi, eta, xi_int = _scalar(state, "xi"), _scalar(state, "eta"), _scalar(state, "xi_int")
    dt2, dt4 = 0.5 * dt, 0.25 * dt

    def baro_thermo_half(v, xi, eta, xi_int, virial, cell):
        # barostat force G_eta = [3 V (P_int - P_ext) + (3 / N_f) 2 KE] / W
        vol = torch.abs(det3x3(cell))
        ke2 = _ke2(m, mask, v)
        p_int = (ke2 / 3.0 + torch.trace(virial) / 3.0) / vol  # eV/A^3
        eta = eta + dt4 * ((3.0 * vol * (p_int - p_ext) + 3.0 * ke2 / n_dof) / w)
        # the thermostat couples the particles and the barostat
        xi = xi + dt4 * ((ke2 + w * eta * eta - (n_dof + 1.0) * kT) / q)
        eta = eta * torch.exp(-dt4 * xi)
        v = v * torch.exp(-dt2 * (xi + (1.0 + 3.0 / n_dof) * eta))
        xi_int = xi_int + dt2 * xi
        eta = eta * torch.exp(-dt4 * xi)
        xi = xi + dt4 * ((_ke2(m, mask, v) + w * eta * eta - (n_dof + 1.0) * kT) / q)
        vol = torch.abs(det3x3(cell))
        ke2 = _ke2(m, mask, v)
        p_int = (ke2 / 3.0 + torch.trace(virial) / 3.0) / vol
        eta = eta + dt4 * ((3.0 * vol * (p_int - p_ext) + 3.0 * ke2 / n_dof) / w)
        return v, xi, eta, xi_int

    v, xi, eta, xi_int = baro_thermo_half(sys_.velocities, xi, eta, xi_int, state.virial,
                                          sys_.cell)
    v = v + dt2 * _accel(state.forces, m)
    # drift with the isotropic cell scaling: r' = e^{dt eta} r + dt v e^{dt eta / 2} sinh(x) / x
    x_ = dt2 * eta
    sinhx = 1.0 + (x_ * x_) / 6.0 + (x_**4) / 120.0
    scale = torch.exp(dt * eta)
    sys_ = sys_.replace(positions=sys_.positions * scale + dt * v * torch.exp(x_) * sinhx,
                        cell=sys_.cell * scale)
    neighbors = rebuild_fn(sys_, state.neighbors)
    out = _evaluate(force_fn, sys_, neighbors)
    v = v + dt2 * _accel(out["forces"], m)
    v, xi, eta, xi_int = baro_thermo_half(v, xi, eta, xi_int, out["virial"], sys_.cell)
    return _advance(state, sys_.replace(velocities=v * mask[:, None]), neighbors, out,
                    thermostat={"xi": xi, "eta": eta, "xi_int": xi_int})


_INTEGRATORS: dict[str, Callable] = {
    "nve": nve_step,
    "langevin": langevin_step,
    "nvt": nose_hoover_step,
    "npt": npt_mtk_step,
    "npt_berendsen": npt_berendsen_step,
}
# the thermostat scalars each integrator carries, created up front
_THERMOSTAT = {"nvt": ("xi", "xi_int"), "npt": ("xi", "xi_int", "eta"),
               "npt_berendsen": ("xi", "xi_int")}


def _takes_system(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "system" or p.kind is inspect.Parameter.VAR_KEYWORD for p in params)


class Simulation:
    """MD driver: ``force_fn(system, neighbors) -> ModelOutputs``,
    ``rebuild_fn(system, prev) -> NeighborData``.  ``integrator`` is a key
    of ``_INTEGRATORS``, and its parameters (``temp_K``, ``damp``,
    ``tdamp``, ``press_bar``, ``pdamp``, ``bulk_modulus_bar``) come as
    keywords; ``seed`` seeds the noise generator.  With ``grow_fn``
    (``engine.grow``; it is given the current system when it takes one) a
    capacity overflow regrows and re-runs the chunk; without it the
    overflow raises (the chunk's results are invalid).  With ``shrink_fn``
    (``engine.maybe_shrink``) the capacity may shrink every
    ``shrink_every`` chunks.  With ``migrate_fn``
    (``HaloShardedAllegroEngine.maybe_migrate``) the atoms may be re-sorted
    into new slabs at a chunk boundary, and an overflowed chunk is first
    re-run after a re-sort (at most ``MAX_MIGRATE_RETRIES`` times a chunk),
    since drift past the halo's margin raises the same flag; ``atom_perm``
    maps the current atom order to the original one."""

    MAX_CHUNK = 2000
    # re-sorts of one chunk before its overflow is taken for capacity
    MAX_MIGRATE_RETRIES = 8

    def __init__(self, system: System, force_fn, rebuild_fn, dt: float = 1.0e-3,
                 integrator: str = "nve", seed: int = 0,
                 grow_fn: Callable[..., Callable] | None = None,
                 shrink_fn: Callable[..., Callable | None] | None = None,
                 shrink_every: int = 10,
                 migrate_fn: Callable[..., tuple] | None = None, **integrator_kwargs):
        if integrator not in _INTEGRATORS:
            raise ValueError(f"integrator {integrator!r} is not one of {sorted(_INTEGRATORS)}")
        self.force_fn = force_fn
        self.rebuild_fn = rebuild_fn
        self.dt = float(dt)
        self.integrator = integrator
        self.integrator_kwargs = integrator_kwargs
        self.grow_fn = grow_fn
        # atom re-assignment to slabs (HaloShardedAllegroEngine.maybe_migrate),
        # called with the current system at every chunk boundary; atom_perm
        # composes its permutations: CURRENT index -> ORIGINAL (None: identity)
        self.migrate_fn = migrate_fn
        self.atom_perm: np.ndarray | None = None
        self.migrations = 0
        self.shrink_fn = shrink_fn
        self.shrink_every = max(1, int(shrink_every))
        self._chunks_since_shrink = 0
        self.regrows = 0
        self.shrinks = 0
        neighbors = rebuild_fn(system, None)
        dtype, dev = system.positions.dtype, system.device
        self.state = MDState(
            system=system, neighbors=neighbors, step=0, overflow=neighbors.overflow,
            generator=torch.Generator(device=dev).manual_seed(seed),
            thermostat={k: torch.zeros((), dtype=dtype, device=dev)
                        for k in _THERMOSTAT.get(integrator, ())},
            **_evaluate(force_fn, system, neighbors),
        )

    def init_velocities(self, temp_K: float, seed: int = 1):
        sys_ = self.state.system
        gen = torch.Generator(device=sys_.device).manual_seed(seed)
        v = create_velocities(sys_.masses, temp_K, gen, valid=sys_.valid_mask())
        self.state = dataclasses.replace(self.state, system=sys_.replace(velocities=v))

    def _step_fn(self):
        return functools.partial(_INTEGRATORS[self.integrator], force_fn=self.force_fn,
                                 rebuild_fn=self.rebuild_fn, dt=self.dt,
                                 **self.integrator_kwargs)

    def _rebind(self, state: MDState, rebuild_fn) -> MDState:
        """``state`` with neighbors built by ``rebuild_fn`` (now this
        run's) and the outputs evaluated on them."""
        self.rebuild_fn = rebuild_fn
        neighbors = rebuild_fn(state.system, None)
        return dataclasses.replace(state, neighbors=neighbors, overflow=neighbors.overflow,
                                   **_evaluate(self.force_fn, state.system, neighbors))

    def _regrow(self, backup: MDState) -> None:
        """Grow capacities (re-estimated from the current geometry when
        ``grow_fn`` takes a system) and rebuild the state from ``backup``."""
        grow = (functools.partial(self.grow_fn, system=backup.system)
                if _takes_system(self.grow_fn) else self.grow_fn)
        self.regrows += 1
        self.state = self._rebind(backup, grow())

    def _apply_migration(self, base: MDState) -> bool:
        """Adopt ``migrate_fn``'s re-sorted system, if it proposes one, in
        ``base``: neighbors and outputs rebuilt, ``atom_perm`` composed; the
        step, thermostat scalars and noise generator carry over (the
        re-sort is a relabeling and a wrap, under which the dynamics are
        the same).  Returns whether it migrated."""
        new_sys, perm, new_rebuild = self.migrate_fn(system=base.system)
        if new_sys is None:
            return False
        self.migrations += 1
        if new_rebuild is not None:  # more halo hops: a new exchange pattern
            self.rebuild_fn = new_rebuild
        self.state = self._rebind(dataclasses.replace(base, system=new_sys), self.rebuild_fn)
        if perm is not None:
            perm = np.asarray(perm)
            self.atom_perm = self.atom_perm[perm] if self.atom_perm is not None else perm
        return True

    def _maybe_shrink(self) -> None:
        """Adopt a smaller capacity mid-run: no work was lost, so the state
        stays and only its neighbors and (edge-shaped) outputs are rebuilt."""
        new_rebuild = self.shrink_fn(system=self.state.system)
        if new_rebuild is not None:
            self.shrinks += 1
            self.state = self._rebind(self.state, new_rebuild)

    def run(self, n_steps: int, log_every: int = 100, callback=None) -> list[dict]:
        """Run n_steps; returns one thermo row per chunk of ``log_every``."""
        log_every = max(1, min(log_every, n_steps, self.MAX_CHUNK))
        rows = []
        done = 0
        migrate_retries = 0
        while done < n_steps:
            n_sub = min(log_every, n_steps - done)
            backup = self.state
            rng_backup = backup.generator.get_state()
            step = self._step_fn()
            state = dataclasses.replace(backup, overflow=backup.neighbors.overflow)
            for _ in range(n_sub):
                with tracing.span("md.step"):
                    state = step(state)
            self.state = state
            with tracing.span("md.chunk_end"):
                row = thermo_row(state)
                if row["overflow"]:
                    # drift past the halo's margin raises the flag too: re-sort
                    # first; a second overflow of the re-run chunk is capacity
                    if self.migrate_fn is not None:
                        backup.generator.set_state(rng_backup)
                        if self._apply_migration(backup):
                            migrate_retries += 1
                            if migrate_retries > self.MAX_MIGRATE_RETRIES:
                                raise RuntimeError(
                                    "atom drift exceeds the halo coverage margin "
                                    f"within a single {n_sub}-step chunk even after "
                                    f"{self.MAX_MIGRATE_RETRIES} re-sorts — use a shorter "
                                    "log_every/chunk, more halo hops, or a larger skin"
                                )
                            continue
                    if self.grow_fn is None:
                        raise RuntimeError(
                            "neighbor capacity overflow during chunk: pass grow_fn "
                            "(results in this chunk are invalid)"
                        )
                    backup.generator.set_state(rng_backup)
                    self._regrow(backup)
                    continue
                rows.append(row)
                if callback is not None:
                    callback(self.state, row)
                done += n_sub
                migrate_retries = 0  # the cap is per chunk
                if self.migrate_fn is not None:
                    # re-sort at half the margin, before the guard trips
                    self._apply_migration(self.state)
                if self.shrink_fn is not None:
                    self._chunks_since_shrink += 1
                    if self._chunks_since_shrink >= self.shrink_every:
                        self._chunks_since_shrink = 0
                        self._maybe_shrink()
        return rows
