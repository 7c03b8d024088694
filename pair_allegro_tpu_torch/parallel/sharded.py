"""Sharded Allegro and NequIP evaluation over a device mesh, positions
replicated (counterpart of ``pair_allegro_tpu/parallel/sharded.py``).

The upstream pair style scales by LAMMPS MPI domain decomposition: each
rank owns a subdomain's atoms, receives ghost copies of its neighbors'
boundary atoms and reverse-communicates their forces
(``pair_nequip_allegro.cpp:86-89, 149, 368-377``).  Here positions stay
REPLICATED (every shard's device holds all N) and the WORK is sharded:
shard s owns the contiguous window [s * n_local, (s + 1) * n_local) of
spatially sorted atoms, builds the neighbor table of its centers only, and
evaluates the strictly local Allegro energy of those centers
(``allegro_energy(center_offset=, num_centers=)``).

* ghost-position forward comm: the positions moved to each shard's device
  (nothing at all where shards share a device);
* ghost-force reverse comm: autograd of those moves; the one positions
  tensor feeds every shard, so the per-shard force contributions sum by
  themselves (the reference's ``comm->reverse_comm``);
* extensive reductions: each shard's value moved to the home device and
  summed (``compute allegro``'s MPI_Allreduce, ``compute_allegro.cpp:127``).

The virial's strain is applied once, to the replicated positions and cell,
before they reach the shards (``potential.make_potential``), so it reaches
every shard's edge vectors.  With ``row_chunk`` each shard runs its rows in
windows of that many centers, each under a checkpoint (the million-atom
mode within a shard, ``engine._make_chunked_energy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pair_allegro_tpu_torch import native, tracing
from pair_allegro_tpu_torch.engine import (
    _estimate_capacities,
    _make_chunked_energy,
    _resolve_remat,
    grow_spec,
    reestimate_spec,
    skin_checked,
)
from pair_allegro_tpu_torch.io.dump import host
from pair_allegro_tpu_torch.models.allegro import allegro_energy
from pair_allegro_tpu_torch.models.nequip import nequip_energy
from pair_allegro_tpu_torch.neighbors.device import (
    NeighborData,
    build_cell_bins,
    cell_list_neighbors,
    dense_neighbors,
)
from pair_allegro_tpu_torch.parallel.mesh import ATOM_AXIS, Mesh
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import System
from pair_allegro_tpu_torch.tree import leaves, tree_map


def spatial_sort(positions: np.ndarray, cell: np.ndarray, pbc, n_bins: int = 8) -> np.ndarray:
    """Host-side permutation ordering atoms by spatial bin (z-major slabs),
    so that contiguous index windows are compact in space and the shards'
    edge counts stay balanced.  The keys come from the C++ host runtime
    (``native.spatial_keys``) or, without it, from numpy."""
    pos = np.asarray(positions, np.float64)
    periodic = cell is not None and any(pbc) and abs(np.linalg.det(cell)) > 1e-12
    key = native.spatial_keys(pos, cell if periodic else None, n_bins)
    if key is None:
        if periodic:
            frac = pos @ np.linalg.inv(np.asarray(cell, np.float64))
            frac -= np.floor(frac)
        else:
            lo, hi = pos.min(0), pos.max(0)
            frac = (pos - lo) / np.maximum(hi - lo, 1e-12)
        b = np.clip((frac * n_bins).astype(np.int64), 0, n_bins - 1)
        key = (b[:, 2] * n_bins + b[:, 1]) * n_bins + b[:, 0]
    return np.argsort(key, kind="stable")


def sorted_system(system: System, perm: np.ndarray, n_shards: int, positions=None) -> System:
    """``system``'s atoms in the order ``perm`` (NEW index -> ORIGINAL),
    padded with masked atoms to a multiple of ``n_shards``, on the
    system's device (``positions``, when given, replaces the positions)."""
    pos = host(system.positions).astype(np.float64) if positions is None else positions
    n = pos.shape[0]
    pad_to = int(np.ceil(n / n_shards) * n_shards)
    out = System.create(
        pos[perm],
        host(system.types)[perm],
        cell=host(system.cell).astype(np.float64),
        velocities=host(system.velocities).astype(np.float64)[perm],
        masses=host(system.masses).astype(np.float64)[perm],
        pbc=system.pbc,
        dtype=system.positions.dtype,
        device=system.device,
        pad_to=pad_to,
    )
    if system.valid is not None:
        valid = np.concatenate([host(system.valid)[perm], np.zeros(pad_to - n, bool)])
        out = out.replace(valid=torch.as_tensor(valid, device=system.device))
    return out


@dataclasses.dataclass
class ShardedNeighbors:
    """The sharded engines' neighbor data: shard s's arrays on
    ``mesh.devices[s]`` (TABLE rows of its centers, or its FLAT (2, E_local)
    list with global i and j; ext-frame j in the halo engine), the ORed
    overflow flag and the skin's reference positions on the home device."""

    edge_index: tuple
    edge_shifts: tuple
    edge_mask: tuple
    overflow: torch.Tensor
    ref_positions: torch.Tensor | None = None

    def count(self):
        home = self.overflow.device
        return sum(m.sum().to(home) for m in self.edge_mask)

    def gathered(self) -> NeighborData:
        """The shards' arrays joined on the home device: an (N, K) table
        (rows in shard order) or one FLAT list."""
        home = self.overflow.device
        dim = 1 if self.edge_mask[0].dim() == 1 else 0  # FLAT (2, E) lists join on E
        return NeighborData(
            edge_index=torch.cat([a.to(home) for a in self.edge_index], dim),
            edge_shifts=torch.cat([a.to(home) for a in self.edge_shifts]),
            edge_mask=torch.cat([a.to(home) for a in self.edge_mask]),
            overflow=self.overflow,
            ref_positions=self.ref_positions,
        )


def any_of(flags, home) -> torch.Tensor:
    """The shards' () bool flags ORed on the home device."""
    return torch.stack([f.to(home) for f in flags]).any()


def params_on(params, devices) -> list:
    """One parameter tree per device: the tree itself on the device that
    holds it, a copy made once elsewhere (the kernels' weight layouts are
    cached per leaf, so each device keeps its own copy)."""
    copies = {}
    for dev in devices:
        if dev not in copies:
            here = all(t.device == dev for t in leaves(params))
            copies[dev] = params if here else tree_map(lambda t, d=dev: t.to(d), params)
    return [copies[dev] for dev in devices]


class ShardedAllegroEngine:
    """Allegro bound to a device mesh, with the ``force_fn`` / ``rebuild_fn``
    / ``grow`` interface of ``engine.AllegroEngine``, so ``Simulation`` runs
    it unchanged.

    Requires ``system.n_atoms`` divisible by the mesh size and atoms
    spatially sorted for load balance (both done by :meth:`prepare_system`)
    and the system on the mesh's home device.  ``row_chunk`` (cell-list
    strategy only, a divisor of n_local) runs each shard in windows."""

    def __init__(self, cfg, params, system: System, mesh: Mesh, axis: str = ATOM_AXIS,
                 skin: float = 0.0, capacity_factor: float = 1.25,
                 compute_virial: bool = True, shard_balance_slack: float = 1.5,
                 row_chunk: int | None = None):
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.compute_virial = compute_virial
        self.skin = skin
        self.n_shards = mesh.shape[axis]
        if system.device != mesh.home:
            raise ValueError(f"system lives on {system.device}, the mesh's home device is "
                             f"{mesh.home}")
        n = system.n_atoms
        if n % self.n_shards:
            raise ValueError(
                f"n_atoms={n} not divisible by mesh axis '{axis}'={self.n_shards}; "
                "pad with ShardedAllegroEngine.prepare_system"
            )
        self.n_local = n // self.n_shards
        self.spec = _estimate_capacities(system, cfg.r_max, skin, capacity_factor)
        self.cfg = cfg = _resolve_remat(cfg, self.spec, n)
        if row_chunk:
            if self.spec.strategy != "cell_list":
                raise ValueError("row_chunk requires the cell-list (table) strategy")
            if self.n_local % row_chunk:
                raise ValueError(f"n_local={self.n_local} not divisible by row_chunk={row_chunk}")
        self.row_chunk = row_chunk or None
        # per-shard flat-edge capacity of the dense strategy (the cell list
        # is per-atom K shaped and needs no balancing slack)
        self._dense_cap_local = (
            int(np.ceil(self.spec.max_edges / self.n_shards * shard_balance_slack / 128.0)) * 128
            + 128
        )
        self._params = params_on(params, mesh.devices)
        self.rebuild_fn = self._make_rebuild()
        self._potential = make_potential(self._sharded_energy)

    @staticmethod
    def prepare_system(system: System, n_shards: int, n_bins: int = 8):
        """Spatially sort and pad a System for an ``n_shards`` mesh.

        Returns (system, perm) where perm maps NEW index -> ORIGINAL index
        (outputs like forces are in the new order: forces_orig =
        forces_new[inverse_permutation(perm)])."""
        perm = spatial_sort(host(system.positions), host(system.cell).astype(np.float64),
                            system.pbc, n_bins)
        return sorted_system(system, perm, n_shards), perm

    def _make_rebuild(self):
        spec, nl, rc = self.spec, self.n_local, self.row_chunk
        table = spec.strategy == "cell_list"
        devices = self.mesh.devices

        def build(system: System) -> ShardedNeighbors:
            home = system.device
            on_dev = {}  # one copy of the replicated inputs (and bins) per device
            parts = []
            for s, dev in enumerate(devices):
                if dev not in on_dev:
                    pos, cell = system.positions.to(dev), system.cell.to(dev)
                    mask = system.valid_mask().to(dev)
                    bins = build_cell_bins(pos, cell, spec.cutoff, spec.grid, spec.cell_capacity,
                                           mask) if table else None
                    on_dev[dev] = (pos, cell, mask, bins)
                pos, cell, mask, bins = on_dev[dev]
                q0 = s * nl
                if table:
                    windows = [
                        cell_list_neighbors(pos, cell, spec.cutoff, spec.grid, spec.cell_capacity,
                                            spec.max_neighbors, atom_mask=mask, query_start=w0,
                                            n_query=rc or nl, bins_data=bins)
                        for w0 in range(q0, q0 + nl, rc or nl)
                    ]
                    nd = windows[0] if len(windows) == 1 else NeighborData(
                        edge_index=torch.cat([w.edge_index for w in windows]),
                        edge_shifts=torch.cat([w.edge_shifts for w in windows]),
                        edge_mask=torch.cat([w.edge_mask for w in windows]),
                        overflow=torch.stack([w.overflow for w in windows]).any(),
                    )
                else:
                    nd = dense_neighbors(pos, cell, spec.shifts_table, spec.cutoff,
                                         self._dense_cap_local, atom_mask=mask, query_start=q0,
                                         n_query=nl, pbc=system.pbc)
                parts.append(nd)
            return ShardedNeighbors(
                edge_index=tuple(p.edge_index for p in parts),
                edge_shifts=tuple(p.edge_shifts for p in parts),
                edge_mask=tuple(p.edge_mask for p in parts),
                overflow=any_of([p.overflow for p in parts], home),
                ref_positions=system.positions.clone() if self.skin > 0.0 else None,
            )

        return skin_checked(build, self.skin)

    def _local_energy(self, s: int):
        """Shard s's energy function over its n_local center rows."""
        if self.row_chunk:
            return _make_chunked_energy(allegro_energy, self._params[s], self.cfg, self.row_chunk)
        params, cfg, nl = self._params[s], self.cfg, self.n_local

        def local(positions, types, edge_index, **kw):
            return allegro_energy(params, cfg, positions, types, edge_index, num_centers=nl, **kw)

        return local

    def _sharded_energy(self, positions, types, edge_index, *, cell=None, edge_shifts=None,
                        atom_mask=None, edge_mask=None):
        home, nl = positions.device, self.n_local
        am = (torch.ones(positions.shape[0], dtype=torch.bool, device=home)
              if atom_mask is None else atom_mask)
        outs = []
        for s, dev in enumerate(self.mesh.devices):
            c0 = s * nl
            outs.append(self._local_energy(s)(
                positions.to(dev), types.to(dev), edge_index[s],
                cell=None if cell is None else cell.to(dev),
                edge_shifts=None if edge_shifts is None else edge_shifts[s],
                atom_mask=am[c0:c0 + nl].to(dev), edge_mask=edge_mask[s], center_offset=c0,
            ))
        return gather_outputs(outs, home, allegro_energy.per_center_outputs)

    def force_fn(self, system: System, neighbors: ShardedNeighbors):
        return self._potential(
            system.positions,
            system.types,
            neighbors.edge_index,
            cell=system.cell,
            edge_shifts=neighbors.edge_shifts,
            atom_mask=system.valid_mask(),
            edge_mask=neighbors.edge_mask,
            compute_virial=self.compute_virial,
        )

    def grow(self, factor: float = 1.5, system: System | None = None):
        """Regrow capacities (re-estimated from ``system`` when given) and
        return the new rebuild_fn."""
        self.spec = (reestimate_spec(self.spec, system, factor) if system is not None
                     else grow_spec(self.spec, factor))
        self._dense_cap_local = int(self._dense_cap_local * factor) + 128
        self.rebuild_fn = self._make_rebuild()
        return self.rebuild_fn


def gather_outputs(outs: list, home, per_center) -> dict:
    """The shards' model outputs joined on the home device: the per-center
    outputs (``per_center``) concatenated in shard order, every other one
    (the total energy, a dipole) summed, as JAX splits its extras
    (``sharded.py:311-345``)."""
    res = {}
    with tracing.span("halo.gather"):
        for key in outs[0]:
            vals = [o[key].to(home) for o in outs]
            res[key] = torch.cat(vals) if key in per_center else torch.stack(vals).sum(0)
    return res


class ShardedNequIPEngine(ShardedAllegroEngine):
    """Multi-device NequIP, which the upstream pair style refuses on more
    than one MPI rank (``pair_nequip_allegro.cpp:86-89``: one ghost exchange
    cannot carry num_layers hops of messages).  Positions and node features
    are replicated; each shard computes the messages and update of its node
    window, and every layer's windows are gathered back to all shards
    (``nequip_energy(mesh=)``), so the result is the single-device model's.
    It runs the plain message path, as in JAX, and needs the cell-list
    strategy."""

    def __init__(self, cfg, params, system: System, mesh: Mesh, **kw):
        if kw.get("row_chunk"):
            raise ValueError(
                "row_chunk requires strict locality; NequIP message passing "
                "propagates num_layers hops"
            )
        super().__init__(cfg, params, system, mesh, **kw)
        if self.spec.strategy != "cell_list":
            raise ValueError(
                "sharded NequIP needs the cell-list (table) strategy; this "
                "system resolved to dense — run the single-device NequIPEngine"
            )

    def _sharded_energy(self, positions, types, edge_index, *, cell=None, edge_shifts=None,
                        atom_mask=None, edge_mask=None):
        return nequip_energy(self.params, self.cfg, positions, types, edge_index, cell=cell,
                             edge_shifts=edge_shifts, atom_mask=atom_mask, edge_mask=edge_mask,
                             mesh=self.mesh, mesh_params=self._params)
