"""Halo-sharded Allegro: positions sharded over the mesh as z-slabs, ghost
atoms exchanged between neighbor slabs (counterpart of
``pair_allegro_tpu/parallel/halo.py``), the translation of LAMMPS spatial
domain decomposition and its ghost-atom contract
(``pair_nequip_allegro.cpp:368-377``).

* The box is cut into **z-slabs** of equal atom count (atoms sorted by the
  coordinate along the normal of the (a0, a1) plane, :meth:`prepare_system`);
  shard s OWNS the index window [s * n_local, (s + 1) * n_local), and its
  arrays are O(n_local * (2h + 1)), not O(N).
* **Forward ghost comm**: shard r receives the position blocks of its ``h``
  neighbor slabs on each side (``h`` the least count whose slabs span
  cutoff + skin, fixed at construction), each moved to its device and
  shifted by ``k * cell[2]`` when the hop wraps the box: the extended frame
  [own, hop +1, hop -1, +2, -2, ...] of ``n_ext = (2h + 1) n_local`` rows.
* Edges are built **locally** over that frame
  (``neighbors.device.halo_cell_list_neighbors``): x and y periodic by
  minimum image, z open; j indices are ext-frame rows.
* **Reverse ghost-force comm comes from autograd**: the exchange runs inside
  the differentiated energy, so the halo copies' force contributions flow
  back to their owners (LAMMPS ``comm->reverse_comm`` under ``newton on``,
  ``pair_nequip_allegro.cpp:149``).  The z shift is computed from the
  strained cell inside the energy, so the virial sees the halo images move
  with the box.
* Extensive outputs are summed over the shards (MPI_Allreduce).
* **Atom migration**: LAMMPS re-assigns atoms to subdomains at every
  reneighboring; here the windows are fixed between chunk boundaries, where
  :meth:`maybe_migrate` re-wraps and re-sorts once drift has eaten half of
  the coverage margin (``Simulation(migrate_fn=)``); within a chunk a drift
  past the margin flags the neighbor data as overflowed, never a silently
  wrong halo.

Use the replicated ``ShardedAllegroEngine`` when slabs would be thinner than
the cutoff (it is also faster there).
"""

from __future__ import annotations

import types as _types

import numpy as np
import torch

from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.engine import _resolve_remat, _round_k, skin_checked
from pair_allegro_tpu_torch.io.dump import host
from pair_allegro_tpu_torch.models.allegro import allegro_energy
from pair_allegro_tpu_torch.neighbors.device import halo_cell_list_neighbors
from pair_allegro_tpu_torch.neighbors.naive import host_neighbor_stats
from pair_allegro_tpu_torch.parallel.mesh import ATOM_AXIS, Mesh
from pair_allegro_tpu_torch.parallel.sharded import (
    ShardedAllegroEngine,
    ShardedNeighbors,
    any_of,
    gather_outputs,
    params_on,
    sorted_system,
)
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import System


def _plane_heights(cell: np.ndarray) -> np.ndarray:
    vol = abs(np.linalg.det(cell))
    out = []
    for a in range(3):
        cross = np.cross(cell[(a + 1) % 3], cell[(a + 2) % 3])
        out.append(vol / np.linalg.norm(cross))
    return np.asarray(out)


def _z_normal_coord(positions: np.ndarray, cell: np.ndarray) -> np.ndarray:
    """Each atom's coordinate along the normal of the (a0, a1) plane, the
    coordinate the slabs are cut along."""
    n = np.cross(cell[0], cell[1])
    return positions @ (n / np.linalg.norm(n))


def _slab_edges(positions: np.ndarray, cell: np.ndarray, n_shards: int):
    """(edges, hz): edges[s] = the lower boundary of slab s along the slab
    normal (quantiles of the sorted, box-wrapped coordinate); n_shards + 1
    entries with edges[S] = edges[0] + hz (the periodic wrap)."""
    z = _z_normal_coord(np.asarray(positions, np.float64), cell)
    hz = float(_plane_heights(cell)[2])
    z = np.sort(z - hz * np.floor(z / hz))
    n = z.shape[0]
    edges = [float(z[(s * n) // n_shards]) for s in range(n_shards)]
    edges.append(edges[0] + hz)
    return np.asarray(edges), hz


def slab_coverage(edges: np.ndarray, hz: float, n_shards: int, h: int) -> float:
    """The least span, over shards and both directions, of the h halo slabs
    beyond a shard's boundary along the slab normal (the ghost region's
    thickness)."""
    cov = np.inf
    for s in range(n_shards):
        j = s - h
        bottom = edges[j % n_shards] + hz * (j // n_shards)
        j2 = s + h
        top = edges[(j2 % n_shards) + 1] + hz * (j2 // n_shards)
        cov = min(cov, edges[s] - bottom, top - edges[s + 1])
    return float(cov)


def required_hops(positions: np.ndarray, cell: np.ndarray, n_shards: int, rc: float) -> int:
    """The least h such that every shard's h slabs on each side span at
    least ``rc`` along the slab normal; ``n_shards`` when none does (the
    caller raises: 2h + 1 > n_shards)."""
    edges, hz = _slab_edges(positions, cell, n_shards)
    for h in range(1, (n_shards - 1) // 2 + 1):
        if slab_coverage(edges, hz, n_shards, h) >= rc:
            return h
    return n_shards


def _drift(system: System, pos0: torch.Tensor) -> float:
    """The largest displacement of a valid atom from ``pos0`` (host)."""
    pos = host(system.positions).astype(np.float64)
    mask = host(system.valid_mask())
    d2 = np.sum((pos - host(pos0).astype(np.float64)) ** 2, -1)[mask]
    return float(np.sqrt(np.max(d2, initial=0.0)))


class HaloShardedAllegroEngine:
    """Allegro with positions sharded over a 1-D mesh and halo exchange, with
    the ``force_fn`` / ``rebuild_fn`` / ``grow`` interface of
    ``AllegroEngine``.  Takes a system prepared by :meth:`prepare_system`
    (wrapped, z-sorted, padded to a multiple of the mesh) on the mesh's
    home device, with full PBC."""

    def __init__(self, cfg, params, system: System, mesh: Mesh, axis: str = ATOM_AXIS,
                 skin: float = 0.0, capacity_factor: float = 1.25, compute_virial: bool = True,
                 row_chunk: int | None = None, hops: int | None = None):
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.skin = skin
        self.compute_virial = compute_virial
        self.n_shards = s = mesh.shape[axis]
        if system.device != mesh.home:
            raise ValueError(f"system lives on {system.device}, the mesh's home device is "
                             f"{mesh.home}")
        n = system.n_atoms
        if n % s:
            raise ValueError(
                f"n_atoms={n} not divisible by mesh axis '{axis}'={s}; "
                "use HaloShardedAllegroEngine.prepare_system"
            )
        self.n_local = n // s
        self.rc = rc = cfg.r_max + skin
        pos = host(system.positions).astype(np.float64)
        cell = host(system.cell).astype(np.float64)
        if not all(system.pbc):
            raise ValueError("halo sharding requires full PBC (z-slab wrap)")
        mask = host(system.valid_mask())
        self.hops = h = hops if hops is not None else required_hops(pos[mask], cell, s, rc)
        if 2 * h + 1 > s:
            raise ValueError(
                f"slabs thinner than the cutoff: need {h} hops per side with "
                f"{s} shards (2h+1 > n_shards) — halo copies would duplicate "
                "atoms; use the replicated ShardedAllegroEngine for this size"
            )
        # the ghost region's thickness at h hops from the initial slabs; the
        # build flags the data once drift eats the (cov_min - rc) margin
        edges, hz = _slab_edges(pos[mask], cell, s)
        self.cov_min = slab_coverage(edges, hz, s, h)
        if self.cov_min < rc:
            raise ValueError(
                f"halo coverage {self.cov_min:.3f} < cutoff+skin {rc:.3f} "
                f"at h={h}; pass hops= larger"
            )
        self._pos0 = system.positions.clone()
        # whether a build since the decomposition was last refreshed found
        # the drift past the margin (a device flag, read only by grow)
        self._drifted = torch.zeros((), dtype=torch.bool, device=system.device)
        self._set_hops(h)

        heights = _plane_heights(cell)
        gx, gy = int(heights[0] // rc), int(heights[1] // rc)
        if min(gx, gy) < 3:
            raise ValueError(
                "cell supports < 3 bins along a periodic axis at this cutoff; "
                "use the replicated engine (dense strategy) for small boxes"
            )
        self.grid_xy = (gx, gy)
        z_extent = (2 * h + 1) / s * heights[2]
        self.gz_cap = max(int(np.ceil(z_extent / rc)) + 2, 3)
        n_edges, max_count = host_neighbor_stats(pos[mask], cell, system.pbc, rc)
        k_max = int(np.ceil(n_edges / max(mask.sum(), 1) * capacity_factor)) + 8
        k_max = max(k_max, int(max_count * capacity_factor) + 2)
        self.max_neighbors = _round_k(k_max)
        per_bin = mask.sum() / (gx * gy * (heights[2] / rc))  # atoms per rc^3 bin
        self.cell_capacity = int(np.ceil(per_bin * capacity_factor * 2.0)) + 8
        if row_chunk and self.n_local % row_chunk:
            raise ValueError(f"n_local={self.n_local} not divisible by row_chunk={row_chunk}")
        self.row_chunk = row_chunk or None
        # the engines' spec view ("cell_list": the edges are per-atom K
        # table shaped) for _resolve_remat and introspection
        self.spec = _types.SimpleNamespace(strategy="cell_list", max_neighbors=self.max_neighbors,
                                           cutoff=rc)
        self.cfg = _resolve_remat(cfg, self.spec, n)
        self._params = params_on(params, mesh.devices)
        self.rebuild_fn = self._make_rebuild()
        self._potential = make_potential(self._sharded_energy)

    def _set_hops(self, h: int) -> None:
        self.hops = h
        self.n_ext = (2 * h + 1) * self.n_local
        # the hop order of the extended frame: [0, +1, -1, +2, -2, ...]
        self.hop_offsets = [0] + [sgn * d for d in range(1, h + 1) for sgn in (+1, -1)]

    @staticmethod
    def prepare_system(system: System, n_shards: int):
        """Wrap positions into the canonical box, sort atoms by their
        coordinate along the slab normal and pad to a multiple of the mesh.
        Returns (system, perm), perm mapping NEW -> ORIGINAL index.

        The wrap matters: the halo build treats z as OPEN, so every atom
        must start inside its slab's range.  MD never wraps afterwards; the
        drift guard bounds how far atoms may stray before a re-sort."""
        pos = host(system.positions).astype(np.float64)
        cell = host(system.cell).astype(np.float64)
        frac = pos @ np.linalg.inv(cell)
        pos = (frac - np.floor(frac)) @ cell
        perm = np.argsort(_z_normal_coord(pos, cell), kind="stable")
        return sorted_system(system, perm, n_shards, positions=pos), perm

    def _halo_exchange(self, blocks, cell, r: int, dev):
        """Shard r's extended frame (n_ext, 3): its own block, then each
        hop's block moved to its device, shifted by k * cell[2] where the
        hop wraps the box.  The moves and the concatenation are
        differentiable: their reverse is the ghost-force communication."""
        s = self.n_shards
        with tracing.span("halo.exchange"):
            parts = [blocks[r].to(dev)]
            for dd in self.hop_offsets[1:]:
                recv = blocks[(r + dd) % s].to(dev)
                k = (r + dd) // s
                parts.append(recv + k * cell[2] if k else recv)
            return torch.cat(parts)

    def _ext_gather(self, arr, r: int):
        """A per-atom array (N, ...) in shard r's extended frame (n_ext, ...)."""
        s, nl = self.n_shards, self.n_local
        return torch.cat([arr[((r + dd) % s) * nl:((r + dd) % s + 1) * nl]
                          for dd in self.hop_offsets])

    def _make_rebuild(self):
        nl, rc = self.n_local, self.rc
        devices = self.mesh.devices

        def build(system: System) -> ShardedNeighbors:
            home = system.device
            blocks = system.positions.split(nl)
            valid = system.valid_mask()
            parts = []
            for r, dev in enumerate(devices):
                cell = system.cell.to(dev)
                pos_ext = self._halo_exchange(blocks, cell, r, dev)
                parts.append(halo_cell_list_neighbors(
                    pos_ext, cell, rc, self.grid_xy, self.gz_cap, self.cell_capacity,
                    self.max_neighbors, nl, ext_mask=self._ext_gather(valid, r).to(dev)))
            # shard membership is fixed between re-sorts, so the one way the
            # halo can silently miss a neighbor is drift past the margin: an
            # excluded atom is at least (cov_min - drift) - drift from any
            # center, so the data is bad once 2 * drift > cov_min - rc
            d = system.positions - self._pos0
            drift2 = torch.where(valid, torch.sum(d * d, dim=-1), 0.0).max()
            bad = 2.0 * torch.sqrt(drift2) > self.cov_min - rc
            self._drifted = self._drifted | bad
            return ShardedNeighbors(
                edge_index=tuple(p.edge_index for p in parts),
                edge_shifts=tuple(p.edge_shifts for p in parts),
                edge_mask=tuple(p.edge_mask for p in parts),
                overflow=any_of([p.overflow for p in parts], home) | bad,
                ref_positions=system.positions.clone() if self.skin > 0.0 else None,
            )

        return skin_checked(build, self.skin)

    # shard r's energy over its own rows (ext rows [0, n_local)), and the
    # potential: as the replicated engine's
    _local_energy = ShardedAllegroEngine._local_energy
    force_fn = ShardedAllegroEngine.force_fn

    def _sharded_energy(self, positions, types, edge_index, *, cell=None, edge_shifts=None,
                        atom_mask=None, edge_mask=None):
        home, nl = positions.device, self.n_local
        am = (torch.ones(positions.shape[0], dtype=torch.bool, device=home)
              if atom_mask is None else atom_mask)
        blocks = positions.split(nl)
        outs = []
        for r, dev in enumerate(self.mesh.devices):
            c = cell.to(dev)
            outs.append(self._local_energy(r)(
                self._halo_exchange(blocks, c, r, dev), self._ext_gather(types, r).to(dev),
                edge_index[r], cell=c,
                edge_shifts=None if edge_shifts is None else edge_shifts[r],
                atom_mask=am[r * nl:(r + 1) * nl].to(dev), edge_mask=edge_mask[r],
                center_offset=0,
            ))
        return gather_outputs(outs, home, allegro_energy.per_center_outputs)

    def maybe_migrate(self, system: System, threshold: float = 0.5):
        """Re-assign atoms to slabs once drift has eaten ``threshold`` of the
        coverage margin: the analog of LAMMPS re-assigning atoms to
        subdomains at reneighboring, at chunk boundaries (``Simulation``'s
        ``migrate_fn``).

        Returns (None, None, None) while drift is under the threshold; else
        the re-wrapped, re-sorted, re-padded system, the permutation NEW
        index -> OLD index over the padded arrays, and a new rebuild_fn when
        the refreshed geometry needs more hops (None otherwise).  Energies
        and forces are invariant under the wrap and covariant under the
        permutation, so the MD state carries over exactly."""
        if 2.0 * _drift(system, self._pos0) <= threshold * (self.cov_min - self.rc):
            return None, None, None
        mask = host(system.valid_mask())
        idx = np.flatnonzero(mask)
        pad_idx = np.flatnonzero(~mask)
        sub = System.create(
            host(system.positions).astype(np.float64)[idx],
            host(system.types)[idx],
            cell=host(system.cell).astype(np.float64),
            velocities=host(system.velocities).astype(np.float64)[idx],
            masses=host(system.masses).astype(np.float64)[idx],
            pbc=system.pbc,
            dtype=system.positions.dtype,
            device=system.device,
        )
        new_sys, perm_v = self.prepare_system(sub, self.n_shards)
        if new_sys.n_atoms != system.n_atoms:
            raise RuntimeError(
                f"migration changed the padded atom count "
                f"({system.n_atoms} -> {new_sys.n_atoms}); the original system "
                "was padded beyond the minimal multiple of the mesh"
            )
        perm = np.concatenate([idx[perm_v], pad_idx])

        # a changed cell or density may need more hops: that changes the
        # exchange pattern and n_ext, and so the rebuild function
        cell = host(new_sys.cell).astype(np.float64)
        new_pos = host(new_sys.positions).astype(np.float64)[: len(idx)]
        h_now = required_hops(new_pos, cell, self.n_shards, self.rc)
        topology_changed = h_now > self.hops
        if topology_changed:
            if 2 * h_now + 1 > self.n_shards:
                raise RuntimeError(
                    f"slabs thinner than the cutoff after migration: need "
                    f"{h_now} hops with {self.n_shards} shards"
                )
            self._set_hops(h_now)
        edges, hz = _slab_edges(new_pos, cell, self.n_shards)
        self.cov_min = slab_coverage(edges, hz, self.n_shards, self.hops)
        if self.cov_min < self.rc:
            raise RuntimeError(
                f"halo coverage {self.cov_min:.3f} < cutoff+skin {self.rc:.3f} "
                "immediately after re-sort — slab population is too skewed "
                "for this shard count"
            )
        self._pos0 = new_sys.positions.clone()
        self._drifted = torch.zeros_like(self._drifted)
        new_rebuild = None
        if topology_changed:
            self.rebuild_fn = new_rebuild = self._make_rebuild()
        return new_sys, perm, new_rebuild

    def grow(self, factor: float = 1.5, system: System | None = None):
        """Capacity regrow.  With ``system``, first checks the current
        geometry: drift past the coverage margin asks for a re-sort, and a
        box that needs more hops than the engine was built with raises (the
        exchange pattern is fixed at construction).  It also raises when a
        build since the last re-sort found the drift past the margin while
        ``system`` (the state a chunk is re-run from) is within it: an atom
        crossed the margin within one chunk, which no capacity and no
        re-sort at the chunk's start can follow (the JAX engine regrows
        there, without end)."""
        if system is not None:
            drift = _drift(system, self._pos0)
            if 2.0 * drift > self.cov_min - self.rc:
                raise RuntimeError(
                    "atom drift has exhausted the halo coverage margin "
                    f"(2*{drift:.3f} > {self.cov_min - self.rc:.3f}); "
                    "wire maybe_migrate into the run loop "
                    "(Simulation(migrate_fn=engine.maybe_migrate)) — the "
                    "analog of LAMMPS re-assigning atoms to subdomains at "
                    "reneighboring — or re-sort manually via prepare_system"
                )
            mask = host(system.valid_mask())
            h_now = required_hops(host(system.positions).astype(np.float64)[mask],
                                  host(system.cell).astype(np.float64), self.n_shards, self.rc)
            if h_now > self.hops:
                raise RuntimeError(
                    f"box change requires {h_now} halo hops (engine built "
                    f"with {self.hops}); rebuild the engine (or pass "
                    "hops= with slack at construction)"
                )
            if bool(self._drifted):
                raise RuntimeError(
                    "an atom drifted past the halo coverage margin "
                    f"({self.cov_min - self.rc:.3f} A over two) within one chunk; a regrow "
                    "cannot help: use a shorter log_every/chunk, more halo hops "
                    "(hops=) or the replicated engine"
                )
        self.max_neighbors = _round_k(int(self.max_neighbors * factor) + 4)
        self.spec.max_neighbors = self.max_neighbors
        self.cell_capacity = int(self.cell_capacity * factor) + 4
        self.gz_cap = self.gz_cap + 2
        self.rebuild_fn = self._make_rebuild()
        return self.rebuild_fn
