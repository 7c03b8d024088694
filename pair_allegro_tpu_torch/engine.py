"""Engine assembly: the pair-style glue (counterpart of
``pair_allegro_tpu/engine.py:42-326, 460-647``).

Binds a model (config + parameters), a type-name mapping and a neighbor
strategy into the two callables the MD runtime consumes, ``force_fn`` and
``rebuild_fn``, plus capacity growth on overflow.  Both neighbor strategies
are ported: the cell list (TABLE layout) for full-PBC boxes of more than 256
atoms with at least 3 bins per axis, the dense build (FLAT layout) for every
other system (small boxes, slabs, molecules, clusters).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_energy
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, nequip_energy
from pair_allegro_tpu_torch.neighbors.device import (
    NeighborData,
    cell_list_neighbors,
    choose_grid,
    dense_build_bytes,
    dense_neighbors,
    reverse_table,
    static_image_shifts,
)
from pair_allegro_tpu_torch.neighbors.naive import host_neighbor_stats
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.system import System, resolve_device


class TypeMapper:
    """Map user type names to model type indices; unknown names raise."""

    def __init__(self, model_type_names: tuple[str, ...]):
        self.model_type_names = tuple(model_type_names)
        self._index = {n: i for i, n in enumerate(self.model_type_names)}

    def map_names(self, names) -> np.ndarray:
        try:
            return np.asarray([self._index[n] for n in names], dtype=np.int64)
        except KeyError as e:
            raise KeyError(
                f"type name {e} not found in model type names {self.model_type_names}"
            ) from None


@dataclasses.dataclass
class NeighborSpec:
    """Resolved neighbor strategy and capacities for a fixed system shape."""

    strategy: str  # "cell_list" (TABLE layout) or "dense" (FLAT layout)
    cutoff: float
    max_edges: int
    # dense only: the (S, 3) integer image shifts the build scans
    shifts_table: np.ndarray | None = None
    grid: tuple[int, int, int] | None = None
    cell_capacity: int = 0
    max_neighbors: int = 0
    # symmetrised per-edge-type build cutoffs including the skin, or None
    cutoff_table: np.ndarray | None = None


def typed_cutoff_table(cfg, skin: float) -> np.ndarray | None:
    """Symmetrised per-edge-type build cutoff table (+ skin), or None when
    the model's cutoff matrix is uniform.  Symmetry keeps reverse_table's
    edge bijection; the model's envelope honours an asymmetric cutoff."""
    m = np.minimum(np.asarray(cfg.cutoff_matrix(), dtype=np.float64), cfg.r_max)
    sym = np.maximum(m, m.T)
    if np.allclose(sym, sym.flat[0]):
        return None
    return sym + skin


def _round_k(k_max: int) -> int:
    """The JAX engine's per-atom capacity rounding, kept so that K (and so
    the work per step) matches it: multiples of 8 up to 24, then the
    multiples of 16 with a 128-aligned block of at most 512 edges, then
    multiples of 128."""
    if k_max <= 24:
        return max(8, -(-k_max // 8) * 8)
    k = -(-k_max // 16) * 16
    while k < 512:
        if any((k * m) % 128 == 0 and k * m <= 512 for m in range(1, 9)):
            return k
        k += 16
    return -(-k_max // 128) * 128


def _host_stats(system: System, cutoff: float, cutoff_table):
    pos = system.positions.detach().cpu().double().numpy()
    cell = system.cell.detach().cpu().double().numpy()
    mask = system.valid_mask().cpu().numpy()
    typed = cutoff_table is not None
    return host_neighbor_stats(
        pos[mask],
        cell if any(system.pbc) else None,
        system.pbc,
        cutoff,
        types=system.types.cpu().numpy()[mask] if typed else None,
        cutoff_matrix=cutoff_table if typed else None,
    )


def _estimate_capacities(system: System, cutoff: float, skin: float, capacity_factor: float,
                         cutoff_table: np.ndarray | None = None) -> NeighborSpec:
    """Strategy and padded capacities from the initial geometry, as the JAX
    engine picks them: the cell list when the box is periodic on every axis,
    holds >= 3 bins per axis and N > 256, with K = round(max count + max(8,
    20%)); else the dense build over the image shifts that cover the
    cutoff, with max_edges the edge count * capacity_factor rounded up to a
    multiple of 128, plus 128."""
    cell = system.cell.detach().cpu().double().numpy()
    rc = cutoff + skin
    n = system.n_atoms
    grid = choose_grid(cell, rc) if all(system.pbc) else None
    n_edges, max_count = _host_stats(system, rc, cutoff_table)
    if grid is not None and n > 256:
        k_max = _round_k(max_count + max(8, -(-max_count // 5)))
        per_bin = n / np.prod(grid)
        return NeighborSpec(
            strategy="cell_list",
            cutoff=rc,
            max_edges=n * k_max,
            grid=grid,
            cell_capacity=int(np.ceil(per_bin * capacity_factor)) + 8,
            max_neighbors=k_max,
            cutoff_table=cutoff_table,
        )
    shifts = static_image_shifts(cell, system.pbc, rc)
    cap = int(np.ceil(n_edges * capacity_factor / 128.0)) * 128 + 128
    return NeighborSpec(strategy="dense", cutoff=rc, max_edges=cap, shifts_table=shifts,
                        cutoff_table=cutoff_table)


def make_rebuild_fn(spec: NeighborSpec, skin: float = 0.0) -> Callable:
    """rebuild_fn(system, prev) -> NeighborData.

    With skin > 0 the list is built at cutoff + skin and rebuilt only when
    some atom moved more than skin/2 since the last build (one device
    reduction and one host read per call).  The cell list gives the TABLE
    layout with its reverse table, the dense build the FLAT layout."""

    def build(system: System) -> NeighborData:
        typed = spec.cutoff_table is not None
        if spec.strategy == "dense":
            nd = dense_neighbors(
                system.positions, system.cell, spec.shifts_table, spec.cutoff, spec.max_edges,
                atom_mask=system.valid_mask(), pbc=system.pbc,
                types=system.types if typed else None, cutoff_table=spec.cutoff_table,
            )
        else:
            nd = cell_list_neighbors(
                system.positions, system.cell, spec.cutoff, spec.grid, spec.cell_capacity,
                spec.max_neighbors, atom_mask=system.valid_mask(),
                types=system.types if typed else None, cutoff_table=spec.cutoff_table,
            )
            nd.edge_rev = reverse_table(nd.edge_index, nd.edge_shifts)
        if skin > 0.0:
            nd.ref_positions = system.positions.clone()
        return nd

    def rebuild(system: System, prev: NeighborData | None) -> NeighborData:
        if prev is None or skin <= 0.0 or prev.ref_positions is None:
            return build(system)
        d = system.positions - prev.ref_positions
        d2 = torch.where(system.valid_mask(), torch.sum(d * d, dim=-1), 0.0).max()
        return build(system) if bool(d2 > (0.5 * skin) ** 2) else prev

    return rebuild


def grow_spec(spec: NeighborSpec, factor: float = 1.5) -> NeighborSpec:
    """Capacity growth on overflow."""
    return dataclasses.replace(
        spec,
        max_edges=int(spec.max_edges * factor) + 128,
        cell_capacity=int(spec.cell_capacity * factor) + 4,
        max_neighbors=_round_k(int(spec.max_neighbors * factor) + 4),
    )


def reestimate_spec(spec: NeighborSpec, system: System, factor: float = 1.5) -> NeighborSpec:
    """Regrow from the CURRENT geometry: re-pick the shift table (one extra
    image layer per periodic axis) or the bin grid, and take the larger of
    the grown and the freshly estimated capacities.  The strategy stays."""
    grown = grow_spec(spec, factor)
    n_edges, max_count = _host_stats(system, spec.cutoff, spec.cutoff_table)
    cell = system.cell.detach().cpu().double().numpy()
    if spec.strategy == "dense":
        shifts = static_image_shifts(cell, system.pbc, spec.cutoff, extra_images=1)
        cap = int(np.ceil(n_edges * factor / 128.0)) * 128 + 128
        return dataclasses.replace(grown, shifts_table=shifts, max_edges=max(grown.max_edges, cap))
    grid = choose_grid(cell, spec.cutoff)
    if grid is None:
        raise RuntimeError(
            "cell contracted below the 3-bin cell-list regime "
            f"(cell heights vs cutoff {spec.cutoff})"
        )
    per_bin = system.n_atoms / np.prod(grid)
    k_max = _round_k(max(int(max_count * factor) + 2, grown.max_neighbors))
    return dataclasses.replace(
        grown,
        grid=grid,
        max_neighbors=k_max,
        max_edges=max(grown.max_edges, system.n_atoms * k_max),
        cell_capacity=max(grown.cell_capacity, int(np.ceil(per_bin * factor)) + 8),
    )


def edge_slots(spec: NeighborSpec, n_atoms: int) -> int:
    """Edge slots the force evaluation computes: N*K on the TABLE layout,
    max_edges on the FLAT one."""
    return spec.max_edges if spec.strategy == "dense" else n_atoms * spec.max_neighbors


def regrow_bytes(spec: NeighborSpec, system: System, cfg) -> int:
    """Device bytes a rebuild and force evaluation need at ``spec``'s
    capacity: the edge slots times the model's own per-edge estimate for
    the layout (``cfg.live_bytes_per_edge(flat)``), plus, for the dense
    strategy, what its build holds (``neighbors.device.dense_build_bytes``:
    one pass of candidate pairs and the compacted outputs)."""
    flat = spec.strategy == "dense"
    need = edge_slots(spec, system.n_atoms) * cfg.live_bytes_per_edge(flat=flat)
    if flat:
        need += dense_build_bytes(system.n_atoms, len(spec.shifts_table), spec.max_edges,
                                  system.positions.element_size())
    return need


def _check_memory(spec: NeighborSpec, system: System, cfg) -> None:
    """Before a regrow on the card: refuse clearly when the new capacity's
    per-edge tensors would not fit in the free device memory."""
    dev = system.positions.device
    if dev.type != "cuda":
        return
    free, _ = torch.cuda.mem_get_info(dev)
    need = regrow_bytes(spec, system, cfg)
    if need > free:
        cap = (f"max_edges={spec.max_edges}" if spec.strategy == "dense"
               else f"K={spec.max_neighbors}")
        raise MemoryError(
            f"regrow to {cap} needs ~{need / 2**30:.1f} GiB of device memory for "
            f"E={edge_slots(spec, system.n_atoms)} edge slots ({spec.strategy} build), "
            f"only {free / 2**30:.1f} GiB is free"
        )


class PairEngine:
    """Bind an energy model to a system shape (the pair_style layer)."""

    def __init__(self, cfg, params, system: System, model_energy: Callable,
                 skin: float = 0.0, capacity_factor: float = 1.25,
                 compute_virial: bool = True):
        self.cfg = cfg
        self.params = params
        self.compute_virial = compute_virial
        self.skin = skin
        self.capacity_factor = capacity_factor
        self.spec = _estimate_capacities(
            system, cfg.r_max, skin, capacity_factor, cutoff_table=typed_cutoff_table(cfg, skin)
        )
        self.rebuild_fn = make_rebuild_fn(self.spec, skin)
        self._potential = make_potential(
            lambda *a, **k: model_energy(params, cfg, *a, **k)
        )

    def force_fn(self, system: System, neighbors: NeighborData):
        return self._potential(
            system.positions,
            system.types,
            neighbors.edge_index,
            cell=system.cell,
            edge_shifts=neighbors.edge_shifts,
            atom_mask=system.valid_mask(),
            edge_mask=neighbors.edge_mask,
            compute_virial=self.compute_virial,
            edge_rev=neighbors.edge_rev,
        )

    def grow(self, factor: float = 1.5, system: System | None = None):
        """Regrow capacities (re-estimated from ``system`` when given) and
        return the new rebuild_fn."""
        spec = (
            reestimate_spec(self.spec, system, factor)
            if system is not None
            else grow_spec(self.spec, factor)
        )
        if system is not None:
            _check_memory(spec, system, self.cfg)
        self.spec = spec
        self.rebuild_fn = make_rebuild_fn(self.spec, self.skin)
        return self.rebuild_fn


def _check_engine_device(system: System, device) -> None:
    dev = resolve_device(device)
    if system.positions.device.type != dev.type:
        raise ValueError(f"system lives on {system.positions.device}, engine on {dev}")


class AllegroEngine(PairEngine):
    """``pair_style allegro`` equivalent.  ``device=None`` means the CUDA
    device; the system's tensors must live on the engine's device."""

    def __init__(self, cfg: AllegroConfig, params, system: System, device=None, **kw):
        _check_engine_device(system, device)
        super().__init__(cfg, params, system, allegro_energy, **kw)


class NequIPEngine(PairEngine):
    """``pair_style nequip`` equivalent (counterpart of
    ``pair_allegro_tpu/engine.py:634-647``): message passing carries
    information num_layers hops, so the strictly local ``row_chunk`` build
    is refused.  ``device=None`` means the CUDA device."""

    def __init__(self, cfg: NequIPConfig, params, system: System, device=None,
                 row_chunk=None, **kw):
        if row_chunk:
            raise ValueError(
                "row_chunk requires strict locality; NequIP message passing "
                "propagates num_layers hops"
            )
        _check_engine_device(system, device)
        super().__init__(cfg, params, system, nequip_energy, **kw)
