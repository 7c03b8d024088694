"""Engine assembly: the pair-style glue (counterpart of
``pair_allegro_tpu/engine.py:42-326, 460-647``).

Binds a model (config + parameters), a type-name mapping and a neighbor
strategy into the two callables the MD runtime consumes, ``force_fn`` and
``rebuild_fn``, plus capacity growth on overflow and its shrink
(``maybe_shrink``).  Both neighbor strategies are ported: the cell list
(TABLE layout) for full-PBC boxes of more than 256 atoms with at least 3
bins per axis, the dense build (FLAT layout) for every other system (small
boxes, slabs, molecules, clusters).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.io.dump import host
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_energy
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, nequip_energy
from pair_allegro_tpu_torch.neighbors.device import (
    NeighborData,
    build_cell_bins,
    cell_list_neighbors,
    choose_grid,
    dense_build_bytes,
    dense_neighbors,
    reverse_table,
    static_image_shifts,
)
from pair_allegro_tpu_torch.neighbors.naive import host_neighbor_stats
from pair_allegro_tpu_torch.ops.scatter import table_edge_vec, table_edge_vec_typed
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
    pos = host(system.positions).astype(np.float64)
    cell = host(system.cell).astype(np.float64)
    mask = host(system.valid_mask())
    typed = cutoff_table is not None
    return host_neighbor_stats(
        pos[mask],
        cell if any(system.pbc) else None,
        system.pbc,
        cutoff,
        types=host(system.types)[mask] if typed else None,
        cutoff_matrix=cutoff_table if typed else None,
    )


def _estimate_capacities(system: System, cutoff: float, skin: float, capacity_factor: float,
                         cutoff_table: np.ndarray | None = None) -> NeighborSpec:
    """Strategy and padded capacities from the initial geometry, as the JAX
    engine picks them: the cell list when the box is periodic on every axis,
    holds >= 3 bins per axis and N > 256, with K = round(max count + max(8,
    20%)), or the value of ``PAT_K_MAX`` when it is set (capacity
    experiments); else the dense build over the image shifts that cover the
    cutoff, with max_edges the edge count * capacity_factor rounded up to a
    multiple of 128, plus 128."""
    cell = host(system.cell).astype(np.float64)
    rc = cutoff + skin
    n = system.n_atoms
    grid = choose_grid(cell, rc) if all(system.pbc) else None
    n_edges, max_count = _host_stats(system, rc, cutoff_table)
    if grid is not None and n > 256:
        k_max = (int(os.environ.get("PAT_K_MAX", "0"))
                 or _round_k(max_count + max(8, -(-max_count // 5))))
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


# remat turns on once the per-layer residuals pass this many bytes (the
# reference's threshold, kept as it is on the 80 GB card)
REMAT_BYTES = 8 * 1024**3


def _resolve_remat(cfg, spec: NeighborSpec, n_atoms: int):
    """Resolve ``cfg.remat == "auto"`` as the reference does
    (``pair_allegro_tpu/engine.py:188-201``): off while the per-layer
    residuals (2 C D + 128 words per edge slot and layer, twice) stay under
    :data:`REMAT_BYTES`, on above it.  Other values pass through."""
    if cfg.remat != "auto":
        return cfg
    d = (cfg.l_max + 1) ** 2
    c = getattr(cfg, "num_tensor_features", getattr(cfg, "num_features", 32))
    resid_bytes = edge_slots(spec, n_atoms) * (2 * c * d + 128) * 4 * cfg.num_layers * 2
    return dataclasses.replace(cfg, remat=resid_bytes > REMAT_BYTES)


def make_rebuild_fn(spec: NeighborSpec, skin: float = 0.0, row_chunk: int | None = None
                    ) -> Callable:
    """rebuild_fn(system, prev) -> NeighborData.

    With skin > 0 the list is built at cutoff + skin and rebuilt only when
    some atom moved more than skin/2 since the last build (one device
    reduction and one host read per call).  The cell list gives the TABLE
    layout with its reverse table, the dense build the FLAT layout.  With
    ``row_chunk`` the cell list bins once and builds the rows in windows
    of ``row_chunk`` centers, so the (N, 27 * cap) candidate matrix never
    exists at full size (the million-atom mode); the tables are
    concatenated, the windows' overflow flags ORed, and the reverse table
    built once on the whole table."""

    def build(system: System) -> NeighborData:
        typed = spec.cutoff_table is not None
        types = system.types if typed else None
        mask = system.valid_mask()
        if spec.strategy == "dense":
            nd = dense_neighbors(
                system.positions, system.cell, spec.shifts_table, spec.cutoff, spec.max_edges,
                atom_mask=mask, pbc=system.pbc, types=types, cutoff_table=spec.cutoff_table,
            )
        else:
            bins = build_cell_bins(system.positions, system.cell, spec.cutoff, spec.grid,
                                   spec.cell_capacity, mask, types=types) if row_chunk else None
            n = system.n_atoms
            windows = [
                cell_list_neighbors(
                    system.positions, system.cell, spec.cutoff, spec.grid, spec.cell_capacity,
                    spec.max_neighbors, atom_mask=mask, types=types,
                    cutoff_table=spec.cutoff_table, query_start=q0, n_query=row_chunk,
                    bins_data=bins,
                )
                for q0 in (range(0, n, row_chunk) if row_chunk else (0,))
            ]
            nd = windows[0] if len(windows) == 1 else NeighborData(
                edge_index=torch.cat([w.edge_index for w in windows]),
                edge_shifts=torch.cat([w.edge_shifts for w in windows]),
                edge_mask=torch.cat([w.edge_mask for w in windows]),
                overflow=torch.stack([w.overflow for w in windows]).any(),
            )
            del windows
            nd.edge_rev = reverse_table(nd.edge_index, nd.edge_shifts)
        if skin > 0.0:
            nd.ref_positions = system.positions.clone()
        return nd

    return skin_checked(build, skin)


def skin_checked(build: Callable, skin: float) -> Callable:
    """rebuild(system, prev) over ``build(system)``: with skin > 0 the
    previous data (which keeps ``ref_positions``) stands until some atom
    moved more than skin / 2 since it was built (one device reduction and
    one host read per call).  Each build counts one ``neighbors.builds``
    (``tracing``)."""

    def rebuild(system: System, prev):
        if prev is not None and skin > 0.0 and prev.ref_positions is not None:
            with tracing.span("neighbors.check"):
                d = system.positions - prev.ref_positions
                d2 = torch.where(system.valid_mask(), torch.sum(d * d, dim=-1), 0.0).max()
                moved = bool(host(d2 > (0.5 * skin) ** 2))
            if not moved:
                return prev
        with tracing.span("neighbors.build"):
            tracing.count("neighbors.builds")
            return build(system)

    return rebuild


def _make_chunked_energy(model_energy: Callable, params, cfg, row_chunk: int) -> Callable:
    """The TABLE-layout energy in windows of ``row_chunk`` center rows (the
    reference's ``_make_chunked_energy``, ``engine.py:329-458``), each run
    under ``torch.utils.checkpoint``, so only one window's activations are
    alive at a time: the million-atom mode on one card.  Exact because the
    model is strictly local per center row.

    With a reverse table the edge vectors (and, for typed models, the
    neighbor-type column) are gathered once for all N rows; each window
    takes its slice of them (``unbind``), so the windows' d(vec) are
    stacked into one cotangent and one reverse gather builds dpos, with no
    scatter per window.  The model runs inside a window with its own remat
    off: the window's checkpoint already bounds the live memory to one
    window, and a layer checkpoint nested inside it would recompute each
    layer's forward a third time (non-reentrant checkpoints re-run the
    inner region once more in the outer one's backward).  The model draws
    no random numbers, so no generator state is stashed.

    The model's per-center outputs (``model_energy.per_center_outputs``,
    leading dim the window's centers) are put back in row order; every
    other output is extensive and summed over the windows (a contract by
    name, so a fixed-size output such as the (3,) dipole is summed even
    when ``row_chunk`` is 3)."""
    from torch.utils.checkpoint import checkpoint

    win_cfg = dataclasses.replace(cfg, remat=False)
    per_center = frozenset(model_energy.per_center_outputs)

    def energy_fn(positions, types, edge_index, *, cell=None, edge_shifts=None, atom_mask=None,
                  edge_mask=None, edge_rev=None, center_offset: int = 0):
        n, k = edge_index.shape
        c = n // row_chunk
        if c * row_chunk != n:
            raise ValueError(f"{n} table rows are not a multiple of row_chunk={row_chunk}")
        am = (torch.ones(n, dtype=torch.bool, device=positions.device) if atom_mask is None
              else atom_mask)
        vec = tjf = None
        if edge_rev is not None and edge_mask is not None:
            if cfg.num_types > 1:
                pos_t = torch.cat([positions, types.to(positions.dtype)[:, None]], 1)
                vec, tjf = table_edge_vec_typed(pos_t, edge_index, edge_rev, edge_mask)
            else:
                vec = table_edge_vec(positions, edge_index, edge_rev, edge_mask)

        def split(a, *tail):
            return (None,) * c if a is None else a.reshape(c, row_chunk, *tail).unbind(0)

        per_w = zip(split(edge_index, k), split(edge_shifts, k, 3), split(edge_mask, k),
                    split(am), split(vec, k, 3), split(tjf, k))

        def window(q0, j_w, sh_w, em_w, am_w, vec_w, tjf_w, positions, cell):
            return model_energy(params, win_cfg, positions, types, j_w, cell=cell,
                                edge_shifts=sh_w, atom_mask=am_w, edge_mask=em_w,
                                center_offset=q0, num_centers=row_chunk, edge_vec=vec_w,
                                edge_tjf=tjf_w)

        outs = [checkpoint(window, center_offset + w * row_chunk, *ops, positions, cell,
                           use_reentrant=False, preserve_rng_state=False)
                for w, ops in enumerate(per_w)]
        res = {}
        for key in outs[0]:
            vals = [o[key] for o in outs]
            if key in per_center:
                res[key] = torch.cat(vals)
            else:
                res[key] = torch.stack(vals).sum(0)
        return res

    return energy_fn


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
    cell = host(system.cell).astype(np.float64)
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


def regrow_bytes(spec: NeighborSpec, system: System, cfg, row_chunk: int | None = None) -> int:
    """Device bytes a rebuild and force evaluation need at ``spec``'s
    capacity: the edge slots times the model's own per-edge estimate for
    the layout and the system's dtype (``cfg.live_bytes_per_edge``), plus,
    for the dense strategy, what its build holds
    (``neighbors.device.dense_build_bytes``: one pass of candidate pairs
    and the compacted outputs).  With ``row_chunk`` only one window's slots
    are alive at the model's estimate; the full-size tables are counted
    besides: index, reverse table, shifts, mask, the edge vectors and their
    cotangent (and the neighbor-type column of a typed model)."""
    flat = spec.strategy == "dense"
    isz = system.positions.element_size()
    slots = edge_slots(spec, system.n_atoms)
    live = row_chunk * spec.max_neighbors if row_chunk and not flat else slots
    need = live * cfg.live_bytes_per_edge(flat=flat, dtype=system.positions.dtype)
    if row_chunk and not flat:
        need += slots * (8 + 8 + 1 + 9 * isz + (isz if cfg.num_types > 1 else 0))
    if flat:
        need += dense_build_bytes(system.n_atoms, len(spec.shifts_table), spec.max_edges, isz)
    return need


def _check_memory(spec: NeighborSpec, system: System, cfg, row_chunk: int | None = None) -> None:
    """Before a regrow on the card: refuse clearly when the new capacity's
    per-edge tensors would not fit in the free device memory."""
    dev = system.positions.device
    if dev.type != "cuda":
        return
    free, _ = torch.cuda.mem_get_info(dev)
    need = regrow_bytes(spec, system, cfg, row_chunk)
    if need > free:
        cap = (f"max_edges={spec.max_edges}" if spec.strategy == "dense"
               else f"K={spec.max_neighbors}")
        raise MemoryError(
            f"regrow to {cap} needs ~{need / 2**30:.1f} GiB of device memory for "
            f"E={edge_slots(spec, system.n_atoms)} edge slots ({spec.strategy} build), "
            f"only {free / 2**30:.1f} GiB is free"
        )


class PairEngine:
    """Bind an energy model to a system shape (the pair_style layer).

    ``cfg.remat == "auto"`` is resolved from the capacity estimate
    (:func:`_resolve_remat`).  ``row_chunk`` (cell-list strategy only, a
    divisor of the atom count) runs the neighbor build and the energy in
    windows of that many center rows (:func:`make_rebuild_fn`,
    :func:`_make_chunked_energy`)."""

    def __init__(self, cfg, params, system: System, model_energy: Callable,
                 skin: float = 0.0, capacity_factor: float = 1.25,
                 compute_virial: bool = True, row_chunk: int | None = None):
        self.params = params
        self.compute_virial = compute_virial
        self.skin = skin
        self.capacity_factor = capacity_factor
        self.spec = _estimate_capacities(
            system, cfg.r_max, skin, capacity_factor, cutoff_table=typed_cutoff_table(cfg, skin)
        )
        self.cfg = cfg = _resolve_remat(cfg, self.spec, system.n_atoms)
        if row_chunk:
            if self.spec.strategy != "cell_list":
                raise ValueError("row_chunk requires the cell-list (table) strategy")
            if system.n_atoms % row_chunk:
                raise ValueError(
                    f"n_atoms={system.n_atoms} not divisible by row_chunk={row_chunk}"
                )
            energy_fn = _make_chunked_energy(model_energy, params, cfg, row_chunk)
        else:
            def energy_fn(*a, **k):
                return model_energy(params, cfg, *a, **k)
        self.row_chunk = row_chunk or None
        self.energy_fn = energy_fn  # the model's energies alone (no forces)
        self.rebuild_fn = make_rebuild_fn(self.spec, skin, self.row_chunk)
        self._potential = make_potential(energy_fn)

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
            _check_memory(spec, system, self.cfg, self.row_chunk)
        self.spec = spec
        self.rebuild_fn = make_rebuild_fn(self.spec, self.skin, self.row_chunk)
        return self.rebuild_fn

    def maybe_shrink(self, system: System):
        """Capacity shrink, the other half of the regrow hysteresis: on the
        cell-list strategy, re-estimate from the current geometry and adopt
        the fresh spec only when the per-atom capacity K strictly drops (the
        estimate's 20% slack and K's rounding keep a count that hovers at a
        border from flip-flopping).  Returns the new rebuild_fn, or None
        when nothing shrank (the dense strategy's capacity is edge-count
        sized, and the strategy never changes mid-run)."""
        if self.spec.strategy != "cell_list":
            return None
        fresh = _estimate_capacities(system, self.cfg.r_max, self.skin, self.capacity_factor,
                                     cutoff_table=self.spec.cutoff_table)
        if fresh.strategy != "cell_list" or fresh.max_neighbors >= self.spec.max_neighbors:
            return None
        self.spec = fresh
        self.rebuild_fn = make_rebuild_fn(self.spec, self.skin, self.row_chunk)
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
