"""Single-point calculator (counterpart of ``pair_allegro_tpu/calculator.py``),
the ASE-calculator analog: energy, per-atom energies, forces, virial and
Voigt stress (ASE's sign, stress = -virial / V) of one configuration.

The engine is rebound whenever (n_atoms, pbc, bin grid) changes: the grid
(None on the dense strategy) is a function of the cell, so a cell that
re-bins the box or flips the strategy gets a fresh engine rather than a
stale grid and the regrow loop.
"""

from __future__ import annotations

import numpy as np
import torch

from pair_allegro_tpu_torch.compile_cache import maybe_enable_from_env
from pair_allegro_tpu_torch.engine import AllegroEngine, NequIPEngine, TypeMapper
from pair_allegro_tpu_torch.io.dump import host
from pair_allegro_tpu_torch.models.nequip import NequIPConfig
from pair_allegro_tpu_torch.neighbors.device import choose_grid
from pair_allegro_tpu_torch.system import System, Units, resolve_device


class Calculator:
    """Single-point results of a model (cfg, params on ``device``)::

        calc = Calculator(cfg, params, device="cpu")
        out = calc.calculate(positions, symbols=["Cu", ...], cell=cell)
        out["energy"], out["forces"], out["stress"]  # eV, eV/A, eV/A^3 Voigt
    """

    def __init__(self, cfg, params, dtype=torch.float32, device=None):
        maybe_enable_from_env()  # PAT_COMPILE_CACHE, as the JAX calculator honours it
        self.cfg = cfg
        self.params = params
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mapper = TypeMapper(cfg.type_names)
        self._engine = None
        self._shape_key = None

    def _get_engine(self, system: System):
        grid = (choose_grid(host(system.cell).astype(np.float64), self.cfg.r_max)
                if all(system.pbc) else None)
        key = (system.n_atoms, system.pbc, grid)
        if self._engine is None or self._shape_key != key:
            cls = NequIPEngine if isinstance(self.cfg, NequIPConfig) else AllegroEngine
            self._engine = cls(self.cfg, self.params, system, device=self.device)
            self._shape_key = key
        return self._engine

    def calculate(self, positions, types=None, symbols=None, cell=None, pbc=None) -> dict:
        """'energy' [eV], 'energies' (N,) [eV], 'forces' (N, 3) [eV/A],
        'virial' (3, 3) [eV], 'stress' (6,) Voigt [eV/A^3] and
        'pressure_bar' (both None without a cell), as numpy float64."""
        if types is None:
            if symbols is None:
                raise ValueError("need types or symbols")
            types = self.mapper.map_names(list(symbols))
        system = System.create(positions, types, cell=cell, pbc=pbc, dtype=self.dtype,
                               device=self.device)
        eng = self._get_engine(system)
        nbrs = eng.rebuild_fn(system, None)
        # a reused engine may meet a far denser configuration: regrow with a
        # cap, and never return results of a truncated edge list
        for _ in range(8):
            if not bool(nbrs.overflow):
                break
            eng.grow()
            nbrs = eng.rebuild_fn(system, None)
        else:
            raise RuntimeError("neighbor capacity still overflowing after 8 regrows; the "
                               "configuration is far denser than the engine was sized for")
        out = eng.force_fn(system, nbrs)
        virial = host(out.virial).astype(np.float64)
        result = {
            "energy": float(out.total_energy),
            "energies": host(out.atomic_energy).astype(np.float64),
            "forces": host(out.forces).astype(np.float64),
            "virial": virial,
            "stress": None,
            "pressure_bar": None,
        }
        if cell is not None:
            vol = abs(np.linalg.det(np.asarray(cell, np.float64)))
            stress = -virial / vol
            result["stress"] = np.array([stress[0, 0], stress[1, 1], stress[2, 2],
                                         stress[1, 2], stress[0, 2], stress[0, 1]])
            result["pressure_bar"] = float(np.trace(virial) / 3.0 / vol * Units.nktv2p)
        return result
