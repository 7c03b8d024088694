"""Simulation state and unit system (counterpart of ``pair_allegro_tpu/system.py``).

The cell is a row-major 3x3 with rows = lattice vectors, as in the JAX
package.  All tensors of one ``System`` live on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class Units:
    """LAMMPS ``units metal`` constants (eV, Angstrom, ps, amu, bar)."""

    kB = 8.617333262e-5
    mvv2e = 1.0364269574711572e-4
    ftm2a = 1.0 / mvv2e
    nktv2p = 1.6021766340000002e6
    fs = 1.0e-3


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  Without a GPU that raises: callers
    that want the CPU say so with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type == "cuda":
        # the glue's f32 products take TF32 only where the matmul precision
        # policy asks for it (ops/prec.py glue_scope); no convolution runs
        torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclasses.dataclass
class System:
    """The atomistic state.

    positions/velocities (N, 3), types (N,) int64, masses (N,), cell (3, 3),
    pbc a static 3-tuple, valid (N,) bool (False rows are padding)."""

    positions: torch.Tensor
    velocities: torch.Tensor
    types: torch.Tensor
    masses: torch.Tensor
    cell: torch.Tensor
    pbc: tuple = (True, True, True)
    valid: torch.Tensor | None = None

    @property
    def n_atoms(self) -> int:
        return self.positions.shape[0]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.n_atoms, dtype=torch.bool, device=self.device)
        return self.valid

    @property
    def n_valid(self):
        return self.valid_mask().sum()

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def create(
        positions,
        types,
        cell=None,
        velocities=None,
        masses=None,
        pbc=None,
        dtype=torch.float32,
        device=None,
        pad_to: int | None = None,
    ) -> "System":
        """Build a System from host data on ``device`` (default: CUDA).
        With ``pad_to`` > N the system is padded to ``pad_to`` atoms with
        masked ones (``valid`` False, type 0, unit mass, at rest) parked
        far outside the data, as the reference pads (``system.py:106-110``,
        the Kokkos fake-atom trick): a row-chunk engine then takes an atom
        count its ``row_chunk`` divides."""
        dev = resolve_device(device)
        pos = np.asarray(positions, dtype=np.float64)
        n = pos.shape[0]
        typ = np.asarray(types, dtype=np.int64)
        vel = np.zeros_like(pos) if velocities is None else np.asarray(velocities, np.float64)
        mas = np.ones((n,)) if masses is None else np.asarray(masses, np.float64)
        if cell is None:
            cell_np = np.zeros((3, 3))
            pbc = (False, False, False) if pbc is None else tuple(pbc)
        else:
            cell_np = np.asarray(cell, dtype=np.float64).reshape(3, 3)
            pbc = (True, True, True) if pbc is None else tuple(pbc)
        valid = np.ones((n,), dtype=bool)
        if pad_to is not None and pad_to > n:
            extent = float(np.abs(pos).max() + np.abs(cell_np).sum() + 100.0)
            pad = pad_to - n
            pos = np.concatenate([pos, np.full((pad, 3), extent)], axis=0)
            vel = np.concatenate([vel, np.zeros((pad, 3))], axis=0)
            typ = np.concatenate([typ, np.zeros((pad,), np.int64)], axis=0)
            mas = np.concatenate([mas, np.ones((pad,))], axis=0)
            valid = np.concatenate([valid, np.zeros((pad,), bool)], axis=0)

        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=dev)

        return System(
            positions=t(pos),
            velocities=t(vel),
            types=t(typ, torch.int64),
            masses=t(mas),
            cell=t(cell_np),
            pbc=pbc,
            valid=t(valid, torch.bool),
        )


def fcc_lattice(n_rep: int, a0: float = 3.61, jitter: float = 0.05, seed: int = 0):
    """FCC crystal of n_rep^3 cubic cells (4 n_rep^3 atoms, copper's lattice
    constant by default) with Gaussian position jitter made from ``seed``.
    Returns (positions (N, 3), cell (3, 3)) as numpy float64."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a0
    pos = np.concatenate(
        [base + np.array([i, j, k]) * a0 for i in range(n_rep) for j in range(n_rep)
         for k in range(n_rep)]
    )
    rng = np.random.RandomState(seed)
    return pos + jitter * rng.randn(*pos.shape), np.eye(3) * a0 * n_rep
