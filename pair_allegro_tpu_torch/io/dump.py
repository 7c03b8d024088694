"""Trajectory dump writer (counterpart of ``pair_allegro_tpu/io/dump.py``):
LAMMPS ``dump custom`` text, the same bytes as the JAX package writes for
the same frame, so that tools written for those dumps read these."""

from __future__ import annotations

import numpy as np
import torch

from pair_allegro_tpu_torch import tracing


def host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array; each tensor
    read counts one ``host_reads`` (``tracing``)."""
    if isinstance(x, torch.Tensor):
        tracing.count("host_reads")
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DumpWriter:
    """Append LAMMPS dump-custom frames to a file: id, type, x y z, then fx
    fy fz, c_pe and the ``c_<name>[k]`` columns of per-atom computes when
    given.  The row loop runs on the host."""

    def __init__(self, path: str, mode: str = "w"):
        self.path = path
        self._fh = open(path, mode)

    def write_frame(self, step: int, system, forces=None, atomic_energy=None,
                    extras=None) -> None:
        """``extras``: {name: (N,) or (N, k)} per-atom columns, written as
        c_<name> or c_<name>[1..k]; padded atoms are left out."""
        pos = host(system.positions)
        valid = host(system.valid_mask())
        idx = np.nonzero(valid)[0]
        cell = host(system.cell)
        fh = self._fh
        fh.write("ITEM: TIMESTEP\n%d\n" % step)
        fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % len(idx))
        xy, xz, yz = cell[1, 0], cell[2, 0], cell[2, 1]
        if any(abs(v) > 1e-12 for v in (xy, xz, yz)):
            fh.write("ITEM: BOX BOUNDS xy xz yz pp pp pp\n")
            lo = [0.0 + min(0.0, xy, xz, xy + xz), 0.0 + min(0.0, yz), 0.0]
            hi = [cell[0, 0] + max(0.0, xy, xz, xy + xz), cell[1, 1] + max(0.0, yz), cell[2, 2]]
            for d, t in zip(range(3), (xy, xz, yz)):
                fh.write(f"{lo[d]:.10g} {hi[d]:.10g} {t:.10g}\n")
        else:
            fh.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                fh.write(f"0 {cell[d, d]:.10g}\n")
        cols = "id type x y z"
        types = host(system.types)
        f_arr = None if forces is None else host(forces)
        e_arr = None if atomic_energy is None else host(atomic_energy)
        if f_arr is not None:
            cols += " fx fy fz"
        if e_arr is not None:
            cols += " c_pe"
        x_arrs = []
        for name, v in (extras or {}).items():
            v = host(v).reshape(len(valid), -1)
            x_arrs.append(v)
            cols += " " + " ".join(f"c_{name}" if v.shape[1] == 1 else f"c_{name}[{j + 1}]"
                                   for j in range(v.shape[1]))
        fh.write(f"ITEM: ATOMS {cols}\n")
        for k, i in enumerate(idx):
            row = f"{k + 1} {types[i] + 1} " + " ".join(f"{x:.12g}" for x in pos[i])
            if f_arr is not None:
                row += " " + " ".join(f"{x:.12g}" for x in f_arr[i])
            if e_arr is not None:
                row += f" {e_arr[i]:.12g}"
            for v in x_arrs:
                row += " " + " ".join(f"{x:.12g}" for x in v[i])
            fh.write(row + "\n")
        fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
