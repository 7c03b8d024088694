"""LAMMPS data-file reader/writer (counterpart of
``pair_allegro_tpu/io/lammps_data.py``).

The ``read_data`` subset: 'atoms' / 'atom types' headers, orthogonal and
triclinic (xy xz yz) boxes, a Masses section, an Atoms section in the
``atomic`` style (id type x y z [image flags]) and optional Velocities.  The
cell is LAMMPS's row-major [[lx, 0, 0], [xy, ly, 0], [xz, yz, lz]] with its
origin at (xlo, ylo, zlo).  numpy only.
"""

from __future__ import annotations

import numpy as np


def read_lammps_data(path: str) -> dict:
    """Returns 'positions' (N, 3), 'types' (N,) int32 0-based (sorted by
    atom id), 'cell' (3, 3), 'origin' (3,), 'masses_by_type' {type: mass},
    'velocities' (N, 3) or None, and 'n_types'."""
    with open(path) as f:
        lines = f.read().splitlines()
    n_types = None
    xlo = xhi = ylo = yhi = zlo = zhi = 0.0
    xy = xz = yz = 0.0
    section = None
    masses: dict[int, float] = {}
    ids, types, pos, vel_rows = [], [], [], {}
    for raw in lines[1:]:  # the first line is the title
        line = raw.split("#")[0].strip()
        if not line:
            continue
        low = line.lower()
        parts = line.split()
        if low.endswith(" atoms"):
            continue  # the count is the Atoms section's length
        if low.endswith(" atom types"):
            n_types = int(parts[0])
        elif low.endswith("xlo xhi"):
            xlo, xhi = map(float, parts[:2])
        elif low.endswith("ylo yhi"):
            ylo, yhi = map(float, parts[:2])
        elif low.endswith("zlo zhi"):
            zlo, zhi = map(float, parts[:2])
        elif low.endswith("xy xz yz"):
            xy, xz, yz = map(float, parts[:3])
        elif low in ("masses", "velocities") or low.startswith("atoms"):
            section = low.split()[0]
        elif section == "masses":
            masses[int(parts[0])] = float(parts[1])
        elif section == "atoms":
            ids.append(int(parts[0]))
            types.append(int(parts[1]))
            pos.append([float(x) for x in parts[2:5]])
        elif section == "velocities":
            vel_rows[int(parts[0])] = [float(x) for x in parts[1:4]]
    order = np.argsort(ids)
    type_arr = (np.asarray(types, np.int32) - 1)[order]
    vel = None
    if vel_rows:
        vel = np.asarray([vel_rows[ids[k]] for k in order], np.float64)
    return {
        "positions": np.asarray(pos, np.float64)[order],
        "types": type_arr,
        "cell": np.array([[xhi - xlo, 0.0, 0.0], [xy, yhi - ylo, 0.0], [xz, yz, zhi - zlo]]),
        "origin": np.array([xlo, ylo, zlo]),
        "masses_by_type": {t - 1: m for t, m in masses.items()},
        "velocities": vel,
        "n_types": n_types if n_types is not None else int(type_arr.max()) + 1,
    }


def write_lammps_data(path: str, positions, types, cell, masses_by_type=None,
                      velocities=None, origin=(0.0, 0.0, 0.0)) -> None:
    """Write an atomic-style data file: ``types`` 0-based (written 1-based),
    ``cell`` in LAMMPS's lower-triangular row-major form."""
    positions = np.asarray(positions, np.float64)
    types = np.asarray(types)
    cell = np.asarray(cell, np.float64)
    if abs(cell[0, 1]) > 1e-12 or abs(cell[0, 2]) > 1e-12 or abs(cell[1, 2]) > 1e-12:
        raise ValueError("cell must be LAMMPS-form [[lx,0,0],[xy,ly,0],[xz,yz,lz]]")
    n = positions.shape[0]
    n_types = int(types.max()) + 1 if len(types) else 0
    ox, oy, oz = origin
    with open(path, "w") as f:
        f.write("written by pair_allegro_tpu_torch\n\n")
        f.write(f"{n} atoms\n{n_types} atom types\n\n")
        f.write(f"{ox:.10g} {ox + cell[0, 0]:.10g} xlo xhi\n")
        f.write(f"{oy:.10g} {oy + cell[1, 1]:.10g} ylo yhi\n")
        f.write(f"{oz:.10g} {oz + cell[2, 2]:.10g} zlo zhi\n")
        if any(abs(v) > 1e-12 for v in (cell[1, 0], cell[2, 0], cell[2, 1])):
            f.write(f"{cell[1, 0]:.10g} {cell[2, 0]:.10g} {cell[2, 1]:.10g} xy xz yz\n")
        if masses_by_type:
            f.write("\nMasses\n\n")
            for t in range(n_types):
                f.write(f"{t + 1} {masses_by_type.get(t, 1.0):.10g}\n")
        f.write("\nAtoms\n\n")
        for i in range(n):
            x, y, z = positions[i]
            f.write(f"{i + 1} {int(types[i]) + 1} {x:.12g} {y:.12g} {z:.12g}\n")
        if velocities is not None:
            vel = np.asarray(velocities)
            f.write("\nVelocities\n\n")
            for i in range(n):
                vx, vy, vz = vel[i]
                f.write(f"{i + 1} {vx:.12g} {vy:.12g} {vz:.12g}\n")
