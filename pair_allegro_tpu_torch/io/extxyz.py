"""Extended-XYZ reader/writer (counterpart of ``pair_allegro_tpu/io/extxyz.py``).

numpy only: the subset the fixtures use, a ``Lattice=`` cell (rows are the
lattice vectors), ``Properties=species:S:1:pos:R:3[:...]``, ``pbc=`` flags
and any other scalar key=value on the comment line.  A file written here
reads back in the JAX package, and the reverse.
"""

from __future__ import annotations

import re

import numpy as np

_KV_RE = re.compile(r'(\w[\w-]*)\s*=\s*(?:"([^"]*)"|(\S+))')
_STANDARD = ("symbols", "positions", "cell", "pbc", "info")


def _parse_comment(line: str) -> dict:
    return {m.group(1): m.group(2) if m.group(2) is not None else m.group(3)
            for m in _KV_RE.finditer(line)}


def _parse_properties(spec: str):
    """'species:S:1:pos:R:3:forces:R:3' -> [(name, kind, ncols), ...]"""
    parts = spec.split(":")
    return [(parts[i], parts[i + 1], int(parts[i + 2])) for i in range(0, len(parts), 3)]


def read_extxyz(path: str, index: int | None = None):
    """Read extxyz frames: a list of dicts (one dict with ``index``) with
    'symbols' (N,) str, 'positions' (N, 3) f64, 'cell' (3, 3) f64 or None,
    'pbc' 3-tuple of bool, 'info' (the comment's key/values) and every
    other per-atom column by name (e.g. 'forces')."""
    with open(path) as f:
        lines = f.read().splitlines()
    frames = []
    k = 0
    while k < len(lines):
        if not lines[k].strip():
            k += 1
            continue
        nat = int(lines[k].strip())
        info = _parse_comment(lines[k + 1])
        rows = [lines[k + 2 + i].split() for i in range(nat)]
        frame: dict = {"info": info}
        col = 0
        for name, kind, ncol in _parse_properties(info.get("Properties", "species:S:1:pos:R:3")):
            block = [r[col:col + ncol] for r in rows]
            col += ncol
            if kind == "S":
                arr = np.asarray([b[0] for b in block])
            else:
                arr = np.asarray(block, dtype=np.int64 if kind == "I" else np.float64)
                arr = arr.reshape(nat, ncol)
                if ncol == 1:
                    arr = arr[:, 0]
            frame["symbols" if name == "species" else name] = arr
        frame["positions"] = frame.pop("pos")
        frame["cell"] = (np.asarray(info["Lattice"].split(), dtype=np.float64).reshape(3, 3)
                         if "Lattice" in info else None)
        pbc_str = info.get("pbc", "T T T" if frame["cell"] is not None else "F F F")
        frame["pbc"] = tuple(tok.upper().startswith("T") for tok in pbc_str.split())
        frames.append(frame)
        k += 2 + nat
    return frames if index is None else frames[index]


def write_extxyz(path: str, frames, mode: str = "w") -> None:
    """Write frames (dicts as ``read_extxyz`` gives them); every other
    (N,) or (N, k) array becomes a real-valued column."""
    if isinstance(frames, dict):
        frames = [frames]
    with open(path, mode) as f:
        for fr in frames:
            pos = np.asarray(fr["positions"], dtype=np.float64)
            nat = pos.shape[0]
            sym = fr.get("symbols", np.asarray(["X"] * nat))
            extras = {k: np.asarray(v) for k, v in fr.items()
                      if k not in _STANDARD and hasattr(v, "__len__") and len(v) == nat}
            props = "species:S:1:pos:R:3"
            for k, v in extras.items():
                props += f":{k}:R:{1 if v.ndim == 1 else v.shape[1]}"
            comment = f"Properties={props}"
            cell = fr.get("cell")
            if cell is not None:
                flat = " ".join(f"{x:.10g}" for x in np.asarray(cell).reshape(-1))
                comment += f' Lattice="{flat}"'
            pbc = fr.get("pbc")
            if pbc is not None:
                comment += ' pbc="' + " ".join("T" if b else "F" for b in pbc) + '"'
            for k, v in fr.get("info", {}).items():
                if k not in ("Properties", "Lattice", "pbc"):
                    comment += f" {k}={v}"
            f.write(f"{nat}\n{comment}\n")
            for i in range(nat):
                row = f"{sym[i]} " + " ".join(f"{x:.12g}" for x in pos[i])
                for v in extras.values():
                    row += " " + " ".join(f"{x:.12g}" for x in np.atleast_1d(v[i]))
                f.write(row + "\n")
