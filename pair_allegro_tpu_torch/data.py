"""Training dataset: extxyz frames -> padded training frames (counterpart of
``pair_allegro_tpu/data.py``).

Every frame of a dataset is padded to ONE ``(N_pad, E_pad)`` shape, the JAX
package's contract: atoms to a multiple of ``pad_multiple``, edges to the
largest frame's count plus 12.5% rounded up to 64, padded edges as (0, 0)
self-loops killed by ``edge_mask``, padded atoms in no edge and out of
``atom_mask``.  Frames stack along a leading batch axis (`stack_frames`).
The JAX package's ``shard_batch`` (data-parallel batches) is not ported:
multi-device training is ROADMAP queue 1, item 9.

Targets follow the extxyz training convention: ``energy=`` on the comment
line, a ``forces`` per-atom column, and optionally a 9-component
``virial=`` entry (write it quoted: ``virial="1 0 0 ..."``).
"""

from __future__ import annotations

import numpy as np
import torch

from pair_allegro_tpu_torch.engine import TypeMapper
from pair_allegro_tpu_torch.io.extxyz import read_extxyz
from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np, pad_edges
from pair_allegro_tpu_torch.system import resolve_device

__all__ = ["load_frames", "stack_frames"]


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def load_frames(
    path: str,
    type_names: tuple[str, ...],
    r_max: float,
    *,
    dtype=torch.float32,
    device=None,
    n_pad: int | None = None,
    e_pad: int | None = None,
    pad_multiple: int = 8,
    energy_key: str = "energy",
    forces_key: str = "forces",
    virial_key: str = "virial",
    cutoff_matrix: np.ndarray | None = None,
) -> list[dict]:
    """Read an extxyz dataset into training frames of ONE common shape, on
    ``device`` (None: the CUDA device).

    Species map by name through ``engine.TypeMapper`` (an unknown one
    raises ``KeyError``); edges are the exact full list within ``r_max``,
    or within ``cutoff_matrix[t_i, t_j]`` when given.  ``n_pad`` /
    ``e_pad`` default to the dataset maxima rounded up to ``pad_multiple``
    (atoms) and with 12.5% headroom rounded up to 64 (edges).

    Returns a list of frame dicts: positions (N_pad, 3), types (N_pad,)
    int64, edge_index (2, E_pad) int64, cell (3, 3) or None, edge_shifts
    (E_pad, 3), edge_mask (E_pad,), atom_mask (N_pad,), n_atoms (),
    forces (N_pad, 3), energy () and, where the file has it, virial (3, 3).
    """
    dev = resolve_device(device)
    mapper = TypeMapper(type_names)
    raw = read_extxyz(path)
    if not raw:
        raise ValueError(f"no frames in {path}")

    parsed = []
    for fi, fr in enumerate(raw):
        pos = np.asarray(fr["positions"], np.float64)
        cell = fr.get("cell")
        pbc = tuple(bool(b) for b in fr.get("pbc", (False,) * 3))
        types = mapper.map_names(list(fr["symbols"]))
        ei, sh = neighbor_list_np(
            pos,
            None if cell is None else np.asarray(cell, np.float64),
            pbc,
            r_max,
            types=types if cutoff_matrix is not None else None,
            cutoff_matrix=cutoff_matrix,
        )
        info = fr.get("info", {})
        if energy_key not in info:
            raise KeyError(f"frame {fi} of {path}: missing '{energy_key}=' in the comment line "
                           f"(keys: {sorted(info)})")
        if forces_key not in fr:
            raise KeyError(f"frame {fi} of {path}: no '{forces_key}' per-atom column "
                           f"(Properties gave: {sorted(k for k in fr if k != 'info')})")
        rec = {"pos": pos, "cell": cell, "types": types, "ei": ei, "sh": sh,
               "energy": float(info[energy_key]),
               "forces": np.asarray(fr[forces_key], np.float64)}
        if virial_key in info:
            v = np.array(str(info[virial_key]).split(), dtype=np.float64)
            if v.size != 9:
                raise ValueError(f"frame {fi}: '{virial_key}=' has {v.size} components, want 9")
            rec["virial"] = v.reshape(3, 3)
        parsed.append(rec)

    max_n = max(r["pos"].shape[0] for r in parsed)
    max_e = max(r["ei"].shape[1] for r in parsed)
    n_pad = n_pad if n_pad is not None else _round_up(max_n, pad_multiple)
    e_pad = e_pad if e_pad is not None else _round_up(max(max_e + max_e // 8, 1), 64)
    if n_pad < max_n:
        raise ValueError(f"n_pad {n_pad} < largest frame ({max_n} atoms)")
    if e_pad < max_e:
        raise ValueError(f"e_pad {e_pad} < largest edge count ({max_e})")

    def real(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)

    def index(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    frames = []
    for rec in parsed:
        n = rec["pos"].shape[0]
        pos = np.zeros((n_pad, 3))
        pos[:n] = rec["pos"]
        types = np.zeros((n_pad,), np.int64)
        types[:n] = rec["types"]
        amask = np.zeros((n_pad,), bool)
        amask[:n] = True
        forces = np.zeros((n_pad, 3))
        forces[:n] = rec["forces"]
        ei, sh, emask = pad_edges(rec["ei"], rec["sh"], e_pad)
        cell = rec["cell"]
        frame = {
            "positions": real(pos),
            "types": index(types),
            "edge_index": index(ei),
            "cell": None if cell is None else real(cell),
            "edge_shifts": real(sh),
            "edge_mask": torch.as_tensor(emask, device=dev),
            "atom_mask": torch.as_tensor(amask, device=dev),
            "n_atoms": torch.tensor(n, dtype=torch.int64, device=dev),
            "forces": real(forces),
            "energy": real(rec["energy"]),
        }
        if "virial" in rec:
            frame["virial"] = real(rec["virial"])
        frames.append(frame)

    # one batch shape needs one cell presence, as the engines require
    has_cell = [f["cell"] is not None for f in frames]
    if any(has_cell) and not all(has_cell):
        raise ValueError("dataset mixes periodic and open frames")
    return frames


def stack_frames(frames: list[dict]) -> dict:
    """One frame dict whose every tensor has a leading batch axis (B, ...);
    a ``None`` cell (open boundaries) stays None."""
    if not frames:
        raise ValueError("empty frame list")
    keys = frames[0].keys()
    for f in frames[1:]:
        if f.keys() != keys:
            raise ValueError("frames disagree on keys; pad/load them together")
    out = {}
    for k in keys:
        vals = [f[k] for f in frames]
        out[k] = None if vals[0] is None else torch.stack(vals)
    return out
