"""Named model outputs as computes (counterpart of
``pair_allegro_tpu/computes.py``): the ``compute allegro`` (a global,
extensive vector: rows summed) and ``compute allegro/atom`` (per-atom rows,
padded atoms zeroed) analogs.  A model surfaces such an output as an extra
entry of its energy dict; ``make_potential`` passes it on as
``ModelOutputs.extras`` and the MD state keeps it as ``extras``."""

from __future__ import annotations

import dataclasses

import torch


def _extra(outputs, quantity: str) -> torch.Tensor:
    try:
        return torch.as_tensor(outputs.extras[quantity])
    except KeyError:
        raise KeyError(
            f"Model did not emit custom output '{quantity}' (available: {sorted(outputs.extras)})"
        ) from None


@dataclasses.dataclass
class GlobalCompute:
    """An extensive global vector from a named extra of shape (N_rows,
    length) or (length,): the rows are summed."""

    quantity: str
    length: int

    def __call__(self, outputs, system=None) -> torch.Tensor:
        t = _extra(outputs, self.quantity)
        if t.ndim == 1 and t.shape[0] == self.length:
            return t
        flat = t.reshape(-1, t.shape[-1]) if t.ndim > 1 else t.reshape(-1, 1)
        if flat.shape[-1] != self.length:
            raise ValueError(
                f"compute {self.quantity}: expected length {self.length}, model gave trailing "
                f"dim {flat.shape[-1]}"
            )
        return torch.sum(flat, dim=0)


@dataclasses.dataclass
class PerAtomCompute:
    """A per-atom (N, ncols) array from a named extra, padded atoms zeroed."""

    quantity: str
    ncols: int

    def __call__(self, outputs, system) -> torch.Tensor:
        t = _extra(outputs, self.quantity)
        n = system.n_atoms
        if t.shape[0] != n:
            raise ValueError(
                f"compute {self.quantity}/atom: leading dim {t.shape[0]} != n_atoms {n}")
        t = t.reshape(n, -1)
        if t.shape[1] != self.ncols:
            raise ValueError(
                f"compute {self.quantity}/atom: expected {self.ncols} columns, got {t.shape[1]}")
        return t * system.valid_mask().to(t.dtype)[:, None]
