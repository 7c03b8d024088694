"""Energies -> forces / virial by autograd (counterpart of
``pair_allegro_tpu/potential.py``).

  forces = -dE/d(positions)
  virial W = -dE/d(strain), symmetrised (stress = -W/V)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from pair_allegro_tpu_torch import tracing
from pair_allegro_tpu_torch.ops import prec


@dataclasses.dataclass
class ModelOutputs:
    """total_energy (), atomic_energy (N,), forces (N, 3), virial (3, 3), and
    the model's other outputs by name."""

    total_energy: torch.Tensor
    atomic_energy: torch.Tensor
    forces: torch.Tensor
    virial: torch.Tensor
    extras: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def make_potential(energy_fn: Callable[..., dict],
                   create_graph: bool = False) -> Callable[..., ModelOutputs]:
    """Wrap ``energy_fn(positions, types, edge_index, cell=, edge_shifts=,
    atom_mask=, edge_mask=, **kw) -> dict`` (with 'total_energy' and
    'atomic_energy') into a potential returning detached ModelOutputs.

    With ``create_graph`` the outputs keep their graph instead: forces and
    virial are differentiable again, so a loss can take the weights'
    gradient of -dE/dr (training, ``train.make_loss_fn``).

    The whole evaluation, forward and backward, runs in one
    ``prec.glue_scope``: the glue's products take the matmul precision
    policy's (TF32 on the card under 'high' and 'default'), their backward
    too, which autograd runs after each forward product has returned.  The
    strain's products stay exact f32 (``prec.exact_mm``), as JAX pins them
    at "highest"."""

    def potential(positions, types, edge_index, *, cell=None, edge_shifts=None,
                  atom_mask=None, edge_mask=None, compute_virial: bool = True,
                  **kw: Any) -> ModelOutputs:
        dtype, dev = positions.dtype, positions.device
        with torch.enable_grad(), prec.glue_scope():
            with tracing.span("force.forward"):
                pos = positions.detach().requires_grad_(True)
                strain = torch.zeros((3, 3), dtype=dtype, device=dev,
                                     requires_grad=compute_virial)
                defm = torch.eye(3, dtype=dtype, device=dev) + strain
                out = energy_fn(
                    prec.exact_mm(pos, defm), types, edge_index,
                    cell=None if cell is None else prec.exact_mm(cell, defm),
                    edge_shifts=edge_shifts, atom_mask=atom_mask, edge_mask=edge_mask, **kw,
                )
            inputs = [pos, strain] if compute_virial else [pos]
            with tracing.span("force.backward"):
                grads = torch.autograd.grad(out["total_energy"], inputs,
                                            create_graph=create_graph)
        if compute_virial:
            virial = -0.5 * (grads[1] + grads[1].T)
        else:
            virial = torch.zeros((3, 3), dtype=dtype, device=dev)

        def keep(t):
            return t if create_graph else t.detach()

        extras = {
            k: keep(v) for k, v in out.items() if k not in ("total_energy", "atomic_energy")
        }
        return ModelOutputs(
            total_energy=keep(out["total_energy"]),
            atomic_energy=keep(out["atomic_energy"]),
            forces=-grads[0],
            virial=virial,
            extras=extras,
        )

    return potential


def virial_to_voigt(virial: torch.Tensor) -> torch.Tensor:
    """3x3 virial -> LAMMPS 6-vector [xx, yy, zz, xy, xz, yz]."""
    return torch.stack(
        [virial[0, 0], virial[1, 1], virial[2, 2], virial[0, 1], virial[0, 2], virial[1, 2]]
    )
