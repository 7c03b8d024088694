"""An episode's start velocities as the MD driver's contract states them:
Maxwell-Boltzmann at ``temp_K`` from a ``torch.Generator`` seeded with the
episode's seed on the system's device (one standard-normal draw of shape
(N, 3) in the masses' dtype), the centre-of-mass drift removed, and the
whole rescaled to exactly ``temp_K`` over 3N - 3 degrees of freedom, in
LAMMPS metal units (A / ps)."""

from __future__ import annotations

import torch

KB = 8.617333262e-5  # eV / K
MVV2E = 1.0364269574711572e-4  # amu A^2 / ps^2 -> eV


def velocities(masses: torch.Tensor, temp_K: float, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=masses.device).manual_seed(seed)
    v = torch.randn((masses.shape[0], 3), generator=gen, dtype=masses.dtype, device=masses.device)
    v = v * torch.sqrt(KB * temp_K / (masses * MVV2E))[:, None]
    m = masses[:, None]
    v = v - (m * v).sum(0) / masses.sum()
    t_now = (MVV2E * (m * v * v).sum()) / ((3.0 * masses.shape[0] - 3.0) * KB)
    return v * torch.sqrt(temp_K / t_now)
