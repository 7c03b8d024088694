"""Thermodynamic observables (counterpart of ``pair_allegro_tpu/md/thermo.py``).

* temperature: T = 2 KE / (n_dof kB), n_dof = 3 N - 3, KE = 0.5 sum m v^2 * mvv2e
* pressure tensor: P = (sum m v (x) v * mvv2e + W) / V * nktv2p   [bar]
"""

from __future__ import annotations

import torch

from pair_allegro_tpu_torch.io.dump import host
from pair_allegro_tpu_torch.ops.geometry import volume
from pair_allegro_tpu_torch.system import Units


def kinetic_energy(system):
    m = system.masses * system.valid_mask().to(system.masses.dtype)
    return 0.5 * Units.mvv2e * torch.sum(m[:, None] * system.velocities**2)


def n_dof(system):
    """3N - 3: the COM momentum is conserved (LAMMPS ``compute temp``)."""
    return torch.clamp_min(3.0 * system.n_valid.to(system.masses.dtype) - 3.0, 1.0)


def temperature(system):
    return 2.0 * kinetic_energy(system) / (n_dof(system) * Units.kB)


def nose_hoover_conserved(state, temp_K: float, tdamp: float):
    """The Nosé-Hoover extended Hamiltonian H' = KE + PE + q xi^2 / 2 +
    n_dof kB T xi_int, conserved by the 'nvt' integrator to splitting
    order (its drift detects thermostat faults)."""
    ndof = n_dof(state.system)
    q = ndof * Units.kB * temp_K * tdamp**2
    xi = state.thermostat["xi"]
    eta = state.thermostat["xi_int"]
    ke = kinetic_energy(state.system)
    return ke + state.potential_energy + 0.5 * q * xi * xi + ndof * Units.kB * temp_K * eta


def npt_mtk_conserved(state, temp_K: float, tdamp: float, press_bar: float, pdamp: float):
    """The MTK NPT invariant H' = KE + PE + q xi^2 / 2 + W eta^2 / 2 +
    (n_dof + 1) kB T xi_int + P_ext V (isotropic, one chain)."""
    ndof = n_dof(state.system)
    kT = Units.kB * temp_K
    q = ndof * kT * tdamp**2
    w = (ndof + 3.0) * kT * pdamp**2
    xi = state.thermostat["xi"]
    eta = state.thermostat["eta"]
    eta_i = state.thermostat["xi_int"]
    vol = volume(state.system.cell)
    p_ext = press_bar / Units.nktv2p
    ke = kinetic_energy(state.system)
    return (ke + state.potential_energy + 0.5 * q * xi * xi + 0.5 * w * eta * eta
            + (ndof + 1.0) * kT * eta_i + p_ext * vol)


def pressure_tensor(system, virial):
    """(3, 3) pressure tensor in bar (potential virial + kinetic term)."""
    m = system.masses * system.valid_mask().to(system.masses.dtype)
    v = system.velocities
    kin = Units.mvv2e * torch.einsum("n,ni,nj->ij", m, v, v)
    return (kin + virial) / volume(system.cell) * Units.nktv2p


def thermo_row(state) -> dict:
    """One row of thermo output from an MDState, as host numbers."""
    sys_ = state.system
    ke = kinetic_energy(sys_)
    press = pressure_tensor(sys_, state.virial)
    dev_vals = {
        "pe": state.potential_energy,
        "ke": ke,
        "etotal": state.potential_energy + ke,
        "temp": temperature(sys_),
        "press": torch.trace(press) / 3.0,
        "n_edges": state.neighbors.count(),
        "overflow": state.overflow,
    }
    # one device -> host transfer for the whole row
    vec = host(torch.cat(
        [torch.stack([v.to(torch.float64).reshape(()) for v in dev_vals.values()]),
         press.reshape(9).to(torch.float64)]
    ))
    row = {"step": int(state.step)}
    row.update({k: float(x) for k, x in zip(dev_vals, vec)})
    row["n_edges"] = int(row["n_edges"])
    row["overflow"] = bool(row["overflow"])
    row["press_tensor"] = vec[len(dev_vals):].reshape(3, 3)
    return row
