"""The comparison that decides ``correct``: states the timed path produced,
against the plain reference one MD step at a time.

At each check point s of an episode the program left (x, v, F, e) at steps
s - 1 and s, and at the episode's start.  The reference, in plain f32 with
TF32 off, computes the forces and per-atom energies at x_{s-1}, takes one
velocity-Verlet step from (x_{s-1}, v_{s-1}) with them, and computes them
at its own x_s; it also computes them at the start lattice, and draws the
start velocities itself (``reference/start.py``).  Three numbers, each the
largest over the check points:

* ``force_gap``: max |F - F_ref| / max |F_ref| at the start, at s - 1 and
  at s (the neighbor build, the edge geometry, every layer, the readout
  and the force backward; at s also the drift of the step);
* ``energy_gap``: max_i |e_i - e_ref,i| / max_i m_ref,i, the per-atom
  energies, at the same three states, over the reference's magnitude of
  each energy m_i (its readout's last sum taken over absolute values,
  ``reference.allegro.readout``): the scale of the rounding.  Over
  max |e_ref| the number swings by seed, since on a near-perfect lattice
  every atom's energy is about one value, which some weights draw near 0
  (kept as ``energy_gap_peak``, read and not compared).  The total's gap
  does not tell the TF32 control from a sound run: its rounding cancels
  in the sum;
* ``kick_gap``: max |v_s - v_ref,s| and max |v_0 - v_ref,0|, over the
  largest half kick 0.5 dt max |F_ref / m| at s (the integrator's velocity
  update, and the start velocities).

The control is the reference at the next precision down, TF32 products,
put in the program's place: its own step from the same (x_{s-1}, v_{s-1}).
"""

from __future__ import annotations

import contextlib
import math

import torch

MVV2E = 1.0364269574711572e-4  # LAMMPS metal units: amu A^2 / ps^2 -> eV
FTM2A = 1.0 / MVV2E  # eV / A / amu -> A / ps^2
NUMBERS = ("force_gap", "energy_gap", "kick_gap")
READ = NUMBERS + ("energy_gap_peak",)  # and read, not compared


@contextlib.contextmanager
def tf32(on: bool):
    """Matmul and convolution TF32 on or off inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def verlet_step(energy_forces, x_prev, v_prev, masses, dt: float):
    """(outputs at x_prev, x, outputs at x, v) of one velocity-Verlet step
    of ``energy_forces(x) -> {'forces', 'total_energy', 'atomic_energy'}``."""
    inv_m = (FTM2A / masses)[:, None]
    prev = energy_forces(x_prev)
    v_half = v_prev + (0.5 * dt) * prev["forces"] * inv_m
    x = x_prev + dt * v_half
    out = energy_forces(x)
    return prev, x, out, v_half + (0.5 * dt) * out["forces"] * inv_m


def _rel(a, b, scale) -> float:
    gap = float((a - b).abs().max())
    return gap / float(scale) if math.isfinite(gap) else math.inf


def gaps(point: dict, ref: tuple, start: tuple, masses, dt: float) -> dict:
    """The three numbers of one check point: ``point`` holds the program's
    'F_prev', 'e_prev', 'F', 'e', 'v' (forces and per-atom energies at s - 1
    and s, velocities at s) and 'F0', 'e0', 'v0' (at the start), ``ref`` is
    :func:`verlet_step`'s result, ``start`` the reference's (outputs,
    velocities) at the start."""
    r_prev, _, r, v_ref = ref
    r0, v0_ref = start
    force = max(_rel(point[f], o["forces"], o["forces"].abs().max())
                for f, o in (("F0", r0), ("F_prev", r_prev), ("F", r)))
    states = (("e0", r0), ("e_prev", r_prev), ("e", r))
    energy = max(_rel(point[e], o["atomic_energy"], o["energy_scale"].max()) for e, o in states)
    peak = max(_rel(point[e], o["atomic_energy"], o["atomic_energy"].abs().max())
               for e, o in states)
    half_kick = 0.5 * dt * (r["forces"] * (FTM2A / masses)[:, None]).abs().max()
    kick = max(_rel(point["v"], v_ref, half_kick), _rel(point["v0"], v0_ref, half_kick))
    return {"force_gap": force, "energy_gap": energy, "kick_gap": kick, "energy_gap_peak": peak}


def compare(points: list, energy_forces, masses, dt: float, control: bool = False) -> dict:
    """The numbers ``READ`` over the check points (each the largest); with
    ``control`` the program's outputs are replaced by the reference's own
    step at TF32."""
    from gpubench.reference.start import velocities

    worst = dict.fromkeys(READ, 0.0)
    at_start = {}  # the start lattice is every episode's: one evaluation
    for p in points:
        with tf32(False):
            ref = verlet_step(energy_forces, p["x_prev"], p["v_prev"], masses, dt)
            if "ref" not in at_start:
                at_start["ref"] = energy_forces(p["x0"])
        start = (at_start["ref"], velocities(masses, p["start"][1], p["start"][0]))
        if control:
            with tf32(True):
                c_prev, _, c, c_v = verlet_step(energy_forces, p["x_prev"], p["v_prev"], masses, dt)
                if "control" not in at_start:
                    at_start["control"] = energy_forces(p["x0"])
            c0 = at_start["control"]
            p = {"F_prev": c_prev["forces"], "e_prev": c_prev["atomic_energy"], "F": c["forces"],
                 "e": c["atomic_energy"], "v": c_v, "F0": c0["forces"], "e0": c0["atomic_energy"],
                 "v0": start[1]}
        for k, g in gaps(p, ref, start, masses, dt).items():
            worst[k] = max(worst[k], g)
        del ref
    return worst
