"""Plain NequIP: energies and forces of a periodic box on the reference's
own edge list.

A frozen, channels-first copy of the model's generic plain path (Batzner et
al., "E(3)-equivariant graph neural networks for data-efficient and accurate
interatomic potentials", Nat. Commun. 13, 2453 (2022)), in the parameter
layout the harness makes (``gpubench/families/nequip.py``).  Node features
h (N, C, D, T): D = (l_max + 1)^2, T tracks (two with parity, even and odd).
Per layer:

  w_ij  = MLP_radial(B(r) u(r)) u(r)                          (E, C, T, P)
  m_i   = sum_j sum_paths w_ij (h_j (x) Y(r_hat)) / sqrt(avg)  routed to
          track tau = pi XOR (l2 mod 2)
  h_i'  = gate(self_connection(h_i, t_i) + mix(m_i)) / sqrt(C)

and E_i = scale[t_i] MLP_out(h_i[l = 0, even]) + shift[t_i].  Message
passing reaches num_layers hops, so the whole box is one graph; each layer
is a ``torch.utils.checkpoint``, so the backward holds one layer's
activations at a time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference.allegro import SILU_NORM, bessel, envelope, mlp, readout
from gpubench.reference.neighbors import box_lengths, pairs
from gpubench.reference.so3 import paths_to_l, sh_slice, spherical_harmonics, uniform_tp

TANH_NORM = 1.5926  # 1 / sqrt(E[tanh(x)^2]), x ~ N(0, 1)


def n_paths(lmax: int) -> int:
    """Paths of the message's product over every l3 (no parity filter)."""
    return sum(len(paths_to_l(lmax, lmax, l3)) for l3 in range(lmax + 1))


def message(hj, Y, w, lmax: int):
    """hj (E, C, D, T), Y (E, D), w (E, C, T, P) -> (E, C, D, T)."""
    T = hj.shape[-1]
    tp = [uniform_tp(hj[..., pi], Y, lmax) for pi in range(T)]
    tracks = [[] for _ in range(T)]
    p_off = 0
    for l3 in range(lmax + 1):
        paths = paths_to_l(lmax, lmax, l3)
        for tau in range(T):
            # (source track, path) pairs landing on tau
            contribs = [(pi, p) for p, (_, l2) in enumerate(paths) for pi in range(T)
                        if (pi ^ (l2 % 2) if T == 2 else 0) == tau]
            acc = None
            for pi in range(T):
                sel = [p for q, p in contribs if q == pi]
                if not sel:
                    continue
                term = torch.einsum("ecpk,ecp->eck", tp[pi][l3][:, :, sel, :],
                                    w[:, :, pi, [p_off + p for p in sel]])
                acc = term if acc is None else acc + term
            tracks[tau].append(acc * (1.0 / math.sqrt(max(len(contribs), 1))))
        p_off += len(paths)
    return torch.stack([torch.cat(blocks, dim=-1) for blocks in tracks], dim=-1)


def layer_step(layer, m: dict, h, types, i, j, Y, radial_in, u):
    """One interaction block: h (N, C, D, T) -> (N, C, D, T)."""
    n, C, _, T = h.shape
    lmax = m["l_max"]
    w = mlp(layer["radial_mlp"]["w"], radial_in) * u[:, None]
    w = w.reshape(w.shape[0], C, T, -1)
    msg = message(h[j], Y, w, lmax)
    agg = torch.zeros_like(h).index_add(0, i, msg) * (1.0 / math.sqrt(m["avg_num_neighbors"]))
    keys = (("self_w", "mix_w"), ("self_w_o", "mix_w_o"))[:T]
    new = []
    for tau, (sw, mw) in enumerate(keys):
        blocks = []
        for l3 in range(lmax + 1):
            sl = sh_slice(l3)
            # species-dependent self-connection, one (C, C) matrix per type
            sc = torch.einsum("ncd,nce->ned", h[:, :, sl, tau], layer[sw][l3][types])
            mixed = torch.einsum("ncd,ce->ned", agg[:, :, sl, tau], layer[mw][l3])
            blocks.append((sc + mixed) * (1.0 / math.sqrt(C)))
        new.append(blocks)
    act_even = F.silu(new[0][0][:, :, 0]) * SILU_NORM
    gates = torch.sigmoid((act_even @ layer["gate_w"]) * (1.0 / math.sqrt(C)))
    gates = gates.reshape(n, C, lmax, T)
    tracks = []
    for tau in range(T):
        s = act_even if tau == 0 else torch.tanh(new[1][0][:, :, 0]) * TANH_NORM
        parts = [s[:, :, None]] + [new[tau][l3] * gates[:, :, l3 - 1:l3, tau]
                                   for l3 in range(1, lmax + 1)]
        tracks.append(torch.cat(parts, dim=2))
    return torch.stack(tracks, dim=3)


def energy_forces(tree, m: dict, positions, types, cell, pbc=(True, True, True)) -> dict:
    """'total_energy' (), 'atomic_energy' (N,), 'energy_scale' (N,) (each
    energy's magnitude, ``allegro.readout``'s) and 'forces' (N, 3) of the
    box, the edges found by :func:`neighbors.pairs` at r_max."""
    L = box_lengths(cell)
    i, j, image = pairs(positions, cell, m["r_max"], pbc)
    n = positions.shape[0]
    lmax, C = m["l_max"], m["num_features"]
    T = 2 if m["parity"] else 1
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        vec = pos[j] - pos[i] - image * L
        r = torch.linalg.vector_norm(vec, dim=-1)
        u = envelope(r, m["r_max"], m["polynomial_cutoff_p"])
        Y = spherical_harmonics(vec, lmax)
        radial_in = bessel(r, m["r_max"], m["num_bessels"]) * u[:, None]
        h = torch.zeros((n, C, (lmax + 1) ** 2, T), dtype=positions.dtype,
                        device=positions.device)
        h[:, :, 0, 0] = tree["chem_embed"][types]
        for layer in tree["layers"]:
            h = checkpoint(layer_step, layer, m, h, types, i, j, Y, radial_in, u,
                           use_reentrant=False)
        e_atom, mag = readout(tree["readout_mlp"]["w"], h[:, :, 0, 0])
        scale = tree["per_type_scale"][types]
        e_atom = scale * e_atom[:, 0] + tree["per_type_shift"][types]
        (g,) = torch.autograd.grad(e_atom.sum(), pos)
    e_atom = e_atom.detach()
    return {"total_energy": e_atom.sum(), "atomic_energy": e_atom,
            "energy_scale": (scale.abs() * mag[:, 0]).detach(), "forces": -g}
