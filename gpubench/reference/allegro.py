"""Plain Allegro: energies and forces of a periodic box, on the
reference's own edge list, in blocks of centers.

A frozen, channels-last copy of the model's plain path (Musaelian et al.,
"Learning local equivariant representations for large-scale atomistic
dynamics", Nat. Commun. 14, 579 (2023)), in the parameter layout the
harness makes (``gpubench/families/allegro.py``):

  x0   = MLP_2b([onehot(t_i); onehot(t_j); B(r) u(r)]) u(r)      (E, ns)
  V0   = (x0 W_embed / sqrt(ns)) (x) Y(r_hat)                     (E, C, D)
  per layer:  w = x W_env / sqrt(ns) u;  env_i = sum_j w (x) Y / sqrt(avg)
              T = V (x) env_i  (channelwise, paths with l1 + l2 + l3 even)
              V = mix(T);  x = (x + MLP_latent([x; T_l3=0]) u) / sqrt(2)
  E_i  = scale[t_i] sum_j MLP_out(x) u + shift[t_i]

Allegro is strictly local, so each block of centers is one energy whose
position gradient is summed into the forces; memory stays one block's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference.neighbors import box_lengths, pairs
from gpubench.reference.so3 import paths_to_l, spherical_harmonics, uniform_tp

SILU_NORM = 1.6790564307512243  # 1 / sqrt(E[silu(x)^2]), x ~ N(0, 1)


def mlp(ws, x):
    """Bias-free MLP, each layer scaled by 1/sqrt(fan_in), normalised SiLU
    between layers."""
    for n, w in enumerate(ws):
        x = (x @ w) * (1.0 / math.sqrt(w.shape[0]))
        if n < len(ws) - 1:
            x = F.silu(x) * SILU_NORM
    return x


def readout(ws, x):
    """:func:`mlp` and the magnitude of its last sum, (|h| @ |w|) / sqrt(fan_in)
    over that layer's input h: the scale of the output's rounding, which a
    sum that cancels does not shrink."""
    h = F.silu(mlp(ws[:-1], x)) * SILU_NORM if len(ws) > 1 else x
    s = 1.0 / math.sqrt(ws[-1].shape[0])
    return (h @ ws[-1]) * s, (h.abs() @ ws[-1].abs()) * s


def bessel(r, r_max: float, n: int):
    k = torch.arange(1, n + 1, dtype=r.dtype, device=r.device)
    return math.sqrt(2.0 / r_max) * torch.sin(k * (math.pi / r_max) * r[:, None]) / r[:, None]


def envelope(r, r_max: float, p: int):
    x = torch.clamp(r / r_max, 0.0, 1.0)
    xp = x ** p
    u = 1.0 - 0.5 * (p + 1.0) * (p + 2.0) * xp + p * (p + 2.0) * xp * x \
        - 0.5 * p * (p + 1.0) * xp * x * x
    return torch.where(r < r_max, u, torch.zeros_like(u))


def block_energy(tree, m: dict, pos, types, i, j, image, L, n_centers: int, c0: int):
    """Energies of the centers [c0, c0 + n_centers) from their edges (i in
    that range, j any atom): (n_centers,) atomic energies, and their
    magnitudes (:func:`readout`'s, summed like the energies)."""
    nt = len(m["type_names"])
    lmax, parity = m["l_max"], m["parity"]
    ns = m["num_scalar_features"]
    vec = pos[j] - pos[i] - image * L
    r = torch.linalg.vector_norm(vec, dim=-1)
    u = envelope(r, m["r_max"], m["polynomial_cutoff_p"])
    Y = spherical_harmonics(vec, lmax)
    oh = torch.eye(nt, dtype=pos.dtype, device=pos.device)
    x = mlp(tree["two_body_mlp"]["w"], torch.cat(
        [oh[types[i]], oh[types[j]], bessel(r, m["r_max"], m["num_bessels"]) * u[:, None]], -1))
    x = x * u[:, None]
    V = ((x @ tree["tensor_embed"]) * (1.0 / math.sqrt(ns)))[:, :, None] * Y[:, None, :]
    il = i - c0
    inv_avg = 1.0 / math.sqrt(m["avg_num_neighbors"])

    def segsum(a):
        return torch.zeros((n_centers, *a.shape[1:]), dtype=a.dtype,
                           device=a.device).index_add(0, il, a)

    for layer in tree["layers"]:
        w = (x @ layer["env_weight"]) * (1.0 / math.sqrt(ns)) * u[:, None]
        env = segsum(w[:, :, None] * Y[:, None, :]) * inv_avg
        T = uniform_tp(V, env[il], lmax, parity)
        inv = T[0][..., 0].reshape(x.shape[0], -1)
        pieces = []
        for l3, t in enumerate(T):
            c_in, p = t.shape[-3], t.shape[-2]
            t = torch.movedim(t, -1, -3).reshape(*t.shape[:-3], 2 * l3 + 1, c_in * p)
            pieces.append(torch.movedim((t @ layer["mix"][f"l{l3}"]) * (1.0 / math.sqrt(c_in * p)),
                                        -1, -2))
        V = torch.cat(pieces, dim=-1)
        x = (x + mlp(layer["latent_mlp"]["w"], torch.cat([x, inv], -1)) * u[:, None]) \
            * (1.0 / math.sqrt(2.0))
    e_edge, mag = readout(tree["readout_mlp"]["w"], x)
    tc = types[c0:c0 + n_centers]
    scale = tree["per_type_scale"][tc]
    return (scale * segsum(e_edge[:, 0] * u) + tree["per_type_shift"][tc],
            scale.abs() * segsum(mag[:, 0] * u))


def energy_forces(tree, m: dict, positions, types, cell, pbc=(True, True, True),
                  block: int = 2048) -> dict:
    """'total_energy' (), 'atomic_energy' (N,), 'energy_scale' (N,) (each
    energy's magnitude, :func:`block_energy`) and 'forces' (N, 3) of the
    box, the edges found by :func:`neighbors.pairs` at r_max."""
    L = box_lengths(cell)
    i_all, j_all, im_all = pairs(positions, cell, m["r_max"], pbc)
    n = positions.shape[0]
    pos = positions.detach().requires_grad_(True)
    forces = torch.zeros_like(positions)
    e_atom = torch.empty(n, dtype=positions.dtype, device=positions.device)
    e_scale = torch.empty_like(e_atom)
    starts = torch.searchsorted(i_all, torch.arange(0, n + block, block, device=i_all.device))
    for b, c0 in enumerate(range(0, n, block)):
        a, z = int(starts[b]), int(starts[b + 1])
        nc = min(block, n - c0)
        with torch.enable_grad():
            e, mag = block_energy(tree, m, pos, types, i_all[a:z], j_all[a:z], im_all[a:z], L,
                                  nc, c0)
            (g,) = torch.autograd.grad(e.sum(), pos)
        forces -= g
        e_atom[c0:c0 + nc] = e.detach()
        e_scale[c0:c0 + nc] = mag.detach()
    return {"total_energy": e_atom.sum(), "atomic_energy": e_atom, "energy_scale": e_scale,
            "forces": forces}


def parity_paths(lmax: int, parity: bool) -> list[int]:
    """Paths per l3 (the mix weights' rows are C * P_l3)."""
    return [len(paths_to_l(lmax, lmax, l3, parity)) for l3 in range(lmax + 1)]
