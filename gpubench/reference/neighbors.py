"""The reference's own neighbor list: every ordered pair (i, j), i != j,
closer than the cutoff under the minimum image of an orthorhombic box,
periodic along the sides that ``pbc`` names and open along the others,
found by brute force over blocks of centers.  Plain PyTorch; no skin, no
capacity, no padding."""

from __future__ import annotations

import torch


def box_lengths(cell: torch.Tensor) -> torch.Tensor:
    """The (3,) side lengths of an orthorhombic cell; anything else raises."""
    off = cell - torch.diag(torch.diagonal(cell))
    if bool(off.abs().max() > 0):
        raise ValueError("the reference takes orthorhombic cells only")
    return torch.diagonal(cell).clone()


def pairs(positions: torch.Tensor, cell: torch.Tensor, cutoff: float, pbc=(True, True, True),
          block: int = 2048):
    """(i, j, image) of every ordered pair within ``cutoff``, in order of i:
    the edge vector is positions[j] - positions[i] - image * L, the image 0
    along an open side.  The minimum image is unique because every periodic
    side is longer than twice the cutoff (checked)."""
    L = box_lengths(cell)
    periodic = torch.tensor([bool(p) for p in pbc], device=positions.device)
    if bool(((L <= 2.0 * cutoff) & periodic).any()):
        raise ValueError(f"periodic box sides {L.tolist()} not longer than twice the cutoff "
                         f"{cutoff}")
    n = positions.shape[0]
    pos = positions.detach()
    out_i, out_j, out_im = [], [], []
    for a in range(0, n, block):
        b = min(n, a + block)
        d = pos[None, :, :] - pos[a:b, None, :]
        image = torch.where(periodic, torch.round(d / L), 0.0)
        d = d - image * L
        r2 = (d * d).sum(-1)
        hit = r2 < cutoff * cutoff
        hit[torch.arange(b - a, device=pos.device), torch.arange(a, b, device=pos.device)] = False
        i, j = hit.nonzero(as_tuple=True)
        out_i.append(i + a)
        out_j.append(j)
        out_im.append(image[i, j])
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_im)
