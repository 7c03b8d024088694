"""Force/energy-matching training (counterpart of ``pair_allegro_tpu/train.py``).

Losses are differentiable in the parameter tree through the plain path:
train with ``cfg.for_training()``, as in JAX.  The kernel tiers hand back
NaN weight cotangents by design (MD forces never need them), so a tree
trained through a kernel comes back NaN; the plain path launches no kernel.
Force matching is the mixed second derivative d/dtheta[-dE/dr]: the
potential's position gradient is taken with ``create_graph`` and the loss
is differentiated again.  The tree is the same for the training and the
kernel configs: train here, then hand ``detached(params)`` to the engines
or to ``checkpoint.save_params``.

Typical flow::

    tcfg = cfg.for_training()
    loss_fn = make_loss_fn(allegro_energy, tcfg)
    step = make_train_step(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3))
    state = step.init(params)
    for frame in frames:                     # one padded shape (data.load_frames)
        params, state, metrics = step.update(params, state, frame)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from pair_allegro_tpu_torch.potential import make_potential

# A training frame (data.load_frames): positions (N, 3), types (N,),
# edge_index (2, E) or (N, K), forces (N, 3) and energy () targets;
# optionally cell (3, 3), edge_shifts, atom_mask (N,), edge_mask, virial.
Frame = dict[str, Any]


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in the tree's order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def detached(params):
    """The tree with every leaf detached (views of the same storage, which
    see later in-place updates).  Hand this to the engines and to
    ``save_params``: a leaf that requires grad makes every MD force
    evaluation build the weights' graph too."""
    return tree_map(lambda t: t.detach(), params)


def make_loss_fn(
    energy_fn: Callable[..., dict],
    cfg,
    w_energy: float = 1.0,
    w_force: float = 1.0,
    w_virial: float = 0.0,
    per_atom_energy: bool = True,
    create_graph: bool = True,
) -> Callable[[dict, Frame], tuple[torch.Tensor, dict]]:
    """``loss(params, frame) -> (scalar, metrics)``: w_energy * the squared
    energy error (per atom by default) + w_force * MSE(forces) over the
    atoms of ``atom_mask``, and with ``w_virial > 0`` the per-atom
    normalised MSE of the (3, 3) virial.  Metrics: loss, loss_energy,
    loss_force, rmse_f, mae_e_per_atom (+ loss_virial).

    ``create_graph=False`` evaluates without the weights' gradient
    (validation): the forces keep no graph, so each frame's graph is freed
    as soon as its forces are taken."""

    def loss_fn(params, frame: Frame):
        pot = make_potential(lambda *a, **k: energy_fn(params, cfg, *a, **k),
                             create_graph=create_graph)
        out = pot(
            frame["positions"],
            frame["types"],
            frame["edge_index"],
            cell=frame.get("cell"),
            edge_shifts=frame.get("edge_shifts"),
            atom_mask=frame.get("atom_mask"),
            edge_mask=frame.get("edge_mask"),
            compute_virial=w_virial > 0.0,
        )
        amask = frame.get("atom_mask")
        if amask is None:
            n = torch.tensor(frame["positions"].shape[0], dtype=out.forces.dtype,
                             device=out.forces.device)
            f_err2 = (out.forces - frame["forces"]) ** 2
        else:
            w = amask.to(out.forces.dtype)
            n = torch.sum(w)
            f_err2 = ((out.forces - frame["forces"]) ** 2) * w[:, None]
        loss_f = torch.sum(f_err2) / (3.0 * n)
        e_err = out.total_energy - frame["energy"]
        if per_atom_energy:
            e_err = e_err / n
        loss_e = e_err**2
        loss = w_energy * loss_e + w_force * loss_f
        metrics = {
            "loss": loss,
            "loss_energy": loss_e,
            "loss_force": loss_f,
            "rmse_f": torch.sqrt(loss_f),
            "mae_e_per_atom": torch.abs(e_err if per_atom_energy else e_err / n),
        }
        if w_virial > 0.0:
            loss_v = torch.sum((out.virial - frame["virial"]) ** 2) / (9.0 * n**2)
            loss = loss + w_virial * loss_v
            metrics["loss"] = loss
            metrics["loss_virial"] = loss_v
        return loss, metrics

    return loss_fn


def make_batched_loss_fn(loss_fn) -> Callable[[dict, Frame], tuple[torch.Tensor, dict]]:
    """Lift a per-frame loss over a leading batch axis (data.stack_frames):
    the mean of the per-frame losses and of each metric.  The frames run
    one after another; with a differentiable loss every frame's graph stays
    alive until the weights' gradient is taken, so training memory grows
    with the batch size times the frame's edges."""

    def batched(params, batch: Frame):
        n = next(v for v in batch.values() if v is not None).shape[0]
        per = [loss_fn(params, {k: None if v is None else v[b] for k, v in batch.items()})
               for b in range(n)]
        loss = torch.stack([p[0] for p in per]).mean()
        metrics = {k: torch.stack([p[1][k] for p in per]).mean() for k in per[0][1]}
        return loss, metrics

    return batched


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """init(params) -> state; update(params, state, frame) -> (params,
    state, metrics), the optimizer updating the tree's leaves in place.
    With ``ema_decay`` the state also carries an exponential moving average
    of the tree (a copy); read it with ``ema(state)`` (None when off)."""

    init: Callable
    update: Callable
    ema: Callable


def make_train_step(loss_fn, optimizer, ema_decay: float | None = None) -> TrainStep:
    """Wire a loss into a ``torch.optim`` optimizer: ``optimizer`` builds one
    from the list of leaves, e.g. ``functools.partial(torch.optim.Adam,
    lr=1e-3)``.  The JAX package's ``optax.adam(lr)``, ``optax.adamw(lr,
    weight_decay)`` and ``optax.sgd(lr)`` are ``torch.optim.Adam``,
    ``AdamW(lr, weight_decay=...)`` and ``SGD(lr)``.

    A leaf the loss does not reach gets a zero gradient, not none: optax
    steps every leaf (AdamW decays it, and its moments see a zero), where
    ``torch.optim`` would skip a leaf whose ``.grad`` is None."""

    def init(params):
        tensors = leaves(params)
        for t in tensors:
            t.requires_grad_(True)
        opt = optimizer(tensors)
        if ema_decay:
            return opt, tree_map(lambda t: t.detach().clone(), params)
        return opt

    def update(params, state, frame: Frame):
        opt, ema = state if ema_decay else (state, None)
        tensors = leaves(params)
        loss, metrics = loss_fn(params, frame)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        for t, g in zip(tensors, grads):
            t.grad = torch.zeros_like(t) if g is None else g
        opt.step()
        with torch.no_grad():
            for t in tensors:
                t.grad = None
            if ema_decay:
                for e, p in zip(leaves(ema), tensors):
                    e.copy_(ema_decay * e + (1.0 - ema_decay) * p)
        return params, state, {k: v.detach() for k, v in metrics.items()}

    return TrainStep(init=init, update=update,
                     ema=lambda state: state[1] if ema_decay else None)
