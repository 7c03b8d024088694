"""Training in the port (``pair_allegro_tpu_torch.train``) against the JAX
package at f64 on the CPU: the loss, its metrics and its gradient on every
leaf against ``make_loss_fn`` / ``jax.grad`` to 1e-10 relative (Allegro
``for_training()`` with and without remat and with the charge head, NequIP,
a virial term, padded atoms, ``per_atom_energy=False``; a leaf the loss
does not reach compares as zeros); JAX's finite-difference check; the
batched loss against the mean of the per-frame losses; ``adam``, ``adamw``
and ``sgd`` and the EMA against optax on the same gradient sequence, one
leaf unreached throughout; JAX's fine-tune descent criterion; and the K1
tier's energy of a tree trained in place against JAX's trained tree."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pair_allegro_tpu.checkpoint import _flatten as jax_flatten
from pair_allegro_tpu.models.allegro import AllegroConfig as JaxAllegroConfig
from pair_allegro_tpu.models.allegro import allegro_energy as jax_allegro_energy
from pair_allegro_tpu.models.allegro import allegro_init
from pair_allegro_tpu.models.nequip import NequIPConfig as JaxNequIPConfig
from pair_allegro_tpu.models.nequip import nequip_energy as jax_nequip_energy
from pair_allegro_tpu.models.nequip import nequip_init
from pair_allegro_tpu.train import make_loss_fn as jax_loss_fn
from pair_allegro_tpu.train import make_train_step as jax_train_step
from pair_allegro_tpu_torch.checkpoint import _unflatten, flatten, params_from_numpy
from pair_allegro_tpu_torch.data import load_frames, stack_frames
from pair_allegro_tpu_torch.io.extxyz import write_extxyz
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_energy, layer_tier
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, nequip_energy
from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np, pad_edges
from pair_allegro_tpu_torch.potential import make_potential
from pair_allegro_tpu_torch.train import (
    detached,
    leaves,
    make_batched_loss_fn,
    make_loss_fn,
    make_train_step,
)
from test_torch_port_tiers import _case, _close, _jax_outputs, _kw, _port_outputs

torch.set_num_threads(2)

# the JAX package's tests/test_training.py:33-56 configs
KW = dict(type_names=("Cu", "Ag"), r_max=3.5, l_max=1, num_layers=2, num_scalar_features=8,
          num_tensor_features=4, two_body_mlp_width=8, allegro_mlp_hidden_layers_width=8,
          readout_mlp_hidden_layers_width=8, avg_num_neighbors=10.0, remat=False)
NKW = dict(type_names=("Cu", "Ag"), r_max=3.5, l_max=1, num_layers=2, num_features=4,
           radial_mlp_width=8, readout_mlp_width=8, avg_num_neighbors=10.0, remat=False)


def _crystal(rng, n_rep=2, a=3.61, jitter=0.08):
    """32 jittered FCC atoms of two species in a periodic box (JAX's
    ``tests/test_training.py:_crystal``)."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(n_rep)
                          for j in range(n_rep) for k in range(n_rep)])
    pos += rng.randn(*pos.shape) * jitter
    return pos, np.eye(3) * a * n_rep, rng.randint(0, 2, size=len(pos))


def _teacher(family, **over):
    """(JAX config, port config, JAX energy fn, port energy fn, numpy tree)."""
    if family == "nequip":
        kw = {**NKW, **over}
        jcfg, cfg = JaxNequIPConfig(**kw), NequIPConfig(**kw)
        tree = nequip_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float64)
        return jcfg, cfg, jax_nequip_energy, nequip_energy, jax.tree.map(np.asarray, tree)
    kw = {**KW, **over}
    jcfg, cfg = JaxAllegroConfig(**kw), AllegroConfig(**kw)
    tree = allegro_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float64)
    return jcfg, cfg, jax_allegro_energy, allegro_energy, jax.tree.map(np.asarray, tree)


def _perturbed(tree, scale=0.01, fn=np.sin):
    return jax.tree.map(lambda x: x + scale * fn(np.arange(x.size).reshape(x.shape)), tree)


def _frame(rng, cfg, energy_fn, tree, n_fake=0, virial=False):
    """A padded FLAT frame (numpy) whose targets are the teacher's own, by
    the port's plain path at f64, with ``n_fake`` padded atoms at the
    origin outside ``atom_mask``."""
    pos, cell, types = _crystal(rng)
    ei, sh = neighbor_list_np(pos, cell, (True,) * 3, cfg.r_max)
    ei, sh, emask = pad_edges(ei, sh, ei.shape[1] + 13)
    ei = ei.astype(np.int64)
    n = len(pos)
    pos = np.concatenate([pos, np.zeros((n_fake, 3))])
    types = np.concatenate([types, np.zeros(n_fake, np.int64)])
    frame = {"positions": pos, "types": types, "edge_index": ei, "cell": cell,
             "edge_shifts": sh, "edge_mask": emask}
    if n_fake:
        frame["atom_mask"] = np.arange(n + n_fake) < n
    params, tcfg, t = _port_params(tree, cfg), cfg.for_training(), _port_frame(frame)
    out = make_potential(lambda *a, **k: energy_fn(params, tcfg, *a, **k))(
        *(t[k] for k in ("positions", "types", "edge_index")),
        **{k: t[k] for k in ("cell", "edge_shifts", "edge_mask", "atom_mask") if k in t})
    frame["forces"] = out.forces.numpy()
    frame["energy"] = out.total_energy.numpy()
    if virial:
        frame["virial"] = out.virial.numpy()
    return frame


def _jax_frame(frame):
    return {k: jnp.asarray(v) for k, v in frame.items()}


def _port_frame(frame):
    return {k: torch.as_tensor(v) for k, v in frame.items()}


def _port_params(tree, cfg, dtype=torch.float64):
    return params_from_numpy(tree, cfg, device="cpu", dtype=dtype)


def _port_grads(loss_fn, params, frame):
    """(loss, metrics, {key: grad}) with unreached leaves as zeros."""
    tensors = leaves(params)
    for t in tensors:
        t.requires_grad_(True)
    loss, metrics = loss_fn(params, frame)
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    flat = {k: np.zeros(t.shape) if g is None else g.numpy()
            for (k, t), g in zip(zip(flatten(params), tensors), grads)}
    return float(loss), {k: float(v) for k, v in metrics.items()}, flat


CASES = {
    "allegro-charges": ("allegro", dict(output_charges=True), {}, {}),
    "allegro-remat": ("allegro", dict(remat=True), {}, {}),
    "nequip": ("nequip", {}, {}, {}),
    "virial": ("allegro", {}, dict(w_virial=1.0), dict(virial=True)),
    "atom_mask": ("allegro", {}, {}, dict(n_fake=3)),
    "per_atom_energy_false": ("allegro", {}, dict(per_atom_energy=False, w_energy=0.3), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_metrics_and_grads_match_jax(case):
    family, over, loss_kw, frame_kw = CASES[case]
    jcfg, cfg, jax_energy, port_energy, tree = _teacher(family, **over)
    frame = _frame(np.random.RandomState(0), cfg, port_energy, tree, **frame_kw)
    student = _perturbed(tree)
    jfn = jax.jit(jax.value_and_grad(
        jax_loss_fn(jax_energy, jcfg.for_training(), **loss_kw), has_aux=True))
    (jl, jm), jg = jfn(jax.tree.map(jnp.asarray, student), _jax_frame(frame))
    loss, metrics, grads = _port_grads(make_loss_fn(port_energy, cfg.for_training(), **loss_kw),
                                       _port_params(student, cfg), _port_frame(frame))
    _close(loss, float(jl), "loss")
    assert set(metrics) == set(jm)
    for k in jm:
        _close(metrics[k], float(jm[k]), k)
    jg = jax_flatten(jg)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        if not np.any(jg[k]):
            np.testing.assert_array_equal(g, jg[k], err_msg=k)
        else:
            _close(g, jg[k], k)
    if case == "allegro-charges":  # the head and the last mix are out of the loss's reach
        assert not np.any(grads["charge_mlp/w/0"]) and not np.any(grads["layers/1/mix/l1"])


def _fd_check(loss_fn, tree, cfg, frame, key, idx, eps=1e-5):
    """JAX's ``_fd_check``: a central difference of one weight against the
    autograd gradient, |ad - fd| <= 1e-6 max(1, |fd|)."""
    _, _, grads = _port_grads(loss_fn, _port_params(tree, cfg), frame)

    def loss_at(w):
        flat = {k: np.array(v) for k, v in jax_flatten(tree).items()}
        flat[key][idx] = w
        return float(loss_fn(_port_params(_unflatten(flat), cfg), frame)[0])

    w0 = jax_flatten(tree)[key][idx]
    fd = (loss_at(w0 + eps) - loss_at(w0 - eps)) / (2 * eps)
    ad = grads[key][idx]
    assert np.isfinite(ad)
    assert abs(ad - fd) <= 1e-6 * max(1.0, abs(fd)), (ad, fd, key)
    return grads


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_grads_match_finite_differences(family):
    jcfg, cfg, jax_energy, port_energy, tree = _teacher(family)
    frame = _port_frame(_frame(np.random.RandomState(1), cfg, port_energy, tree))
    student = _perturbed(tree, fn=np.sin if family == "allegro" else np.cos)
    loss = make_loss_fn(port_energy, cfg.for_training())
    keys = ([("tensor_embed", (0, 0)), ("per_type_scale", (1,)), ("readout_mlp/w/0", (2, 0))]
            if family == "allegro" else [("per_type_scale", (0,)), ("layers/0/mix_w/1", (1, 2))])
    for key, idx in keys:
        grads = _fd_check(loss, student, cfg, frame, key, idx)
    assert all(np.all(np.isfinite(g)) for g in grads.values())


def _dataset(tmp_path, cfg, tree, n=4, virial=False):
    """An extxyz file of ``n`` teacher-labelled frames (virial quoted)."""
    rng = np.random.RandomState(3)
    frames = []
    for _ in range(n):
        f = _frame(rng, cfg, allegro_energy, tree, virial=virial)
        info = {"energy": f"{float(f['energy']):.17g}"}
        if virial:
            info["virial"] = '"' + " ".join(f"{x:.17g}" for x in f["virial"].reshape(-1)) + '"'
        frames.append({"symbols": np.asarray(cfg.type_names)[f["types"]],
                       "positions": f["positions"], "cell": f["cell"], "pbc": (True,) * 3,
                       "forces": f["forces"], "info": info})
    path = str(tmp_path / "frames.xyz")
    write_extxyz(path, frames)
    return path


def test_batched_loss_is_the_mean_of_the_per_frame_losses(tmp_path):
    _, cfg, _, _, tree = _teacher("allegro")
    path = _dataset(tmp_path, cfg, tree, virial=True)
    frames = load_frames(path, cfg.type_names, cfg.r_max, dtype=torch.float64, device="cpu")
    params = _port_params(_perturbed(tree), cfg)
    loss = make_loss_fn(allegro_energy, cfg.for_training(), w_virial=0.5)
    per = [loss(params, f) for f in frames]
    bat, metrics = make_batched_loss_fn(loss)(params, stack_frames(frames))
    np.testing.assert_allclose(float(bat), np.mean([float(p[0]) for p in per]), rtol=1e-12)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), np.mean([float(p[1][k]) for p in per]),
                                   rtol=1e-12, err_msg=k)


def test_eval_loss_keeps_no_graph(tmp_path):
    """``create_graph=False`` (validation) gives the training loss's values
    to 1e-12 with no graph left, even on leaves that require grad."""
    _, cfg, _, _, tree = _teacher("allegro")
    path = _dataset(tmp_path, cfg, tree, n=2, virial=True)
    batch = stack_frames(load_frames(path, cfg.type_names, cfg.r_max, dtype=torch.float64,
                                     device="cpu"))
    params = _port_params(_perturbed(tree), cfg)
    for t in leaves(params):
        t.requires_grad_(True)
    train, ev = (make_batched_loss_fn(make_loss_fn(allegro_energy, cfg.for_training(),
                                                   w_virial=0.5, create_graph=g))(params, batch)
                 for g in (True, False))
    assert train[0].requires_grad and not ev[0].requires_grad
    assert sorted(train[1]) == sorted(ev[1])
    for k, v in ev[1].items():
        assert not v.requires_grad, k
        np.testing.assert_allclose(float(v), float(train[1][k]), rtol=1e-12, err_msg=k)


def _linear_case():
    """A tree, 5 gradient trees (leaf 'b' zero throughout in JAX, out of
    the port loss's reach), and the two losses whose gradients they are."""
    rng = np.random.RandomState(7)
    tree = {"a": rng.randn(3, 2), "b": rng.randn(4), "c": [rng.randn(2), rng.randn(2, 2)]}
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape) * 10.0 ** rng.randint(-3, 2), tree)
             for _ in range(5)]
    for g in grads:
        g["b"] = np.zeros(4)

    def jax_loss(p, g):
        lin = sum(jnp.sum(x * y) for x, y in zip(jax.tree.leaves(p), jax.tree.leaves(g)))
        return lin, {"loss": lin}

    def port_loss(p, g):  # leaf 'b' is not used: its .grad comes back None
        lin = sum(torch.sum(x * torch.as_tensor(y))
                  for k, (x, y) in enumerate(zip(leaves(p), jax.tree.leaves(g))) if k != 1)
        return lin, {"loss": lin}

    return tree, grads, jax_loss, port_loss


OPTIMIZERS = {
    "adam": (optax.adam(3e-2), functools.partial(torch.optim.Adam, lr=3e-2)),
    "adamw": (optax.adamw(3e-2, weight_decay=0.1),
              functools.partial(torch.optim.AdamW, lr=3e-2, weight_decay=0.1)),
    "sgd": (optax.sgd(3e-2), functools.partial(torch.optim.SGD, lr=3e-2)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
@pytest.mark.parametrize("ema", [None, 0.9])
def test_optimizers_and_ema_follow_optax(name, ema):
    """The same 5 gradient trees through JAX's step (optax) and the port's
    (torch.optim): the trees and the EMA to 1e-12; the leaf the port's loss
    does not reach is stepped as optax steps a zero gradient (AdamW decays
    it)."""
    tree, grads, jax_loss, port_loss = _linear_case()
    jopt, topt = OPTIMIZERS[name]
    jstep = jax_train_step(jax_loss, jopt, ema_decay=ema)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jstep.init(jp)
    tstep = make_train_step(port_loss, topt, ema_decay=ema)
    tp = {"a": torch.tensor(tree["a"]), "b": torch.tensor(tree["b"]),
          "c": [torch.tensor(x) for x in tree["c"]]}
    tstate = tstep.init(tp)
    for g in grads:
        jp, jstate, _ = jstep.update(jp, jstate, jax.tree.map(jnp.asarray, g))
        tp, tstate, _ = tstep.update(tp, tstate, g)
    pairs = [(jp, tp)] + ([(jstep.ema(jstate), tstep.ema(tstate))] if ema else [])
    for want, got in pairs:
        want, got = jax_flatten(want), flatten(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-15, err_msg=k)
    moved = not np.array_equal(flatten(tp)["b"], tree["b"])
    assert moved == (name == "adamw")  # only the decay moves the unreached leaf
    assert all(not t.requires_grad for t in leaves(detached(tp)))


def test_adam_recovers_perturbed_forces():
    """JAX's ``TestFineTune`` criterion at f32: 60 Adam steps cut the
    teacher-student force-matching loss by more than 10x, and the trained
    tree runs on the kernel config."""
    _, cfg, _, _, tree = _teacher("allegro")
    tree32 = jax.tree.map(lambda x: x.astype(np.float32), tree)
    frame = _frame(np.random.RandomState(2), cfg, allegro_energy, tree)
    frame = {k: torch.as_tensor(v, dtype=torch.float32) if v.dtype == np.float64
             else torch.as_tensor(v) for k, v in frame.items()}
    student = jax.tree.map(
        lambda x: x * (1.0 + 0.05 * np.sin(np.arange(x.size).reshape(x.shape))), tree32)
    params = _port_params(student, cfg, torch.float32)
    loss_fn = make_loss_fn(allegro_energy, cfg.for_training())
    step = make_train_step(loss_fn, functools.partial(torch.optim.Adam, lr=3e-3))
    state = step.init(params)
    l0 = float(loss_fn(detached(params), frame)[0])
    for _ in range(60):
        params, state, metrics = step.update(params, state, frame)
    assert float(metrics["loss"]) < l0 / 10.0, (l0, float(metrics["loss"]))
    assert np.isfinite(float(make_loss_fn(allegro_energy, cfg)(detached(params), frame)[0]))


def test_trained_tree_on_the_k1_tier_matches_jax():
    """Both packages train the same student for 3 SGD steps; the K1 tier's
    energy, forces, virial and charges of the port's tree (its plain
    versions on the CPU), through the same leaves whose kernel layouts were
    cached before training and through ``detached`` views, equal JAX's
    trained tree on its kernel config to 1e-10."""
    kw = _kw(2)
    jcfg, cfg = JaxAllegroConfig(remat=False, **kw), AllegroConfig(**kw)
    tree = jax.tree.map(np.asarray, allegro_init(jax.random.PRNGKey(0), jcfg,
                                                  dtype=jnp.float64))
    frame = _frame(np.random.RandomState(4), cfg, allegro_energy, _perturbed(tree, 0.05))
    jstep = jax_train_step(jax_loss_fn(jax_allegro_energy, jcfg.for_training()),
                           optax.sgd(1e-2))
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jstep.init(jp)
    params = _port_params(tree, cfg)
    jargs, jkw, targs, tkw = _case(2)
    assert layer_tier(cfg, False, dtype=torch.float64, card=False) == "k1"
    before = _port_outputs(params, cfg, targs, tkw)  # caches the K1 layouts of these leaves
    step = make_train_step(make_loss_fn(allegro_energy, cfg.for_training()),
                           functools.partial(torch.optim.SGD, lr=1e-2))
    state = step.init(params)
    for _ in range(3):
        jp, jstate, _ = jstep.update(jp, jstate, _jax_frame(frame))
        params, state, _ = step.update(params, state, _port_frame(frame))
    want = _jax_outputs(jp, jcfg, jargs, jkw)
    for got in (_port_outputs(params, cfg, targs, tkw),
                _port_outputs(detached(params), cfg, targs, tkw)):
        assert abs(got["total_energy"] - before["total_energy"]) > 1e-8
        for name in want:
            _close(got[name], want[name], name)
    plain = _port_outputs(detached(params), dataclasses.replace(cfg, fused_tp=False), targs, tkw)
    _close(got["forces"], plain["forces"], "k1 against plain")


def test_potential_keeps_the_graph_only_when_asked():
    """``make_potential``'s default detaches every output (the MD path);
    ``create_graph=True`` gives forces with a graph back to the weights,
    equal in value to 1e-12 (the double-backward graph sums in another
    order)."""
    _, cfg, _, _, tree = _teacher("allegro")
    frame = _port_frame(_frame(np.random.RandomState(5), cfg, allegro_energy, tree))
    params = _port_params(tree, cfg.for_training())
    for t in leaves(params):
        t.requires_grad_(True)
    args = (frame["positions"], frame["types"], frame["edge_index"])
    kw = dict(cell=frame["cell"], edge_shifts=frame["edge_shifts"], edge_mask=frame["edge_mask"])
    outs = [make_potential(lambda *a, **k: allegro_energy(params, cfg.for_training(), *a, **k),
                           create_graph=g)(*args, **kw) for g in (False, True)]
    for name in ("total_energy", "atomic_energy", "forces", "virial"):
        a, b = getattr(outs[0], name), getattr(outs[1], name)
        assert not a.requires_grad and b.requires_grad, name
        _close(a.numpy(), b.detach().numpy(), name, tol=1e-12)
