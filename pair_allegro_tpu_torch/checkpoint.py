"""Model checkpoints and simulation state files (counterpart of
``pair_allegro_tpu/checkpoint.py``), in the JAX package's own ``.npz``
layout, so that files move between the two packages in both directions.

* parameters: the tree flattened to '/'-joined path keys, plus the config
  as JSON (``__config_json__``) and the family (``__family__``);
* state: positions, velocities, types, masses, cell, pbc, valid, step and
  ``thermostat/<name>``.  The port adds ``torch_rng_state``, its noise
  generator's state, so that ``langevin`` resumes bit for bit here.  A JAX
  state file carries a JAX ``rng_key`` instead, which the port cannot
  continue: :func:`generator_from_rng` seeds the port's generator from the
  key's words, the same way every time.  The JAX package ignores
  ``torch_rng_state``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from pair_allegro_tpu_torch.io.dump import host
from pair_allegro_tpu_torch.models.allegro import AllegroConfig, allegro_params_from_numpy
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, nequip_params_from_numpy
from pair_allegro_tpu_torch.ops.tp import paths_to_l
from pair_allegro_tpu_torch.system import System, resolve_device

_CFG_KEY = "__config_json__"
_FAMILY_KEY = "__family__"
RNG_KEY = "torch_rng_state"


def flatten(tree, prefix=""):
    """{'/'-joined path: numpy array} of a tree of dicts, lists and leaves."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = host(tree)
    return flat


def _unflatten(flat: dict):
    """Nested dicts and lists from '/'-joined keys (all-digit keys: a list)."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def as_tuples(v):
    """``v`` with every list, nested ones too, as a tuple."""
    return tuple(as_tuples(x) for x in v) if isinstance(v, list) else v


def save_params(path: str, params, cfg=None, family: str | None = None) -> None:
    """Save a parameter tree (tensors or arrays) and its config to one .npz."""
    meta = {}
    if cfg is not None:
        meta[_CFG_KEY] = np.asarray(json.dumps(dataclasses.asdict(cfg)))
        meta[_FAMILY_KEY] = np.asarray(family or type(cfg).__name__)
    np.savez(path, **flatten(params), **meta)


def load_params(path: str):
    """(params as a numpy tree, the config dict or None, the family or
    None); the config's lists come back as tuples, nested ones too."""
    with np.load(path, allow_pickle=False) as data:
        flat, cfg, family = {}, None, None
        for k in data.files:
            if k == _CFG_KEY:
                cfg = json.loads(str(data[k]))
            elif k == _FAMILY_KEY:
                family = str(data[k])
            else:
                flat[k] = data[k]
    if cfg is not None:
        cfg = {k: as_tuples(v) for k, v in cfg.items()}
    return _unflatten(flat), cfg, family


def make_config(cfg_dict: dict, family: str, params=None):
    """The config dataclass of a saved config dict.  With ``params`` (the
    tree loaded beside it), an Allegro checkpoint without ``parity`` gets
    the parity whose path count matches the saved mix rows (C * P_1)."""
    if family in ("AllegroConfig", "allegro"):
        if "parity" not in cfg_dict and params is not None:
            lmax = int(cfg_dict.get("l_max", 2))
            c = int(cfg_dict.get("num_tensor_features", 32))
            try:
                rows = int(np.asarray(params["layers"][0]["mix"]["l1"]).shape[0])
            except (KeyError, IndexError, TypeError):
                rows = None
            for parity in (True, False):
                if rows == c * len(paths_to_l(lmax, lmax, 1, parity)):
                    cfg_dict = dict(cfg_dict, parity=parity)
                    break
        return AllegroConfig(**cfg_dict)
    if family in ("NequIPConfig", "nequip"):
        return NequIPConfig(**cfg_dict)
    raise ValueError(f"unknown model family {family!r}")


def params_from_numpy(tree: dict, cfg, device=None, dtype=torch.float32) -> dict:
    """The port's parameter tensors of a numpy tree, on ``device``."""
    conv = nequip_params_from_numpy if isinstance(cfg, NequIPConfig) else allegro_params_from_numpy
    return conv(tree, cfg, device=device, dtype=dtype)


def load_model(path: str, device=None, dtype=torch.float32):
    """(cfg, params on ``device``, family) of a checkpoint either package
    wrote."""
    tree, cfg_dict, family = load_params(path)
    if cfg_dict is None:
        raise ValueError(f"{path} holds no model config ({_CFG_KEY})")
    cfg = make_config(cfg_dict, family, params=tree)
    family = "nequip" if isinstance(cfg, NequIPConfig) else "allegro"
    return cfg, params_from_numpy(tree, cfg, device, dtype), family


def save_state(path: str, system: System, step: int = 0, thermostat: dict | None = None,
               rng_state: torch.Tensor | None = None) -> None:
    """The full dynamical state (the LAMMPS restart analog); ``rng_state``
    (``torch.Generator.get_state()``) makes ``langevin`` resume bit for
    bit.  Types are written as int32, as the JAX package writes them."""
    extra = {} if rng_state is None else {RNG_KEY: host(rng_state)}
    np.savez(
        path,
        positions=host(system.positions),
        velocities=host(system.velocities),
        types=host(system.types).astype(np.int32),
        masses=host(system.masses),
        cell=host(system.cell),
        pbc=np.asarray(system.pbc),
        valid=host(system.valid_mask()),
        step=np.asarray(step),
        **extra,
        **{f"thermostat/{k}": host(v) for k, v in (thermostat or {}).items()},
    )


def load_state(path: str, dtype=torch.float64, device=None):
    """(System on ``device``, step, {name: 0-d tensor}, rng).  ``rng`` is
    the port's generator state (a uint8 tensor), a JAX ``rng_key`` (a
    numpy array) when only that is in the file, or None: give it to
    :func:`generator_from_rng`."""
    dev = resolve_device(device)
    with np.load(path) as data:
        def t(name, dt=dtype):
            return torch.as_tensor(data[name], dtype=dt, device=dev)

        system = System(
            positions=t("positions"),
            velocities=t("velocities"),
            types=t("types", torch.int64),
            masses=t("masses"),
            cell=t("cell"),
            pbc=tuple(bool(b) for b in data["pbc"]),
            valid=t("valid", torch.bool),
        )
        thermo = {k.split("/", 1)[1]: torch.as_tensor(data[k], device=dev)
                  for k in data.files if k.startswith("thermostat/")}
        if RNG_KEY in data.files:
            rng = torch.as_tensor(data[RNG_KEY], dtype=torch.uint8)
        elif "rng_key" in data.files:
            rng = np.asarray(data["rng_key"])
        else:
            rng = None
        step = int(data["step"])
    return system, step, thermo, rng


def generator_from_rng(rng, device) -> tuple[torch.Generator, bool]:
    """(a generator on ``device`` that continues ``rng``, whether ``rng``
    was a JAX key).  A port state continues exactly; a JAX key seeds the
    generator from its words (the noise stream is then the port's own); a
    state of a generator on another device type raises ``ValueError``."""
    gen = torch.Generator(device=device)
    if isinstance(rng, np.ndarray):
        words = np.asarray(rng, dtype=np.uint64).reshape(-1)
        seed = 0
        for w in words:
            seed = (seed * 2**32 + int(w) % 2**32) % 2**63
        gen.manual_seed(seed)
        return gen, True
    if rng is not None:
        if rng.numel() != gen.get_state().numel():
            raise ValueError(
                f"the state file's generator state ({rng.numel()} bytes) is not one of a "
                f"{torch.device(device).type} generator: resume on the device type it was "
                "written on"
            )
        gen.set_state(rng)
    return gen, False
