"""Import model weights from torch checkpoints (counterpart of
``pair_allegro_tpu/import_torch.py``).

Reads a torch state dict (a Lightning ``.ckpt``, a ``.pth`` of tensors, or
a compiled TorchScript package with its metadata) into the parameter tree
of the JAX package's layout, as numpy arrays: ``checkpoint.save_params``
writes it and ``checkpoint.params_from_numpy`` puts it on a device.

Key mapping: source keys are expected to match the canonical flat names
('/'-joined tree paths, e.g. ``two_body_mlp/w/0``) unless a ``key_map``
translates them (the presets below for the upstream and e3nn naming
schemes).  Lightning prefixes (``state_dict`` nesting, ``model.``) are
stripped, and torch ``nn.Linear`` (out, in) weights are transposed to
(in, out) on shape evidence or by a preset's transpose set.

The template the tree is filled into comes from the port's numpy init
(``allegro_init_numpy`` / ``nequip_init_numpy``) cast to ``dtype``
(float32 by default, the JAX package's template dtype), with its dict keys
sorted as a ``jax.tree.map`` sorts them: so with every key present the
tree, its key order and the list of missing keys equal the JAX package's.
With ``strict=False`` a missing key keeps the port's init value, which is
not the JAX package's ``jax.random`` draw.
"""

from __future__ import annotations

import numpy as np
import torch

from pair_allegro_tpu_torch.checkpoint import _unflatten, flatten
from pair_allegro_tpu_torch.models.allegro import allegro_init_numpy
from pair_allegro_tpu_torch.models.nequip import NequIPConfig, nequip_init_numpy
from pair_allegro_tpu_torch.ops.tp import paths_to_l

_STRIP_PREFIXES = ("model.", "func.", "module.", "_orig_mod.")

# metadata keys a compiled TorchScript artifact carries
_TS_METADATA_KEYS = (
    "r_max", "per_edge_type_cutoff", "type_names", "num_types", "allow_tf32"
)


def _strip(name: str) -> str:
    changed = True
    while changed:
        changed = False
        for p in _STRIP_PREFIXES:
            if name.startswith(p):
                name = name[len(p):]
                changed = True
    return name


def load_torchscript_artifact(path: str):
    """Open a compiled TorchScript package (``model.nequip.pth``), the
    artifact the LAMMPS pair style loads with ``torch::jit::load`` and
    whose extra-files map carries the metadata r_max /
    per_edge_type_cutoff / type_names / num_types / allow_tf32; the
    module's state_dict carries the weights.  Returns ({name: np.ndarray},
    {metadata_key: str}).
    """
    extra = {k: "" for k in _TS_METADATA_KEYS}
    mod = torch.jit.load(path, map_location="cpu", _extra_files=extra)
    sd = {
        _strip(k): v.detach().cpu().numpy() for k, v in mod.state_dict().items()
    }
    meta = {}
    for k, v in extra.items():
        if isinstance(v, bytes):
            v = v.decode()
        if v:
            meta[k] = v
    return sd, meta


def config_kwargs_from_metadata(meta: dict) -> dict:
    """Artifact metadata strings -> model-config kwargs (r_max, type names,
    the per-edge-type cutoff matrix), as the pair style's ``coeff`` parses
    them."""
    kw = {}
    if "r_max" in meta:
        kw["r_max"] = float(meta["r_max"])
    if "type_names" in meta:
        kw["type_names"] = tuple(meta["type_names"].split())
    if "per_edge_type_cutoff" in meta:
        vals = [float(x) for x in meta["per_edge_type_cutoff"].split()]
        nt = len(kw.get("type_names", ())) or int(meta.get("num_types", 0))
        if nt and len(vals) == nt * nt:
            kw["per_edge_type_cutoff"] = tuple(
                tuple(vals[i * nt : (i + 1) * nt]) for i in range(nt)
            )
    return kw


def _is_torchscript(path: str) -> bool:
    """TorchScript packages are zip archives containing constants.pkl +
    code/; eager checkpoints are zips with only data.pkl."""
    import zipfile

    try:
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        return any(n.endswith("constants.pkl") for n in names)
    except (OSError, zipfile.BadZipFile):
        return False


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a torch checkpoint into {name: np.ndarray}: an eager state-dict
    checkpoint (Lightning .ckpt) or a compiled TorchScript package
    (.nequip.pth; its metadata is dropped here: load_torchscript_artifact
    keeps it)."""
    if _is_torchscript(path):
        sd, _ = load_torchscript_artifact(path)
        return sd
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if not hasattr(v, "detach"):
            continue
        out[_strip(k)] = v.detach().cpu().numpy()
    return out


def map_state_dict(
    sd: dict[str, np.ndarray],
    template_params,
    key_map: dict[str, str] | None = None,
    strict: bool = True,
    transpose: set[str] | str = "auto",
):
    """Fill the template pytree from named tensors.

    key_map values are source-key strings OR callables ``sd -> ndarray`` for
    sources whose weights are PACKED differently than ours (e.g. e3nn
    ``o3.Linear`` flat irreps-block concatenation — see
    ``e3nn_allegro_key_map``).  A callable must return the array already in
    canonical orientation; a KeyError it raises counts as a missing key.

    transpose: "auto" transposes 2-D tensors only when the direct shape does
    not fit but the transpose does (ambiguous for square matrices!); a set of
    canonical keys transposes exactly those — key-map presets that KNOW the
    source orientation (torch ``nn.Linear`` stores (out, in)) pass the set so
    square layers import correctly.  Missing keys: error when strict, else
    keep the template value (useful for partially-trained or schema-evolved
    checkpoints).
    """
    flat_t = flatten(template_params)
    key_map = key_map or {}
    out, missing, mismatched = {}, [], []
    for k, tmpl in flat_t.items():
        src_key = key_map.get(k, k)
        if callable(src_key):
            try:
                arr = np.asarray(src_key(sd))
            except KeyError:
                missing.append(k)
                out[k] = tmpl
                continue
            if arr.shape == tmpl.shape:
                out[k] = arr.astype(tmpl.dtype)
            else:
                mismatched.append((k, arr.shape, tmpl.shape))
            continue
        if src_key not in sd and src_key.replace("/", ".") in sd:
            # torch module trees always join with '.'; canonical names use '/'
            src_key = src_key.replace("/", ".")
        if src_key not in sd:
            missing.append(k)
            out[k] = tmpl
            continue
        arr = np.asarray(sd[src_key])
        if transpose != "auto" and k in transpose:
            if arr.ndim != 2 or arr.T.shape != tmpl.shape:
                mismatched.append((k, arr.shape, tmpl.shape))
                continue
            out[k] = arr.T.astype(tmpl.dtype)
        elif arr.shape == tmpl.shape:
            out[k] = arr.astype(tmpl.dtype)
        elif arr.ndim == 2 and arr.T.shape == tmpl.shape:
            out[k] = arr.T.astype(tmpl.dtype)  # torch Linear (out, in)
        else:
            mismatched.append((k, arr.shape, tmpl.shape))
    if mismatched:
        raise ValueError(f"shape mismatches: {mismatched}")
    if strict and missing:
        raise KeyError(
            f"{len(missing)} parameter(s) not found in checkpoint: "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}"
        )
    return _unflatten(out), missing


def propose_key_map(
    sd: dict[str, np.ndarray], template_params, name_ratio_min: float = 0.35
):
    """Shape-match a foreign state dict against the template pytree.

    The safe half of an auto-importer: propose only what shapes determine
    unambiguously, refuse the rest.  For each (shape class) the proposal is

    * exactly one template key and one source key of that shape → mapped;
    * equal counts > 1 → mapped ONLY if name similarity (difflib ratio on
      '/'-vs-'.'-normalized names) yields a stable bijection with every pair
      ≥ ``name_ratio_min`` AND each side's best match is mutual — otherwise
      the whole class is reported ambiguous with its candidates;
    * unequal counts → ambiguous.

    2-D source tensors additionally match transposed (torch ``nn.Linear`` is
    (out, in)); a transposed match is tagged so the caller can build the
    ``transpose`` set.  Square 2-D matches are proposed but tagged
    ``orientation-unverifiable`` — shape evidence cannot pin them
    (the reason the pinned presets carry explicit transpose sets).

    Returns (proposed: {canonical: source}, transpose_keys: set,
    ambiguous: {shape_repr: (template_keys, source_keys)},
    unmatched_template: list, unused_source: list).
    """
    import difflib

    flat_t = flatten(template_params)
    by_shape_t: dict[tuple, list[str]] = {}
    for k, v in flat_t.items():
        by_shape_t.setdefault(tuple(v.shape), []).append(k)
    by_shape_s: dict[tuple, list[str]] = {}
    for k, v in sd.items():
        by_shape_s.setdefault(tuple(np.asarray(v).shape), []).append(k)

    def _norm(name: str) -> str:
        return name.replace(".", "/").replace("layers/", "").lower()

    proposed: dict[str, str] = {}
    tkeys: set[str] = set()
    ambiguous: dict[str, tuple[list[str], list[str]]] = {}
    used_src: set[str] = set()

    for shape, t_keys in sorted(by_shape_t.items(), key=lambda x: str(x[0])):
        direct = list(by_shape_s.get(shape, ()))
        flipped: list[str] = []
        square = len(shape) == 2 and shape[0] == shape[1]
        if len(shape) == 2 and not square:
            flipped = [k for k in by_shape_s.get(shape[::-1], ())
                       if k not in direct]
        cands = [k for k in direct + flipped if k not in used_src]
        if len(cands) == len(t_keys) == 1:
            src = cands[0]
            proposed[t_keys[0]] = src
            used_src.add(src)
            if src in flipped:
                tkeys.add(t_keys[0])
        elif len(cands) == len(t_keys) and t_keys:
            # name-similarity bijection, required to be mutual-best
            ratio = {
                (t, s): difflib.SequenceMatcher(
                    None, _norm(t), _norm(s)
                ).ratio()
                for t in t_keys for s in cands
            }
            pick = {t: max(cands, key=lambda s: ratio[(t, s)]) for t in t_keys}
            rpick = {s: max(t_keys, key=lambda t: ratio[(t, s)]) for s in cands}
            bijective = (
                len(set(pick.values())) == len(t_keys)
                and all(rpick[pick[t]] == t for t in t_keys)
                and all(ratio[(t, pick[t])] >= name_ratio_min for t in t_keys)
            )
            if bijective:
                for t in t_keys:
                    proposed[t] = pick[t]
                    used_src.add(pick[t])
                    if pick[t] in flipped:
                        tkeys.add(t)
            else:
                ambiguous[str(shape)] = (t_keys, cands)
        else:
            ambiguous[str(shape)] = (t_keys, cands)

    unmatched = [k for k in flat_t if k not in proposed
                 and not any(k in g[0] for g in ambiguous.values())]
    unused = [k for k in sd if k not in used_src]
    return proposed, tkeys, ambiguous, unmatched, unused


def inspect_state_dict(sd: dict[str, np.ndarray], template_params=None) -> str:
    """Human-readable report of a foreign checkpoint: every tensor with its
    shape/dtype, and — when a template pytree is given — the shape-matched
    key-map proposal from ``propose_key_map`` (the ``--inspect`` mode of the
    CLI importer)."""
    lines = [f"source checkpoint: {len(sd)} tensors"]
    for k in sorted(sd):
        a = np.asarray(sd[k])
        lines.append(f"  {k}  {tuple(a.shape)}  {a.dtype}")
    if template_params is None:
        return "\n".join(lines)
    flat_t = flatten(template_params)
    lines.append(f"template: {len(flat_t)} parameters")
    for k in sorted(flat_t):
        lines.append(f"  {k}  {tuple(flat_t[k].shape)}")
    proposed, tkeys, ambiguous, unmatched, unused = propose_key_map(
        sd, template_params
    )
    lines.append(f"proposed key map ({len(proposed)} of {len(flat_t)}):")
    for t in sorted(proposed):
        square = flat_t[t].ndim == 2 and flat_t[t].shape[0] == flat_t[t].shape[1]
        tag = (" [transposed]" if t in tkeys
               else " [orientation-unverifiable: square]" if square else "")
        lines.append(f"  {t}  <-  {proposed[t]}{tag}")
    if ambiguous:
        lines.append(
            f"AMBIGUOUS ({len(ambiguous)} shape classes) — refusing to guess; "
            "resolve via an explicit key_map:"
        )
        for shape, (tk, sk) in sorted(ambiguous.items()):
            lines.append(f"  shape {shape}:")
            lines.append(f"    template: {', '.join(sorted(tk))}")
            lines.append(f"    source:   {', '.join(sorted(sk))}")
    if unmatched:
        lines.append(f"unmatched template params ({len(unmatched)}):")
        for k in sorted(unmatched):
            lines.append(f"  {k}  {tuple(flat_t[k].shape)}")
    if unused:
        lines.append(f"unused source tensors ({len(unused)}):")
        for k in sorted(unused):
            lines.append(f"  {k}  {tuple(np.asarray(sd[k]).shape)}")
    return "\n".join(lines)


def upstream_allegro_key_map(cfg) -> tuple[dict[str, str], set[str]]:
    """Pinned (key_map, transpose_keys) for TWIN-SHAPED Allegro checkpoints.

    The same preset as the JAX package's: derived from the module names of
    the upstream Allegro training YAML and held against the JAX package's
    torch twin (``torch_ref``), not against an upstream-trained
    ``last.ckpt``.  Upstream checkpoints use e3nn modules whose naming and
    packing may differ; import one with an explicit ``key_map`` after
    reading its keys (``cli import --inspect``).

    Canonical flat name (ours)      → checkpoint key (after ``model.`` strip)
      two_body_mlp/w/{i}            → radial_chemical_embed.two_body_mlp.layers.{i}.weight
      tensor_embed                  → tensor_embed.weight                (out, in)
      layers/{k}/env_weight         → layers.{k}.env_embed.weight       (out, in)
      layers/{k}/latent_mlp/w/{i}   → layers.{k}.latent_mlp.layers.{i}.weight
      layers/{k}/mix/l{l}           → layers.{k}.tp_mix.l{l}.weight     (out, in)
      readout_mlp/w/{i}             → readout_mlp.layers.{i}.weight
      per_type_shift / per_type_scale → per_type_energy_shifts / _scales

    Every 2-D entry is a torch ``nn.Linear`` weight in (out, in) orientation,
    so all of them are returned in ``transpose_keys`` — import is exact even
    for square layers.
    """
    km: dict[str, str] = {}
    tkeys: set[str] = set()

    def _mlp(ours: str, theirs: str, n_linear: int):
        for i in range(n_linear):
            km[f"{ours}/w/{i}"] = f"{theirs}.layers.{i}.weight"
            tkeys.add(f"{ours}/w/{i}")

    _mlp("two_body_mlp", "radial_chemical_embed.two_body_mlp",
         cfg.two_body_mlp_depth + 1)
    km["tensor_embed"] = "tensor_embed.weight"
    tkeys.add("tensor_embed")
    for k in range(cfg.num_layers):
        km[f"layers/{k}/env_weight"] = f"layers.{k}.env_embed.weight"
        tkeys.add(f"layers/{k}/env_weight")
        _mlp(f"layers/{k}/latent_mlp", f"layers.{k}.latent_mlp",
             cfg.allegro_mlp_hidden_layers_depth + 1)
        for l3 in range(cfg.l_max + 1):
            km[f"layers/{k}/mix/l{l3}"] = f"layers.{k}.tp_mix.l{l3}.weight"
            tkeys.add(f"layers/{k}/mix/l{l3}")
    _mlp("readout_mlp", "readout_mlp", cfg.readout_mlp_hidden_layers_depth + 1)
    km["per_type_shift"] = "per_type_energy_shifts"
    km["per_type_scale"] = "per_type_energy_scales"
    return km, tkeys


def e3nn_allegro_key_map(cfg) -> tuple[dict, set[str]]:
    """(key_map, transpose_keys) for e3nn-STYLE PACKED Allegro checkpoints.

    Real upstream checkpoints come from e3nn modules whose weight STORAGE
    differs structurally from plain ``nn.Linear`` trees:

    * ``e3nn.o3.Linear`` holds ONE flat 1-D ``weight`` — the concatenation,
      in instruction order, of per-irrep blocks each of shape
      (mul_in, mul_out) — with 1/sqrt(fan_in) path normalization applied at
      run time (matching our run-time scaling convention);
    * ``e3nn.nn.FullyConnectedNet`` is a ``torch.nn.Sequential`` of layers
      whose state-dict keys are bare indices (``mlp.0.weight``) and whose
      weights are (h_in, h_out) — the OPPOSITE orientation of
      ``torch.nn.Linear`` — also scaled by 1/sqrt(h_in) at run time.

    This preset maps that layout (as produced by
    ``torch_ref.e3nn_pack_allegro_state``):

      two_body_mlp/w/{i}   ← radial_chemical_embed.two_body_mlp.{i}.weight  (in, out; direct)
      tensor_embed         ← tensor_embed.weight       flat (ns·C,) → (ns, C)
      layers/{k}/env_weight← layers.{k}.env_embed.weight  flat (ns·C,) → (ns, C)
      layers/{k}/mix/l{l}  ← slice of layers.{k}.tp_mix.weight — ONE flat
                             concatenation over l of (C·p_l, C) blocks
      readout/latent MLPs  ← indexed Sequential keys, (in, out) direct
      per_type_shift/scale ← per_type_energy_shifts / _scales

    REMAINING UNKNOWNS, which only a real upstream checkpoint settles: (a)
    the upstream module-tree NAMES (this fixture's names follow the training-YAML module names, like
    the twin's); (b) the (channel, path) ordering inside each o3.Linear
    multiplicity axis — this preset assumes channel-major, matching a
    reshape from (C, p_l); flipping to path-major is the one-line
    ``order="F"`` change in ``_unpack_2d`` below.  Both are resolvable in
    minutes against a real checkpoint via ``cli import --inspect``.
    """
    km: dict = {}
    tkeys: set[str] = set()
    ns, C, nt = cfg.num_scalar_features, cfg.num_tensor_features, cfg.num_types
    
    def _unpack_2d(key: str, off: int, rows: int, cols: int):
        def get(sd, key=key, off=off, rows=rows, cols=cols):
            return np.asarray(sd[key]).reshape(-1)[off : off + rows * cols] \
                .reshape(rows, cols, order="C")

        return get

    def _mlp(ours: str, theirs: str, n_linear: int):
        for i in range(n_linear):
            km[f"{ours}/w/{i}"] = f"{theirs}.{i}.weight"  # (in, out) direct

    _mlp("two_body_mlp", "radial_chemical_embed.two_body_mlp",
         cfg.two_body_mlp_depth + 1)
    km["tensor_embed"] = _unpack_2d("tensor_embed.weight", 0, ns, C)
    for k in range(cfg.num_layers):
        km[f"layers/{k}/env_weight"] = _unpack_2d(
            f"layers.{k}.env_embed.weight", 0, ns, C
        )
        _mlp(f"layers/{k}/latent_mlp", f"layers.{k}.latent_mlp",
             cfg.allegro_mlp_hidden_layers_depth + 1)
        off = 0
        for l3 in range(cfg.l_max + 1):
            pl = len(paths_to_l(cfg.l_max, cfg.l_max, l3,
                                getattr(cfg, "parity", False)))
            km[f"layers/{k}/mix/l{l3}"] = _unpack_2d(
                f"layers.{k}.tp_mix.weight", off, C * pl, C
            )
            off += C * pl * C
    _mlp("readout_mlp", "readout_mlp", cfg.readout_mlp_hidden_layers_depth + 1)
    km["per_type_shift"] = "per_type_energy_shifts"
    km["per_type_scale"] = "per_type_energy_scales"
    return km, tkeys


def upstream_nequip_key_map(cfg) -> tuple[dict[str, str], set[str]]:
    """Pinned (key_map, transpose_keys) for TWIN-SHAPED NequIP checkpoints
    (module tree per the upstream NequIP training YAML; held against the
    JAX package's torch twin, not a genuine upstream checkpoint: see
    upstream_allegro_key_map).

    Canonical flat name (ours)      → checkpoint key (after ``model.`` strip)
      chem_embed                    → chemical_embedding
      layers/{k}/radial_mlp/w/{i}   → layers.{k}.radial_mlp.layers.{i}.weight
      layers/{k}/self_w/{l}         → layers.{k}.self_interaction.{l}   (3-D, direct)
      layers/{k}/mix_w/{l}          → layers.{k}.linear.{l}.weight      (out, in)
      layers/{k}/gate_w             → layers.{k}.gate.weight            (out, in)
      readout_mlp/w/{i}             → readout_mlp.layers.{i}.weight
      per_type_shift / per_type_scale → per_type_energy_shifts / _scales
    """
    km: dict[str, str] = {}
    tkeys: set[str] = set()

    def _mlp(ours: str, theirs: str, n_linear: int):
        for i in range(n_linear):
            km[f"{ours}/w/{i}"] = f"{theirs}.layers.{i}.weight"
            tkeys.add(f"{ours}/w/{i}")

    km["chem_embed"] = "chemical_embedding"
    parity = bool(getattr(cfg, "parity", False))
    for k in range(cfg.num_layers):
        _mlp(f"layers/{k}/radial_mlp", f"layers.{k}.radial_mlp",
             cfg.radial_mlp_depth + 1)
        for l3 in range(cfg.l_max + 1):
            km[f"layers/{k}/self_w/{l3}"] = f"layers.{k}.self_interaction.{l3}"
            km[f"layers/{k}/mix_w/{l3}"] = f"layers.{k}.linear.{l3}.weight"
            tkeys.add(f"layers/{k}/mix_w/{l3}")
            if parity:  # odd-track twins (parity: true models)
                km[f"layers/{k}/self_w_o/{l3}"] = (
                    f"layers.{k}.self_interaction_o.{l3}"
                )
                km[f"layers/{k}/mix_w_o/{l3}"] = f"layers.{k}.linear_o.{l3}.weight"
                tkeys.add(f"layers/{k}/mix_w_o/{l3}")
        km[f"layers/{k}/gate_w"] = f"layers.{k}.gate.weight"
        tkeys.add(f"layers/{k}/gate_w")
    _mlp("readout_mlp", "readout_mlp", cfg.readout_mlp_depth + 1)
    km["per_type_shift"] = "per_type_energy_shifts"
    km["per_type_scale"] = "per_type_energy_scales"
    return km, tkeys


def e3nn_nequip_key_map(cfg) -> tuple[dict, set[str]]:
    """(key_map, transpose_keys) for e3nn-STYLE PACKED NequIP checkpoints —
    the NequIP mirror of ``e3nn_allegro_key_map`` (layout produced by
    ``torch_ref.e3nn_pack_nequip_state``; see that docstring for the packing
    contract).  Real upstream NequIP checkpoints store per-layer weights in
    e3nn modules: one flat multi-instruction ``o3.Linear`` weight per layer
    (irreps-block concatenation), a flat ``FullyConnectedTensorProduct``
    self-connection whose per-instruction blocks are
    (mul_in1=C, mul_in2=num_types, mul_out=C), indexed-Sequential
    ``FullyConnectedNet`` radial nets in (in, out) orientation, and a flat
    scalar gate linear.

    The same REMAINING UNKNOWNS as the Allegro preset apply (upstream module
    NAMES; e3nn's canonical irrep sort vs this preset's l-major/even-odd
    instruction order), resolvable against a real artifact via
    ``cli import --inspect``."""
    km: dict = {}
    tkeys: set[str] = set()
    C, nt, lmax = cfg.num_features, cfg.num_types, cfg.l_max
    parity = bool(getattr(cfg, "parity", False))
    n_tracks = 2 if parity else 1

    def _flat_2d(key: str, off: int, rows: int, cols: int):
        def get(sd, key=key, off=off, rows=rows, cols=cols):
            return np.asarray(sd[key]).reshape(-1)[off : off + rows * cols] \
                .reshape(rows, cols)

        return get

    def _flat_self(key: str, off: int):
        # (C, nt, C) instruction block -> the twin/JAX (nt, C, C) storage
        def get(sd, key=key, off=off):
            blk = np.asarray(sd[key]).reshape(-1)[off : off + C * nt * C]
            return blk.reshape(C, nt, C).transpose(1, 0, 2)

        return get

    def _mlp(ours: str, theirs: str, n_linear: int):
        for i in range(n_linear):
            km[f"{ours}/w/{i}"] = f"{theirs}.{i}.weight"  # (in, out) direct

    km["chem_embed"] = "chemical_embedding"
    for k in range(cfg.num_layers):
        _mlp(f"layers/{k}/radial_mlp", f"layers.{k}.radial_mlp",
             cfg.radial_mlp_depth + 1)
        off = 0
        for l3 in range(lmax + 1):
            km[f"layers/{k}/mix_w/{l3}"] = _flat_2d(
                f"layers.{k}.linear.weight", off, C, C
            )
            km[f"layers/{k}/self_w/{l3}"] = _flat_self(
                f"layers.{k}.self_interaction.weight", off * nt
            )
            off += C * C
            if parity:
                km[f"layers/{k}/mix_w_o/{l3}"] = _flat_2d(
                    f"layers.{k}.linear.weight", off, C, C
                )
                km[f"layers/{k}/self_w_o/{l3}"] = _flat_self(
                    f"layers.{k}.self_interaction.weight", off * nt
                )
                off += C * C
        km[f"layers/{k}/gate_w"] = _flat_2d(
            f"layers.{k}.gate.weight", 0, C, C * max(lmax, 1) * n_tracks
        )
    _mlp("readout_mlp", "readout_mlp", cfg.readout_mlp_depth + 1)
    km["per_type_shift"] = "per_type_energy_shifts"
    km["per_type_scale"] = "per_type_energy_scales"
    return km, tkeys


def _sorted_tree(tree):
    """``tree`` with every dict's keys sorted (the order ``jax.tree.map``
    gives a dict)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted_tree(v) for v in tree]
    return tree


def template(cfg, dtype=np.float32) -> dict:
    """The tree ``cfg`` asks for (Allegro or NequIP), in the init's key
    order, as ``dtype`` arrays: the port's numpy init of seed 0."""
    init = nequip_init_numpy if isinstance(cfg, NequIPConfig) else allegro_init_numpy
    return _unflatten({k: v.astype(dtype) for k, v in flatten(init(cfg, 0)).items()})


def _import(path, cfg, key_map, strict, dtype, presets):
    transpose: set[str] | str = "auto"
    if isinstance(key_map, str) and key_map in presets:
        key_map, transpose = presets[key_map](cfg)
    sd = load_torch_state_dict(path)
    return map_state_dict(sd, _sorted_tree(template(cfg, dtype)), key_map, strict, transpose)


def import_allegro_checkpoint(path: str, cfg, key_map=None, strict: bool = True,
                              dtype=np.float32):
    """torch checkpoint -> (Allegro numpy tree for ``cfg``, missing keys).

    key_map: an explicit dict, or "upstream" / "e3nn" for the pinned
    presets (`upstream_allegro_key_map`, `e3nn_allegro_key_map`)."""
    return _import(path, cfg, key_map, strict, dtype,
                   {"upstream": upstream_allegro_key_map, "e3nn": e3nn_allegro_key_map})


def import_nequip_checkpoint(path: str, cfg, key_map=None, strict: bool = True,
                             dtype=np.float32):
    """torch checkpoint -> (NequIP numpy tree for ``cfg``, missing keys);
    key_map as for :func:`import_allegro_checkpoint`."""
    return _import(path, cfg, key_map, strict, dtype,
                   {"upstream": upstream_nequip_key_map, "e3nn": e3nn_nequip_key_map})
