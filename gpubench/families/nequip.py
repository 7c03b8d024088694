"""The NequIP family: the port's config and engine from a configuration
file's ``model`` block, and the parameter tree made from a seed."""

from __future__ import annotations

from gpubench.families import leaves_from_seed


def model_config(m: dict):
    from pair_allegro_tpu_torch.models.nequip import NequIPConfig

    return NequIPConfig(**{**m, "type_names": tuple(m["type_names"])})


def tree_shapes(m: dict) -> dict:
    """The parameter tree of the JAX layout as shapes: unit-normal weights,
    per-type shifts 0 and scales 1; the radial MLP's last columns c-major
    (c * T * P + tau * P + p), the gate's (c * l_max * T + l * T + tau)."""
    from gpubench.reference.nequip import n_paths

    nt, C, lmax = len(m["type_names"]), m["num_features"], m["l_max"]
    T = 2 if m["parity"] else 1

    def mlp(*dims):
        return {"w": [(a, b) for a, b in zip(dims[:-1], dims[1:])]}

    def layer():
        out = {
            "radial_mlp": mlp(m["num_bessels"], *[m["radial_mlp_width"]] * m["radial_mlp_depth"],
                              C * n_paths(lmax) * T),
            "self_w": [(nt, C, C) for _ in range(lmax + 1)],
            "mix_w": [(C, C) for _ in range(lmax + 1)],
            "gate_w": (C, C * lmax * T),
        }
        if T == 2:
            out["self_w_o"] = [(nt, C, C) for _ in range(lmax + 1)]
            out["mix_w_o"] = [(C, C) for _ in range(lmax + 1)]
        return out

    return {
        "chem_embed": (nt, C),
        "layers": [layer() for _ in range(m["num_layers"])],
        "readout_mlp": mlp(C, *[m["readout_mlp_width"]] * m["readout_mlp_depth"], 1),
        "per_type_shift": ("zeros", nt),
        "per_type_scale": ("ones", nt),
    }


def make_tree(m: dict, seed: int, device, dtype):
    return leaves_from_seed(tree_shapes(m), seed, device, dtype)


def make_engine(cfg, params, system, skin: float, device):
    from pair_allegro_tpu_torch.engine import NequIPEngine

    return NequIPEngine(cfg, params, system, device=device, skin=skin)
