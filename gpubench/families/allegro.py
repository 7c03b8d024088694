"""The Allegro family: the port's config and engine from a configuration
file's ``model`` block, and the parameter tree made from a seed."""

from __future__ import annotations

from gpubench.families import leaves_from_seed


def model_config(m: dict):
    from pair_allegro_tpu_torch.models.allegro import AllegroConfig

    return AllegroConfig(**{**m, "type_names": tuple(m["type_names"])})


def tree_shapes(m: dict) -> dict:
    """The parameter tree of the JAX layout as shapes: unit-normal weights,
    per-type shifts 0 and scales 1."""
    from gpubench.reference.allegro import parity_paths

    nt, ns, c = len(m["type_names"]), m["num_scalar_features"], m["num_tensor_features"]
    P = parity_paths(m["l_max"], m["parity"])

    def mlp(*dims):
        return {"w": [(a, b) for a, b in zip(dims[:-1], dims[1:])]}

    return {
        "two_body_mlp": mlp(2 * nt + m["num_bessels"],
                            *[m["two_body_mlp_width"]] * m["two_body_mlp_depth"], ns),
        "tensor_embed": (ns, c),
        "layers": [
            {"env_weight": (ns, c),
             "latent_mlp": mlp(ns + c * P[0], *[m["allegro_mlp_hidden_layers_width"]]
                               * m["allegro_mlp_hidden_layers_depth"], ns),
             "mix": {f"l{l3}": (c * P[l3], c) for l3 in range(m["l_max"] + 1)}}
            for _ in range(m["num_layers"])
        ],
        "readout_mlp": mlp(ns, *[m["readout_mlp_hidden_layers_width"]]
                           * m["readout_mlp_hidden_layers_depth"], 1),
        "per_type_shift": ("zeros", nt),
        "per_type_scale": ("ones", nt),
    }


def make_tree(m: dict, seed: int, device, dtype):
    return leaves_from_seed(tree_shapes(m), seed, device, dtype)


def make_engine(cfg, params, system, skin: float, device):
    from pair_allegro_tpu_torch.engine import AllegroEngine

    return AllegroEngine(cfg, params, system, device=device, skin=skin)
