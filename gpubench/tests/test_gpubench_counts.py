"""counts/ against chip_smoke.py's cost functions at the slot count E = N K,
where the frozen copies must agree with the originals."""

import pytest
import torch

import chip_smoke
from cells import small_cell


@pytest.mark.parametrize("form", ["first", "middle", "last"])
@pytest.mark.parametrize("bwd", [False, True])
def test_gpubench_k1_counts_match_chip_smoke(form, bwd):
    from pair_allegro_tpu_torch.ops.fused_layer import k1_weights

    from gpubench import harness
    from gpubench.counts import allegro as counts
    from gpubench.families import allegro as fam

    cf = harness.load("configs", "allegro-cu-flagship")
    m = cf["model"]
    layer = fam.make_tree(m, 0, "cpu", torch.float32)["layers"][0]
    w = k1_weights(layer, m["l_max"], m["parity"])
    e, k = 5324 * 64, 64
    n_w = sum(t.numel() for t in w.tensors())
    dims = counts.layer_dims(m)
    assert tuple(w.dims[:3]) == dims[:3] and list(w.dims[3]) == dims[3]
    assert counts.k1_cost(dims, n_w, m["l_max"], m["parity"], e, form, bwd) == \
        chip_smoke.k1_cost(w, e, k, form, bwd)
    assert counts.k1_products(dims, m["l_max"], m["parity"], form, bwd) == \
        chip_smoke.k1_products(w, form, bwd)


@pytest.mark.parametrize("bwd", [False, True])
def test_gpubench_k3_counts_match_chip_smoke(bwd):
    from pair_allegro_tpu_torch.ops.nequip_conv import prepare_radial, radial_cl

    from gpubench import harness
    from gpubench.counts import nequip as counts
    from gpubench.families import nequip as fam
    from gpubench.reference.nequip import n_paths

    m = harness.load("configs", "nequip-cu-flagship")["model"]
    C, T = m["num_features"], 2
    ws = fam.make_tree(m, 0, "cpu", torch.float32)["layers"][0]["radial_mlp"]["w"]
    w = prepare_radial(radial_cl(ws, C, n_paths(m["l_max"]), T), C, T, m["l_max"])
    e, k = 16384 * 64, 64
    n_w = sum(t.numel() for t in w.tensors())
    assert counts.radial_dims(m) == w.dims
    assert counts.k3_cost(w.dims, C, T, m["l_max"], n_w, e, e // k, bwd) == \
        chip_smoke.k3_cost(w, e, k, bwd)


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_gpubench_evaluation_counts_scale_with_edges(family):
    import importlib

    from gpubench import harness

    counts = importlib.import_module(f"gpubench.counts.{family}")
    m = harness.load("configs", small_cell(family)[0]["config"])["model"]
    a, b = counts.evaluation(m, 1000, 42000), counts.evaluation(m, 1000, 84000)
    assert 0 < a["products"] < a["flops"] and a["bytes"] > 0
    assert 1.5 < b["flops"] / a["flops"] < 2.0
