"""CUDA legs of the PyTorch port: K1 (csrc/fused_layer.cu) and K3
(csrc/nequip_conv.cu) against their plain PyTorch versions on the card, f32,
forward and backward, for every form; launch counting; the wrappers'
refusals on the card; the models' kernel paths against their CPU plain
paths and regrows on the card.  Every test here needs a card and skips
without one.

This file imports torch and the port only (no JAX), so that it also runs
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from pair_allegro_tpu_torch.engine import AllegroEngine
from pair_allegro_tpu_torch.models.allegro import (
    AllegroConfig,
    allegro_init_numpy,
    allegro_params_from_numpy,
)
from pair_allegro_tpu_torch.ops import fused_layer as fl
from pair_allegro_tpu_torch.system import System, fcc_lattice

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
FORMS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _layer(cuda, ns, c, seed=0, lmax=2, parity=True):
    cfg = AllegroConfig(type_names=("A", "B"), r_max=4.0, l_max=lmax, num_layers=1,
                        num_scalar_features=ns, num_tensor_features=c, avg_num_neighbors=5.0,
                        parity=parity)
    return allegro_params_from_numpy(allegro_init_numpy(cfg, seed), cfg, device=cuda)["layers"][0]["k1"]


def _operands(cuda, ns, c, k, nc, first_v, seed, lmax=2):
    g = torch.Generator(device="cpu").manual_seed(seed)
    e, d = nc * k, (lmax + 1) ** 2
    x = torch.randn(ns, e, generator=g) * 0.3
    V = torch.randn(c, e, generator=g) * 0.3 if first_v else torch.randn(d, c, e, generator=g) * 0.3
    Y = torch.randn(d, e, generator=g)
    u = torch.rand(1, e, generator=g)
    u[:, -k // 3:] = 0.0  # padded slots at the end of the last row
    return [t.to(cuda) for t in (x, V, Y, u)]


@pytest.mark.parametrize("ns,c,k", [(16, 8, 32), (64, 32, 64), (64, 32, 40)])
@pytest.mark.parametrize("first_v,last", FORMS)
def test_kernel_matches_plain(cuda, ns, c, k, first_v, last):
    w = _layer(cuda, ns, c)
    ins = [t.requires_grad_(True) for t in _operands(cuda, ns, c, k, 6, first_v, 1)]
    out_k = fl.fused_layer(*ins, w, k, 5.0, first_v=first_v, last=last)
    out_r = fl.fused_layer_reference(*ins, w, k, 1.0 / math.sqrt(5.0), first_v, last)
    out_k, out_r = ((out_k,), (out_r,)) if last else (out_k, out_r)
    for a, b in zip(out_k, out_r):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    cots = [torch.randn_like(o) for o in out_r]
    for a, b in zip(torch.autograd.grad(out_k, ins, cots), torch.autograd.grad(out_r, ins, cots)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("lmax,parity", [(1, True), (1, False), (2, False), (3, True)])
@pytest.mark.parametrize("first_v,last", [(True, False), (False, True)])
def test_kernel_matches_plain_other_lmax(cuda, lmax, parity, first_v, last):
    w = _layer(cuda, 16, 8, lmax=lmax, parity=parity)
    ins = [t.requires_grad_(True) for t in _operands(cuda, 16, 8, 24, 5, first_v, 4, lmax)]
    out_k = fl.fused_layer(*ins, w, 24, 5.0, first_v=first_v, last=last)
    out_r = fl.fused_layer_reference(*ins, w, 24, 1.0 / math.sqrt(5.0), first_v, last)
    out_k, out_r = ((out_k,), (out_r,)) if last else (out_k, out_r)
    for a, b in zip(out_k, out_r):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    cots = [torch.randn_like(o) for o in out_r]
    for a, b in zip(torch.autograd.grad(out_k, ins, cots), torch.autograd.grad(out_r, ins, cots)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_kernel_counts_its_launches(cuda):
    w = _layer(cuda, 16, 8)
    ins = [t.requires_grad_(True) for t in _operands(cuda, 16, 8, 32, 4, True, 2)]
    f0, b0 = fl.launches.fwd, fl.launches.bwd
    x, _ = fl.fused_layer(*ins, w, 32, 5.0, first_v=True)
    x.sum().backward()
    assert (fl.launches.fwd - f0, fl.launches.bwd - b0) == (1, 1)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    w = _layer(cuda, 16, 8)
    x, V, Y, u = _operands(cuda, 16, 8, 32, 4, False, 3)
    with pytest.raises(TypeError):
        fl.fused_layer(x.double(), V.double(), Y.double(), u.double(), w, 32, 5.0)
    with pytest.raises(ValueError):
        fl.fused_layer(x.T.contiguous().T, V, Y, u, w, 32, 5.0)  # not contiguous
    with pytest.raises(ValueError):
        fl.fused_layer(x, V.cpu(), Y, u, w, 32, 5.0)  # mixed devices


@pytest.mark.parametrize("types", ["one", "two"])
def test_model_kernel_path_matches_cpu_plain_path(cuda, types):
    names = ("Cu",) if types == "one" else ("Cu", "Ag")
    cut = None if types == "one" else ((4.5, 4.2), (4.2, 4.0))
    cfg = AllegroConfig(type_names=names, r_max=4.5, l_max=2, num_layers=3,
                        num_scalar_features=32, num_tensor_features=16, avg_num_neighbors=12.0,
                        output_charges=True, per_edge_type_cutoff=cut)
    tree = allegro_init_numpy(cfg, 0)
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    typ = np.random.RandomState(1).randint(0, len(names), n)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        s = System.create(pos, typ, cell=cell, masses=np.full(n, 63.546), device=dev)
        eng = AllegroEngine(cfg, allegro_params_from_numpy(tree, cfg, device=dev), s, device=dev)
        o = eng.force_fn(s, eng.rebuild_fn(s, None))
        outs.append((o.forces.cpu(), o.extras["charges"].cpu()))
    (fk, qk), (fp, qp) = outs
    assert float((fk - fp).abs().max()) < 5e-4
    assert float((qk - qp).abs().max()) < 5e-4


def test_forced_small_k_regrows_on_the_card(cuda):
    """A too-small K overflows, regrows (with the device-memory check) and
    the run then follows the CPU plain path's."""
    import dataclasses

    from pair_allegro_tpu_torch.engine import make_rebuild_fn
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, l_max=2, num_layers=2,
                        num_scalar_features=16, num_tensor_features=8, avg_num_neighbors=12.0)
    tree = allegro_init_numpy(cfg, 0)
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    ends = []
    for dev in (cuda, torch.device("cpu")):
        s = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=np.full(n, 63.546),
                          device=dev)
        eng = AllegroEngine(cfg, allegro_params_from_numpy(tree, cfg, device=dev), s, device=dev,
                            skin=0.4)
        eng.spec = dataclasses.replace(eng.spec, max_neighbors=16, max_edges=n * 16)
        eng.rebuild_fn = make_rebuild_fn(eng.spec, 0.4)
        sim = Simulation(s, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs, grow_fn=eng.grow)
        sim.run(6, log_every=3)
        assert sim.regrows >= 1 and eng.spec.max_neighbors > 16
        ends.append(sim.state.system.positions.cpu())
    assert float((ends[0] - ends[1]).abs().max()) < 1e-4


# --- K3: the fused NequIP convolution (csrc/nequip_conv.cu) ---------------


def _k3_case(cuda, lmax, T, c, k, nc, seed):
    from pair_allegro_tpu_torch.ops import nequip_conv as nc_mod
    from pair_allegro_tpu_torch.ops.tp import tp_num_paths

    g = torch.Generator(device="cpu").manual_seed(seed)
    d, p, e = (lmax + 1) ** 2, tp_num_paths(lmax), nc * k
    ws = [torch.randn(8, 32, generator=g), torch.randn(32, 32, generator=g),
          torch.randn(32, T * p * c, generator=g)]
    w = nc_mod.prepare_radial([t.to(cuda) for t in ws], c, T, lmax)
    hj = torch.randn(e, d * T * c, generator=g)
    bes = torch.randn(e, 8, generator=g)
    u = torch.rand(e, 1, generator=g)
    u[-k // 3:] = 0.0  # padded slots at the end of the last row
    Y = torch.randn(e, d, generator=g)
    return w, [t.to(cuda) for t in (hj, bes, u, Y)]


@pytest.mark.parametrize("c,k", [(64, 64), (32, 40), (8, 20)])
@pytest.mark.parametrize("lmax,T", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_k3_kernel_matches_plain(cuda, lmax, T, c, k):
    from pair_allegro_tpu_torch.ops import nequip_conv as nc_mod

    w, ins = _k3_case(cuda, lmax, T, c, k, 6, 1)
    ins = [t.requires_grad_(True) for t in ins]
    out_k = nc_mod.nequip_conv(*ins, w, k, 12.0)
    out_r = nc_mod.nequip_conv_reference(*ins, w, k, 1.0 / math.sqrt(12.0))
    torch.testing.assert_close(out_k, out_r, atol=1e-4, rtol=1e-4)
    cot = torch.randn_like(out_r)
    for a, b in zip(torch.autograd.grad(out_k, ins, cot), torch.autograd.grad(out_r, ins, cot)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_k3_counts_its_launches(cuda):
    from pair_allegro_tpu_torch.ops import nequip_conv as nc_mod

    w, ins = _k3_case(cuda, 1, 2, 64, 32, 4, 2)
    ins = [t.requires_grad_(True) for t in ins]
    f0, b0 = nc_mod.launches.fwd, nc_mod.launches.bwd
    nc_mod.nequip_conv(*ins, w, 32, 12.0).sum().backward()
    assert (nc_mod.launches.fwd - f0, nc_mod.launches.bwd - b0) == (1, 1)


def test_k3_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from pair_allegro_tpu_torch.ops import nequip_conv as nc_mod

    w, (hj, bes, u, Y) = _k3_case(cuda, 1, 2, 64, 32, 4, 3)
    with pytest.raises(TypeError):
        nc_mod.nequip_conv(hj.double(), bes.double(), u.double(), Y.double(), w, 32, 12.0)
    with pytest.raises(ValueError):
        nc_mod.nequip_conv(hj, bes.T.contiguous().T, u, Y, w, 32, 12.0)  # not contiguous
    with pytest.raises(ValueError):
        nc_mod.nequip_conv(hj, bes.cpu(), u, Y, w, 32, 12.0)  # mixed devices


def test_nequip_forced_small_k_regrows_on_the_card(cuda):
    """A too-small K overflows and regrows a NequIPEngine on the card (the
    regrow's device-memory check reads NequIP's own estimate), and the run
    then follows the CPU plain path's."""
    import dataclasses

    from pair_allegro_tpu_torch.engine import NequIPEngine, make_rebuild_fn
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.models.nequip import (
        NequIPConfig,
        nequip_init_numpy,
        nequip_params_from_numpy,
    )
    from pair_allegro_tpu_torch.system import Units

    cfg = NequIPConfig(type_names=("Cu",), r_max=4.5, num_layers=2, num_features=16,
                       avg_num_neighbors=12.0, parity=True)
    tree = nequip_init_numpy(cfg, 0)
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    ends = []
    for dev in (cuda, torch.device("cpu")):
        s = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=np.full(n, 63.546),
                          device=dev)
        eng = NequIPEngine(cfg, nequip_params_from_numpy(tree, cfg, device=dev), s, device=dev,
                           skin=0.4)
        eng.spec = dataclasses.replace(eng.spec, max_neighbors=16, max_edges=n * 16)
        eng.rebuild_fn = make_rebuild_fn(eng.spec, 0.4)
        sim = Simulation(s, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs, grow_fn=eng.grow)
        sim.run(6, log_every=3)
        assert sim.regrows >= 1 and eng.spec.max_neighbors > 16
        ends.append(sim.state.system.positions.cpu())
    assert float((ends[0] - ends[1]).abs().max()) < 1e-4
