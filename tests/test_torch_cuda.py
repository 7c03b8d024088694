"""CUDA legs of the PyTorch port: K1 (csrc/fused_layer.cu), K3
(csrc/nequip_conv.cu), K2 (csrc/env_layer.cu), K5 (csrc/env_layer_mxu.cu,
each precision mode) and K4 (csrc/tp_mix_fused.cu) against their plain
PyTorch versions on the card, f32, forward and backward, for every form;
launch counting; the wrappers' refusals on the card; the models' kernel
paths (K1, per-layer and K4 tiers, NequIP, the FLAT layout of the dense
strategy) against their CPU plain paths and regrows on the card; the
routing predicate against the launchers.  Every test here needs a card
and skips without one.

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
    layer = allegro_params_from_numpy(allegro_init_numpy(cfg, seed), cfg, device=cuda)["layers"][0]
    return fl.k1_weights(layer, lmax, parity)


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


# --- K2 and K5: the per-layer env-fused TP + mix (csrc/env_layer.cu,
# csrc/env_layer_mxu.cu) ----------------------------------------------------

ENV_MODES = ["paths", "mxu_highest", "mxu_bf16x3", "mxu_bf16"]
# forward rtol on max|plain|: sum order only, except mxu_bf16, whose O
# elements near a bf16 rounding boundary may round the other way
ENV_FWD_RTOL = {"paths": 1e-4, "mxu_highest": 1e-4, "mxu_bf16x3": 1e-4, "mxu_bf16": 2e-3}


def _env_case(cuda, mode, c, k, nc, lmax, parity, seed):
    from pair_allegro_tpu_torch.ops import env_layer as k2
    from pair_allegro_tpu_torch.ops import env_layer_mxu as k5
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    g = torch.Generator(device="cpu").manual_seed(seed)
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    mix = {f"l{l3}": torch.randn(c * P[l3], c, generator=g).to(cuda) for l3 in range(lmax + 1)}
    d, e = (lmax + 1) ** 2, nc * k
    V = torch.randn(d, c, e, generator=g) * 0.5
    wz = torch.randn(c, e, generator=g)
    wz[:, -k // 3:] = 0.0  # padded slots (u = 0) at the end of the last row
    Y = torch.randn(d, e, generator=g)
    ins = [t.to(cuda) for t in (V, wz, Y)]
    if mode == "paths":
        w = k2.k2_weights(mix, lmax, parity)
        return k2, w, ins, k2.env_layer, k2.env_layer_reference
    w = k5.k5_weights(mix, lmax, parity, mode)
    return k5, w, ins, k5.env_layer_mxu, None


def _env_compare(mod, w, ins, fn, k, mode, drop_v=False):
    """Kernel against plain version, forward and backward; ``drop_v`` uses
    only inv downstream, so V''s cotangent arrives as zeros (the dead last
    layer)."""
    inv_avg = 1.0 / math.sqrt(5.0)
    ins = [t.requires_grad_(True) for t in ins]
    out_k = fn(*ins, w, k, 5.0)
    if mod.__name__.endswith("mxu"):
        out_r = mod.env_layer_mxu_reference(*[t.detach() for t in ins], w, k, inv_avg)
    else:
        out_r = mod.env_layer_reference(*[t.detach() for t in ins], w, k, inv_avg)
    for a, b in zip(out_k, out_r):
        tol = 1e-4 + ENV_FWD_RTOL[mode] * float(b.abs().max())
        assert float((a.detach() - b).abs().max()) <= tol
    cots = [torch.randn_like(o) for o in out_r]
    if drop_v:
        cots[0] = torch.zeros_like(cots[0])
        g_k = torch.autograd.grad(out_k[1], ins, cots[1])
    else:
        g_k = torch.autograd.grad(out_k, ins, cots)
    if mod.__name__.endswith("mxu"):
        g_r = mod.env_layer_mxu_reference_bwd(*[t.detach() for t in ins], w, k, inv_avg, *cots)
    else:
        with torch.enable_grad():
            ref_in = [t.detach().requires_grad_(True) for t in ins]
            g_r = torch.autograd.grad(mod.env_layer_reference(*ref_in, w, k, inv_avg), ref_in, cots)
    for a, b in zip(g_k, g_r):
        assert float((a - b).abs().max()) <= 1e-4 + 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("c,k,lmax,parity", [(8, 32, 2, True), (32, 64, 2, True), (32, 40, 2, True),
                                             (32, 64, 1, True), (16, 24, 1, False), (8, 20, 2, False)])
@pytest.mark.parametrize("mode", ENV_MODES)
def test_env_kernels_match_plain(cuda, mode, c, k, lmax, parity):
    mod, w, ins, fn, _ = _env_case(cuda, mode, c, k, 6, lmax, parity, 1)
    _env_compare(mod, w, ins, fn, k, mode)


@pytest.mark.parametrize("mode", ENV_MODES)
def test_env_kernels_dead_v_cotangent(cuda, mode):
    mod, w, ins, fn, _ = _env_case(cuda, mode, 32, 64, 4, 2, True, 2)
    _env_compare(mod, w, ins, fn, 64, mode, drop_v=True)


@pytest.mark.parametrize("mode", ["paths", "mxu_bf16x3"])
def test_env_kernels_count_their_launches(cuda, mode):
    mod, w, ins, fn, _ = _env_case(cuda, mode, 8, 32, 4, 2, True, 3)
    ins = [t.requires_grad_(True) for t in ins]
    f0, b0 = mod.launches.fwd, mod.launches.bwd
    out, inv = fn(*ins, w, 32, 5.0)
    (out.sum() + inv.sum()).backward()
    assert (mod.launches.fwd - f0, mod.launches.bwd - b0) == (1, 1)


@pytest.mark.parametrize("mode", ["paths", "mxu_highest"])
def test_env_wrappers_refuse_what_the_kernels_do_not_take(cuda, mode):
    mod, w, (V, wz, Y), fn, _ = _env_case(cuda, mode, 8, 32, 4, 2, True, 4)
    with pytest.raises(TypeError):
        fn(V.double(), wz.double(), Y.double(), w, 32, 5.0)
    with pytest.raises(ValueError):
        fn(V, wz.T.contiguous().T, Y, w, 32, 5.0)  # not contiguous
    with pytest.raises(ValueError):
        fn(V, wz.cpu(), Y, w, 32, 5.0)  # mixed devices
    # K2's thread-owned TP cells need C to divide its 256 threads; K5's
    # register tiles need D*C/4 <= 576
    _, w2, ins2, _, _ = _env_case(cuda, mode, 132 if mode == "paths" else 264, 8, 2, 2, True, 5)
    with pytest.raises(RuntimeError, match="does not take"):
        fn(*ins2, w2, 8, 5.0)


@pytest.mark.parametrize("tp_mode", ["paths", "mxu_highest", "mxu_bf16x3"])
def test_perlayer_model_kernel_path_matches_cpu_plain_path(cuda, tp_mode):
    cfg = AllegroConfig(type_names=("Cu", "Ag"), r_max=4.5, l_max=2, num_layers=3,
                        num_scalar_features=32, num_tensor_features=16, avg_num_neighbors=12.0,
                        output_charges=True, per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)),
                        layer_fused=False, tp_mode=tp_mode)
    tree = allegro_init_numpy(cfg, 0)
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    typ = np.random.RandomState(1).randint(0, 2, n)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        s = System.create(pos, typ, cell=cell, masses=np.full(n, 63.546), device=dev)
        eng = AllegroEngine(cfg, allegro_params_from_numpy(tree, cfg, device=dev), s, device=dev)
        o = eng.force_fn(s, eng.rebuild_fn(s, None))
        outs.append((o.forces.cpu(), o.extras["charges"].cpu()))
    (fk, qk), (fp, qp) = outs
    assert float((fk - fp).abs().max()) < 5e-4
    assert float((qk - qp).abs().max()) < 5e-4


def test_perlayer_forced_small_k_regrows_on_the_card(cuda):
    """The per-layer engine regrows on the card (the memory check reads the
    tier's own estimate) and then follows the CPU plain path's run."""
    import dataclasses

    from pair_allegro_tpu_torch.engine import make_rebuild_fn
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, l_max=2, num_layers=2,
                        num_scalar_features=16, num_tensor_features=8, avg_num_neighbors=12.0,
                        layer_fused=False)
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


# --- K4: the per-edge TP + mix (csrc/tp_mix_fused.cu) and the FLAT layout --


def _k4_case(cuda, c, cout, lmax, parity, e, seed):
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    g = torch.Generator(device="cpu").manual_seed(seed)
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    mix = {f"l{l3}": torch.randn(c * P[l3], cout, generator=g).to(cuda) for l3 in range(lmax + 1)}
    d = (lmax + 1) ** 2
    V = torch.randn(d, c, e, generator=g).to(cuda)
    env = torch.randn(d, c, e, generator=g).to(cuda)
    return k4.k4_weights(mix, lmax, parity), [V, env]


def _k4_compare(w, ins, zero_dout=False):
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    ins = [t.requires_grad_(True) for t in ins]
    out_k = k4.tp_mix_fused_t(*ins, w)
    out_r = k4.tp_mix_fused_reference(*[t.detach() for t in ins], w)
    for a, b in zip(out_k, out_r):
        assert float((a.detach() - b).abs().max()) <= 1e-4 + 1e-4 * float(b.abs().max())
    cots = [torch.randn_like(o) for o in out_r]
    if zero_dout:
        cots[0] = torch.zeros_like(cots[0])
    g_k = torch.autograd.grad(out_k, ins, cots)
    with torch.enable_grad():
        ref_in = [t.detach().requires_grad_(True) for t in ins]
        g_r = torch.autograd.grad(k4.tp_mix_fused_reference(*ref_in, w), ref_in, cots)
    for a, b in zip(g_k, g_r):
        assert float((a - b).abs().max()) <= 1e-4 + 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("c,cout,lmax,parity,e", [
    (32, 32, 2, True, 4096), (32, 32, 2, True, 1001), (32, 32, 1, True, 999), (8, 8, 2, True, 37),
    (16, 24, 2, False, 300), (32, 16, 1, False, 77), (32, 32, 3, True, 200), (64, 64, 3, True, 61),
    (64, 64, 2, True, 130)])
def test_k4_kernel_matches_plain(cuda, c, cout, lmax, parity, e):
    w, ins = _k4_case(cuda, c, cout, lmax, parity, e, 1)
    _k4_compare(w, ins)


def test_k4_dead_v_cotangent(cuda):
    w, ins = _k4_case(cuda, 32, 32, 2, True, 513, 2)
    _k4_compare(w, ins, zero_dout=True)


def test_k4_counts_its_launches(cuda):
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    w, ins = _k4_case(cuda, 8, 8, 2, True, 40, 3)
    ins = [t.requires_grad_(True) for t in ins]
    f0, b0 = k4.launches.fwd, k4.launches.bwd
    out, inv = k4.tp_mix_fused_t(*ins, w)
    (out.sum() + inv.sum()).backward()
    assert (k4.launches.fwd - f0, k4.launches.bwd - b0) == (1, 1)


def test_k4_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    w, (V, env) = _k4_case(cuda, 8, 8, 2, True, 40, 4)
    f0 = k4.launches.fwd
    with pytest.raises(TypeError):
        k4.tp_mix_fused_t(V.double(), env.double(), w)
    with pytest.raises(ValueError):
        k4.tp_mix_fused_t(V, env.transpose(1, 2).contiguous().transpose(1, 2), w)  # not contiguous
    with pytest.raises(ValueError):
        k4.tp_mix_fused_t(V, env.cpu(), w)  # mixed devices
    w6, ins6 = _k4_case(cuda, 6, 8, 1, True, 40, 5)  # C not a multiple of 4
    with pytest.raises(RuntimeError, match="does not take D=4, C=6"):
        k4.tp_mix_fused_t(*ins6, w6)
    with pytest.raises(ValueError, match="3j entries"):  # l_max=3 without parity
        _k4_case(cuda, 8, 8, 3, False, 40, 6)
    assert k4.launches.fwd == f0


def _flat_cfg(species=2, **kw):
    cut = None if species == 1 else ((4.5, 4.2), (4.2, 4.0))
    base = dict(type_names=("Cu", "Ag")[:species], r_max=4.5, l_max=2, num_layers=3,
                num_scalar_features=32, num_tensor_features=16, avg_num_neighbors=12.0,
                output_charges=True, per_edge_type_cutoff=cut)
    return AllegroConfig(**{**base, **kw})


def _flat_system(dev, n_rep, slab, species=2):
    pos, cell = fcc_lattice(n_rep)
    pbc = None
    if slab:
        cell = cell.copy()
        cell[2, 2] += 20.0
        pbc = (True, True, False)
    n = pos.shape[0]
    typ = np.random.RandomState(1).randint(0, species, n)
    return System.create(pos, typ, cell=cell, masses=np.full(n, 63.546), pbc=pbc, device=dev)


@pytest.mark.parametrize("n_rep,slab", [(4, False), (4, True)])
def test_flat_allegro_kernel_path_matches_cpu(cuda, n_rep, slab):
    """The dense strategy's FLAT layout on the card (K4, 3 + 3 launches)
    against the CPU plain path: a 256-atom box and a 256-atom slab."""
    from pair_allegro_tpu_torch.ops import fused_layer, tp_mix_fused

    cfg = _flat_cfg()
    tree = allegro_init_numpy(cfg, 0)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        s = _flat_system(dev, n_rep, slab)
        eng = AllegroEngine(cfg, allegro_params_from_numpy(tree, cfg, device=dev), s, device=dev)
        assert eng.spec.strategy == "dense"
        nb = eng.rebuild_fn(s, None)
        f0, k1 = tp_mix_fused.launches.fwd, fused_layer.launches.fwd
        o = eng.force_fn(s, nb)
        if dev.type == "cuda":
            assert (tp_mix_fused.launches.fwd - f0, fused_layer.launches.fwd - k1) == (3, 0)
        outs.append((o.forces.cpu(), o.extras["charges"].cpu()))
    (fk, qk), (fp, qp) = outs
    assert float((fk - fp).abs().max()) < 5e-4
    assert float((qk - qp).abs().max()) < 5e-4


def test_flat_nequip_matches_cpu_without_k3(cuda):
    from pair_allegro_tpu_torch.engine import NequIPEngine
    from pair_allegro_tpu_torch.models.nequip import (
        NequIPConfig,
        nequip_init_numpy,
        nequip_params_from_numpy,
    )
    from pair_allegro_tpu_torch.ops import nequip_conv

    cfg = NequIPConfig(type_names=("Cu", "Ag"), r_max=4.5, num_layers=2, num_features=16,
                       avg_num_neighbors=12.0, parity=True,
                       per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)))
    tree = nequip_init_numpy(cfg, 0)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        s = _flat_system(dev, 3, True)
        eng = NequIPEngine(cfg, nequip_params_from_numpy(tree, cfg, device=dev), s, device=dev)
        k3 = nequip_conv.launches.fwd
        o = eng.force_fn(s, eng.rebuild_fn(s, None))
        assert nequip_conv.launches.fwd == k3
        outs.append(o.forces.cpu())
    assert float((outs[0] - outs[1]).abs().max()) < 5e-4


def test_dense_regrow_on_the_card(cuda):
    """A too-small max_edges overflows, regrows (with the memory check that
    counts the dense build) and the run then follows the CPU's."""
    import dataclasses

    from pair_allegro_tpu_torch.engine import make_rebuild_fn
    from pair_allegro_tpu_torch.md.integrate import Simulation
    from pair_allegro_tpu_torch.system import Units

    cfg = _flat_cfg(species=1, num_layers=2, num_scalar_features=16, num_tensor_features=8,
                    output_charges=False)
    tree = allegro_init_numpy(cfg, 0)
    ends = []
    for dev in (cuda, torch.device("cpu")):
        s = _flat_system(dev, 3, True, species=1)
        eng = AllegroEngine(cfg, allegro_params_from_numpy(tree, cfg, device=dev), s, device=dev,
                            skin=0.4)
        small = eng.spec.max_edges // 2
        eng.spec = dataclasses.replace(eng.spec, max_edges=small)
        eng.rebuild_fn = make_rebuild_fn(eng.spec, 0.4)
        sim = Simulation(s, eng.force_fn, eng.rebuild_fn, dt=2.0 * Units.fs, grow_fn=eng.grow)
        sim.run(6, log_every=3)
        assert sim.regrows >= 1 and eng.spec.max_edges > small
        ends.append(sim.state.system.positions.cpu())
    assert float((ends[0] - ends[1]).abs().max()) < 1e-4


@pytest.mark.parametrize("c,lmax,layer_fused", [(32, 2, True), (64, 2, True), (64, 2, False),
                                                (64, 3, False), (32, 3, True)])
def test_env_fused_viable_mirrors_the_launchers(cuda, c, lmax, layer_fused):
    """The predicate that routes TABLE models is True exactly where the
    env-fused kernel of the tier launches (K1 or K2 at these widths)."""
    from pair_allegro_tpu_torch.models.allegro import env_fused_viable
    from pair_allegro_tpu_torch.ops import env_layer as k2

    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, l_max=lmax, num_layers=1,
                        num_scalar_features=64, num_tensor_features=c, layer_fused=layer_fused)
    layer = allegro_params_from_numpy(allegro_init_numpy(cfg, 0), cfg, device=cuda)["layers"][0]
    k = 16
    x, V, Y, u = _operands(cuda, 64, c, k, 3, True, 7, lmax)
    x.requires_grad_(True)
    try:
        if layer_fused:
            fl.fused_layer(x, V, Y, u, fl.k1_weights(layer, lmax, True), k, 5.0, first_v=True)
            V0 = V.unsqueeze(0) * Y.unsqueeze(1)
            out = fl.fused_layer(x, V0, Y, u, fl.k1_weights(layer, lmax, True), k, 5.0)
            out[0].sum().backward()  # the backward takes the most shared memory
        else:
            V0 = (V.unsqueeze(0) * Y.unsqueeze(1)).requires_grad_(True)
            w2 = k2.k2_weights(layer["mix"], lmax, True)
            out, inv = k2.env_layer(V0, x[:c].contiguous(), Y, w2, k, 5.0)
            (out.sum() + inv.sum()).backward()
        torch.cuda.synchronize()
        launched = True
    except RuntimeError as err:
        assert "launch failed" in str(err)
        launched = False
    assert launched == env_fused_viable(cfg)


def test_too_wide_table_model_runs_k4_on_the_card(cuda):
    """A TABLE model the env-fused kernels cannot hold (C=64 on the K1
    tier) runs K4 on the card, no K1, and matches the CPU."""
    from pair_allegro_tpu_torch.models.allegro import env_fused_viable
    from pair_allegro_tpu_torch.ops import tp_mix_fused

    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, l_max=2, num_layers=2,
                        num_scalar_features=32, num_tensor_features=64, avg_num_neighbors=12.0)
    assert not env_fused_viable(cfg)
    tree = allegro_init_numpy(cfg, 0)
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        s = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=np.full(n, 63.546),
                          device=dev)
        eng = AllegroEngine(cfg, allegro_params_from_numpy(tree, cfg, device=dev), s, device=dev)
        assert eng.spec.strategy == "cell_list"
        f0, k1 = tp_mix_fused.launches.fwd, fl.launches.fwd
        o = eng.force_fn(s, eng.rebuild_fn(s, None))
        if dev.type == "cuda":
            assert (tp_mix_fused.launches.fwd - f0, fl.launches.fwd - k1) == (2, 0)
        outs.append(o.forces.cpu())
    assert float((outs[0] - outs[1]).abs().max()) < 5e-4
