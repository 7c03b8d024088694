"""CUDA legs of the PyTorch port: K1 (csrc/fused_layer.cu), K3
(csrc/nequip_conv.cu), K2 (csrc/env_layer.cu), K5 (csrc/env_layer_mxu.cu,
each precision mode), K4 (csrc/tp_mix_fused.cu), K6 / K7
(csrc/embed_readout_layer.cu) and K8 (csrc/fused_stack.cu) against their
plain PyTorch versions on the card, f32, forward and backward, for every
form; launch counting; the wrappers' refusals on the card; the models'
kernel paths (K1 in its three forms, per-layer, K4 and stack tiers,
NequIP, the FLAT layout of the dense strategy) against their CPU plain
paths and regrows on the card; the routing predicates against the
launchers; f64 systems and widths no kernel takes on the plain path;
``cli run`` on the card against ``--device cpu``, the CUDA noise
generator's state across a restart; a training step on the card (no
kernel launch), its gradient against the CPU's at f64, and the trained
tree on the K1 tier against the plain path.  Every test here needs a card
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


def _cotangents(outs, seed=7):
    """Cotangents for ``outs`` from a seeded CPU generator, moved to the
    outputs' device: a leg's inputs are the same alone and in the whole
    suite (the global CUDA generator's state depends on the legs before)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(o.shape, generator=g, dtype=o.dtype).to(o.device) for o in outs]


def _layer(cuda, ns, c, seed=0, lmax=2, parity=True, **fields):
    cfg = AllegroConfig(type_names=("A", "B"), r_max=4.0, l_max=lmax, num_layers=1,
                        num_scalar_features=ns, num_tensor_features=c, avg_num_neighbors=5.0,
                        parity=parity, **fields)
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
    cots = _cotangents(out_r)
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
    cots = _cotangents(out_r)
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
    (cot,) = _cotangents((out_r,))
    for a, b in zip(torch.autograd.grad(out_k, ins, cot), torch.autograd.grad(out_r, ins, cot)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


# (l_max, tracks, C, K, centers, hidden widths, Bessels): together they reach
# every layout the launcher picks, forward and backward (every edge tile,
# the last weight resident and read through the read-only cache; the CPU
# test tests/test_torch_port_k3.py holds that), with tails (K no multiple
# of the forward tile, E no multiple of the backward one), C = 4 and 128,
# a last radial input width no multiple of 8, two dX passes (64), and no
# hidden layer
K3_LAYOUT_CASES = [
    (1, 2, 64, 64, 12, (32, 32), 8),   # the main path's widths
    (1, 2, 64, 70, 5, (32, 32), 8),
    (2, 2, 64, 40, 6, (32, 32), 8),
    (2, 2, 128, 24, 4, (32, 32), 8),
    (1, 1, 128, 33, 5, (36,), 12),
    (1, 1, 4, 20, 7, (32, 32), 8),
    (2, 1, 16, 50, 3, (64, 64), 8),
    (1, 2, 32, 16, 9, (), 8),
    (2, 2, 16, 30, 3, (128,), 8),
    (2, 2, 8, 30, 3, (256,), 8),
    (1, 1, 4, 30, 3, (128,), 8),
    (1, 1, 4, 30, 3, (256,), 8),
    (1, 1, 4, 18, 3, (512,), 8),
    (2, 2, 4, 18, 3, (256,), 8),
    (2, 2, 4, 18, 3, (384,), 8),
    (2, 2, 4, 18, 3, (512,), 8),
    (2, 1, 4, 18, 3, (512,), 8),
    (2, 2, 4, 18, 3, (512, 512), 8),
    (2, 1, 4, 18, 3, (768, 768), 8),
]


def _k3_layout_case(cuda, lmax, T, c, k, n, hidden, b, seed=4):
    from pair_allegro_tpu_torch.ops import nequip_conv as nc_mod
    from pair_allegro_tpu_torch.ops.tp import tp_num_paths

    g = torch.Generator(device="cpu").manual_seed(seed)
    d, e = (lmax + 1) ** 2, n * k
    dims = (b, *hidden, T * tp_num_paths(lmax) * c)
    ws = [torch.randn(a, o, generator=g) for a, o in zip(dims[:-1], dims[1:])]
    w = nc_mod.prepare_radial([t.to(cuda) for t in ws], c, T, lmax)
    u = torch.rand(e, 1, generator=g)
    u[-k // 3:] = 0.0
    ins = [torch.randn(e, d * T * c, generator=g), torch.randn(e, b, generator=g), u,
           torch.randn(e, d, generator=g)]
    return w, [t.to(cuda) for t in ins]


def _tight(kind, got, want):
    """chip_smoke's tight gate: max|got - want| <= atol + rtol max|want|."""
    from chip_smoke import TIGHT_TOLS

    atol, rtol = TIGHT_TOLS[kind]
    for i, (a, b) in enumerate(zip(got, want)):
        err, tol = float((a - b).abs().max()), atol + rtol * float(b.abs().max())
        assert err <= tol, (kind, i, err, tol)


@pytest.mark.parametrize("case", K3_LAYOUT_CASES)
def test_k3_matches_plain_at_every_layout(cuda, case):
    """K3 against its plain version within the tight gate (TIGHT_TOLS),
    forward and backward, at widths that reach each layout the launcher
    picks; the launcher's pick is the one block_layout mirrors."""
    from pair_allegro_tpu_torch.ops import nequip_conv as nc_mod

    lmax, T, c, k, n = case[:5]
    w, ins = _k3_layout_case(cuda, *case)
    lib = nc_mod.LIB.load()
    for bwd in (False, True):
        got = tuple(lib.k3_layout_of(int(bwd), lmax, T, nc_mod.launch_dims(w, k, n * k), what)
                    for what in (0, 1, 2))
        nbytes, et, resident = nc_mod.block_layout(c, T, lmax, w.dims, bwd)
        assert got == (nbytes, et, int(resident)), (case, bwd)
    ins = [t.requires_grad_(True) for t in ins]
    out_k = nc_mod.nequip_conv(*ins, w, k, 12.0)
    out_r = nc_mod.nequip_conv_reference(*ins, w, k, 1.0 / math.sqrt(12.0))
    _tight("fwd", (out_k.detach(),), (out_r.detach(),))
    (cot,) = _cotangents((out_r,))
    _tight("bwd", torch.autograd.grad(out_k, ins, cot), torch.autograd.grad(out_r, ins, cot))


def test_k3_long_radial_product_over_cotangent_seeds(cuda):
    """The case whose 768-wide hidden layer gives the last radial product a
    768-term sum (K3_LAYOUT_CASES[18]), over 20 cotangent seeds: the
    kernel's backward within the tight gate of the plain version at f64 on
    the card, and of the plain f32 version (the gate of the layout leg)."""
    from chip_smoke import K3_SPREAD_CASE, TIGHT_TOLS, k3_layout_operands, k3_seed_grads

    assert K3_SPREAD_CASE == K3_LAYOUT_CASES[18]
    atol, rtol = TIGHT_TOLS["bwd"]
    w, ins = k3_layout_operands(cuda, *K3_SPREAD_CASE)
    for seed in range(20):
        g_k, g_p, g_64 = k3_seed_grads(w, ins, K3_SPREAD_CASE[3], 12.0, seed)
        for want in (g_64, g_p):
            for i, (a, b) in enumerate(zip(g_k, want)):
                b = b.double()
                err = float((a.double() - b).abs().max())
                assert err <= atol + rtol * float(b.abs().max()), (seed, i, err)


def test_k3_layout_refusals_mirror_the_launcher(cuda):
    """Widths the launcher refuses (its negative codes) are those
    kernel_takes refuses: C, the last input width, the output width."""
    import ctypes

    from pair_allegro_tpu_torch.ops import nequip_conv as nc_mod

    lib = nc_mod.LIB.load()
    for c, T, lmax, dims, code in [(12, 1, 1, (8, 32, 60), -3), (64, 2, 1, (8, 30, 640), -7),
                                   (64, 2, 1, (8, 32, 600), -4), (256, 1, 1, (8, 32, 1280), -3)]:
        arr = (ctypes.c_int * 13)(c, 10, 30, len(dims) - 1, *dims, *([0] * (9 - len(dims))))
        for bwd in (0, 1):
            assert lib.k3_layout_of(bwd, lmax, T, arr, 0) == code, (c, dims)
        assert not nc_mod.kernel_takes(c, T, lmax, dims)


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


def _env_case(cuda, mode, c, k, nc, lmax, parity, seed, cout=None):
    from pair_allegro_tpu_torch.ops import env_layer as k2
    from pair_allegro_tpu_torch.ops import env_layer_mxu as k5
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    g = torch.Generator(device="cpu").manual_seed(seed)
    P = num_paths_per_l(lmax, lmax, lmax, parity)
    mix = {f"l{l3}": torch.randn(c * P[l3], cout or c, generator=g).to(cuda)
           for l3 in range(lmax + 1)}
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
    cots = _cotangents(out_r)
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


# K5 at margin widths (c, cout, k, l_max, parity): C = 12 and 20 zero-fill
# the chunks' depth, Cout != C, l_max 3 takes two row passes each way, K not
# a multiple of the 64-edge tile (100: two tiles, 20: one partial); C = 172
# at l_max 2 and C = 300 at l_max 0 (widths the CUDA-core K5 took) take
# five backward passes over channel blocks, the last one partial
K5_MARGINS = [(12, 12, 64, 2, True), (20, 20, 64, 2, True), (32, 16, 64, 2, True),
              (12, 20, 40, 1, True), (20, 12, 64, 1, False), (32, 32, 64, 3, True),
              (12, 12, 64, 3, False), (32, 32, 100, 2, True), (32, 32, 20, 2, True),
              (172, 172, 64, 2, True), (300, 40, 64, 0, True)]


@pytest.mark.parametrize("c,cout,k,lmax,parity", K5_MARGINS)
@pytest.mark.parametrize("mode", ENV_MODES[1:])
def test_k5_matches_plain_margin_widths(cuda, mode, c, cout, k, lmax, parity):
    mod, w, ins, fn, _ = _env_case(cuda, mode, c, k, 5, lmax, parity, 7, cout=cout)
    _env_compare(mod, w, ins, fn, k, mode)


def test_k5_layouts_mirror_the_launcher(cuda):
    """The library's shared-memory and layout sizes against the wrapper's
    (``smem_bytes``, ``kernel_layout``'s chunk count and dtype)."""
    from pair_allegro_tpu_torch.ops import env_layer_mxu as k5

    lib = k5.LIB.load()
    for c, cout, d, mode in [(32, 32, 9, 0), (12, 20, 4, 1), (128, 128, 16, 2), (264, 264, 9, 0),
                             (20, 24, 16, 1), (4, 4, 1, 0)]:
        name = k5.MODES[mode]
        for bwd in (False, True):
            assert lib.k5_smem_bytes(int(bwd), c, cout, d, mode) == k5.smem_bytes(bwd, c, cout, d,
                                                                                  name)
            npass, R, nq, _ = k5.plan(bwd, c, cout, d)
            chunk = R * 32 * (4 if mode == 0 else 2 * (2 if mode == 1 else 1))
            want = (d if bwd else 1) * npass * nq * chunk
            assert lib.k5_layout_bytes(int(bwd), c, cout, d, mode) == want


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
    if mode == "paths":  # K2's thread-owned TP cells need C to divide its 256 threads
        _, w2, ins2, _, _ = _env_case(cuda, mode, 132, 8, 2, 2, True, 5)
        with pytest.raises(RuntimeError, match="does not take"):
            fn(*ins2, w2, 8, 5.0)
        return
    # K5 takes every width whose matrix is of a buildable size; its launcher
    # refuses a backward whose env and denv (2 D*C words) overflow shared
    # memory (C = 1200 at l_max 2, a 4 GB matrix): a negative code, before
    # any pointer is read
    import ctypes

    assert not mod.kernel_takes(1200, 1200, 9, 3, mode)
    dims = (ctypes.c_int * 7)(1200, 1200, 9, 8, 16, 3, 0)
    ptrs = (ctypes.c_ulonglong * 12)(0, 0, 0, 256, *([0] * 8))
    assert mod.LIB.load().k5_launch(1, ptrs, dims, ctypes.c_float(1.0), None) == -6
    # a refused launch makes the wrapper raise, each way, and counts nothing:
    # K = 48 does not divide the 128 edge slots (the launcher's code -3)
    ins = (V, wz, Y)
    out, inv = mod._kernel_fwd(*ins, w, 32, 0.5)
    counts = (mod.launches.fwd, mod.launches.bwd)
    with pytest.raises(RuntimeError, match="does not take"):
        mod._kernel_fwd(*ins, w, 48, 0.5)
    with pytest.raises(RuntimeError, match="does not take"):
        mod._kernel_bwd(*ins, w, 48, 0.5, torch.ones_like(out), torch.ones_like(inv))
    assert (mod.launches.fwd, mod.launches.bwd) == counts


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
    cots = _cotangents(out_r)
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


# K2 at the margins of its layouts (c, cout, k, l_max, parity): K not a
# multiple of 32 nor of 4 (the tiles then load without cp.async), the
# narrowest C, the widest C at l_max 0 and 2, and the widths whose backward
# takes the tile stride 32 with the ring in the whole shared memory (C =
# 128, l_max 1) and without it (Cout = 256); the flagship widths' backward
# (stride 32, two blocks an SM) is in the legs above
K2_MARGINS = [(8, 8, 50, 2, True), (8, 12, 7, 1, False), (64, 64, 33, 2, True),
              (256, 256, 8, 0, True), (128, 132, 40, 1, False), (64, 256, 16, 2, True)]


@pytest.mark.parametrize("c,cout,k,lmax,parity", K2_MARGINS)
def test_k2_matches_plain_margin_widths(cuda, c, cout, k, lmax, parity):
    from pair_allegro_tpu_torch.ops import env_layer as k2

    mod, w, ins, fn, _ = _env_case(cuda, "paths", c, k, 3, lmax, parity, 8, cout=cout)
    assert k2.kernel_takes(c, cout, (lmax + 1) ** 2, lmax, parity)
    _env_compare(mod, w, ins, fn, k, "paths")


def test_k2_dead_v_cotangent_at_the_narrow_stride(cuda):
    """A zero dV' (the dead last layer) read by the stride-32 backward."""
    mod, w, ins, fn, _ = _env_case(cuda, "paths", 128, 40, 2, 1, False, 9, cout=132)
    _env_compare(mod, w, ins, fn, 40, "paths", drop_v=True)


def test_k2_k4_layouts_mirror_the_launchers(cuda):
    """Each library's own layout (k2_layout_bytes; k4_layout_bytes, k4_tile,
    k4_ring_words) against the wrapper's block_layout, which kernel_takes
    sums: every stride, ring and tile the launchers choose, and the
    refusals."""
    import ctypes

    from pair_allegro_tpu_torch.ops import env_layer as k2
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    lib2, lib4 = k2.LIB.load(), k4.LIB.load()
    for c, cout, lmax, parity in [(32, 32, 2, True), (8, 4, 0, True), (128, 132, 1, False),
                                  (64, 256, 2, True), (128, 128, 2, True), (64, 64, 3, True),
                                  (152, 152, 2, True), (12, 20, 1, True), (256, 256, 2, True)]:
        d, P = (lmax + 1) ** 2, num_paths_per_l(lmax, lmax, lmax, parity)
        for bwd in (False, True):
            if k2.widths_ok(c, cout, d):
                want = k2.block_layout(c, cout, d, lmax, parity, bwd)[0]
                got = lib2.k2_layout_bytes(int(bwd), (ctypes.c_int * 7)(c, cout, d, 8, 64,
                                                                        max(P) * c, P[0]))
                assert got == (want if want <= fl.SMEM_MAX else -6), (c, cout, lmax, bwd)
            dims = (ctypes.c_int * 6)(c, cout, d, 64, max(P) * c, P[0])
            plan = k4.block_layout(c, cout, d, lmax, parity, bwd)
            got = (lib4.k4_layout_bytes(int(bwd), dims), lib4.k4_tile(int(bwd), dims),
                   lib4.k4_ring_words(int(bwd), dims))
            assert got == (plan or (-6, -6, -6)), (c, cout, lmax, bwd)


@pytest.mark.parametrize("c,cout,lmax,parity,e,tiles", [
    (8, 12, 1, True, 45, (32, 32)), (32, 32, 2, True, 1001, (32, 16)),
    (48, 24, 2, True, 300, (16, 8)), (96, 32, 2, True, 77, (8, 8))])
def test_k4_matches_plain_at_every_tile(cuda, c, cout, lmax, parity, e, tiles):
    """Each edge tile the kernel is built for, forward and backward, reached
    by widths at which the launcher chooses it, with a tail tile (E no
    multiple of the tile) and, at E = 45 and 77, tiles that load without
    cp.async."""
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    w, ins = _k4_case(cuda, c, cout, lmax, parity, e, 11)
    assert tuple(k4.kernel_tile(w, ins[0], bwd) for bwd in (False, True)) == tiles
    _k4_compare(w, ins)


@pytest.mark.parametrize("c,cout,lmax,parity,e", [(4, 4, 2, True, 37), (152, 152, 2, True, 77),
                                                  (84, 84, 3, True, 50), (596, 596, 0, True, 40),
                                                  (168, 168, 2, True, 19)])
def test_k4_matches_plain_widest_and_narrowest(cuda, c, cout, lmax, parity, e):
    """The narrowest width and the widest the FFMA K4 took at l_max 0, 2 and
    3 (8-edge tiles, some without the ring), and C = 168 past it."""
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4

    assert k4.kernel_takes(c, cout, (lmax + 1) ** 2, lmax, parity)
    w, ins = _k4_case(cuda, c, cout, lmax, parity, e, 12)
    _k4_compare(w, ins)


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


# --- K6 / K7: the embed- and readout-fused layers (csrc/embed_readout_layer.cu)


def _er_case(cuda, ns, c, lmax, charges, seed=0, **kw):
    """(cfg, params) of a 2-layer model at these widths (two species, so the
    two-body input has 2*2 + 8 = 12 rows; one species gives 10)."""
    cfg = AllegroConfig(type_names=kw.pop("names", ("A", "B")), r_max=4.0, l_max=lmax,
                        num_layers=2, num_scalar_features=ns, num_tensor_features=c,
                        avg_num_neighbors=5.0, output_charges=charges, **kw)
    return cfg, allegro_params_from_numpy(allegro_init_numpy(cfg, seed), cfg, device=cuda)


def _er_operands(cuda, n_in, ns, c, k, nc, lmax, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    e, d = nc * k, (lmax + 1) ** 2
    ops = {"in": torch.randn(n_in, e, generator=g) * 0.5, "x": torch.randn(ns, e, generator=g) * 0.3,
           "V": torch.randn(d, c, e, generator=g) * 0.3, "Y": torch.randn(d, e, generator=g),
           "u": torch.rand(1, e, generator=g)}
    ops["u"][:, -k // 3:] = 0.0  # padded slots at the end of the last row
    return {key: t.to(cuda) for key, t in ops.items()}


def _check_pair(out_k, out_r, ins):
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_r = out_r if isinstance(out_r, tuple) else (out_r,)
    for a, b in zip(out_k, out_r):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    cots = _cotangents(out_r)
    for a, b in zip(torch.autograd.grad(out_k, ins, cots), torch.autograd.grad(out_r, ins, cots)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("ns,c,k,lmax,names", [(64, 32, 64, 2, ("Cu",)), (64, 32, 64, 1, ("Cu",)),
                                               (16, 8, 40, 2, ("A", "B")), (32, 16, 20, 3, ("A", "B"))])
def test_k6_kernel_matches_plain(cuda, ns, c, k, lmax, names):
    """K6 against its plain version, forward (x', V') and backward (d(in),
    dY, du): the flagship widths (10 input rows), l_max 1 and 3, and K
    that is no multiple of the 32-edge tile."""
    from pair_allegro_tpu_torch.ops import embed_layer as k6

    cfg, params = _er_case(cuda, ns, c, lmax, False, names=names)
    w = k6.k6_weights(params, lmax, True)
    ops = _er_operands(cuda, w.n_in, ns, c, k, 5, lmax, 1)
    ins = [ops[key].requires_grad_(True) for key in ("in", "Y", "u")]
    out_k = k6.embed_layer(*ins, w, k, 5.0)
    out_r = k6.embed_layer_reference(*ins, w, k, 1.0 / math.sqrt(5.0))
    _check_pair(out_k, out_r, ins)


@pytest.mark.parametrize("charges", [False, True])
@pytest.mark.parametrize("ns,c,k,lmax", [(64, 32, 64, 2), (64, 32, 64, 1), (16, 8, 40, 2)])
def test_k7_kernel_matches_plain(cuda, ns, c, k, lmax, charges):
    """K7 against its plain version, forward (e, q rows) and backward (dx,
    dV, dY, du), with and without the charge head."""
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    cfg, params = _er_case(cuda, ns, c, lmax, charges)
    w = k7.k7_weights(params, lmax, True, charges)
    ops = _er_operands(cuda, 12, ns, c, k, 5, lmax, 2)
    ins = [ops[key].requires_grad_(True) for key in ("x", "V", "Y", "u")]
    out_k = k7.readout_layer(*ins, w, k, 5.0)
    out_r = k7.readout_layer_reference(*ins, w, k, 1.0 / math.sqrt(5.0))
    _check_pair(out_k, out_r, ins)


def test_k6_k7_count_their_launches(cuda):
    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    cfg, params = _er_case(cuda, 16, 8, 2, True)
    ops = _er_operands(cuda, 12, 16, 8, 32, 4, 2, 3)
    before = [(m.launches.fwd, m.launches.bwd) for m in (k6, k7, fl)]
    ins = ops["in"].requires_grad_(True)
    x, V = k6.embed_layer(ins, ops["Y"], ops["u"], k6.k6_weights(params, 2, True), 32, 5.0)
    e, q = k7.readout_layer(x, V, ops["Y"], ops["u"], k7.k7_weights(params, 2, True, True), 32, 5.0)
    (e.sum() + q.sum()).backward()
    after = [(m.launches.fwd, m.launches.bwd) for m in (k6, k7, fl)]
    assert [(a - c, b - d) for (a, b), (c, d) in zip(after, before)] == [(1, 1), (1, 1), (0, 0)]


@pytest.mark.parametrize("kernel,lmax,width,takes", [
    ("k6", 2, 128, True), ("k6", 2, 256, True), ("k6", 2, 384, False), ("k6", 1, 256, True),
    ("k6", 1, 384, False), ("k7", 2, 256, True), ("k7", 2, 512, False), ("k7", 3, 128, True),
    ("k7", 3, 256, False),
])
def test_k6_k7_kernel_takes_mirror_the_launchers(cuda, kernel, lmax, width, takes):
    """kernel_takes is True exactly where the launcher takes the widths
    (a wider two-body MLP for K6, wider heads with charges for K7), forward
    and backward, at ns 64, C 32."""
    from pair_allegro_tpu_torch.models.allegro import embed_readout_viable
    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    kw = {"two_body_mlp_width": width} if kernel == "k6" else {"readout_mlp_hidden_layers_width": width}
    cfg, params = _er_case(cuda, 64, 32, lmax, True, names=("Cu",), **kw)
    ops = _er_operands(cuda, 10, 64, 32, 16, 3, lmax, 4)
    if kernel == "k6":
        w = k6.k6_weights(params, lmax, True)
        mirror = k6.kernel_takes(64, 32, (lmax + 1) ** 2, w.layer.dims[3], lmax, True, w.tb_dims)
        ins = ops["in"].requires_grad_(True)
        call = lambda: sum(o.sum() for o in k6.embed_layer(ins, ops["Y"], ops["u"], w, 16, 5.0))
    else:
        w = k7.k7_weights(params, lmax, True, True)
        mirror = k7.kernel_takes(64, 32, (lmax + 1) ** 2, w.layer.dims[3], lmax, True, w.heads_dims)
        ins = ops["x"].requires_grad_(True)
        call = lambda: sum(o.sum() for o in k7.readout_layer(ins, ops["V"], ops["Y"], ops["u"], w,
                                                             16, 5.0))
    try:
        call().backward()
        torch.cuda.synchronize()
        launched = True
    except RuntimeError as err:
        assert "launch failed" in str(err)
        launched = False
    assert launched == mirror == takes
    assert embed_readout_viable(cfg) == takes


def _er_model(dev, layers, charges=True, **kw):
    cfg = AllegroConfig(type_names=("Cu", "Ag"), r_max=4.5, l_max=2, num_layers=layers,
                        num_scalar_features=32, num_tensor_features=16, avg_num_neighbors=12.0,
                        output_charges=charges, per_edge_type_cutoff=((4.5, 4.2), (4.2, 4.0)),
                        **kw)
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    typ = np.random.RandomState(1).randint(0, 2, n)
    s = System.create(pos, typ, cell=cell, masses=np.full(n, 63.546), device=dev)
    eng = AllegroEngine(cfg, allegro_params_from_numpy(allegro_init_numpy(cfg, 0), cfg, device=dev),
                        s, device=dev)
    return cfg, s, eng


@pytest.mark.parametrize("layers", [2, 3])
def test_embed_model_kernel_path_matches_cpu(cuda, layers, monkeypatch):
    """PAT_L1_EMBED=1: forces and charges of the K6 / K1 / K7 path on the
    card against the CPU plain path, and one K6, layers - 2 K1 and one K7
    launch each way per force evaluation."""
    from pair_allegro_tpu_torch.models.allegro import layer_tier
    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import readout_layer as k7

    monkeypatch.setenv("PAT_L1_EMBED", "1")
    outs = []
    for dev in (cuda, torch.device("cpu")):
        cfg, s, eng = _er_model(dev, layers)
        assert layer_tier(cfg, False) == "k1-embed"
        nb = eng.rebuild_fn(s, None)
        before = [(m.launches.fwd, m.launches.bwd) for m in (k6, fl, k7)]
        o = eng.force_fn(s, nb)
        after = [(m.launches.fwd, m.launches.bwd) for m in (k6, fl, k7)]
        if dev.type == "cuda":
            want = [(1, 1), (layers - 2, layers - 2), (1, 1)]
            assert [(a - c, b - d) for (a, b), (c, d) in zip(after, before)] == want
        outs.append((o.forces.cpu(), o.extras["charges"].cpu()))
    (fk, qk), (fp, qp) = outs
    assert float((fk - fp).abs().max()) < 5e-4
    assert float((qk - qp).abs().max()) < 5e-4


def test_nopos_model_kernel_path_matches_cpu(cuda, monkeypatch):
    """PAT_L1_POSITIONAL=0: every layer runs K1's middle form on the card
    (3 + 3 launches) and matches the CPU."""
    monkeypatch.setenv("PAT_L1_POSITIONAL", "0")
    outs = []
    for dev in (cuda, torch.device("cpu")):
        cfg, s, eng = _er_model(dev, 3, charges=False)
        f0 = fl.launches.fwd
        o = eng.force_fn(s, eng.rebuild_fn(s, None))
        if dev.type == "cuda":
            assert fl.launches.fwd - f0 == 3
        outs.append(o.forces.cpu())
    assert float((outs[0] - outs[1]).abs().max()) < 5e-4


# --- K8: the whole layer stack (csrc/fused_stack.cu) -------------------------


def _stack_case(cuda, ns, c, lmax, layers, k, nc, seed=0, parity=True, **fields):
    """The tree's layers of a model at these widths and (x0, pT, Y, u) with
    padded slots at the end of the last center's row."""
    cfg = AllegroConfig(type_names=("A", "B"), r_max=4.0, l_max=lmax, num_layers=layers,
                        num_scalar_features=ns, num_tensor_features=c, avg_num_neighbors=5.0,
                        parity=parity, **fields)
    params = allegro_params_from_numpy(allegro_init_numpy(cfg, seed), cfg, device=cuda)
    return params["layers"], _operands(cuda, ns, c, k, nc, True, seed + 1, lmax)


def _stack_compare(layers, ops, k, lmax, parity):
    """K8 against its plain version: forward 1e-4 + 1e-4 max|plain|,
    backward (dx0, dpT, dY, du) 1e-4 + 1e-3 max|plain|."""
    from pair_allegro_tpu_torch.ops import fused_stack as k8

    ins = [t.detach().clone().requires_grad_(True) for t in ops]
    out_k = k8.fused_stack(*ins, layers, k, lmax, 5.0, parity)
    out_r = k8.allegro_stack_reference(*ins, layers, k, lmax, 5.0, parity)
    assert float((out_k - out_r).detach().abs().max()) <= \
        1e-4 + 1e-4 * float(out_r.detach().abs().max())
    (cot,) = _cotangents((out_r,))
    for a, b in zip(torch.autograd.grad(out_k, ins, cot), torch.autograd.grad(out_r, ins, cot)):
        assert float((a - b).abs().max()) <= 1e-4 + 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("ns,c,lmax,layers,k,parity", [
    (64, 32, 2, 3, 64, True), (64, 32, 1, 3, 64, True), (64, 32, 2, 1, 64, True),
    (64, 32, 2, 2, 40, True), (16, 8, 2, 3, 20, True), (16, 8, 2, 3, 24, False),
    (16, 8, 3, 2, 33, True)])
def test_k8_kernel_matches_plain(cuda, ns, c, lmax, layers, k, parity):
    """Flagship widths with 3 layers, l_max 1 and 3, 1 and 2 layers (the
    first and the last layer in one), parity off, and K that is no
    multiple of the 32-edge tile."""
    layers_, ops = _stack_case(cuda, ns, c, lmax, layers, k, 6, parity=parity)
    _stack_compare(layers_, ops, k, lmax, parity)


def test_k8_counts_its_launches_and_nan_weight_cotangents(cuda):
    from pair_allegro_tpu_torch.ops import fused_stack as k8

    layers, (x, pT, Y, u) = _stack_case(cuda, 16, 8, 2, 3, 32, 4)
    leaves = [t.requires_grad_(True) for layer in layers for t in fl.layer_leaves(layer, 2)]
    x.requires_grad_(True)
    before = [(m.launches.fwd, m.launches.bwd) for m in (k8, fl)]
    k8.fused_stack(x, pT, Y, u, layers, 32, 2, 5.0, True).sum().backward()
    after = [(m.launches.fwd, m.launches.bwd) for m in (k8, fl)]
    assert [(a - c, b - d) for (a, b), (c, d) in zip(after, before)] == [(1, 1), (0, 0)]
    assert torch.isfinite(x.grad).all()
    assert all(t.grad is not None and torch.isnan(t.grad).all() for t in leaves)


def test_k8_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """Non-f32, non-contiguous or mixed-device operands raise before any
    launch; there is no fallback to the plain version on the card."""
    from pair_allegro_tpu_torch.ops import fused_stack as k8

    layers, (x, pT, Y, u) = _stack_case(cuda, 16, 8, 2, 2, 32, 4)
    f0 = k8.launches.fwd
    with pytest.raises(TypeError):
        k8.fused_stack(x.double(), pT.double(), Y.double(), u.double(), layers, 32, 2, 5.0, True)
    with pytest.raises(ValueError):
        k8.fused_stack(x.T.contiguous().T, pT, Y, u, layers, 32, 2, 5.0, True)
    with pytest.raises(ValueError):
        k8.fused_stack(x, pT.cpu(), Y, u, layers, 32, 2, 5.0, True)
    assert k8.launches.fwd == f0


@pytest.mark.parametrize("c,lmax,layers,takes", [
    (32, 2, 3, True), (32, 2, 8, True), (32, 2, 9, False), (64, 2, 3, False), (48, 2, 3, False),
    (32, 3, 3, True)])
def test_k8_kernel_takes_mirrors_the_launcher(cuda, c, lmax, layers, takes):
    """kernel_takes (and the model's stack_viable) is True exactly where
    the launcher takes the stack, forward and backward, at ns 64."""
    from pair_allegro_tpu_torch.models.allegro import stack_viable
    from pair_allegro_tpu_torch.ops import fused_stack as k8

    layers_, (x, pT, Y, u) = _stack_case(cuda, 64, c, lmax, layers, 16, 3)
    w = fl.k1_weights(layers_[0], lmax, True)
    mirror = k8.kernel_takes(64, c, (lmax + 1) ** 2, tuple(w.dims[3]), lmax, True, layers)
    x.requires_grad_(True)
    try:
        k8.fused_stack(x, pT, Y, u, layers_, 16, lmax, 5.0, True).sum().backward()
        torch.cuda.synchronize()
        launched = True
    except RuntimeError as err:
        assert "launch failed" in str(err)
        launched = False
    cfg = AllegroConfig(type_names=("A", "B"), r_max=4.0, l_max=lmax, num_layers=layers,
                        num_scalar_features=64, num_tensor_features=c, fused_stack=True)
    assert launched == mirror == stack_viable(cfg) == takes


def test_stack_model_kernel_path_matches_cpu(cuda):
    """fused_stack=True: forces and charges of the K8 path on the card
    against the CPU plain path, one K8 launch each way and no K1."""
    from pair_allegro_tpu_torch.models.allegro import layer_tier
    from pair_allegro_tpu_torch.ops import fused_stack as k8

    outs = []
    for dev in (cuda, torch.device("cpu")):
        cfg, s, eng = _er_model(dev, 3, fused_stack=True)
        assert layer_tier(cfg, False) == "stack"
        nb = eng.rebuild_fn(s, None)
        before = [(m.launches.fwd, m.launches.bwd) for m in (k8, fl)]
        o = eng.force_fn(s, nb)
        after = [(m.launches.fwd, m.launches.bwd) for m in (k8, fl)]
        if dev.type == "cuda":
            assert [(a - c, b - d) for (a, b), (c, d) in zip(after, before)] == [(1, 1), (0, 0)]
        outs.append((o.forces.cpu(), o.extras["charges"].cpu()))
    (fk, qk), (fp, qp) = outs
    assert float((fk - fp).abs().max()) < 5e-4
    assert float((qk - qp).abs().max()) < 5e-4


# --- routing: dtype and the widths a kernel refuses run the plain path ------


def _launch_totals():
    from pair_allegro_tpu_torch.ops import (
        embed_layer,
        env_layer,
        env_layer_mxu,
        fused_stack,
        nequip_conv,
        readout_layer,
        tp_mix_fused,
    )

    mods = (fl, nequip_conv, env_layer, env_layer_mxu, tp_mix_fused, embed_layer, readout_layer,
            fused_stack)
    return sum(m.launches.fwd + m.launches.bwd for m in mods)


def _cu_system(dev, dtype, flat=False):
    """FCC Cu: 256 atoms (the engines' dense strategy, FLAT layout) or 500
    (cell list, TABLE layout)."""
    pos, cell = fcc_lattice(4 if flat else 5)
    return System.create(pos, np.zeros(len(pos), np.int64), cell=cell,
                         masses=np.full(len(pos), 63.546), dtype=dtype, device=dev)


def _allegro_forces(cfg, dev, dtype, flat=False):
    s = _cu_system(dev, dtype, flat)
    tree = allegro_init_numpy(cfg, 0)
    eng = AllegroEngine(cfg, allegro_params_from_numpy(tree, cfg, device=dev, dtype=dtype), s,
                        device=dev)
    assert eng.spec.strategy == ("dense" if flat else "cell_list")
    o = eng.force_fn(s, eng.rebuild_fn(s, None))
    return o.forces.cpu(), o.total_energy.cpu()


def _nequip_forces(cfg, dev, dtype):
    from pair_allegro_tpu_torch.engine import NequIPEngine
    from pair_allegro_tpu_torch.models.nequip import nequip_init_numpy, nequip_params_from_numpy

    s = _cu_system(dev, dtype)
    tree = nequip_init_numpy(cfg, 0)
    eng = NequIPEngine(cfg, nequip_params_from_numpy(tree, cfg, device=dev, dtype=dtype), s,
                       device=dev)
    o = eng.force_fn(s, eng.rebuild_fn(s, None))
    return o.forces.cpu(), o.total_energy.cpu()


ALLEGRO_TIERS = {"k1": {}, "perlayer": dict(layer_fused=False), "stack": dict(fused_stack=True),
                 "flat": {}}


@pytest.mark.parametrize("tier", list(ALLEGRO_TIERS) + ["nequip"])
def test_f64_on_the_card_runs_plain_and_matches_cpu(cuda, tier):
    """An f64 system on the card takes the plain path on every tier (no
    kernel launches) and gives the CPU f64 path's forces to 1e-9
    relative."""
    from pair_allegro_tpu_torch.models.nequip import NequIPConfig

    outs = []
    for dev in (cuda, torch.device("cpu")):
        n0 = _launch_totals()
        if tier == "nequip":
            cfg = NequIPConfig(type_names=("Cu",), r_max=4.5, num_layers=2, num_features=16,
                               avg_num_neighbors=12.0, parity=True)
            outs.append(_nequip_forces(cfg, dev, torch.float64))
        else:
            cfg = _flat_cfg(species=1, num_layers=2, **ALLEGRO_TIERS[tier])
            outs.append(_allegro_forces(cfg, dev, torch.float64, flat=tier == "flat"))
        if dev.type == "cuda":
            assert _launch_totals() == n0
    (fk, ek), (fp, ep) = outs
    assert fk.dtype == torch.float64
    assert float((fk - fp).abs().max()) <= 1e-9 * float(fp.abs().max())
    assert abs(float(ek) - float(ep)) <= 1e-9 * abs(float(ep))


@pytest.mark.parametrize("flat", [False, True])
def test_widths_k1_and_k4_refuse_run_plain_on_the_card(cuda, flat):
    """num_tensor_features=6: K1, K8 and K4 refuse C not a multiple of 4,
    so the TABLE and FLAT models run the plain path (no launch) and match
    the CPU."""
    from pair_allegro_tpu_torch.models.allegro import layer_tier

    cfg = _flat_cfg(species=1, num_tensor_features=6, fused_stack=True)
    assert layer_tier(cfg, flat) == "plain"
    outs = []
    for dev in (cuda, torch.device("cpu")):
        n0 = _launch_totals()
        outs.append(_allegro_forces(cfg, dev, torch.float32, flat=flat))
        if dev.type == "cuda":
            assert _launch_totals() == n0
    assert float((outs[0][0] - outs[1][0]).abs().max()) < 5e-4


def test_nequip_width_k3_refuses_runs_plain_on_the_card(cuda):
    """num_features=48: K3 refuses the channel count, so NequIP runs its
    plain message path on the card (no K3 launch) and matches the CPU."""
    from pair_allegro_tpu_torch.models.nequip import NequIPConfig, conv_route
    from pair_allegro_tpu_torch.ops import nequip_conv

    cfg = NequIPConfig(type_names=("Cu",), r_max=4.5, num_layers=2, num_features=48,
                       avg_num_neighbors=12.0, parity=True)
    assert not conv_route(cfg, False)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        k3 = nequip_conv.launches.fwd
        outs.append(_nequip_forces(cfg, dev, torch.float32))
        assert nequip_conv.launches.fwd == k3
    assert float((outs[0][0] - outs[1][0]).abs().max()) < 5e-4


@pytest.mark.parametrize("kernel,width,takes", [
    ("k4", 8, True), ("k4", 6, False), ("k4", 128, True), ("k4", 256, False),
    ("k3", 64, True), ("k3", 48, False), ("k3", 128, True), ("k3", 256, False)])
def test_k3_k4_kernel_takes_mirror_the_launchers(cuda, kernel, width, takes):
    """kernel_takes is True exactly where the wrapper and its launcher take
    the widths, forward and backward (K4 at l_max 2 with parity, K3 at l_max
    1 with two tracks)."""
    from pair_allegro_tpu_torch.ops import nequip_conv as k3
    from pair_allegro_tpu_torch.ops import tp_mix_fused as k4
    from pair_allegro_tpu_torch.ops.tp import tp_num_paths

    if kernel == "k4":
        mirror = k4.kernel_takes(width, width, 9, 2, True)
        w, ins = _k4_case(cuda, width, width, 2, True, 64, 7)
        ins = [t.requires_grad_(True) for t in ins]
        call = lambda: sum(o.sum() for o in k4.tp_mix_fused_t(*ins, w))
    else:
        mirror = k3.kernel_takes(width, 2, 1, (8, 32, 32, 2 * tp_num_paths(1) * width))
        w, ins = _k3_case(cuda, 1, 2, width, 16, 3, 7)
        ins = [t.requires_grad_(True) for t in ins]
        call = lambda: k3.nequip_conv(*ins, w, 16, 12.0).sum()
    try:
        call().backward()
        torch.cuda.synchronize()
        launched = True
    except (RuntimeError, ValueError) as err:
        assert "launch failed" in str(err) or "takes C in" in str(err)
        launched = False
    assert launched == mirror == takes


# ---------------------------------------------------------------------------
# The layer body on the tensor cores (K1, K6, K7, K8): its layout and its
# products at shapes off the flagship's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["k1", "k6", "k7", "k8"])
def test_layouts_mirror_the_launchers(cuda, form):
    """block_bytes (the sum kernel_takes of K1, K6, K7 and K8 compare with
    the limit) equals the library's own layer_layout sum, and refuses
    exactly where the library refuses for shared memory, over 288 widths
    (the widths the library refuses otherwise widths_ok refuses too)."""
    import ctypes
    import itertools

    from pair_allegro_tpu_torch.ops import embed_layer as k6
    from pair_allegro_tpu_torch.ops import fused_stack as k8
    from pair_allegro_tpu_torch.ops.tp import num_paths_per_l

    lib = {"k1": fl.LIB, "k6": k6.LIB, "k7": k6.LIB, "k8": k8.LIB}[form].load()
    for ns, c, lmax, parity, width, bwd in itertools.product(
            (16, 64, 128), (8, 32, 48, 64), (1, 2, 3), (True, False), (32, 64), (0, 1)):
        d, P = (lmax + 1) ** 2, num_paths_per_l(lmax, lmax, lmax, parity)
        latd = (ns + c * P[0], width, width, ns)
        first_v, last = form in ("k1", "k6", "k8"), form == "k7"
        dims = [ns, c, c, d, 64, 640, 3, int(first_v), int(last), width, max(P) * c, latd[0],
                10, width, 2 * width, 2]
        arr = (ctypes.c_int * len(dims))(*dims)
        got = {"k1": lambda: lib.k1_layout_bytes(bwd, arr), "k8": lambda: lib.k8_layout_bytes(bwd, arr),
               "k6": lambda: lib.er_layout_bytes(1, bwd, arr),
               "k7": lambda: lib.er_layout_bytes(2, bwd, arr)}[form]()
        name = {"k1": "plain", "k6": "embed", "k7": "readout", "k8": "stack"}[form]
        mirror = fl.block_bytes(ns, c, c, d, latd, lmax, parity, first_v, bool(bwd), name, 10,
                                width, 2 * width)
        if got == -6:  # the shared-memory refusal
            assert mirror > fl.SMEM_MAX, (ns, c, lmax, parity, width, bwd)
        elif got < 0:  # a width refusal (C = 48: the TP's cells)
            assert not fl.widths_ok(ns, c, c, d, latd, lmax, parity), (ns, c, lmax, got)
        else:
            assert got == mirror, (ns, c, lmax, parity, width, bwd)


@pytest.mark.parametrize("first_v,last", FORMS)
def test_kernel_matches_plain_ragged_products(cuda, first_v, last):
    """ns = 20 and C = 8: products whose depth (20, 44) is no multiple of the
    8-deep k-step nor of the staging chunk and whose outputs (20 rows) no
    multiple of the 16-row tile, on a ragged last edge tile (K = 40)."""
    w = _layer(cuda, 20, 8)
    ins = [t.requires_grad_(True) for t in _operands(cuda, 20, 8, 40, 5, first_v, 9)]
    out_k = fl.fused_layer(*ins, w, 40, 5.0, first_v=first_v, last=last)
    out_r = fl.fused_layer_reference(*ins, w, 40, 1.0 / math.sqrt(5.0), first_v, last)
    out_k, out_r = ((out_k,), (out_r,)) if last else (out_k, out_r)
    for a, b in zip(out_k, out_r):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    cots = _cotangents(out_r)
    for a, b in zip(torch.autograd.grad(out_k, ins, cots), torch.autograd.grad(out_r, ins, cots)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


def test_stack_tiles_off_the_vector_path(cuda):
    """K8 where the edge slots are no multiple of 4 (K = 21): every tile
    loads synchronously instead of by 16-byte cp.async, same results."""
    layers_, ops = _stack_case(cuda, 16, 8, 2, 3, 21, 5)
    _stack_compare(layers_, ops, 21, 2, True)


# (ns, C, latent MLP width and depth, the backward layout's tile stride and
# whether it has a weight ring): latent MLPs wide enough that the backward
# takes the narrower tile stride, with the ring and without it
WIDE_LAYOUTS = [(64, 32, 256, 2, 32, True), (8, 32, 256, 3, 32, False)]


@pytest.mark.parametrize("ns,c,width,depth,lds,ring", WIDE_LAYOUTS)
@pytest.mark.parametrize("first_v,last", FORMS)
def test_kernel_matches_plain_wide_layouts(cuda, ns, c, width, depth, lds, ring, first_v, last):
    """K1 with a wide latent MLP, whose backward layout falls back to the
    tile stride LDS_MIN (and, at ns 8 with three 256-wide layers, to no
    weight ring: the products read the weights from device memory), on a
    ragged last edge tile (K = 40): the same results as the plain version."""
    w = _layer(cuda, ns, c, allegro_mlp_hidden_layers_width=width,
               allegro_mlp_hidden_layers_depth=depth)
    _, got_lds, got_ring = fl.block_layout(ns, c, c, 9, w.dims[3], 2, True, first_v, True)
    assert (got_lds, got_ring > 0) == (lds, ring)
    ins = [t.requires_grad_(True) for t in _operands(cuda, ns, c, 40, 5, first_v, 11)]
    out_k = fl.fused_layer(*ins, w, 40, 5.0, first_v=first_v, last=last)
    out_r = fl.fused_layer_reference(*ins, w, 40, 1.0 / math.sqrt(5.0), first_v, last)
    _check_pair(out_k, out_r, ins)


@pytest.mark.parametrize("ns,c,width,depth,lds,ring", WIDE_LAYOUTS)
def test_k8_matches_plain_wide_layouts(cuda, ns, c, width, depth, lds, ring):
    """K8 (3 layers) at the same wide latent MLPs, K = 40."""
    layers_, ops = _stack_case(cuda, ns, c, 2, 3, 40, 5, allegro_mlp_hidden_layers_width=width,
                               allegro_mlp_hidden_layers_depth=depth)
    _stack_compare(layers_, ops, 40, 2, True)


def _cli_case(tmp_path, masses=63.546):
    """A small K1-width Allegro checkpoint and a start state of the 108-atom
    fixture with numpy velocities (the CPU and CUDA generators draw
    different streams, so no velocities are drawn)."""
    from pathlib import Path

    from pair_allegro_tpu_torch import checkpoint as ckpt
    from pair_allegro_tpu_torch.io.extxyz import read_extxyz
    from pair_allegro_tpu_torch.system import Units

    cfg = AllegroConfig(type_names=("Cu",), r_max=4.0, l_max=2, num_layers=2,
                        num_scalar_features=16, num_tensor_features=8, avg_num_neighbors=12.0)
    model = str(tmp_path / "model.npz")
    ckpt.save_params(model, allegro_init_numpy(cfg, 0), cfg, family="allegro")
    fr = read_extxyz(str(Path(__file__).resolve().parent.parent / "examples" / "cu_fcc_108.xyz"),
                     index=0)
    n = len(fr["positions"])
    rng = np.random.RandomState(2)
    vel = rng.randn(n, 3) * np.sqrt(Units.kB * 50.0 / (masses * Units.mvv2e))
    start = System.create(fr["positions"], np.zeros(n, np.int64), cell=fr["cell"],
                          velocities=vel - vel.mean(0), masses=np.full(n, masses), device="cpu")
    state = str(tmp_path / "start.npz")
    ckpt.save_state(state, start, step=0)
    return model, state


def _cli_run(tmp_path, name, conf, device=None):
    import json

    from pair_allegro_tpu_torch.cli import main

    path = tmp_path / f"{name}.yaml"
    path.write_text(json.dumps(conf))
    assert main(["run", str(path)] + ([] if device is None else ["--device", device])) == 0


def _dump_forces(path):
    lines = open(path).read().splitlines()
    return np.array([[float(x) for x in ln.split()[5:8]] for ln in lines[9:]])


def test_cli_nvt_on_the_card_matches_cpu(cuda, tmp_path, capsys):
    """``cli run`` NVT on the fixture, the card (the dense build's FLAT
    layout, K4) against ``--device cpu`` at f32: the 5 steps' forces in the
    last dump frame within the 5e-4 model gate."""
    from pair_allegro_tpu_torch.ops import tp_mix_fused

    model, state = _cli_case(tmp_path)
    for name, dev in (("cpu", "cpu"), ("card", None)):
        tp_mix_fused.launches.reset()
        _cli_run(tmp_path, f"nvt_{name}", {
            "model": {"checkpoint": model}, "restart_from": state, "integrator": "nvt",
            "temp_K": 50.0, "tdamp_ps": 0.05, "dt_fs": 2.0, "steps": 5, "log_every": 5,
            "skin": 0.4, "dump": {"path": str(tmp_path / f"{name}.dump"), "every": 5}}, dev)
    assert tp_mix_fused.launches.fwd == tp_mix_fused.launches.bwd >= 2 * 6  # the card's run
    capsys.readouterr()
    df = np.abs(_dump_forces(tmp_path / "card.dump") - _dump_forces(tmp_path / "cpu.dump"))
    assert df.max() < 5e-4


def test_langevin_generator_state_round_trips_on_cuda(cuda, tmp_path, capsys):
    """A Langevin run on the card resumed from its state file draws the
    same noise as the uninterrupted run: the CUDA generator's state (seed
    and offset) crosses the file, and both runs end at the same state."""
    import torch as _torch

    from pair_allegro_tpu_torch import checkpoint as ckpt

    model, state = _cli_case(tmp_path)
    common = {"model": {"checkpoint": model}, "integrator": "langevin", "temp_K": 50.0,
              "damp_ps": 0.05, "dt_fs": 1.0, "log_every": 4}
    _cli_run(tmp_path, "a", {**common, "restart_from": state, "steps": 8,
                             "restart": {"path": str(tmp_path / "a.npz")}})
    _cli_run(tmp_path, "b", {**common, "restart_from": state, "steps": 4,
                             "restart": {"path": str(tmp_path / "b.npz")}})
    _cli_run(tmp_path, "c", {**common, "restart_from": str(tmp_path / "b.npz"), "steps": 4,
                             "restart": {"path": str(tmp_path / "c.npz")}})
    capsys.readouterr()
    sa, step_a, _, rng_a = ckpt.load_state(str(tmp_path / "a.npz"), dtype=_torch.float32)
    sc, step_c, _, rng_c = ckpt.load_state(str(tmp_path / "c.npz"), dtype=_torch.float32)
    assert step_a == step_c == 8
    assert rng_a.numel() == _torch.Generator(device="cuda").get_state().numel()
    assert _torch.equal(rng_a, rng_c)
    gen, from_jax = ckpt.generator_from_rng(rng_a, "cuda")
    ref = _torch.Generator(device="cuda")
    ref.set_state(rng_c)
    assert not from_jax and _torch.equal(_torch.randn(64, generator=gen, device="cuda"),
                                         _torch.randn(64, generator=ref, device="cuda"))
    # the kernels' sums may run in another order: the same trajectory to f32
    torch.testing.assert_close(sa.positions, sc.positions, atol=1e-4, rtol=0)
    torch.testing.assert_close(sa.velocities, sc.velocities, atol=1e-3, rtol=1e-3)


# --- the million-atom mode (row_chunk) and remat on the card ---------------


def _flagship(cuda, pad_to=None, **fields):
    cfg = AllegroConfig(type_names=("Cu",), r_max=4.5, l_max=2, num_layers=3,
                        num_scalar_features=64, num_tensor_features=32, avg_num_neighbors=12.0,
                        output_charges=True, **fields)
    pos, cell = fcc_lattice(5)
    n = pos.shape[0]
    s = System.create(pos, np.zeros(n, np.int64), cell=cell, masses=np.full(n, 63.546),
                      device=cuda, pad_to=pad_to)
    return cfg, allegro_params_from_numpy(allegro_init_numpy(cfg, 0), cfg, device=cuda), s


@pytest.mark.parametrize("remat", [False, True])
def test_row_chunk_k1_matches_unchunked_on_the_card(cuda, remat):
    """500 atoms in 4 windows of 125 rows against no windows, the K1 tier:
    forces within 1e-5 eV/A, the same charges; each window's K1 forward
    runs twice (the window's checkpoint recomputes it) and its layers take
    no checkpoint of their own, whatever remat says."""
    import dataclasses

    from chip_smoke import launched_now, reset_launches

    cfg, params, s = _flagship(cuda)
    cfg = dataclasses.replace(cfg, remat=remat)
    outs = {}
    for rc in (None, 125):
        eng = AllegroEngine(cfg, params, s, device=cuda, row_chunk=rc)
        nb = eng.rebuild_fn(s, None)
        reset_launches()
        outs[rc] = eng.force_fn(s, nb)
        torch.cuda.synchronize()
        if rc:
            assert launched_now() == {"K1": (2 * 3 * 4, 3 * 4)}
    assert float((outs[125].forces - outs[None].forces).abs().max()) <= 1e-5
    assert float((outs[125].extras["charges"] - outs[None].extras["charges"]).abs().max()) <= 1e-6


@pytest.mark.parametrize("model", ["allegro", "nequip"])
def test_remat_on_the_card(cuda, model):
    """remat=True against remat=False on K1 (Allegro) and K3 (NequIP):
    forces within the tight gate, and the forward launches doubled."""
    import dataclasses

    from chip_smoke import TIGHT_TOLS, launched_now, make_nequip_case, reset_launches

    from pair_allegro_tpu_torch.engine import NequIPEngine

    atol, rtol = TIGHT_TOLS["bwd"]
    res = {}
    for remat in (False, True):
        if model == "allegro":
            cfg, params, s = _flagship(cuda)
            eng = AllegroEngine(dataclasses.replace(cfg, remat=remat), params, s, device=cuda)
        else:
            cfg, params, s = make_nequip_case(5, cuda)
            eng = NequIPEngine(dataclasses.replace(cfg, remat=remat), params, s, device=cuda)
        nb = eng.rebuild_fn(s, None)
        reset_launches()
        f = eng.force_fn(s, nb).forces
        torch.cuda.synchronize()
        res[remat] = (f, launched_now())
    kernel = "K1" if model == "allegro" else "K3"
    assert res[False][1] == {kernel: (3, 3)} and res[True][1] == {kernel: (6, 3)}
    f0, f1 = res[False][0], res[True][0]
    assert float((f1 - f0).abs().max()) <= atol + rtol * float(f0.abs().max())


def test_pad_to_on_the_card(cuda):
    """500 atoms padded to 501 with masked atoms, in windows of 3 rows:
    the real atoms' forces and energies match the unpadded, unchunked
    system's; the padded row is zero."""
    cfg, params, s = _flagship(cuda)
    _, _, sp = _flagship(cuda, pad_to=501)
    assert sp.n_atoms == 501 and int(sp.n_valid) == 500
    eng0 = AllegroEngine(cfg, params, s, device=cuda)
    eng1 = AllegroEngine(cfg, params, sp, device=cuda, row_chunk=3)
    o0 = eng0.force_fn(s, eng0.rebuild_fn(s, None))
    o1 = eng1.force_fn(sp, eng1.rebuild_fn(sp, None))
    assert float((o1.forces[:500] - o0.forces).abs().max()) <= 1e-5
    assert float(o1.forces[500].abs().max()) == 0.0 and float(o1.atomic_energy[500]) == 0.0
    assert float((o1.atomic_energy[:500] - o0.atomic_energy).abs().max()) <= 1e-5
    assert o1.extras["dipole"].shape == (3,)


# training (train.py) on the card: a small Allegro on 500-atom frames (5^3
# cells, 4 bins an axis, so the engine's table takes the K1 tier)
TRAIN_KW = dict(type_names=("Cu",), r_max=4.0, l_max=2, num_layers=2, num_scalar_features=16,
                num_tensor_features=8, avg_num_neighbors=12.0)


def _kernel_launches():
    from pair_allegro_tpu_torch.ops import (
        embed_layer,
        env_layer,
        env_layer_mxu,
        fused_stack,
        nequip_conv,
        readout_layer,
        tp_mix_fused,
    )

    mods = (fl, nequip_conv, env_layer, env_layer_mxu, tp_mix_fused, embed_layer, readout_layer,
            fused_stack)
    return mods, lambda: sum(m.launches.fwd + m.launches.bwd for m in mods)


def _train_frames(device, dtype, n=4):
    """``n`` padded FLAT frames of 500 jittered Cu atoms labelled by the
    teacher (seed 0) on the plain path, and the student's numpy tree."""
    from pair_allegro_tpu_torch.models.allegro import allegro_energy
    from pair_allegro_tpu_torch.neighbors.naive import neighbor_list_np, pad_edges
    from pair_allegro_tpu_torch.potential import make_potential

    cfg = AllegroConfig(**TRAIN_KW)
    tree = allegro_init_numpy(cfg, 0)
    teacher = allegro_params_from_numpy(tree, cfg, device=device, dtype=dtype)
    pot = make_potential(lambda *a, **k: allegro_energy(teacher, cfg.for_training(), *a, **k))
    frames, built = [], []
    for i in range(n):
        pos, cell = fcc_lattice(5, jitter=0.1, seed=10 + i)
        built.append((pos, cell, *neighbor_list_np(pos, cell, (True,) * 3, cfg.r_max)))
    e_pad = max(b[2].shape[1] for b in built) + 64
    for pos, cell, ei, sh in built:
        ei, sh, mask = pad_edges(ei, sh, e_pad)
        f = {"positions": torch.tensor(pos, dtype=dtype, device=device),
             "types": torch.zeros(len(pos), dtype=torch.int64, device=device),
             "edge_index": torch.tensor(ei, dtype=torch.int64, device=device),
             "cell": torch.tensor(cell, dtype=dtype, device=device),
             "edge_shifts": torch.tensor(sh, dtype=dtype, device=device),
             "edge_mask": torch.tensor(mask, device=device)}
        out = pot(f["positions"], f["types"], f["edge_index"], cell=f["cell"],
                  edge_shifts=f["edge_shifts"], edge_mask=f["edge_mask"])
        f["forces"], f["energy"] = out.forces, out.total_energy
        frames.append(f)

    def perturb(t):
        return t * (1.0 + 0.03 * np.sin(np.arange(t.size).reshape(t.shape)))

    from pair_allegro_tpu_torch.train import tree_map

    student = tree_map(perturb, tree)
    return cfg, frames, student


def _batch_grads(cfg, frames, tree, device, dtype):
    from pair_allegro_tpu_torch.data import stack_frames
    from pair_allegro_tpu_torch.models.allegro import allegro_energy
    from pair_allegro_tpu_torch.train import leaves, make_batched_loss_fn, make_loss_fn

    params = allegro_params_from_numpy(tree, cfg, device=device, dtype=dtype)
    tensors = leaves(params)
    for t in tensors:
        t.requires_grad_(True)
    loss, _ = make_batched_loss_fn(make_loss_fn(allegro_energy, cfg.for_training()))(
        params, stack_frames(frames))
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return [np.zeros(t.shape) if g is None else g.double().cpu().numpy()
            for t, g in zip(tensors, grads)]


def test_training_step_on_the_card_launches_no_kernel(cuda):
    import functools

    from pair_allegro_tpu_torch.data import stack_frames
    from pair_allegro_tpu_torch.models.allegro import allegro_energy
    from pair_allegro_tpu_torch.train import make_batched_loss_fn, make_loss_fn, make_train_step

    cfg, frames, student = _train_frames(cuda, torch.float32, n=2)
    params = allegro_params_from_numpy(student, cfg, device=cuda)
    step = make_train_step(make_batched_loss_fn(make_loss_fn(allegro_energy, cfg.for_training())),
                           functools.partial(torch.optim.Adam, lr=1e-4))
    state = step.init(params)
    mods, total = _kernel_launches()
    for m in mods:
        m.launches.reset()
    params, state, metrics = step.update(params, state, stack_frames(frames))
    torch.cuda.synchronize()
    assert total() == 0
    assert all(math.isfinite(float(v)) for v in metrics.values())


def test_training_gradient_on_the_card_matches_cpu_f64(cuda):
    """One batch's gradient, the card at f32 against the CPU at f64 of the
    same tree and frames: every leaf within 1e-3 of its max (the leaves the
    loss does not reach are zero on both)."""
    cfg, frames, student = _train_frames(cuda, torch.float32, n=2)
    _, cpu_frames, _ = _train_frames("cpu", torch.float64, n=2)
    got = _batch_grads(cfg, frames, student, cuda, torch.float32)
    want = _batch_grads(cfg, cpu_frames, student, "cpu", torch.float64)
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        if scale == 0.0:
            assert not np.any(g)
        else:
            assert np.abs(g - w).max() <= 1e-3 * scale


def test_trained_tree_on_the_k1_tier_matches_plain(cuda):
    """The tree trained in place on the card, through the same detached
    views the K1 engine cached its layouts from before training: 2 / 2 K1
    launches an evaluation, forces within the 5e-4 model gate of the plain
    path, and moved by training (no stale layout)."""
    import functools

    from pair_allegro_tpu_torch.data import stack_frames
    from pair_allegro_tpu_torch.models.allegro import allegro_energy
    from pair_allegro_tpu_torch.train import (
        detached,
        make_batched_loss_fn,
        make_loss_fn,
        make_train_step,
    )

    cfg, frames, student = _train_frames(cuda, torch.float32, n=2)
    params = allegro_params_from_numpy(student, cfg, device=cuda)
    views = detached(params)
    pos, cell = fcc_lattice(5, jitter=0.1, seed=99)
    system = System.create(pos, np.zeros(len(pos)), cell=cell, device=cuda)
    eng = AllegroEngine(cfg, views, system, device=cuda)
    nb = eng.rebuild_fn(system, None)
    before = eng.force_fn(system, nb)
    step = make_train_step(make_batched_loss_fn(make_loss_fn(allegro_energy, cfg.for_training())),
                           functools.partial(torch.optim.Adam, lr=1e-3))
    state = step.init(params)
    for _ in range(3):
        params, state, _ = step.update(params, state, stack_frames(frames))
    fl.launches.reset()
    after = eng.force_fn(system, nb)
    torch.cuda.synchronize()
    assert (fl.launches.fwd, fl.launches.bwd) == (cfg.num_layers, cfg.num_layers)
    plain = AllegroEngine(cfg.for_training(), views, system, device=cuda)
    ref = plain.force_fn(system, plain.rebuild_fn(system, None))
    assert float((after.forces - ref.forces).abs().max()) < 5e-4
    assert float((after.forces - before.forces).abs().max()) > 1e-3
