"""The port's training dataset (``pair_allegro_tpu_torch.data``) against the
JAX package's ``load_frames`` / ``stack_frames`` on multi-frame extxyz files
the tests write: periodic frames of two sizes, open frames, a virial, a
typed cutoff matrix, f64 and f32; every array equal exactly.  Each error of
the JAX loader is raised, and without a GPU the default device raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pair_allegro_tpu.data import load_frames as jax_load_frames
from pair_allegro_tpu.data import stack_frames as jax_stack_frames
from pair_allegro_tpu.neighbors.naive import pad_edges as jax_pad_edges
from pair_allegro_tpu_torch.data import load_frames, stack_frames
from pair_allegro_tpu_torch.io.extxyz import write_extxyz
from pair_allegro_tpu_torch.neighbors.naive import pad_edges
from pair_allegro_tpu_torch.system import fcc_lattice

TYPES = ("Cu", "Ag")


def _periodic(rng, n_rep, virial=False):
    pos, cell = fcc_lattice(n_rep, jitter=0.1, seed=int(rng.randint(1000)))
    n = len(pos)
    info = {"energy": f"{rng.randn() * 10:.17g}"}
    if virial:
        info["virial"] = '"' + " ".join(f"{x:.17g}" for x in rng.randn(9)) + '"'
    return {"symbols": np.asarray(TYPES)[rng.randint(0, 2, n)], "positions": pos, "cell": cell,
            "pbc": (True, True, True), "forces": rng.randn(n, 3), "info": info}


def _open(rng, n):
    pos = rng.rand(n, 3) * 6.0
    return {"symbols": np.asarray(TYPES)[rng.randint(0, 2, n)], "positions": pos,
            "forces": rng.randn(n, 3), "info": {"energy": f"{rng.randn():.17g}"}}


def _write(tmp_path, frames, name="frames.xyz"):
    path = str(tmp_path / name)
    write_extxyz(path, frames)
    return path


def _same(port_frames, jax_frames):
    assert len(port_frames) == len(jax_frames)
    for pf, jf in zip(port_frames, jax_frames):
        assert pf.keys() == jf.keys()
        for k in jf:
            if jf[k] is None:
                assert pf[k] is None, k
                continue
            assert pf[k].device.type == "cpu"
            np.testing.assert_array_equal(pf[k].numpy(), np.asarray(jf[k]), err_msg=k)


CASES = {
    "periodic": (lambda rng: [_periodic(rng, 2), _periodic(rng, 2), _periodic(rng, 3)], {}),
    "open": (lambda rng: [_open(rng, 9), _open(rng, 12)], {}),
    "virial": (lambda rng: [_periodic(rng, 2, virial=True) for _ in range(3)], {}),
    "typed_cutoff": (lambda rng: [_periodic(rng, 2), _periodic(rng, 3)],
                     dict(cutoff_matrix=np.array([[3.6, 3.0], [3.0, 2.7]]))),
    "explicit_pads": (lambda rng: [_periodic(rng, 2)], dict(n_pad=40, e_pad=1000)),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_load_frames_equals_jax(tmp_path, case, dtype):
    make, kw = CASES[case]
    path = _write(tmp_path, make(np.random.RandomState(len(case))))
    want = jax_load_frames(path, TYPES, 3.6, dtype=getattr(jnp, dtype), **kw)
    got = load_frames(path, TYPES, 3.6, dtype=getattr(torch, dtype), device="cpu", **kw)
    _same(got, want)
    shapes = {k: tuple(v.shape) for k, v in got[0].items() if v is not None}
    assert all({k: tuple(v.shape) for k, v in f.items() if v is not None} == shapes for f in got)
    _same([stack_frames(got)], [jax_stack_frames(want)])


def test_pad_edges_equals_jax():
    rng = np.random.RandomState(0)
    ei, sh = rng.randint(0, 7, (2, 11)).astype(np.int32), rng.randn(11, 3)
    for a, b in zip(pad_edges(ei, sh, 16, dump_atom=3), jax_pad_edges(ei, sh, 16, dump_atom=3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="edge capacity"):
        pad_edges(ei, sh, 10)


def _no_energy(rng):
    f = _periodic(rng, 2)
    f["info"] = {}
    return [f]


def _no_forces(rng):
    f = _periodic(rng, 2)
    del f["forces"]
    return [f]


def _short_virial(rng):
    f = _periodic(rng, 2)
    f["info"]["virial"] = '"1 2 3"'
    return [f]


ERRORS = {
    "unknown_species": (lambda rng: [_periodic(rng, 2)], dict(type_names=("Cu",)), KeyError,
                        "Ag"),
    "missing_energy": (_no_energy, {}, KeyError, "energy="),
    "missing_forces": (_no_forces, {}, KeyError, "forces"),
    "virial_not_9": (_short_virial, {}, ValueError, "3 components"),
    "n_pad_too_small": (lambda rng: [_periodic(rng, 2)], dict(n_pad=16), ValueError, "n_pad"),
    "e_pad_too_small": (lambda rng: [_periodic(rng, 2)], dict(e_pad=64), ValueError, "e_pad"),
    "mixed_periodic_open": (lambda rng: [_periodic(rng, 2), _open(rng, 9)], {}, ValueError,
                            "mixes periodic and open"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(tmp_path, case):
    make, kw, exc, match = ERRORS[case]
    path = _write(tmp_path, make(np.random.RandomState(1)))
    kw = dict(kw)
    names = kw.pop("type_names", TYPES)
    with pytest.raises(exc, match=match):
        jax_load_frames(path, names, 3.6, **kw)
    with pytest.raises(exc, match=match):
        load_frames(path, names, 3.6, device="cpu", **kw)


def test_empty_stack_raises():
    with pytest.raises(ValueError, match="empty"):
        stack_frames([])


def test_default_device_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    path = _write(tmp_path, [_periodic(np.random.RandomState(2), 2)])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_frames(path, TYPES, 3.6)
