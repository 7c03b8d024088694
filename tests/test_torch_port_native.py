"""The port's C++ host runtime (``native.py``, ``csrc/pat_host.cpp``) against
its numpy fallbacks and the JAX package's, and ``compile_cache.py``'s rules
(counterpart of ``tests/test_native.py``; the cache rules are those of
``pair_allegro_tpu/compile_cache.py``).  The native results must equal the
numpy ones exactly: they are integer counts, sort keys and parsed text."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pair_allegro_tpu.neighbors.naive import host_neighbor_stats as jax_host_stats
from pair_allegro_tpu_torch import compile_cache, native
from pair_allegro_tpu_torch.io.extxyz import read_extxyz, write_extxyz
from pair_allegro_tpu_torch.neighbors.naive import host_neighbor_stats, neighbor_list_np
from pair_allegro_tpu_torch.ops import _build
from pair_allegro_tpu_torch.parallel.sharded import spatial_sort

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def built():
    """The library builds with the host compiler (the port's own copy of
    the source, not the JAX package's csrc/)."""
    assert native.available()
    assert native.SOURCE == ROOT / "pair_allegro_tpu_torch" / "csrc" / "pat_host.cpp"


def _numpy_stats(pos, cell, rc, monkeypatch):
    """host_neighbor_stats with the native path off (its numpy version)."""
    with monkeypatch.context() as m:
        m.setattr(native, "neighbor_stats", lambda *a: None)
        return host_neighbor_stats(pos, cell, (True,) * 3, rc)


@pytest.mark.parametrize("seed", [0, 1])
def test_neighbor_stats_match_numpy_and_the_oracle(monkeypatch, seed):
    """A triclinic box with unwrapped atoms: the native count equals the
    numpy binned count, the exact list's and JAX's; host_neighbor_stats
    takes the native path for an untyped periodic count."""
    rng = np.random.RandomState(seed)
    cell = np.diag([16.0, 15.0, 17.0])
    cell[2, 0] = 2.0
    pos = rng.rand(400, 3) @ cell
    pos[:100] += cell[0] * 2
    rc = 4.0
    res = native.neighbor_stats(pos, cell, rc)
    ei, _ = neighbor_list_np(pos, cell, (True,) * 3, rc)
    assert res == (ei.shape[1], int(np.bincount(ei[0], minlength=400).max()))
    assert res == _numpy_stats(pos, cell, rc, monkeypatch) == jax_host_stats(pos, cell,
                                                                             (True,) * 3, rc)
    calls = []
    monkeypatch.setattr(native, "neighbor_stats", lambda *a: calls.append(a) or res)
    assert host_neighbor_stats(pos, cell, (True,) * 3, rc) == res and len(calls) == 1
    host_neighbor_stats(pos, cell, (True,) * 3, rc, types=np.zeros(400, np.int64),
                        cutoff_matrix=np.full((1, 1), rc))
    host_neighbor_stats(pos, cell, (True, True, False), rc)
    assert len(calls) == 1  # typed counts and open boundaries stay on numpy, as in JAX


def test_neighbor_stats_small_box_falls_back(rng):
    """Fewer than 3 bins on an axis: the native path declines (None) and
    host_neighbor_stats answers with the exact list."""
    pos = rng.rand(20, 3) * 6.0
    cell = np.eye(3) * 6.0
    assert native.neighbor_stats(pos, cell, 4.0) is None
    ei, _ = neighbor_list_np(pos, cell, (True,) * 3, 4.0)
    assert host_neighbor_stats(pos, cell, (True,) * 3, 4.0)[0] == ei.shape[1]


@pytest.mark.parametrize("with_cell", [True, False])
def test_spatial_keys_match_numpy(rng, with_cell, monkeypatch):
    """The z-major bin keys equal the numpy fallback's (periodic and
    bounding-box), so spatial_sort gives one permutation either way."""
    cell = np.diag([10.0, 11.0, 12.0])
    pos = rng.rand(200, 3) @ cell - 3.0
    keys = native.spatial_keys(pos, cell if with_cell else None, 8)
    if with_cell:
        frac = pos @ np.linalg.inv(cell)
        frac -= np.floor(frac)
    else:
        frac = (pos - pos.min(0)) / (pos.max(0) - pos.min(0))
    b = np.clip((frac * 8).astype(np.int64), 0, 7)
    np.testing.assert_array_equal(keys, (b[:, 2] * 8 + b[:, 1]) * 8 + b[:, 0])
    pbc = (True,) * 3 if with_cell else (False,) * 3
    perm = spatial_sort(pos, cell if with_cell else None, pbc)
    monkeypatch.setattr(native, "spatial_keys", lambda *a: None)
    np.testing.assert_array_equal(spatial_sort(pos, cell if with_cell else None, pbc), perm)


def test_extxyz_fast_read(tmp_path, rng):
    """The first frame's positions and symbols as the python reader gives
    them."""
    pos = rng.rand(9, 3) * 5
    syms = np.array(["Cu", "O", "H", "Cu", "Pd", "O", "H", "Cu", "O"])
    p = str(tmp_path / "a.xyz")
    write_extxyz(p, {"symbols": syms, "positions": pos, "cell": np.eye(3) * 5,
                     "pbc": (True,) * 3, "info": {}})
    pos2, syms2 = native.read_extxyz_frame(p)
    fr = read_extxyz(p, index=0)
    np.testing.assert_array_equal(pos2, fr["positions"])
    assert list(syms2) == list(fr["symbols"]) == list(syms)
    assert native.read_extxyz_frame(str(tmp_path / "missing.xyz")) is None


def test_no_native_env_falls_back(tmp_path):
    """PAT_NO_NATIVE: nothing is built or loaded, every entry point returns
    None and host_neighbor_stats still answers (numpy)."""
    code = (
        "import numpy as np\n"
        "from pair_allegro_tpu_torch import native\n"
        "from pair_allegro_tpu_torch.neighbors.naive import host_neighbor_stats\n"
        "pos = np.random.RandomState(0).rand(300, 3) * 14.0\n"
        "assert not native.available()\n"
        "assert native.neighbor_stats(pos, np.eye(3) * 14.0, 4.0) is None\n"
        "assert native.spatial_keys(pos) is None\n"
        "print(host_neighbor_stats(pos, np.eye(3) * 14.0, (True,) * 3, 4.0))\n"
    )
    env = {"PAT_NO_NATIVE": "1", "PAT_COMPILE_CACHE": str(tmp_path / "cache"),
           "PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    pos = np.random.RandomState(0).rand(300, 3) * 14.0
    assert res.stdout.strip() == str(native.neighbor_stats(pos, np.eye(3) * 14.0, 4.0))
    assert not list((tmp_path / "cache").glob("*.so"))


def test_compile_cache_rules(tmp_path, monkeypatch):
    """JAX's rules: enabling is idempotent for the same path and refuses
    another; PAT_COMPILE_CACHE enables it; the kernel libraries' and the
    host library's paths move under it."""
    monkeypatch.setattr(compile_cache, "_ENABLED", None)
    monkeypatch.delenv("PAT_COMPILE_CACHE", raising=False)
    assert not compile_cache.maybe_enable_from_env()
    assert _build.build_dir() == _build.BUILD_DIR
    a = tmp_path / "a"
    compile_cache.enable_compile_cache(str(a))
    compile_cache.enable_compile_cache(str(a) + "/")  # the same path: a no-op
    assert a.is_dir() and compile_cache.cache_dir() == str(a)
    with pytest.raises(ValueError, match="cannot move it"):
        compile_cache.enable_compile_cache(str(tmp_path / "b"))
    assert _build.build_dir() == a
    from pair_allegro_tpu_torch.ops import fused_layer

    assert fused_layer.LIB.paths()[0].parent == a
    assert native.LIB.path().parent == a
    monkeypatch.setattr(compile_cache, "_ENABLED", None)
    monkeypatch.setenv("PAT_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.maybe_enable_from_env() and compile_cache.cache_dir() == str(
        tmp_path / "env")


def test_compile_cache_second_process_builds_nothing(tmp_path):
    """A first process with PAT_COMPILE_CACHE builds the host library
    there; a second one with the same sources loads it and runs no
    compiler (the counterpart of JAX's compile-cache round trip)."""
    code = (
        "from pair_allegro_tpu_torch import compile_cache, native\n"
        "compile_cache.maybe_enable_from_env()\n"
        "assert native.available()\n"
        "print(native.LIB.build_seconds is not None, native.LIB.path())\n"
    )
    env = {"PAT_COMPILE_CACHE": str(tmp_path), "PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    runs = [subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300) for _ in range(2)]
    assert all(r.returncode == 0 for r in runs), runs[0].stderr + runs[1].stderr
    (built1, path1), (built2, path2) = (r.stdout.split() for r in runs)
    assert (built1, built2) == ("True", "False") and path1 == path2
    assert Path(path1).parent == tmp_path

