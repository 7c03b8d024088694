"""ctypes bindings to the port's C++ host runtime (``csrc/pat_host.cpp``),
the counterpart of ``pair_allegro_tpu/native.py``.

The library is built with the host C++ compiler on first use, once per
version of the source (the file name carries a hash of it), into
``ops._build.build_dir()`` beside the kernel libraries (the compile cache's
directory when one is enabled).  Every entry point returns None when the
library is unavailable (no compiler, a failed build, or ``PAT_NO_NATIVE``
set) or cannot take the input, and its caller then runs the numpy version:
the extension is an accelerator of set-up work, never a requirement, and
its results equal the numpy ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from pair_allegro_tpu_torch.ops._build import CSRC, build_dir

SOURCE = CSRC / "pat_host.cpp"
# no -march=native: a library in a shared compile cache may be loaded on
# another host's CPU
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-fopenmp", "-shared"]


class HostLibrary:
    """The built and bound ``pat_host`` library of this process."""

    def __init__(self):
        self.build_seconds = None  # wall time of this process's compiler run, if it ran
        self.error = None  # why the library is unavailable, if it is
        self.flags = None  # the flags of this process's compiler run, if it ran
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def path(self):
        tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
        return build_dir() / f"libpat_host_{tag}.so"

    def load(self):
        """The bound library, or None when it is unavailable."""
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            if os.environ.get("PAT_NO_NATIVE"):
                self.error = "PAT_NO_NATIVE is set"
                return None
            out = self.path()
            if not out.exists():
                self.error = self._build(out)
                if self.error:
                    return None
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                self.error = f"cannot load {out}: {e}"
                return None
            _bind(lib)
            self._lib = lib
            return lib


    def _build(self, out) -> str | None:
        """Compile the source into ``out``; an error message, or None.  A
        compiler without OpenMP builds the count loop serial."""
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            return "no C++ compiler (g++, c++ or $CXX) on PATH"
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.time()
        errors = []
        for flags in (FLAGS, [f for f in FLAGS if f != "-fopenmp"]):
            try:
                subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)], check=True,
                               capture_output=True, text=True, timeout=300)
            except subprocess.CalledProcessError as e:
                errors.append(f"{cxx} {' '.join(flags)}: {e.stderr.strip()[-500:]}")
                continue
            except (OSError, subprocess.SubprocessError) as e:
                errors.append(f"{cxx}: {e}")
                break
            os.replace(tmp, out)
            self.build_seconds, self.flags = time.time() - t0, flags
            return None
        tmp.unlink(missing_ok=True)
        return "; ".join(errors)


def _bind(lib) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.pat_neighbor_stats.restype = ctypes.c_int
    lib.pat_neighbor_stats.argtypes = [dptr, ctypes.c_int64, dptr, ctypes.c_double, i64p, i64p]
    lib.pat_spatial_keys.restype = ctypes.c_int
    lib.pat_spatial_keys.argtypes = [dptr, ctypes.c_int64, dptr, ctypes.c_int, ctypes.c_int,
                                     i64p]
    lib.pat_extxyz_count.restype = ctypes.c_int64
    lib.pat_extxyz_count.argtypes = [ctypes.c_char_p]
    lib.pat_extxyz_read.restype = ctypes.c_int
    lib.pat_extxyz_read.argtypes = [ctypes.c_char_p, ctypes.c_int64, dptr, ctypes.c_char_p]


LIB = HostLibrary()


def available() -> bool:
    return LIB.load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def neighbor_stats(positions, cell, cutoff: float):
    """Binned (total_edges, max_per_atom) under full PBC (minimum image);
    None when the native path is unavailable or the box holds fewer than 3
    bins on an axis (the caller falls back to its numpy version)."""
    lib = LIB.load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float64)
    cl = np.ascontiguousarray(cell, np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3 or cl.shape != (3, 3):
        raise ValueError(f"positions (N, 3) and cell (3, 3), got {pos.shape}, {cl.shape}")
    total = ctypes.c_int64()
    maxc = ctypes.c_int64()
    rc = lib.pat_neighbor_stats(_dptr(pos), pos.shape[0], _dptr(cl), float(cutoff),
                                ctypes.byref(total), ctypes.byref(maxc))
    if rc != 0:
        return None
    return int(total.value), int(maxc.value)


def spatial_keys(positions, cell=None, n_bins: int = 8):
    """Z-major bin ids (the sort keys of ``parallel.sharded.spatial_sort``):
    fractional coordinates of ``cell`` wrapped into [0, 1), or of the
    positions' bounding box without one; None = fall back."""
    lib = LIB.load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions (N, 3), got {pos.shape}")
    n = pos.shape[0]
    keys = np.empty(n, np.int64)
    use_cell = cell is not None
    cl = np.ascontiguousarray(cell if use_cell else np.eye(3), np.float64)
    rc = lib.pat_spatial_keys(_dptr(pos), n, _dptr(cl), int(use_cell), int(n_bins),
                              keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    return keys


def read_extxyz_frame(path: str):
    """The first frame's (positions, symbols) of an extxyz file whose
    columns start species, x, y, z; None = fall back to the python parser
    (which reads the comment line's metadata either way)."""
    lib = LIB.load()
    if lib is None:
        return None
    n = lib.pat_extxyz_count(str(path).encode())
    if n < 0:
        return None
    pos = np.empty((n, 3), np.float64)
    syms = ctypes.create_string_buffer(8 * n)
    rc = lib.pat_extxyz_read(str(path).encode(), n, _dptr(pos), syms)
    if rc != 0:
        return None
    symbols = np.array([syms.raw[8 * k: 8 * k + 8].split(b"\0")[0].decode() for k in range(n)])
    return pos, symbols
