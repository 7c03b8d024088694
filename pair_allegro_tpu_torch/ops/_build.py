"""Build and load the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.

Each library is built once per version of its sources (the file name
carries a hash of them) into :func:`build_dir` (``build/pair_allegro_tpu_torch/``
beside the package, or the directory ``compile_cache.enable_compile_cache``
names), with ``ptxas``'s register and spill report next to it.  Builds of
several libraries may run at once: :meth:`CudaLibrary.start` launches
``nvcc`` in the background and :meth:`CudaLibrary.load` waits for it; both
may be called from several threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

from pair_allegro_tpu_torch import compile_cache
from pair_allegro_tpu_torch.tracing import LaunchCounts  # noqa: F401 (the kernels import it here)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "pair_allegro_tpu_torch"


def build_dir() -> Path:
    """Where libraries are built and looked up: the compile cache's
    directory when one is enabled, else :data:`BUILD_DIR`."""
    cached = compile_cache.cache_dir()
    return Path(cached) if cached else BUILD_DIR


class CudaLibrary:
    """One kernel library: ``sources[0]`` is compiled, every source (headers
    included) enters the cache tag; ``bind(lib)`` declares the C functions'
    argument types and checks the library against the wrapper."""

    def __init__(self, stem: str, sources: list[Path], bind: Callable[[ctypes.CDLL], None]):
        self.stem = stem
        self.sources = sources
        self.bind = bind
        self.build_seconds = None  # wall time of this process's nvcc run, if it ran
        self.started = None  # when that run started (time.time())
        self._lib = None
        self._proc = None  # the running nvcc, between start() and load()
        self._tmp = None
        self._lock = threading.RLock()

    def paths(self) -> tuple[Path, Path]:
        """(shared library, ptxas report) of the current sources."""
        h = hashlib.sha256()
        for s in self.sources:
            h.update(s.read_bytes())
        tag = h.hexdigest()[:12]
        base = build_dir() / f"lib{self.stem}_{tag}"
        return base.with_suffix(".so"), base.with_suffix(".ptxas.txt")

    def start(self) -> None:
        """Start nvcc in the background unless the library is built or building."""
        with self._lock:
            out, _ = self.paths()
            if self._lib is not None or self._proc is not None or out.exists():
                return
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            out.parent.mkdir(parents=True, exist_ok=True)
            self._tmp = out.with_suffix(f".{os.getpid()}.tmp")
            self.started = time.time()
            self._proc = subprocess.Popen(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(self._tmp),
                 str(self.sources[0])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            self.start()
            out, report = self.paths()
            if self._proc is not None:
                stdout, stderr = self._proc.communicate()
                rc = self._proc.returncode
                self._proc = None
                if rc != 0:
                    raise RuntimeError(f"nvcc failed for {self.sources[0]}:\n{stdout}\n{stderr}")
                # nvcc's wall time, read from its output's write time: load()
                # may come long after the build finished
                self.build_seconds = os.path.getmtime(self._tmp) - self.started
                os.replace(self._tmp, out)
                report.write_text(stderr)
            lib = ctypes.CDLL(str(out))
            self.bind(lib)
            self._lib = lib
            return lib
