"""Persistent build cache of the port's compiled libraries (counterpart of
``pair_allegro_tpu/compile_cache.py``).

The JAX package caches XLA executables so that a later process loads the
compiled MD step instead of compiling it again, the analog of the upstream
deployment contract "compile once offline, load at MD time"
(``pair_nequip_allegro.cpp:197-247``).  The port compiles two kinds of code:
its CUDA kernels with ``nvcc`` (``ops/_build.py``) and its host runtime with
the host C++ compiler (``native.py``), each into a file named by a hash of
its sources.  :func:`enable_compile_cache` puts those files under ``path``,
so that a later process with the same sources loads them from there and
runs no compiler; a run with the cache unset builds into
``build/pair_allegro_tpu_torch/`` beside the package.

Activation (either):
  * YAML: ``compile_cache: /path/to/cache`` in a ``cli run`` config,
  * env:  ``PAT_COMPILE_CACHE=/path/to/cache`` (honoured by the CLI and the
    calculator).
"""

from __future__ import annotations

import os

_ENABLED: str | None = None


def enable_compile_cache(path: str) -> None:
    """Build into and load from ``path`` (idempotent).

    Must run before the first build to cover it: a library already loaded
    stays loaded from where it was built.  A later call with the same path
    is a no-op; another path raises (the cache directory is a process-wide
    setting, as in the JAX package)."""
    global _ENABLED
    path = os.path.abspath(os.path.expanduser(path))
    if _ENABLED is not None:
        if _ENABLED != path:
            raise ValueError(
                f"compilation cache already enabled at {_ENABLED!r}; "
                f"cannot move it to {path!r} in the same process"
            )
        return
    os.makedirs(path, exist_ok=True)
    _ENABLED = path


def cache_dir() -> str | None:
    """The enabled cache directory, or None."""
    return _ENABLED


def maybe_enable_from_env() -> bool:
    """Honour ``PAT_COMPILE_CACHE`` if set; returns whether a cache is on."""
    path = os.environ.get("PAT_COMPILE_CACHE")
    if path:
        enable_compile_cache(path)
    return _ENABLED is not None
