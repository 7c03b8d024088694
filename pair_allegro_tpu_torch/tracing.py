"""Spans and counters of the port: what the host is doing while the card
waits, and how often it launches, reads back and rebuilds.

:func:`span` marks one stretch of host work as ``pat.<name>`` in whichever
``torch.profiler`` trace is running, on the clock of the device's
operations, while :func:`enable` has turned tracing on; while it is off
(the default) it hands back one shared null context and does nothing else.
The CLI's ``profile: {trace_dir}`` turns it on for its run; a caller that
profiles the engine itself calls :func:`enable`.  The spans, by layer:

* ``md.step``, ``md.chunk_end`` (``md/integrate.Simulation.run``): each
  step; the thermo row, the migration check, the regrow, the shrink and
  the callback at a chunk's end;
* ``neighbors.check``, ``neighbors.build`` (``engine.skin_checked``): the
  skin check's reduction and host read; each build;
* ``force.forward``, ``force.backward`` (``potential.make_potential``):
  the energy; ``torch.autograd.grad``;
* ``model.inputs``, ``model.layers``, ``model.readout``
  (``models/allegro.py``, ``models/nequip.py``): edge geometry, basis and
  embedding; the layer stack on its tier; the readout and the per-atom
  sum;
* ``halo.exchange``, ``halo.gather`` (``parallel/``): the halo engine's
  ghost exchange, in the build and in the force; the shards' outputs
  joined on the home device.

Every span opens on the thread that calls the engine, except those a
recompute under remat opens on autograd's threads.

The counters are plain integers and always count: ``host_reads`` (each
device-to-host read through ``io.dump.host``), ``neighbors.builds`` (each
neighbor build, from scratch or let through by the skin check), and each
kernel build's launches (:class:`LaunchCounts`, named
``K<n>.<build>``, read as ``.fwd`` and ``.bwd``).  :func:`counters` takes a
snapshot of all of them.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "pat."
_NULL = contextlib.nullcontext()
_on = False
_COUNTS = {"host_reads": 0, "neighbors.builds": 0}
_LAUNCHES: dict[str, "LaunchCounts"] = {}


def enable(on: bool) -> None:
    """Turn the spans on or off (the counters always count)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """``torch.profiler.record_function("pat." + name)`` while tracing is
    on, else the shared null context."""
    return torch.profiler.record_function(PREFIX + name) if _on else _NULL


def count(name: str) -> None:
    """Add one to the counter ``name`` (``host_reads``, ``neighbors.builds``)."""
    _COUNTS[name] += 1


class LaunchCounts:
    """One kernel build's launches since the last :meth:`reset` (plain
    integers), registered under ``name`` (``K<n>.<build>``)."""

    def __init__(self, name: str):
        if name in _LAUNCHES:
            raise ValueError(f"launch counts {name!r} are registered already")
        self.name = name
        self.fwd = 0
        self.bwd = 0
        _LAUNCHES[name] = self

    def reset(self):
        self.fwd = 0
        self.bwd = 0


def counters() -> dict[str, int]:
    """Every counter as {name: int}: ``host_reads``, ``neighbors.builds``
    and ``<launch counts>.fwd`` / ``.bwd`` of each registered build."""
    out = dict(_COUNTS)
    for name, c in _LAUNCHES.items():
        out[f"{name}.fwd"] = c.fwd
        out[f"{name}.bwd"] = c.bwd
    return out
