"""The 1-D device mesh of the multi-device engines (counterpart of
``pair_allegro_tpu/parallel/mesh.py``).

The JAX package runs its mesh from one process: ``shard_map`` over
``jax.devices()``, its collectives named by the mesh axis.  The port does
the same in one process: a :class:`Mesh` is an ordered list of
``torch.device``s under an axis name, shard ``s`` runs its work on
``mesh.devices[s]``, and the collectives are plain differentiable tensor
moves, so autograd writes every reverse communication:

* ``psum``: each shard's value moved to one device and summed;
* ``all_gather``: ``torch.cat`` of the shards' blocks;
* ``ppermute``: a re-pairing of blocks moved with ``.to(device)``.

A device may repeat: several shards then share one device and run one
after another, the analog of the JAX suite's 8 virtual CPU devices (the
upstream tests' ``mpirun --oversubscribe``); that is how the CPU tests and
one card run S >= 2 shards.  On a host with several GPUs the shards sit on
``cuda:0 .. cuda:S-1``.  A multi-process ``torch.distributed`` backend
(several hosts) is not part of this package.
"""

from __future__ import annotations

import dataclasses

import torch

from pair_allegro_tpu_torch.system import resolve_device

ATOM_AXIS = "atoms"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices under one axis name."""

    devices: tuple
    axis_name: str = ATOM_AXIS

    @property
    def shape(self) -> dict:
        """{axis_name: number of shards}, as a JAX mesh's ``shape``."""
        return {self.axis_name: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The device that holds a System on this mesh (shard 0's)."""
        return self.devices[0]


def make_mesh(n_devices: int | None = None, axis_name: str = ATOM_AXIS,
              devices=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards.

    ``devices`` None (or "cuda") takes the GPUs ``cuda:0 .. n-1`` (default:
    all of them) and raises, as JAX does, when ``n_devices`` exceeds
    ``torch.cuda.device_count()``; one device with an index ("cuda:0") or
    "cpu" is repeated ``n_devices`` times (default 1), since several shards
    may share a device (the CPU counts as any number of devices, as the JAX
    suite's 8 virtual ones do); a list of devices, which may repeat, is
    taken as it is (its first ``n_devices`` when that is given)."""
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = resolve_device(devices)
        if dev.type == "cuda" and dev.index is None:
            count = torch.cuda.device_count()
            n = count if n_devices is None else int(n_devices)
            if n > count:
                raise ValueError(f"requested {n} devices, have {count}")
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [dev] * (1 if n_devices is None else int(n_devices))
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
            devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), axis_name)
