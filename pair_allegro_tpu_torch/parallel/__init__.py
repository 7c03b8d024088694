"""Multi-device engines (counterpart of ``pair_allegro_tpu/parallel``): a
one-process device mesh (``mesh.py``), replicated-positions sharding of
Allegro and NequIP (``sharded.py``) and z-slab halo sharding of Allegro
(``halo.py``)."""

from pair_allegro_tpu_torch.parallel.halo import HaloShardedAllegroEngine
from pair_allegro_tpu_torch.parallel.mesh import make_mesh
from pair_allegro_tpu_torch.parallel.sharded import ShardedAllegroEngine, ShardedNequIPEngine

__all__ = [
    "make_mesh",
    "ShardedAllegroEngine",
    "ShardedNequIPEngine",
    "HaloShardedAllegroEngine",
]
