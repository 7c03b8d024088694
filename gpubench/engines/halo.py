"""Allegro over ``shards`` z-slabs with halo exchange
(``HaloShardedAllegroEngine``), the atoms wrapped and sorted into the
slabs, and re-sorted by the MD driver when they drift (``maybe_migrate``).
On a card, shard s runs on ``cuda:(s mod chips)``; elsewhere every shard
shares the one device."""

import torch


def make(fam, cfg, params, system, wl: dict, device):
    from pair_allegro_tpu_torch.parallel import HaloShardedAllegroEngine, make_mesh

    n = wl["shards"]
    if torch.device(device).type == "cuda":
        devices = [torch.device("cuda", s % wl["chips"]) for s in range(n)]
    else:
        devices = [torch.device(device)] * n
    system, _ = HaloShardedAllegroEngine.prepare_system(system, n)
    eng = HaloShardedAllegroEngine(cfg, params, system, make_mesh(devices=devices),
                                   skin=wl["skin"])
    return system, eng, {"migrate": True}
