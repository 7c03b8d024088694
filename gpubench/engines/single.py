"""One device: the family's own engine (``AllegroEngine``,
``NequIPEngine``) with the cell's skin."""


def make(fam, cfg, params, system, wl: dict, device):
    return system, fam.make_engine(cfg, params, system, wl["skin"], device), {}
