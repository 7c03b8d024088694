"""Structure and trajectory I/O (counterpart of ``pair_allegro_tpu/io``),
plus the YAML-subset reader of the run configs."""

from pair_allegro_tpu_torch.io.config import load_config, parse_config
from pair_allegro_tpu_torch.io.dump import DumpWriter
from pair_allegro_tpu_torch.io.extxyz import read_extxyz, write_extxyz
from pair_allegro_tpu_torch.io.lammps_data import read_lammps_data, write_lammps_data

__all__ = [
    "DumpWriter",
    "load_config",
    "parse_config",
    "read_extxyz",
    "read_lammps_data",
    "write_extxyz",
    "write_lammps_data",
]
