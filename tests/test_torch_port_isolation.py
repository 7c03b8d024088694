"""The PyTorch port stands alone: importing every module of
``pair_allegro_tpu_torch`` loads neither JAX nor the JAX package, and
neither the package's sources nor ``chip_smoke.py`` import them."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pair_allegro_tpu_torch"


def _forbidden(name: str) -> bool:
    return name in ("jax", "pair_allegro_tpu") or name.startswith(("jax.", "pair_allegro_tpu."))


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pair_allegro_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'pair_allegro_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'pair_allegro_tpu')"
        " or k.startswith(('jax.', 'pair_allegro_tpu.')))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 10 else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def test_every_port_module_is_scanned():
    mods = {m.name for m in pkgutil.walk_packages([str(PKG)], "pair_allegro_tpu_torch.")}
    assert "pair_allegro_tpu_torch.ops.fused_layer" in mods
    assert "pair_allegro_tpu_torch.md.integrate" in mods
    for name in ("ops._build", "ops.nequip_conv", "models.nequip", "models.edges",
                 "ops.env_layer", "ops.env_layer_mxu", "ops.weight_cache", "ops.tp_mix_fused",
                 "ops.scatter", "neighbors.device", "ops.embed_layer", "ops.readout_layer",
                 "ops.fused_stack", "checkpoint", "cli", "computes", "calculator", "debug",
                 "io.config", "io.dump", "io.extxyz", "io.lammps_data", "ops.remat", "train",
                 "data", "import_torch", "native", "compile_cache", "parallel", "parallel.mesh",
                 "parallel.sharded", "parallel.halo", "tree", "ops.prec"):
        assert f"pair_allegro_tpu_torch.{name}" in mods
