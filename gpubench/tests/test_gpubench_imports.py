"""The import rule, by top-level name compared whole: the harness loads no
JAX and not the JAX package (the port's name begins with the JAX
package's, and is allowed); the reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _imported(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(str(p.relative_to(HERE)) for p in HERE.rglob("*.py")
                                        if "tests" not in p.parts))
def test_gpubench_sources_import_no_jax(path):
    tops = _imported(HERE / path)
    assert not tops & {"jax", "jaxlib", "flax", "pair_allegro_tpu"}, tops
    if path.startswith("reference"):
        assert "pair_allegro_tpu_torch" not in tops, tops


def test_gpubench_reference_loads_nothing_of_the_port():
    code = ("import sys, gpubench.reference.allegro, gpubench.reference.nequip; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'pair_allegro_tpu', 'pair_allegro_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("family", ["allegro", "nequip"])
def test_gpubench_a_run_loads_no_jax(family):
    """A whole run on the CPU at a small size, then every module a traced
    run's readers load (the trace's reduction, each per-layer reader, the
    counts), then the harness's own look at sys.modules as ``run.py`` takes
    it before its result line, in a fresh process."""
    code = (
        "import importlib, json, sys, time\n"
        "sys.path.insert(0, 'gpubench/tests')\n"
        "from cells import small_cell\n"
        "from gpubench import harness, trace\n"
        f"wl, cf = small_cell('{family}')\n"
        "res = harness.run_cell('small', wl, cf, 5, 0.0, True, 'cpu', time.time())\n"
        "importlib.import_module('gpubench.counts.' + cf['counts'])\n"
        "for m in harness.benchmark()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "print(json.dumps([harness.forbidden_modules(), res['correct']]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[[], true]"
