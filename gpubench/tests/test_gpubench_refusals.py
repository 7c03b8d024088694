"""The harness refuses to run without a card, and in a directory that
holds only BENCHMARK.json and the benchmark's own files."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "allegro-cu5k-nve",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.strip().splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_gpubench_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and "CUDA device" in out.stderr
    _no_result(out)


def test_gpubench_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
