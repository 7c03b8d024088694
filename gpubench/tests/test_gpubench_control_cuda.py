"""The control on the card: the reference at TF32 in the program's place
fails the cell's limits where the program holds them, on three seeds, on
the first cell's model and traffic at a smaller lattice (6^3 cells)."""

import pytest

from gpubench import check


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["allegro-cu5k-nve", "nequip-cu16k-nve"])
def test_gpubench_control_fails_where_the_program_holds(card, cell):
    from gpubench import control, harness

    limits = harness.load("workloads", cell)["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = control.readings(cell, seed, 0.0, n_rep=6)
        assert r["points"] >= 1 and r["failed"] == 0
        assert all(r["program"][k] <= limits[k] for k in check.NUMBERS), r
        assert any(r["control"][k] > limits[k] for k in check.NUMBERS), r
