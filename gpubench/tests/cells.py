"""Small cells of each family for the CPU tests: the same files, a
smaller lattice, 4-step episodes and smaller widths."""

SMALL = {
    "allegro": {"num_layers": 2, "num_scalar_features": 16, "num_tensor_features": 8,
                "two_body_mlp_width": 16, "allegro_mlp_hidden_layers_width": 16,
                "readout_mlp_hidden_layers_width": 8},
    "nequip": {"num_features": 16, "radial_mlp_width": 16, "readout_mlp_width": 8},
}
CELLS = {"allegro": "allegro-cu5k-nve", "nequip": "nequip-cu16k-nve"}


def small_cell(family: str, n_rep: int = 5, **wl_over):
    """(workload, config) of the family's first cell at a CPU size: the
    same file with a smaller lattice, 4-step episodes and smaller widths."""
    from gpubench import harness

    wl = harness.load("workloads", CELLS[family])
    wl.update(n_rep=n_rep, episode_steps=4, warmup_steps=2, check_points=1, **wl_over)
    cf = harness.load("configs", wl["config"])
    cf["model"].update(SMALL[family])
    return wl, cf
