"""Engines: one module per ``engine`` that a cell's file names, with
``make(fam, cfg, params, system, wl, device) -> (system, engine,
keywords)``: the system as the engine takes it, the engine, and the
keywords of :func:`gpubench.harness.run_episode` it needs."""
