"""The benchmark of the PyTorch/CUDA port, ``pair_allegro_tpu_torch``: MD
throughput of Allegro and NequIP on one H100, one cell a run
(``python -m gpubench.run``).  It imports neither JAX nor the JAX package;
``reference/`` imports nothing of the port either."""
