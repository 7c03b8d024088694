"""The plain reference that decides ``correct``: plain PyTorch, f32 with
TF32 off where the check runs it, its own neighbor list, the weights drawn
again from the seed.  It imports nothing of the port and nothing of JAX."""
