"""PyTorch/CUDA port of the Allegro MD engine in ``pair_allegro_tpu``.

The JAX package beside this one is the reference: every module here mirrors
a module path there, and the tests hold each against its counterpart.  This
package imports torch and numpy only, never JAX or the JAX package.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper takes its plain
PyTorch version.
"""

from pair_allegro_tpu_torch.system import System, Units, resolve_device

__all__ = ["System", "Units", "resolve_device"]
