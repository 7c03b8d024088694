"""Matmul precision policy (counterpart of ``pair_allegro_tpu/ops/prec.py``).

The policy names the precision of every product in the port, as the JAX
package's does of every dot it traces:

* the products inside the layer body's kernels (K1, K6, K7, K8) and their
  plain versions take :func:`kernel_mode` of their operands' dtype, the
  mode JAX's ``pallas_tp._kernel_precision`` gives the TPU kernels:
  ``highest`` and ``mixed`` -> ``"tf32x3"`` (f32-accurate: the 3xTF32
  builds, JAX's HIGHEST), ``kernel_high`` (the default) and ``high`` ->
  ``"bf16x3"`` (JAX's HIGH, written out as the kernels write it: both
  operands split hi + lo in bf16, ``hi*hi + hi*lo + lo*hi`` in f32),
  ``default`` -> ``"bf16"`` (one bf16 pass with f32 sums, JAX's DEFAULT);
  bf16 operands always ``"bf16"``, and f64 operands keep their own
  precision (``"tf32x3"``: the plain product at the dtype);
* the glue, every product outside a kernel, takes :func:`get_matmul_precision`
  (``matmul_precision_for`` of a dtype), as XLA maps it on an NVIDIA GPU:
  ``highest`` keeps f32 products exact (TF32 off), ``high`` and ``default``
  let cuBLAS take TF32 (:func:`glue_scope`); on the CPU every precision is
  exact f32, as XLA's CPU backend is.  The sites JAX pins at ``"highest"``
  take :func:`exact_mm` under every policy.

JAX reads the policy when it traces a function; the port reads it at each
call (a kernel wrapper's forward fixes the mode its backward uses).
:func:`kmm` is the plain product of each mode on tensors of any device, so
every plain kernel version is its build's exact oracle.
"""

from __future__ import annotations

import contextlib
import functools

import torch

POLICIES = ("highest", "high", "default", "mixed", "kernel_high")
MODES = ("tf32x3", "bf16x3", "bf16")

_PRECISION = "kernel_high"


def get_precision_policy() -> str:
    """The raw policy: 'highest' | 'high' | 'default' | 'mixed' | 'kernel_high'.

    'mixed' runs the glue at 'high' while the kernels stay f32-accurate;
    'kernel_high' is its converse: the glue exact f32, the kernels' products
    bf16x3."""
    return _PRECISION


def get_matmul_precision() -> str:
    """The glue's precision ('highest' | 'high' | 'default'): 'mixed'
    surfaces as 'high' here, 'kernel_high' as 'highest'."""
    if _PRECISION == "mixed":
        return "high"
    if _PRECISION == "kernel_high":
        return "highest"
    return _PRECISION


def matmul_precision_for(dtype: torch.dtype) -> str:
    """Per-dtype glue precision: bf16 operands take their one native pass
    ('default')."""
    if dtype == torch.bfloat16:
        return "default"
    return get_matmul_precision()


def set_matmul_precision(p: str) -> None:
    global _PRECISION
    if p not in POLICIES:
        raise ValueError(f"unknown matmul precision policy {p!r}; one of {POLICIES}")
    _PRECISION = p


@contextlib.contextmanager
def matmul_precision(p: str):
    """The policy ``p`` inside the block, the previous one after it (also
    after an exception)."""
    global _PRECISION
    old = _PRECISION
    set_matmul_precision(p)
    try:
        yield
    finally:
        _PRECISION = old


def kernel_mode(dtype: torch.dtype) -> str:
    """The layer body's product mode for operands of ``dtype`` under the
    policy (see the module docstring)."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype != torch.float32:
        return "tf32x3"
    return {"highest": "tf32x3", "mixed": "tf32x3", "kernel_high": "bf16x3", "high": "bf16x3",
            "default": "bf16"}[_PRECISION]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _kmm2(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return _bf16(a) @ _bf16(b)
    if mode != "bf16x3":
        raise ValueError(f"unknown kernel mode {mode!r}; one of {MODES}")
    a_hi, b_hi = _bf16(a), _bf16(b)
    a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


class _KMM(torch.autograd.Function):
    """scale * a @ b (2-D) in a rounding mode, whose backward is the same
    mode's products of the transposes with the unscaled cotangent split and
    the scale applied after, as the kernels (and JAX's ``_mm(w, g) *
    scale``) compute it; not autograd through the roundings, whose casts
    would round the cotangent to bf16."""

    @staticmethod
    def forward(ctx, a, b, mode, scale):
        ctx.save_for_backward(a, b)
        ctx.mode, ctx.scale = mode, scale
        return _kmm2(a, b, mode) * scale

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = kmm(g, b.T, ctx.mode, ctx.scale) if ctx.needs_input_grad[0] else None
        gb = kmm(a.T, g, ctx.mode, ctx.scale) if ctx.needs_input_grad[1] else None
        return ga, gb, None, None


def kmm(a: torch.Tensor, b: torch.Tensor, mode: str, scale: float = 1.0) -> torch.Tensor:
    """scale * a @ b (b 2-D, a with any leading dims) as a kernel of
    ``mode`` computes it, on any device: ``tf32x3`` the plain product at the
    operands' dtype; ``bf16`` both operands rounded to bf16, one product
    with f32 sums (at bf16 operands the plain bf16 product, f32 sums rounded
    once); ``bf16x3`` JAX's split (``hi = bf16(x)``, ``lo = bf16(x - hi)``)
    and ``hi*hi + hi*lo + lo*hi``, each a product of bf16 values (exact in
    f32) summed in f32.  The scale applies after the product, and the
    backward is the same mode's products of the transposes and the unscaled
    cotangent, then the scale (``pallas_stack._mm(w, g) * scale``)."""
    if mode == "tf32x3" or a.dtype == torch.bfloat16:
        return (a @ b) * scale
    lead = a.shape[:-1]
    out = _KMM.apply(a.reshape(-1, a.shape[-1]), b, mode, scale)
    return out.reshape(*lead, b.shape[-1])


def glue_tf32() -> bool:
    """Whether the glue's f32 products may take TF32 on the card: under
    'high' and 'default' (and 'mixed'), as XLA runs them on an NVIDIA GPU."""
    return get_matmul_precision() != "highest"


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def glue_scope():
    """A context in which cuBLAS takes the glue's precision under the
    policy (TF32 on or off), restored after it.  A product's backward runs
    when autograd reaches it, so a scope must hold the backward too:
    ``potential.make_potential`` holds the whole force evaluation in one."""
    return _tf32(glue_tf32())


def under_glue(fn):
    """``fn`` run inside :func:`glue_scope` (a neighbor build: no autograd)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with glue_scope():
            return fn(*args, **kwargs)

    return wrapped


class _ExactMM(torch.autograd.Function):
    """a @ b with TF32 off in the forward and in the backward, whatever the
    surrounding scope says; its backward is made of the same Function, so a
    second derivative stays exact too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _tf32(False):
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = exact_mm(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = exact_mm(a.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D) at f32 accuracy under every policy, both ways: the sites
    JAX pins at ``precision="highest"``."""
    return _ExactMM.apply(a, b)
