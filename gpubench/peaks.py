"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit), and the rate at which each
matmul precision policy of the program runs its products."""

from __future__ import annotations

BF16_FLOPS = 989e12  # tensor cores, dense bf16: the one yardstick of mfu
TF32_FLOPS = 495e12  # tensor cores, dense TF32
F32_FLOPS = 67e12  # CUDA cores, f32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes per second

# products per policy: 'kernel_high' and 'high' split each f32 operand in
# two bf16 halves and take three passes (bf16x3), 'highest' and 'mixed'
# three TF32 passes (3xTF32), 'default' one bf16 pass
PRODUCT_FLOPS = {
    "kernel_high": BF16_FLOPS / 3,
    "high": BF16_FLOPS / 3,
    "highest": TF32_FLOPS / 3,
    "mixed": TF32_FLOPS / 3,
    "default": BF16_FLOPS,
}


def least_seconds(flops: float, products: float, nbytes: float, policy: str) -> float:
    """The least time of work of ``flops`` operations, ``products`` of them
    in matrix products at the policy's rate and the rest at the f32 rate
    (side by side, so the larger of the two), moving ``nbytes``: the larger
    of the operations' time and the bytes' time."""
    ops = max(products / PRODUCT_FLOPS[policy], (flops - products) / F32_FLOPS)
    return max(ops, nbytes / HBM_BYTES)
