"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity),
the rates at its full power limit of 700 W. Every run prints the card's
enforced power limit beside the numbers that use them; a card held below
700 W reaches less of them.

The kernel bounds copy ``chip_smoke.py``'s arithmetic (``HBM_BYTES_PER_S``,
``PEAK_FLOPS`` and the bounds of ``groupnorm_row`` and ``time_flash``): the
least time the card could take is the larger of bytes over the HBM rate and
operations over the peak rate of the units that do them.
"""

BF16_FLOPS = 989e12       # dense tensor-core bf16
FP32_FLOPS = 67e12        # float32 outside the tensor cores (CUDA cores)
HBM_BYTES_PER_S = 3.35e12
POWER_W = 700             # the limit at which the rates above hold

# GroupNorm+SiLU: each input element read once and each output element
# written once (in the compute dtype), and about ten float32 operations an
# element on the CUDA cores (statistics, normalise, affine, SiLU's exp and
# divide). The bytes bound is the larger by about ten times.
GN_SILU_OPS_PER_ELEMENT = 10

# flash attention: the forward's 4·B·H·Nq·Nk·Dh on the tensor cores, the
# backward's 2.5 times that (dK, dV, dQ and the recomputed logits).
FLASH_BACKWARD_FACTOR = 2.5


def gn_silu_bound_s(elements: int, itemsize: int) -> float:
    """Least seconds for GroupNorm+SiLU over ``elements`` inputs."""
    return max(2 * elements * itemsize / HBM_BYTES_PER_S,
               GN_SILU_OPS_PER_ELEMENT * elements / FP32_FLOPS)


def flash_bound_s(batch: int, tokens: int, channels: int, itemsize: int,
                  backward: bool) -> float:
    """Least seconds for one attention block's forward (and backward) over
    ``tokens`` tokens of ``channels`` channels: q, k, v read and the output
    written once (the backward also reads dO and writes dQ, dK, dV)."""
    ops = 4 * batch * tokens * tokens * channels
    tensor_bytes = batch * tokens * channels * itemsize
    fwd = max(ops / BF16_FLOPS, 4 * tensor_bytes / HBM_BYTES_PER_S)
    if not backward:
        return fwd
    bwd = max(FLASH_BACKWARD_FACTOR * ops / BF16_FLOPS, 8 * tensor_bytes / HBM_BYTES_PER_S)
    return fwd + bwd
