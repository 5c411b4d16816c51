"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity), at the full power limit of 700 W.  A card set below that
limit runs slower under load: the run prints its limit beside every share."""

BYTES_PER_S = 3.35e12  # HBM3
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # bfloat16 tensor cores
