"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set to a
lower power limit reaches less; the harness prints the limit beside every
share of these peaks."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
FP32_FLOPS = 67e12         # float32 on the CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # 80 GB HBM3
