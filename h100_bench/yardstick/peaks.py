"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit): HBM bytes/s, bf16 and
int8 tensor-core operations/s, and the CUDA-core rate (its fp32 figure),
used for the kernels' integer work.  A card set below 700 W reports its
limit beside every share counted against these."""

HBM = 3.35e12
BF16 = 989e12
INT8 = 1979e12
CUDA_CORE = 67e12
