"""NVIDIA H100 SXM constants (per card), the counterpart of JAX's TPU
v5e ones.

Data-sheet peaks (NVIDIA's H100 data sheet, SXM part, dense rates
without sparsity, at the full 700 W power limit), not measurements: a
card set to a lower limit runs slower under load, so every bound
computed from these stands beside the card's ``nvidia-smi`` name and
power limit.
"""

HBM_BW = 3.35e12          # bytes/s, HBM3
PEAK_F32 = 67e12          # float32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12        # TF32 FLOP/s on the tensor cores
PEAK_BF16 = 989e12        # bf16 (and fp16) FLOP/s on the tensor cores
PEAK_F64 = 34e12          # float64 FLOP/s outside the tensor cores
PEAK_FLOPS = PEAK_BF16    # JAX's PEAK_FLOPS is its bf16 rate too
ICI_BW = 450e9            # bytes/s each way: NVLink 4, 900 GB/s both ways
# One dependent float32 operation, issue to use: 4 cycles (FADD, FMUL and
# FFMA on Volta and its successors: Jia et al., "Dissecting the NVIDIA
# Volta GPU Architecture via Microbenchmarking", 2018) at the H100 SXM's
# 1980 MHz maximum SM clock (NVIDIA's H100 architecture white paper).  A
# serial chain of n operations takes at least n times this.
F32_DEP_LATENCY_S = 4 / 1.98e9

# a step's peak by the type its matmuls run in
PEAK_BY_DTYPE = {
    "float32": PEAK_F32,
    "tf32": PEAK_TF32,
    "bfloat16": PEAK_BF16,
    "float16": PEAK_BF16,
    "float64": PEAK_F64,
}

CHIP = {
    "peak_flops": PEAK_FLOPS,
    "hbm_bw": HBM_BW,
    "ici_bw": ICI_BW,
    "hbm_bytes": 80 * 10**9,
    "peak_by_dtype": PEAK_BY_DTYPE,
}
