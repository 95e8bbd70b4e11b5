"""Published peaks of one NVIDIA H100 SXM5 80 GB at its 700 W limit
(NVIDIA's data sheet, dense rates, no structured sparsity).

Frozen copies of the port's ``repro_torch/configs/base.py`` constants,
which ``launch/roofline.py`` reads: a later change to the port does not
move the benchmark's divisors.  A run prints the card's power limit
beside every share of these peaks, since a card held under 700 W runs
slower under load.
"""
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 on the CUDA cores
HBM_BW = 3.35e12              # bytes/s, HBM3
HBM_BYTES = 80e9              # bytes
