"""NVIDIA's data-sheet peaks for one H100 SXM (NVIDIA H100 80GB HBM3) at its
full 700 W power limit: dense FLOP/s by input type and HBM bytes/s.  A card
set below 700 W runs slower under load, so every share of these is printed
beside the card's power limit."""

#: HBM bytes/s
HBM_BYTES_PER_S = 3.35e12
#: dense bfloat16 FLOP/s on the tensor cores
BF16_FLOPS = 989e12
#: float32 FLOP/s on the CUDA cores
F32_FLOPS = 67e12
