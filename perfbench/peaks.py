"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). A share of a peak is stated
against these, with the card's power limit printed beside it."""

BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16
FP32_FLOPS = 67e12         # outside the tensor cores
HBM_BYTES = 3.35e12        # bytes a second of device memory
