"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Every share of a
peak or roofline is stated against these, with the card's power limit
beside it.

The per-pipe instruction rates follow from the 67 TFLOP/s float32 rate
(an FMA counts 2) and the CUDA programming guide's per-SM rates for
compute capability 9.0: 128 float32, 64 int32 add / logic / compare and
16 popcount / conversion instructions a clock; shared memory serves 32
lanes of 4 bytes a clock an SM (a quarter of the float32 rate).
"""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PIPE_OPS_PER_S = {"float32": FP32_FLOPS / 2, "int32": FP32_FLOPS / 4,
                  "popc/cvt": FP32_FLOPS / 16}
LDS_PER_S = FP32_FLOPS / 2 / 4
