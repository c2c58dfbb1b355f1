"""The peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit).

Both configurations are float32.  The program's float32 products run on
the tensor cores (3xTF32 `mma.sync` in the hand-written kernels, cuDNN's
TF32 convolutions), which can pass the 67 TFLOP/s of float32 outside the
tensor cores; so every product is held to the TF32 tensor-core rate, which
nothing that keeps float32 accuracy beats.  Bytes are held to the HBM3
rate.
"""

F32_PRODUCT_FLOPS = 495e12   # FLOP/s, dense TF32 on the tensor cores
HBM_BYTES = 3.35e12          # B/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / F32_PRODUCT_FLOPS, nbytes / HBM_BYTES)
