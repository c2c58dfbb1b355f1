"""The whole training step's share of the card's float32 product peak:
the products of the steps the window completed (the reference step's
forward and backward passes with R1's double backward, counted by
`work.step.step_flops`), over the window's seconds, over 495 TFLOP/s."""

from work.peaks import F32_PRODUCT_FLOPS


def read(ctx):
    if not ctx.get("flops_per_unit"):
        return None
    return 100.0 * ctx["flops_per_unit"] * ctx["units"] / ctx["window_s"] / F32_PRODUCT_FLOPS
