"""#1's share of its roofline at the served frame's shape: the least time
for its work (`work.kernels.inr_tile`, at 495 TFLOP/s and 3.35 TB/s) over
its measured time, each recorded call of one eager frame timed alone."""

from work.kernels import inr_tile
from work.peaks import least_seconds

ENTRIES = ["cips3d_tpu_torch.ops.inr_tile:inr_tile"]


def read(ctx):
    calls = ctx["calls"].get(ENTRIES[0], [])
    if not calls:
        return None
    least = spent = 0.0
    for args, kwargs in calls:
        x, weights = args[0], args[3]
        b, n, in0 = x.shape
        layers = weights.wrest.shape[0] + 1
        least += least_seconds(*inr_tile(b, n, in0, weights.wrest.shape[-1], layers,
                                          weights.wr.shape[0]))
        spent += ctx["time_call"](ENTRIES[0], args, kwargs)
    return 100.0 * least / spent
