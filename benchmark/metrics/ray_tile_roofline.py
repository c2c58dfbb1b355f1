"""#2's share of its roofline at the served frame's shape: the least time
for its work (`work.kernels.ray_tile`, at 495 TFLOP/s and 3.35 TB/s) over
its measured time, each recorded call of one eager frame timed alone."""

from work.kernels import ray_tile
from work.peaks import least_seconds

ENTRIES = ["cips3d_tpu_torch.ops.ray_tile:ray_tile"]


def read(ctx):
    calls = ctx["calls"].get(ENTRIES[0], [])
    if not calls:
        return None
    g = ctx["config"]["generator"]
    H, L, R = g["nerf_hidden_dim"], g["nerf_hidden_layers"], g["nerf_rgb_dim"]
    least = spent = 0.0
    for args, kwargs in calls:
        b, n, S, _ = args[1].shape
        least += least_seconds(*ray_tile(b, n, S, H, L, H // 2, R))
        spent += ctx["time_call"](ENTRIES[0], args, kwargs)
    return 100.0 * least / spent
