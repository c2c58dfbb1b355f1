"""#2r's and #3's share of their roofline over one G phase: the least time
for the work of the ray tile with residuals and of its backward from them
(`work.kernels`, at 495 TFLOP/s and 3.35 TB/s) over their measured time,
each recorded call of one eager step timed alone."""

from work.kernels import ray_tile_bwd, ray_tile_residuals
from work.peaks import least_seconds

FWD = "cips3d_tpu_torch.ops.ray_tile:ray_tile_cuda"
BWD = "cips3d_tpu_torch.ops.ray_tile:ray_tile_bwd_cuda"
ENTRIES = [FWD, BWD]


def read(ctx):
    g = ctx["config"]["generator"]
    H, L, R = g["nerf_hidden_dim"], g["nerf_hidden_layers"], g["nerf_rgb_dim"]
    calls = ([(FWD, a, k, ray_tile_residuals) for a, k in ctx["calls"].get(FWD, [])
              if k.get("with_residuals")]
             + [(BWD, a, k, ray_tile_bwd) for a, k in ctx["calls"].get(BWD, [])])
    if not calls:
        return None
    least = spent = 0.0
    for entry, args, kwargs, work in calls:
        b, n, S, _ = args[1].shape
        least += least_seconds(*work(b, n, S, H, L, H // 2, R))
        spent += ctx["time_call"](entry, args, kwargs)
    return 100.0 * least / spent
