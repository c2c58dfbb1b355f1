"""Tiny widths of every cell for the CPU tests: the cell's own files,
with the generator, discriminator and image cut so a run takes seconds,
and two gloo ranks in place of the cards of a data-parallel cell.

``RANKS`` is the data-parallel driver's cell that no entry of
``BENCHMARK.json`` names yet: the `train_r64_ranks` mix on `cips3d_ffhq`,
held to the limits of `train_r64_exact` (the same stage), so that the
driver's path stays rehearsed."""

import dataclasses

import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]
RANKS = "train_r64_ranks"

SIZES = {
    "generator": dict(z_dim_nerf=16, z_dim_inr=32, nerf_hidden_dim=16, nerf_style_dim=16,
                      nerf_mapping_layers=2, inr_hidden_dim=32, inr_style_dim=32,
                      inr_mapping_layers=2, nerf_rgb_dim=8),
    "discriminator": dict(max_size=16, channels_override={4: 16, 8: 16, 16: 16}),
    "render": dict(num_steps=3),
    "img_size": 16,
    "forward_points": 128,
}


def sizes(c: harness.Cell) -> dict:
    return dict(SIZES, ranks=2) if c.traffic["driver"] == "train_ranks" else SIZES


def ranks_cell() -> harness.Cell:
    exact = harness.cell("train_r64_exact")
    return harness.Cell(RANKS, 4, harness.load_json("configs", "cips3d_ffhq.json"),
                        harness.load_json("traffic", RANKS + ".json"), exact.end_to_end, [],
                        exact.limits)


def tiny_cell(name: str) -> harness.Cell:
    """The cell with its traffic cut to a few small batches."""
    c = ranks_cell() if name == RANKS else harness.cell(name)
    tr = dict(c.traffic, num_images=8, num_workers=1)
    if tr["driver"] in ("train", "train_ranks"):
        tr.update(batch_size=2, dispatch_chunk=2)
    else:
        tr.update(num_steps=3, check_frames=4, check_within=4, seed_pool=3, p_depth=0.5)
    return dataclasses.replace(c, traffic=tr)
