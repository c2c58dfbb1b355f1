"""Seconds of the run in the warm-ups and captures of its CUDA graphs (the
program's ``graph`` counters, `utils/graphs.py::Graph`; a build of the
kernels inside a warm-up left out); every capture of this cell happens in
set-up."""

from work.counters import counters


def read(ctx):
    g = (counters() or {}).get("graph")
    if not g or not g["captures"]:
        return None
    return (g["warm_up_ns"] + g["capture_ns"]) / 1e9
