"""Process groups for training on many GPUs: counterpart of
`cips3d_tpu/parallel/mesh.py`.

The JAX package runs one SPMD program over a device mesh and lets XLA
insert the collectives.  The port runs one process per card, as the
reference's DDP does, and calls `torch.distributed` itself:

  * ``initialize_multihost``: the ``CIPS3D_COORDINATOR``,
    ``CIPS3D_NUM_PROCESSES`` and ``CIPS3D_PROCESS_ID`` env vars onto
    `torch.distributed.init_process_group` (NCCL for a CUDA device, gloo on
    the CPU); a no-op without them;
  * `Mesh` (`make_mesh`): world size, rank, ``ray_shards`` R and the
    process groups.  Ranks form groups of R consecutive ranks: the 2-D
    (data x rays) layout, where a group shares one set of latents, each rank
    renders 1/R of the pixel list, and the discriminator is batch-parallel
    over every rank;
  * `all_reduce_mean_flat`: every gradient of a phase in one flat buffer,
    one all-reduce (sum), divided by the world size;
  * `gather_pixels`: an autograd all-gather of the rendered pixels within a
    ray group (backward: all-reduce of the cotangent, then the rank's own
    slice); `gather_rows` the same over the batch axis of every rank;
  * `shard_batch`: the rank's rows of a batch of draws or images;
  * `host_barrier` on the process group's store, `broadcast_modules`.

Why the mean over ranks of each rank's local-mean gradient is the JAX
gradient, in both layouts.  The JAX step's losses are means over the global
batch of B rows, and every rank holds the same number of the discriminator's
rows, B / world, so the global mean is the mean over ranks of the ranks'
means.  D's gradient follows directly.  G's: in the 1-D layout a rank's D
loss reaches only the G rows it rendered.  In the 2-D layout the cotangent
of a rank's D loss flows back through `gather_pixels` to the ranks of its
group that rendered those pixels, and each rank's G gradient holds, for the
pixels it rendered, the cotangents of every rank's loss in its group.  So
the sum of G's gradients over all ranks counts every D-loss term exactly
once, and dividing by the world size gives the global mean.  The norm, the
clip and the NaN guard then run on the reduced gradient, identical on every
rank, and so are Adam's update and the EMA.

Staging: none.  gloo's ``all_reduce``, ``all_gather`` and ``broadcast``
take CUDA tensors (they copy through host memory inside ProcessGroupGloo),
checked on torch 2.11 with CUDA 12.8; NCCL takes them natively.

Chunked dispatch (`train/chunk.py`): in an NCCL group each rank captures
its step with the step's all-reduces inside the CUDA graph, and every
replay runs them again (NCCL's communicator is made in the warm-up step,
before the capture); `COLLECTIVES` counts them through the replays.  In a
gloo group (the CPU, or ranks sharing a card) a chunk is eager steps:
gloo's collectives go through host memory and cannot be captured.

What is not ported: ``pixel_shard_map``, ``pixel_sharding_scope``,
``constrain_*`` and ``shard_chunk_*`` exist for GSPMD (which cannot
partition a Mosaic call) and for placing a ``lax.scan`` chunk's stacked
batches; a process renders its pixel slice with the kernels as they are,
and a chunk's batches reach its graph one step at a time.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from cips3d_tpu_torch.utils import trace

#: collectives launched by this module, by kind (read by the smoke run): the
#: ``collectives`` counters of `utils/trace.py`
COLLECTIVES: collections.Counter = trace.counter("collectives")
#: calls of `host_barrier` by name in this process (every rank makes the same calls)
_BARRIER_CALLS: collections.Counter = collections.Counter()


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device: str = "cuda",
                         backend: Optional[str] = None) -> bool:
    """Join the process group that the arguments (default: the env vars
    ``CIPS3D_COORDINATOR`` (host:port), ``CIPS3D_NUM_PROCESSES`` and
    ``CIPS3D_PROCESS_ID``) describe.  The backend is NCCL when ``device`` is
    a CUDA device and gloo otherwise, unless ``backend`` names one; under
    NCCL the process takes card ``process_id % device_count``.  Returns
    False, and does nothing, without a multi-process configuration."""
    coordinator_address = coordinator_address or os.environ.get("CIPS3D_COORDINATOR")
    if num_processes is None and "CIPS3D_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["CIPS3D_NUM_PROCESSES"])
    if process_id is None and "CIPS3D_PROCESS_ID" in os.environ:
        process_id = int(os.environ["CIPS3D_PROCESS_ID"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("CIPS3D_PROCESS_ID is needed with CIPS3D_NUM_PROCESSES > 1")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def local_device(device: str) -> str:
    """The rank's device: ``cuda:{rank % device_count}`` for ``cuda`` in a
    process group, else ``device`` as given."""
    if dist.is_initialized() and device == "cuda":
        return f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process layout of a run: ``world`` ranks in groups of
    ``ray_shards`` consecutive ranks.  ``data_group`` spans every rank (the
    gradient and metric all-reduces: parameters are replicated over both
    axes); ``rays_group`` is the rank's ray group (None when R == 1)."""

    world: int
    rank: int
    ray_shards: int
    data_group: Any = None
    rays_group: Any = None

    @property
    def ray_index(self) -> int:
        """The rank's place in its ray group."""
        return self.rank % self.ray_shards

    @property
    def group_index(self) -> int:
        """The rank's ray group: its index on the data axis."""
        return self.rank // self.ray_shards

    @property
    def pixel_shards(self):
        """(index, count, group) of the axis that splits pixels: the ray
        group, or every rank when R == 1 (the JAX package's
        ``render_sharded`` takes a mesh's first axis then)."""
        if self.ray_shards > 1:
            return self.ray_index, self.ray_shards, self.rays_group
        return self.rank, self.world, self.data_group

    def pixel_range(self, n: int):
        """(lo, hi) of the rank's share of ``n`` pixels on the pixel axis."""
        index, count, _ = self.pixel_shards
        if n % count:
            raise ValueError(f"{n} pixels do not divide by {count} pixel shards")
        m = n // count
        return index * m, (index + 1) * m


def make_mesh(ray_shards: int = 1) -> Mesh:
    """The mesh of the current process group (of one process without one):
    every rank must call it, in the same order, since it creates the ray
    groups.  Raises the JAX package's ValueError when ``ray_shards`` does not
    divide the world size."""
    ray_shards = max(1, int(ray_shards))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % ray_shards:
        raise ValueError(f"ray_shards={ray_shards} must divide device count {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    rays_group = None
    if ray_shards > 1:
        for g in range(world // ray_shards):
            pg = dist.new_group(list(range(g * ray_shards, (g + 1) * ray_shards)))
            if g == rank // ray_shards:
                rays_group = pg
    return Mesh(world, rank, ray_shards, None, rays_group)


def all_reduce_mean_flat(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean over every rank of each tensor, through one all-reduce of one
    flat float32 buffer; each result has its input's shape and dtype."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    trace.count("collectives", "all_reduce")
    flat = flat / mesh.world
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` within ``group``, the ranks' parts in rank
    order; the backward sums the cotangent over the group and keeps the
    rank's part (each rank's loss reads the whole gathered tensor)."""

    @staticmethod
    def forward(ctx, x, dim, group, index, count):
        ctx.dim, ctx.group, ctx.index, ctx.n = dim, group, index, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(count)]
        dist.all_gather(parts, x.contiguous(), group=group)
        trace.count("collectives", "all_gather")
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        trace.count("collectives", "all_reduce")
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None


def gather_pixels(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(b, m, C) → (b, m * shards, C): the pixel slices of the pixel axis
    (`Mesh.pixel_shards`), in rank order."""
    index, count, group = mesh.pixel_shards
    return _Gather.apply(x, 1, group, index, count)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(b, ...) → (world * b, ...): every rank's rows, in rank order."""
    return _Gather.apply(x, 0, mesh.data_group, mesh.rank, mesh.world)


#: fields of draws that are not per row (the pixel permutation of a microbatch)
_NOT_PER_ROW = ("perm",)


def shard_batch(tree, lo: int, hi: int, rows: int):
    """Rows [lo, hi) of every tensor of ``tree`` (tensors, tuples, named
    tuples, dicts, lists, None) whose leading dim holds ``rows`` rows: a
    leading dim of ``rows * k`` is row-major over k entries a row (a
    ``(b * n, S)`` draw).  Tensors without a batch dim (0-d, or a named
    tuple's ``perm``) pass through."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        if tree.ndim == 0:
            return tree
        if tree.shape[0] % rows:
            raise ValueError(f"leading dim {tree.shape[0]} is not a multiple of {rows} rows")
        k = tree.shape[0] // rows
        return tree[lo * k:hi * k]
    if isinstance(tree, dict):
        return {key: shard_batch(v, lo, hi, rows) for key, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(v if f in _NOT_PER_ROW else shard_batch(v, lo, hi, rows)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, lo, hi, rows) for v in tree)
    raise TypeError(f"cannot take rows of {type(tree).__name__}")


def broadcast_modules(modules: Sequence[torch.nn.Module], mesh: Mesh) -> None:
    """Rank 0's parameters and buffers of ``modules`` onto every rank: one
    broadcast a dtype."""
    tensors = [t for m in modules for t in list(m.parameters()) + list(m.buffers())]
    by_dtype = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, 0, group=mesh.data_group)
            trace.count("collectives", "broadcast")
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].reshape(t.shape))
                off += t.numel()


def host_barrier(name: str, timeout_s: float = 600.0) -> bool:
    """Rendezvous every process on the process group's store, not through a
    device collective, so it works on both backends.  No-op (False) without
    a process group.  Every process must reach each call; the n-th call of a
    name meets the n-th call of that name on the others.  Raises, naming the
    barrier, the rank and the wait, when a peer has not arrived within
    ``timeout_s``."""
    if not dist.is_initialized():
        return False
    world, rank = dist.get_world_size(), dist.get_rank()
    store = dist.distributed_c10d._get_default_store()
    _BARRIER_CALLS[name] += 1
    key = f"cips3d_host_barrier/{name}/{_BARRIER_CALLS[name]}"
    t0 = time.time()
    store.add(key, 1)
    while int(store.add(key, 0)) < world:
        if time.time() - t0 > timeout_s:
            raise RuntimeError(
                f"host_barrier {name!r} failed after {time.time() - t0:.0f}s (timeout "
                f"{timeout_s:.0f}s) on process {rank}/{world}: a peer likely died or is still "
                "building; check the other processes' logs for the last barrier they reached")
        time.sleep(0.005)
    waited = time.time() - t0
    if waited > 0.25 * timeout_s:
        print(f"[mesh] host_barrier {name!r}: process {rank} waited {waited:.0f}s of the "
              f"{timeout_s:.0f}s budget", flush=True)
    return True
