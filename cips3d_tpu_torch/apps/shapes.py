"""3D shape extraction: the NeRF density on a voxel grid, as an .mrc volume.
Counterpart of `cips3d_tpu/apps/shapes.py` (`exp/pigan/scripts/
extract_shapes.py:13-92`): sample an n^3 grid inside the NeRF's cube,
evaluate the SIREN's sigma head in chunks (styles truncated at ``psi``),
and write an MRC2014 volume (1024-byte header, mode 2 float32) ready for
marching cubes, with numpy only: the bytes are the JAX writer's.

The SIREN runs as `NeRFNetwork.forward` (plain PyTorch, as the JAX package
runs it through XLA): the ray-tile kernel renders rays, not free points.
A chunk is one program (on the card a CUDA graph, replayed each chunk).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from cips3d_tpu_torch.models.generator import GeneratorNerfINR
from cips3d_tpu_torch.utils import graphs


def create_voxel_grid(n: int = 256, sidelength: float = 0.24) -> np.ndarray:
    """(n^3, 3) grid covering the NeRF's box (`extract_shapes.py:13-36`)."""
    lin = np.linspace(-sidelength / 2, sidelength / 2, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=-1)


def _sigma(model: GeneratorNerfINR, pts: torch.Tensor, styles) -> torch.Tensor:
    """The SIREN's sigma at (m, 3) points: (m,) float32."""
    return model.siren(pts[None], styles)[1][0, :, 0].float()


@torch.no_grad()
def sample_sigma_volume(model: GeneratorNerfINR, seed: int = 0, n: int = 128,
                        sidelength: float = 0.24, chunk: int = 65536, psi: float = 0.7,
                        styles: Optional[dict] = None, draws=None,
                        dispatch: str = "program") -> np.ndarray:
    """Sigma on an n^3 grid (`extract_shapes.py:38-63`), ``chunk`` points a
    SIREN call (the grid padded to whole chunks, as the JAX package pads
    it); the styles are seed ``seed``'s (`apps/render.py::seed_styles`)
    unless given.  The sigmas are gathered on the device and copied to the
    host once.  A chunk is one program, as the JAX package jits it
    (`utils/graphs.py::program_for`: a CUDA graph on the card, replayed
    each chunk); ``dispatch="eager"`` runs the chunks op by op.  Returns
    (n, n, n) float32."""
    from cips3d_tpu_torch.apps.render import Draws, seed_styles

    captured = not graphs.eager(dispatch)
    if styles is None:
        styles = seed_styles(model, seed, psi, draws or Draws(model.device))
    grid = create_voxel_grid(n, sidelength)
    num = grid.shape[0]
    pad = (-num) % chunk
    if pad:
        grid = np.concatenate([grid, np.zeros((pad, 3), np.float32)])
    grid = torch.as_tensor(grid, device=model.device)
    vol = torch.empty(grid.shape[0], dtype=torch.float32, device=model.device)
    prog = None
    if captured:
        inputs = {"pts": grid[:chunk], "styles": dict(styles)}
        prog = graphs.program_for(model, ("sigma", chunk), inputs,
                                  lambda m, x, rng: _sigma(m, x["pts"], x["styles"]),
                                  f"sigma volume chunk of {chunk} points")
    for lo in range(0, grid.shape[0], chunk):
        pts = grid[lo:lo + chunk]
        vol[lo:lo + chunk] = (_sigma(model, pts, styles) if prog is None
                              else prog({"pts": pts, "styles": styles}))
    return vol[:num].cpu().numpy().reshape(n, n, n)


def write_mrc(path: str, volume: np.ndarray, voxel_size: float = 1.0) -> None:
    """Minimal MRC2014 writer: mode 2 (float32) volume."""
    vol = np.ascontiguousarray(volume, np.float32)
    nz, ny, nx = vol.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)          # NX NY NZ
    struct.pack_into("<i", header, 12, 2)                   # MODE 2 = float32
    struct.pack_into("<3i", header, 28, nx, ny, nz)         # MX MY MZ
    struct.pack_into("<3f", header, 40, nx * voxel_size, ny * voxel_size,
                     nz * voxel_size)                       # CELLA
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)   # CELLB
    struct.pack_into("<3i", header, 64, 1, 2, 3)            # MAPC MAPR MAPS
    struct.pack_into("<3f", header, 76, float(vol.min()), float(vol.max()),
                     float(vol.mean()))                     # DMIN DMAX DMEAN
    header[208:212] = b"MAP "                               # MAP stamp
    header[212:216] = b"\x44\x44\x00\x00"                   # little-endian stamp
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vol.tobytes())


def read_mrc(path: str) -> np.ndarray:
    """Read back a mode-2 MRC volume."""
    with open(path, "rb") as f:
        header = f.read(1024)
        nx, ny, nz = struct.unpack_from("<3i", header, 0)
        mode = struct.unpack_from("<i", header, 12)[0]
        if mode != 2:
            raise ValueError(f"unsupported MRC mode {mode}")
        data = np.frombuffer(f.read(), np.float32)
    return data.reshape(nz, ny, nx)


def extract_shape(model: GeneratorNerfINR, out_path: str, seed: int = 0, n: int = 128,
                  sidelength: float = 0.24, psi: float = 0.7, draws=None) -> np.ndarray:
    """Sigma volume → .mrc (`extract_shapes.py:66-92`)."""
    vol = sample_sigma_volume(model, seed=seed, n=n, sidelength=sidelength, psi=psi,
                              draws=draws)
    write_mrc(out_path, vol)
    return vol
