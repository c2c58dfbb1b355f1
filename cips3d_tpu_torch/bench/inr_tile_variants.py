"""Where the INR-tile kernel's time goes: variants of `csrc/inr_tile.cu`
timed side by side on one card.

    python3 -m cips3d_tpu_torch.bench.inr_tile_variants

Each variant is the kernel's source with a few lines edited, built with
`nvcc` (one process each, all at once) into its own library under
``csrc/build/variants/`` (git-ignored) and timed with CUDA events at the
serving shape (b = 1, r128: 16384 pixels, D = 512, 9 blocks, random weights
from a seed), f32 and bf16, in turns.  Besides the kernel as it ships:
  * ``8_warps``: the other warp layout, 8 warps of 64 rows x 64 channels
    (256 threads, up to 255 registers a thread; right, like the shipped one);
  * ``no_products``: the multiply skipped (the weight feed, the splits of
    A, the barriers and epilogues remain);
  * ``no_weight_feed``: no weight stage loaded (the products run on what
    the ring holds);
  * ``no_residual``: no block input saved to or read back from the scratch
    slot.
The edited variants compute wrong values; only their times and ptxas
reports are read.  Prints one line per variant with its registers and
spills (ptxas) and median ms, beside the card's name and power limit.
"""

import ctypes
import re
import statistics
import subprocess
import sys

import torch

from cips3d_tpu_torch.models.cips_net import CIPSNet
from cips3d_tpu_torch.ops import build, inr_tile

VARIANTS = {
    "as shipped": [],
    "8_warps": [("constexpr int kWarps = 16;", "constexpr int kWarps = 8;")],
    "no_products": [("if (active) tile_mma", "if (false) tile_mma")],
    "no_weight_feed": [("    if (tile < tiles) {\n", "    if (false) {\n")],
    "no_residual": [("if (active && stage == 0 && blk >= kFirstSkip)", "if (false)"),
                    ("if (stage == 1 && blk >= kFirstSkip) {", "if (false) {")],
}


def build_variants(out_dir):
    """{name: (ctypes library, ptxas {f32|bf16: (registers, spill st, spill ld)})}."""
    src = (build.CSRC / "inr_tile.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in inr_tile.cu")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
               "-o", str(out_dir / f"v{i}.so"), str(cu)]
        jobs[name] = (out_dir / f"v{i}.so",
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        found = re.findall(r"inr_tile_kernelI(f|13__nv_bfloat16)E.*\n.*?(\d+) bytes spill stores, "
                           r"(\d+) bytes spill loads\n.*?Used (\d+) registers", log)
        res = {("f32" if k == "f" else "bf16"): (int(r), int(st), int(ld)) for k, st, ld, r in found}
        lib = ctypes.CDLL(str(so))
        lib.cips_inr_tile_forward.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.cips_inr_tile_forward.restype = ctypes.c_int
        libs[name] = (lib, res)
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("inr_tile_variants: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build_variants(build.BUILD_DIR / "variants")
    dev = torch.device("cuda")
    b, n, D, in0 = 1, 128 * 128, 512, 32
    g = torch.Generator().manual_seed(0)
    net = CIPSNet(input_dim=in0, hidden_dim=D, style_dim=D, generator=g)
    styles = {f"inr_w{r}_{j}": torch.randn(b, D, generator=g)
              for r in ("4", "8", "16", "32", "64", "128", "256", "512", "1024") for j in (0, 1)}
    weights, mods = inr_tile.extract_inr_weights(net, 9)
    s, d = inr_tile.compute_inr_mods(mods, styles, D)
    x = (torch.randn(b, n, in0, generator=g) * 0.3).to(dev)
    s, d = s.to(dev), d.to(dev)
    weights = inr_tile.InrWeights(*(w.to(dev) for w in weights))
    grid = inr_tile.forward_grid(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = torch.empty(inr_tile.scratch_shape(grid, D), device=dev)
    out = torch.empty((b, n, 3), device=dev)
    for mm in (torch.float32, torch.bfloat16):
        dn = "f32" if mm == torch.float32 else "bf16"
        w0, wrest, wr = (t.to(mm).contiguous() for t in (weights.w0, weights.wrest, weights.wr))

        def call(lib):
            err = lib.cips_inr_tile_forward(
                x.data_ptr(), s.data_ptr(), d.data_ptr(), w0.data_ptr(), wrest.data_ptr(),
                wr.data_ptr(), weights.br.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                b, n, in0, D, 9, int(mm == torch.bfloat16), grid,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        names = list(libs)
        for name in names:
            for _ in range(3):
                call(libs[name][0])
        torch.cuda.synchronize()
        times = {name: [] for name in names}
        for _ in range(10):
            for name in names + names[::-1]:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                call(libs[name][0])
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
        for name in names:
            regs, st, ld = libs[name][1].get(dn, (None, None, None))
            print(f"inr_tile variant {name} {dn} r128 (n=16384, D=512): median "
                  f"{statistics.median(times[name]):.3f} ms; {regs} registers, spills {st}/{ld} B "
                  f"[{smi}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
