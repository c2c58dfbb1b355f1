"""Long-lived render server: weights stay on the device, frames on demand.

Counterpart of `cips3d_tpu/apps/serve.py`: a stdlib HTTP server holding
one generator per model, a style cache, and the chunked explicit-camera
render.  By default the NeRF stage and the INR decode run through the
hand-written kernels (`ops/ray_tile.py`, `ops/inr_tile.py`) with the
polynomial sine; ``--exact`` keeps the same kernels with exact ``sinf``.

Endpoints:
  GET /                 — interactive page (drag to look around)
  GET /render?seed=0&yaw=1.57&pitch=1.57&psi=0.7[&depth=1][&model=name]  — one JPEG frame
  GET /models           — available model names + the default (JSON)
  GET /healthz          — liveness + device info (JSON)

Usage:
  python -m cips3d_tpu_torch.apps.serve --ckpt results/.../ckptdir/best_fid \
      --img-size 128 --port 8000
  python -m cips3d_tpu_torch.apps.serve --ckpt ffhq=.../best_fid --ckpt afhq=.../best_fid
  python -m cips3d_tpu_torch.apps.serve --ckpt .../best_fid --config configs/ffhq.yaml \
      --command train_r64

``--ckpt`` reads snapshots in the JAX package's layout (``G_ema.npz``),
written by either package.  Frames are encoded by the port's own baseline
JPEG encoder (`utils/video.py`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from cips3d_tpu_torch.apps.render import compute_styles, depth_to_uint8, render_chunked
from cips3d_tpu_torch.eval.images import to_uint8
from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions, sample_zs
from cips3d_tpu_torch.utils.video import encode_jpeg

_INDEX = """<!doctype html>
<html><head><meta charset="utf-8"><title>cips3d live</title>
<style>
  body { background:#111; color:#ddd; font:14px system-ui, sans-serif;
         display:flex; flex-direction:column; align-items:center; gap:12px; padding:24px; }
  #view { width:384px; height:384px; cursor:grab; border-radius:8px; }
  .row { display:flex; gap:8px; } #hud { color:#888; }
  button { background:#333; color:#ddd; border:1px solid #555; border-radius:6px;
           padding:6px 12px; cursor:pointer; }
  button.on { background:#4a6; color:#fff; }
</style></head><body>
<h3>cips3d &mdash; live render server</h3>
<img id="view" draggable="false">
<div id="hud"></div>
<div class="row" id="models"></div>
<div class="row">
  <button onclick="seed=Math.max(0,seed-1);load()">&minus; seed</button>
  <button onclick="seed+=1;load()">+ seed</button>
  <button id="dep" onclick="depth=1-depth;this.classList.toggle('on',!!depth);load()">depth</button>
</div>
<script>
let seed = 0, yaw = Math.PI/2, pitch = Math.PI/2, depth = 0, inflight = false, queued = false;
let model = '';
const view = document.getElementById('view'), hud = document.getElementById('hud');
fetch('/models').then(r => r.json()).then(m => {
  model = m.default;
  if (m.models.length < 2) return;
  const row = document.getElementById('models');
  for (const name of m.models) {
    const b = document.createElement('button');
    b.textContent = name;
    b.classList.toggle('on', name === model);
    b.onclick = () => {
      model = name;
      for (const c of row.children) c.classList.toggle('on', c === b);
      load();
    };
    row.appendChild(b);
  }
});
function load() {
  if (inflight) { queued = true; return; }
  inflight = true;
  const url = `/render?seed=${seed}&yaw=${yaw.toFixed(3)}&pitch=${pitch.toFixed(3)}&depth=${depth}` +
              (model ? `&model=${encodeURIComponent(model)}` : '');
  const img = new Image();
  img.onload = () => { view.src = img.src; inflight = false;
                       if (queued) { queued = false; load(); } };
  img.src = url;
  hud.textContent = `seed ${seed} | yaw ${yaw.toFixed(2)} | pitch ${pitch.toFixed(2)}`;
}
let drag = null;
view.addEventListener('pointerdown', e => {
  drag = {x: e.clientX, y: e.clientY, yaw, pitch};
  view.setPointerCapture(e.pointerId);
});
view.addEventListener('pointermove', e => {
  if (!drag) return;
  yaw   = Math.min(Math.PI/2+0.6, Math.max(Math.PI/2-0.6, drag.yaw   + (e.clientX-drag.x)/250));
  pitch = Math.min(Math.PI/2+0.3, Math.max(Math.PI/2-0.3, drag.pitch - (e.clientY-drag.y)/250));
  load();
});
view.addEventListener('pointerup', () => drag = null);
load();
</script></body></html>
"""


class RenderService:
    """Holds the generators and renders frames, one at a time.

    ``models`` is one `GeneratorNerfINR` (served as "default") or a dict
    ``{name: GeneratorNerfINR}``; styles are cached per (model, seed, psi).
    """

    def __init__(self, models: Union[GeneratorNerfINR, Dict[str, GeneratorNerfINR]],
                 img_size: int = 128, num_steps: int = 24, fov: float = 12.0,
                 forward_points: int = 256 ** 2, radius: float = 1.0):
        self.models = dict(models) if isinstance(models, dict) else {"default": models}
        if not self.models:
            raise ValueError("need at least one model")
        self.default_model = next(iter(self.models))
        self.opts = RenderOptions(img_size=img_size, num_steps=num_steps, fov=fov,
                                  h_stddev=0.0, v_stddev=0.0)
        self.forward_points = forward_points
        self.radius = radius
        self._styles_cache = {}
        self._lock = threading.Lock()   # one device; serialize renders

    def styles(self, seed: int, psi: float, model: Optional[str] = None):
        model = model or self.default_model
        k = (model, int(seed), round(float(psi), 4))
        if k not in self._styles_cache:
            gen = self.models[model]
            zs = sample_zs(1, gen.cfg, torch.Generator(gen.device).manual_seed(int(seed)),
                           device=gen.device)
            self._styles_cache[k] = compute_styles(gen, zs, psi=float(psi))
        return self._styles_cache[k]

    def render(self, seed: int = 0, yaw: float = math.pi / 2, pitch: float = math.pi / 2,
               psi: float = 0.7, model: Optional[str] = None):
        """One frame as device tensors: image (1, 3, H, W) in [-1, 1] and
        depth (1, 1, H, W)."""
        model = model or self.default_model
        if model not in self.models:
            raise KeyError(f"unknown model {model!r}; available: {sorted(self.models)}")
        gen = self.models[model]
        pos = self.radius * torch.tensor(
            [[math.sin(pitch) * math.cos(yaw), math.cos(pitch),
              math.sin(pitch) * math.sin(yaw)]], device=gen.device)
        with self._lock:
            styles = self.styles(seed, psi, model)
            # camera_lookup is a view DIRECTION: -pos looks at the scene origin
            return render_chunked(gen, styles, self.opts,
                                  torch.Generator(gen.device).manual_seed(int(seed)),
                                  self.forward_points, pos, -pos, None, return_depth=True)

    def frame(self, seed: int = 0, yaw: float = math.pi / 2, pitch: float = math.pi / 2,
              psi: float = 0.7, depth: bool = False, model: Optional[str] = None) -> np.ndarray:
        """Render one (H, W, 3) uint8 frame."""
        img, dmap = self.render(seed, yaw, pitch, psi, model)
        if depth:
            return depth_to_uint8(dmap[0, 0].float().cpu().numpy(), self.opts)
        return to_uint8(img[0].float().cpu().numpy())


def device_info() -> dict:
    if torch.cuda.is_available():
        return {"device": torch.cuda.get_device_name(), "devices": torch.cuda.device_count()}
    return {"device": "cpu", "devices": 1}


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, _INDEX.encode(), "text/html")
            elif url.path == "/healthz":
                self._json(200, {"ok": True, **device_info(),
                                 "img_size": service.opts.img_size,
                                 "models": sorted(service.models)})
            elif url.path == "/models":
                self._json(200, {"models": list(service.models),
                                 "default": service.default_model})
            elif url.path == "/render":
                q = parse_qs(url.query)

                def f(name, default, cast=float):
                    return cast(q[name][0]) if name in q else default

                try:
                    kwargs = dict(seed=f("seed", 0, int), yaw=f("yaw", math.pi / 2),
                                  pitch=f("pitch", math.pi / 2), psi=f("psi", 0.7),
                                  depth=bool(f("depth", 0, int)), model=f("model", None, str))
                except ValueError as e:   # uncastable query param
                    self._json(400, {"error": str(e)})
                    return
                try:
                    body = encode_jpeg(service.frame(**kwargs), quality=90)
                except KeyError as e:     # unknown model
                    self._json(404, {"error": str(e)})
                    return
                except Exception as e:    # surface render and encode errors as 500 JSON
                    self._json(500, {"error": str(e)})
                    return
                self._send(200, body, "image/jpeg")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def serve(service: RenderService, host: str = "127.0.0.1", port: int = 8000):
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    from cips3d_tpu_torch.eval.cli import generator_config, load_generator, serving_config

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, action="append",
                   help="snapshot dir, or NAME=DIR; repeat to serve several models "
                   "(same architecture)")
    p.add_argument("--module", default="G_ema")
    p.add_argument("--config", default=None, help="YAML with a `generator:` node "
                   "(to serve checkpoints of non-default architecture)")
    p.add_argument("--command", default=None, help="command node in --config")
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--num-steps", type=int, default=24)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--exact", action="store_true",
                   help="exact sinf inside the same kernels (default: polynomial sine)")
    args = p.parse_args(argv)

    gen_cfg = serving_config(generator_config(args.config, args.command), fast_sin=not args.exact)
    models = {}
    for i, spec in enumerate(args.ckpt):
        name, _, path = spec.rpartition("=")
        if not name:
            path = spec
            # a name from the experiment dir (…/<exp>/ckptdir/<snap>)
            name = (os.path.basename(os.path.dirname(os.path.dirname(path)))
                    if len(args.ckpt) > 1 else "default")
        if name in models:
            name = f"{name}_{i}"
        models[name] = load_generator(path, gen_cfg, args.module, device="cuda")
    service = RenderService(models, img_size=args.img_size, num_steps=args.num_steps)
    print("warming up (first frame builds the kernels)...", flush=True)
    service.frame()
    httpd = serve(service, args.host, args.port)
    print(f"serving on http://{args.host}:{args.port}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
