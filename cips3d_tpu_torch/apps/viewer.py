"""Static-HTML interactive 3D viewer.  Counterpart of
`cips3d_tpu/apps/viewer.py`, the replacement of the reference's streamlit
demos (`exp/cips3d/models/st_web.py`, `scripts/web_demo.py`): a (seed x
pitch x yaw) pose grid rendered with the explicit-camera chunked render and
written as ONE self-contained HTML file (frames embedded as base64 JPEGs
from the port's own encoder; no server, no network).  Drag the image to
look around, pick identities, toggle an orbit autoplay and, with
``depth``, the depth maps.

    python -m cips3d_tpu_torch.eval.cli viewer --ckpt .../best_fid --out viewer.html
"""

from __future__ import annotations

import base64
import json
import math
import os
from typing import Optional, Sequence

import numpy as np

from cips3d_tpu_torch.apps.render import Draws, depth_to_uint8, render_frame, seed_styles
from cips3d_tpu_torch.models.generator import GeneratorNerfINR, RenderOptions
from cips3d_tpu_torch.utils.image_io import to_uint8
from cips3d_tpu_torch.utils.video import encode_jpeg

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>cips3d viewer</title>
<style>
  body {{ background:#111; color:#ddd; font:14px system-ui, sans-serif;
         display:flex; flex-direction:column; align-items:center; gap:12px;
         padding:24px; }}
  #view {{ width:{display}px; height:{display}px; image-rendering:auto;
           cursor:grab; border-radius:8px; }}
  #view:active {{ cursor:grabbing; }}
  .row {{ display:flex; gap:8px; align-items:center; }}
  button {{ background:#333; color:#ddd; border:1px solid #555;
            border-radius:6px; padding:6px 12px; cursor:pointer; }}
  button.on {{ background:#4a6; color:#fff; }}
  #hud {{ color:#888; }}
</style></head><body>
<h3>cips3d &mdash; 3D-aware generator viewer</h3>
<img id="view" draggable="false">
<div id="hud"></div>
<div class="row" id="seeds"></div>
<div class="row">
  <button id="play">&#9658; orbit</button>
  <button id="depth" style="display:{depth_display}">depth</button>
  <span id="meta">{n_yaw}&times;{n_pitch} poses &middot; psi {psi}</span>
</div>
<script>
const F = {frames_json};            // [seed][pitch][yaw] -> base64 jpeg
const D = {depth_json};             // same layout, depth maps (or null)
const NY = {n_yaw}, NP = {n_pitch}, SEEDS = {seeds_json};
let si = 0, yi = Math.floor(NY / 2), pi = Math.floor(NP / 2), playing = false;
let showDepth = false;
const view = document.getElementById('view');
const hud = document.getElementById('hud');
function show() {{
  const src = (showDepth && D) ? D[si][pi][yi] : F[si][pi][yi];
  view.src = 'data:image/jpeg;base64,' + src;
  hud.textContent = 'seed ' + SEEDS[si] + ' | yaw ' + (yi + 1) + '/' + NY +
                    ' | pitch ' + (pi + 1) + '/' + NP + (showDepth ? ' | depth' : '');
  document.querySelectorAll('#seeds button').forEach(
    (b, i) => b.classList.toggle('on', i === si));
}}
document.getElementById('depth').onclick = e => {{
  showDepth = !showDepth;
  e.target.classList.toggle('on', showDepth);
  show();
}};
const seedRow = document.getElementById('seeds');
SEEDS.forEach((s, i) => {{
  const b = document.createElement('button');
  b.textContent = 'seed ' + s;
  b.onclick = () => {{ si = i; show(); }};
  seedRow.appendChild(b);
}});
let drag = null;
view.addEventListener('pointerdown', e => {{
  drag = {{ x: e.clientX, y: e.clientY, yi, pi }};
  view.setPointerCapture(e.pointerId);
}});
view.addEventListener('pointermove', e => {{
  if (!drag) return;
  const step = {display} / NY / 1.5;
  yi = Math.min(NY - 1, Math.max(0, drag.yi + Math.round((e.clientX - drag.x) / step)));
  pi = Math.min(NP - 1, Math.max(0, drag.pi - Math.round((e.clientY - drag.y) / (step * 2))));
  show();
}});
view.addEventListener('pointerup', () => drag = null);
let dir = 1;
setInterval(() => {{
  if (!playing) return;
  yi += dir;
  if (yi >= NY - 1 || yi <= 0) dir = -dir;
  show();
}}, 90);
document.getElementById('play').onclick = e => {{
  playing = !playing;
  e.target.classList.toggle('on', playing);
}};
show();
</script></body></html>
"""


def _camera_position(yaw: float, pitch: float, radius: float = 1.0) -> np.ndarray:
    """Spherical pose → camera position, as `core/rays.py::
    sample_camera_positions` places it (`exp/comm/comm_utils.py:365-427`)."""
    return radius * np.array([math.sin(pitch) * math.cos(yaw), math.cos(pitch),
                              math.sin(pitch) * math.sin(yaw)])


def export_html_viewer(model: GeneratorNerfINR, out_path: str,
                       seeds: Sequence[int] = (0, 1, 2, 3), n_yaw: int = 9, n_pitch: int = 3,
                       yaw_span: float = 0.9, pitch_span: float = 0.5, img_size: int = 128,
                       num_steps: int = 24, psi: float = 0.7, fov: float = 12.0,
                       forward_points: int = 256 ** 2, display: int = 384, quality: int = 88,
                       depth: bool = False, draws: Optional[Draws] = None) -> str:
    """Render the pose grid and write the HTML viewer; returns its path.

    Poses sweep ``yaw_span`` x ``pitch_span`` radians around the frontal
    camera (h_mean = v_mean = pi/2); every pose of a seed renders with the
    draws of that seed's key (`viewer.py:176-179`)."""
    draws = draws or Draws(model.device)
    opts = RenderOptions(img_size=img_size, num_steps=num_steps, fov=fov, h_stddev=0.0,
                         v_stddev=0.0, psi=psi)
    yaws = np.pi / 2 + np.linspace(-yaw_span / 2, yaw_span / 2, n_yaw)
    pitches = np.pi / 2 + np.linspace(-pitch_span / 2, pitch_span / 2, n_pitch)

    def b64(arr_hwc):
        return base64.b64encode(encode_jpeg(arr_hwc, quality=quality)).decode("ascii")

    frames, depth_frames = [], [] if depth else None
    for seed in seeds:
        styles = seed_styles(model, int(seed), psi, draws)
        per_seed, per_seed_d = [], []
        for pitch in pitches:
            row, row_d = [], []
            for yaw in yaws:
                pos = _camera_position(float(yaw), float(pitch))[None]
                # camera_lookup is a view DIRECTION: -pos looks at the scene origin
                img, dmap = render_frame(model, styles, opts, int(seed), draws, forward_points,
                                         pos, -pos, return_depth=True)
                row.append(b64(to_uint8(img[0].float().cpu().numpy())))
                if depth:
                    row_d.append(b64(depth_to_uint8(dmap[0, 0].float().cpu().numpy(), opts)))
            per_seed.append(row)
            per_seed_d.append(row_d)
        frames.append(per_seed)
        if depth:
            depth_frames.append(per_seed_d)

    html = _PAGE.format(
        frames_json=json.dumps(frames), depth_json=json.dumps(depth_frames),
        depth_display="inline-block" if depth else "none",
        seeds_json=json.dumps([int(s) for s in seeds]), n_yaw=n_yaw, n_pitch=n_pitch, psi=psi,
        display=display)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
