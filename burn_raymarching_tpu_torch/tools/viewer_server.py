"""Interactive scene viewer over HTTP (port of
burn_raymarching_tpu/tools/viewer_server.py).

The reference's viewer is a native winit/wgpu window with WASD+arrow
controls at 60 fps (src/bin/viewer.rs:202-207). This is its headless
equivalent: a tiny localhost HTTP server renders frames on the device on
demand and a canvas page provides the same controls (WASD move, arrows
orbit, mouse-drag orbit, +/- zoom). The scene.json contract and the shading
models are tools/viewer_offline's.

Latency model (the native viewer's realtime feel, adapted to a
render-per-request transport): frames are PROGRESSIVE — while the camera
moves the page requests quarter-resolution frames (q=low, ~16x fewer
rays, displayed pixelated like a dragging preview), and ~0.3 s after the
last input it refines with one full-resolution frame. One render runs on
the device at a time; frames are encoded as PNG with the standard library
(data/image_io.encode_png_rgb).

Usage:
  python -m burn_raymarching_tpu_torch.tools.viewer_server scene.json
      [--port 8000] [--size 384] [--model viewer|train] [--device cuda]
      [--trace-spans spans.json]
then open http://localhost:8000/ (port-forward from the GPU host).

``--trace-spans PATH`` turns the program's tracer on while the server runs
(utils/profiling.TRACER: each frame's ``view.frame`` span with its
``view.scene_upload``, ``view.rays``, ``view.render``, ``view.readback`` and
``view.encode`` children, and the ``frames.low`` / ``frames.full`` counters)
and writes ``TRACER.dump(PATH)`` when the server stops.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>burn_raymarching_tpu viewer</title>
<style>body{background:#111;color:#ddd;font-family:monospace;text-align:center}
img{image-rendering:pixelated;width:640px;height:640px;border:1px solid #444}
</style></head>
<body>
<h3>burn_raymarching_tpu — interactive viewer</h3>
<p>WASD move &nbsp; arrows orbit &nbsp; +/- zoom</p>
<img id="view" src="/frame?yaw=0&pitch=0.2&dist=2.5" draggable="false">
<script>
let yaw=0, pitch=0.2, dist=2.5, cx=0, cy=0, cz=0, busy=false, dirty=true;
let refineTimer=null;
function url(q){
  return `/frame?yaw=${yaw}&pitch=${pitch}&dist=${dist}&cx=${cx}&cy=${cy}`+
         `&cz=${cz}&q=${q}&t=${Date.now()}`;
}
function refresh(q='low'){
  // Progressive: low-res frames while moving, one full-res refine after
  // ~0.3 s of no input (the headless analog of the native viewer's
  // continuous redraw, viewer.rs:202-207).
  if(refineTimer) clearTimeout(refineTimer);
  refineTimer=setTimeout(()=>{refresh._q='full'; refresh('full');}, 300);
  if(busy){dirty=true; refresh._q=q; return}
  busy=true; dirty=false;
  const img=document.getElementById('view');
  img.onload=()=>{busy=false; if(dirty) refresh(refresh._q||'low');};
  img.onerror=img.onload;
  img.src=url(q);
}
document.addEventListener('keydown', e=>{
  const s=0.1;
  switch(e.key){
    case 'ArrowLeft': yaw-=0.12; break;
    case 'ArrowRight': yaw+=0.12; break;
    case 'ArrowUp': pitch=Math.min(1.4,pitch+0.08); break;
    case 'ArrowDown': pitch=Math.max(-1.4,pitch-0.08); break;
    case 'w': cz+=s*Math.cos(yaw); cx+=s*Math.sin(yaw); break;
    case 's': cz-=s*Math.cos(yaw); cx-=s*Math.sin(yaw); break;
    case 'a': cx-=s*Math.cos(yaw); cz+=s*Math.sin(yaw); break;
    case 'd': cx+=s*Math.cos(yaw); cz-=s*Math.sin(yaw); break;
    case '+': case '=': dist=Math.max(0.5,dist-0.15); break;
    case '-': dist+=0.15; break;
    default: return;
  }
  e.preventDefault(); refresh('low');
});
// Mouse-drag orbit (native-viewer feel): low-res while dragging.
const view=document.getElementById('view');
let drag=null;
view.addEventListener('pointerdown', e=>{
  drag=[e.clientX,e.clientY]; view.setPointerCapture(e.pointerId);});
view.addEventListener('pointermove', e=>{
  if(!drag) return;
  yaw+=(e.clientX-drag[0])*0.006;
  pitch=Math.min(1.4,Math.max(-1.4,pitch+(e.clientY-drag[1])*0.006));
  drag=[e.clientX,e.clientY]; refresh('low');});
view.addEventListener('pointerup', ()=>{drag=null; refresh('full');});
view.addEventListener('wheel', e=>{
  dist=Math.min(12,Math.max(0.5,dist+Math.sign(e.deltaY)*0.15));
  e.preventDefault(); refresh('low');});
</script></body></html>"""


class _ViewerState:
    def __init__(self, scene_path: str, size: int, model: str,
                 device="cuda"):
        from burn_raymarching_tpu_torch.data.scene_io import load_scene_json

        self.scene = load_scene_json(scene_path)
        self.size = size
        # Progressive preview resolution: ~16x fewer rays while the
        # camera moves (quarter linear size, floored at 64 px, never
        # above the full size).
        self.low_size = min(size, max(64, size // 4))
        self.model = model
        self.device = device
        self.lock = threading.Lock()
        self.frame_ids = itertools.count()

    def render(self, yaw: float, pitch: float, dist: float,
               center, quality: str = "full") -> bytes:
        from burn_raymarching_tpu_torch.data.image_io import encode_png_rgb
        from burn_raymarching_tpu_torch.tools.viewer_offline import (
            render_pose,
        )
        from burn_raymarching_tpu_torch.utils.profiling import (
            TRACER,
            annotate,
        )

        size = self.low_size if quality == "low" else self.size
        cx, cy, cz = center
        eye = [
            cx + dist * math.cos(pitch) * math.sin(yaw),
            cy + dist * math.sin(pitch),
            cz - dist * math.cos(pitch) * math.cos(yaw),
        ]
        TRACER.count(f"frames.{quality}")
        with annotate("view.frame", frame=next(self.frame_ids),
                      quality=quality, size=size):
            with self.lock:  # one device render at a time
                img = render_pose(self.scene, eye, [cx, cy, cz], size,
                                  model=self.model, device=self.device)
            with annotate("view.encode"):
                u8 = (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)
                return encode_png_rgb(u8.reshape(size, size, 3))


def make_handler(state: _ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/frame":
                q = parse_qs(url.query)

                def f(name, default):
                    try:
                        return float(q.get(name, [default])[0])
                    except ValueError:
                        return default

                quality = q.get("q", ["full"])[0]
                png = state.render(
                    f("yaw", 0.0), f("pitch", 0.2), f("dist", 2.5),
                    (f("cx", 0.0), f("cy", 0.0), f("cz", 0.0)),
                    quality="low" if quality == "low" else "full")
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
            elif url.path == "/scene":
                body = json.dumps(
                    {"num_spheres": state.scene["num_spheres"]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("scene", nargs="?", default="scene.json")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--size", type=int, default=384)
    parser.add_argument("--model", choices=("viewer", "train"),
                        default="viewer")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; a missing card "
                             "raises)")
    parser.add_argument("--trace-spans", dest="trace_spans", default="",
                        metavar="PATH",
                        help="keep each frame's spans and the frame counts "
                             "and write them as JSON to PATH when the "
                             "server stops")
    args = parser.parse_args(argv)

    from burn_raymarching_tpu_torch.utils.device import resolve_device
    from burn_raymarching_tpu_torch.utils.profiling import TRACER

    state = _ViewerState(args.scene, args.size, args.model,
                         device=resolve_device(args.device))
    server = ThreadingHTTPServer(("127.0.0.1", args.port),
                                 make_handler(state))
    print(f"Serving {args.scene} ({state.scene['num_spheres']} spheres) on "
          f"http://localhost:{args.port}/ — WASD move, arrows orbit")
    if args.trace_spans:
        TRACER.reset()
        TRACER.enable()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if args.trace_spans:
            TRACER.disable()
            TRACER.dump(args.trace_spans)


if __name__ == "__main__":
    main()
