"""HTTP viewer server: an MJPEG stream and JSON control, on the standard
library and the port's own JPEG encoder (port of
``nerf_texture_tpu/viewer/server.py``).  Endpoints:

  GET  /            a minimal HTML page (the stream and key bindings)
  GET  /stream      MJPEG of the render / train loop, one part a frame
  POST /control     {"action": name, ...kwargs} -> a ViewerApp method
  GET  /status      training state, frame times, modes
  GET  /scalars     the trainer's logged scalars, {name: [[step, v]]}
  GET  /dashboard   a page charting them
"""

from __future__ import annotations

import json
import os
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.jpeg import encode

# the stream's JPEG quality
STREAM_QUALITY = 85

_PAGE = """<!doctype html><html><body style='background:#111;color:#eee'>
<h3>nerf_texture_tpu viewer</h3>
<img id='v' src='/stream' style='width:70%'>
<p>drag: orbit &middot; wheel: zoom &middot; t: toggle training &middot;
m: visual mode &middot; l: light mode</p>
<script>
const img = document.getElementById('v');
let drag = false, lx = 0, ly = 0;
const post = (b) => fetch('/control', {method: 'POST',
  body: JSON.stringify(b)});
img.onmousedown = e => {drag = true; lx = e.clientX; ly = e.clientY;};
window.onmouseup = () => drag = false;
window.onmousemove = e => {if (!drag) return;
  post({action: 'orbit', dx: e.clientX - lx, dy: e.clientY - ly});
  lx = e.clientX; ly = e.clientY;};
img.onwheel = e => post({action: 'scale', delta: e.deltaY > 0 ? -1 : 1});
window.onkeydown = e => {
  if (e.key == 't') post({action: 'toggle_training'});
  if (e.key == 'm') post({action: 'switch_visual_mode'});
  if (e.key == 'l') post({action: 'switch_light_mode'});};
</script></body></html>"""


_DASH_PAGE = """<!doctype html><html><body style='background:#111;\
color:#eee;font-family:sans-serif'>
<h3>scalars</h3><div id='charts'></div>
<script>
async function draw() {
  const data = await (await fetch('/scalars')).json();
  const div = document.getElementById('charts');
  div.innerHTML = '';
  for (const [name, series] of Object.entries(data)) {
    if (!series.length) continue;
    const W = 640, H = 160, pad = 34;
    const xs = series.map(p => p[0]), ys = series.map(p => p[1]);
    const x0 = Math.min(...xs), x1 = Math.max(...xs, x0 + 1);
    const y0 = Math.min(...ys), y1 = Math.max(...ys, y0 + 1e-9);
    const X = v => pad + (v - x0) / (x1 - x0) * (W - 2 * pad);
    const pts = series.map(p => X(p[0]).toFixed(1) + ',' +
      (H - pad - (p[1] - y0) / (y1 - y0) * (H - 2 * pad)).toFixed(1))
      .join(' ');
    div.innerHTML += `<p>${name} (last ${ys[ys.length-1].toPrecision(4)})\
</p><svg width=${W} height=${H} style='background:#181818'>
      <polyline points='${pts}' fill='none' stroke='#6cf'/></svg>`;
  }
}
draw(); setInterval(draw, 5000);
</script></body></html>"""


def _read_scalars(app, max_points: int = 2000):
    """{metric: [[step, value], ...]} from the trainer's MetricsLogger
    jsonl (downsampled to max_points per series)."""
    logger = getattr(app.trainer, "logger", None)
    path = getattr(logger, "jsonl", None)
    series: dict = {}
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                step = rec.get("step", 0)
                for k, v in rec.items():
                    if k in ("step", "time"):
                        continue
                    series.setdefault(k, []).append([step, v])
    for k, pts in series.items():
        if len(pts) > max_points:
            stride = len(pts) // max_points + 1
            series[k] = pts[::stride]
    return series


def status(app) -> dict:
    """The /status document."""
    return {
        "training": app.training,
        "steps_per_frame": app.train_ctrl.steps,
        "downscale": app.res_ctrl.downscale,
        "visual_mode": getattr(app.trainer, "visual_mode", "RGB"),
        "metrics": {k: float(v) for k, v in app.last_metrics.items()},
    }


def serve(app, host: str = "0.0.0.0", port: int = 7860,
          block: bool = True):
    """Run the viewer loop (a thread rendering ``app.frame()`` and encoding
    each frame) and an HTTP server around a ViewerApp.  ``port`` 0 takes a
    free port (``httpd.server_address`` holds it).  With ``block`` it
    serves until SIGTERM or Ctrl-C, then stops the loop and returns;
    without, it returns at once and the caller runs
    ``httpd.serve_forever()``.  Returns (httpd, stop): setting ``stop``
    ends the loop and the streams.

    A frame that fails to render is printed and the loop goes on (the
    viewer stays up for the user); each /stream part is a new frame."""
    latest = {"jpeg": encode(np.zeros((64, 64, 3), np.uint8),
                             quality=STREAM_QUALITY), "seq": 0}
    fresh = threading.Condition()
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                jpeg = encode(app.frame(), quality=STREAM_QUALITY)
            except Exception as e:   # keep serving on render errors
                print("[viewer] frame error:", e, flush=True)
                continue
            with fresh:
                latest["jpeg"] = jpeg
                latest["seq"] += 1
                fresh.notify_all()
        with fresh:
            fresh.notify_all()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seen = -1
                try:
                    while not stop.is_set():
                        with fresh:
                            fresh.wait_for(lambda: latest["seq"] != seen
                                           or stop.is_set(), timeout=1.0)
                            if latest["seq"] == seen:
                                continue
                            jpg, seen = latest["jpeg"], latest["seq"]
                        self.wfile.write(b"--frame\r\nContent-Type: "
                                         b"image/jpeg\r\nContent-Length: "
                                         + str(len(jpg)).encode()
                                         + b"\r\n\r\n")
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            elif self.path.startswith("/scalars"):
                self._send(json.dumps(_read_scalars(app)).encode(),
                           "application/json")
            elif self.path == "/dashboard":
                self._send(_DASH_PAGE.encode(), "text/html")
            elif self.path == "/status":
                self._send(json.dumps(status(app)).encode(),
                           "application/json")
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/control":
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            action = req.pop("action", "")
            try:
                if action == "orbit":
                    app.camera.orbit(req.get("dx", 0), req.get("dy", 0))
                elif action == "scale":
                    app.camera.scale(req.get("delta", 0))
                elif action == "pan":
                    app.camera.pan(req.get("dx", 0), req.get("dy", 0))
                elif action == "toggle_training":
                    app.training = not app.training
                elif hasattr(app, action):
                    getattr(app, action)(**req)
                self.send_response(200)
                self.end_headers()
            except Exception as e:
                body = str(e).encode()
                self.send_response(500)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    worker = threading.Thread(target=loop, daemon=True)
    worker.start()
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    print(f"[viewer] serving on http://{host}:{httpd.server_address[1]}",
          flush=True)
    if block:
        def on_term(*_):
            raise SystemExit(0)

        previous = signal.signal(signal.SIGTERM, on_term)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            stop.set()
            httpd.server_close()
            worker.join(timeout=60)
            signal.signal(signal.SIGTERM, previous)
    return httpd, stop
