"""Browser scribble UI for interactive video segmentation (port of
``nerf_texture_tpu/viewer/segment.py``).

The same stdlib HTTP server over a ``data.segmenter.MaskSession``: left-drag
paints foreground, right-drag background, GrabCut segments the keyframe,
optical-flow propagation masks the rest.  The tinted frame is computed in
float32 numpy as the JAX package computes it and encoded by the port's
``data.jpeg.encode`` (PIL's file, byte for byte), so no image library is
needed.

  GET  /            the scribble page
  GET  /frame?i=N   frame N as JPEG with the current mask tinted
  POST /api         {"op": info|stroke|segment|propagate|clear|save, ...}
"""

from __future__ import annotations

import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..data.jpeg import encode

_PAGE = """<!doctype html><html><body style='background:#111;color:#eee;
font-family:sans-serif'>
<h3>segmenter</h3>
<div>frame <span id='idx'>0</span>/<span id='n'>?</span>
 <button onclick='nav(-1)'>&lt;</button>
 <button onclick='nav(1)'>&gt;</button>
 <button onclick='api({op:"segment"})'>segment</button>
 <button onclick='api({op:"propagate"})'>propagate all</button>
 <button onclick='api({op:"clear"})'>clear strokes</button>
 <button onclick='api({op:"save"})'>save masks</button>
 <span>left-drag: foreground &middot; right-drag: background</span></div>
<img id='v' draggable='false' style='max-width:95%'>
<script>
let i = 0, stroke = null;
const img = document.getElementById('v');
const refresh = () => img.src = '/frame?i=' + i + '&t=' + Date.now();
const api = async (b) => {b.i = i;
  await fetch('/api', {method: 'POST', body: JSON.stringify(b)});
  refresh();};
fetch('/api', {method: 'POST', body: JSON.stringify({op: 'info'})})
  .then(r => r.json()).then(d => {
    document.getElementById('n').textContent = d.n; });
function nav(d) {i = Math.max(0, i + d);
  document.getElementById('idx').textContent = i; refresh();}
const pos = e => {const r = img.getBoundingClientRect();
  return [Math.round((e.clientX - r.left) * img.naturalWidth / r.width),
          Math.round((e.clientY - r.top) * img.naturalHeight / r.height)];};
img.oncontextmenu = e => e.preventDefault();
img.onmousedown = e => {stroke = {label: e.button == 2 ? 2 : 1,
                                  points: [pos(e)]};};
img.onmousemove = e => {if (stroke) stroke.points.push(pos(e));};
window.onmouseup = e => {if (!stroke) return;
  api({op: 'stroke', label: stroke.label, points: stroke.points});
  stroke = null;};
refresh();
</script></body></html>"""


def _frame_jpeg(session, idx: int) -> bytes:
    """Frame ``idx`` (clamped) with its mask tinted (background dimmed,
    foreground greened) and its strokes painted, as a quality-88 JPEG."""
    idx = max(0, min(idx, len(session.files) - 1))
    img = session.load_frame(idx).astype(np.float32)
    m = session.masks[idx]
    if m is not None:
        img[~m] *= 0.35                       # dim background
        img[m, 1] = np.minimum(img[m, 1] * 1.15 + 16, 255)
    st = session.strokes[idx]
    img[st == 1] = [64, 255, 64]
    img[st == 2] = [255, 64, 64]
    return encode(img.astype(np.uint8), quality=88)


def serve_segmenter(session, host: str = "0.0.0.0", port: int = 7870,
                    block: bool = True):
    """HTTP scribble UI over a data.segmenter.MaskSession; with
    ``block=False`` returns the server without serving."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str = "application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame"):
                q = parse_qs(urlparse(self.path).query)
                idx = int(q.get("i", ["0"])[0])
                self._send(_frame_jpeg(session, idx), "image/jpeg")
            elif self.path.startswith("/"):
                self._send(_PAGE.encode(), "text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            op = req.get("op")
            idx = int(req.get("i", 0))
            out = {"ok": True}
            try:
                if op == "info":
                    out["n"] = len(session.files)
                elif op == "stroke":
                    session.add_stroke(idx, req["points"],
                                       int(req.get("label", 1)))
                elif op == "segment":
                    session.segment(idx)
                elif op == "propagate":
                    out["masked"] = session.propagate_all(idx)
                elif op == "clear":
                    session.clear_strokes(idx)
                elif op == "save":
                    root = os.path.dirname(
                        os.path.abspath(session.frame_dir))
                    out["saved"] = session.save(
                        os.path.join(root, "masks"),
                        composite_dir=os.path.join(root, "images_masked"))
                else:
                    out = {"ok": False, "error": f"unknown op {op}"}
            except Exception as e:      # noqa: BLE001 -- keep serving
                out = {"ok": False, "error": str(e)[:300]}
            self._send(json.dumps(out).encode())

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"[segmenter] serving on http://{host}:{port}")
    if block:
        httpd.serve_forever()
    return httpd
