"""HTTP live viewer for the display film.

Counterpart of luisarender_tpu/films/live_server.py: the latest tonemapped
frame, served from a daemon thread by the standard library's
ThreadingHTTPServer, so a browser can watch a render. It binds to
127.0.0.1 (the reference binds every interface); reach it from another
machine through a tunnel.

Endpoints:
  GET /            a page that polls the frame at ~4 Hz
  GET /frame.png   the latest tonemapped frame (an in-memory PNG)
  GET /stats.json  {"frame": N, "spp": ..., "elapsed": seconds}
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = b"""<!doctype html>
<html><head><title>luisarender_tpu live</title>
<style>body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;max-width:95vw;max-height:85vh;margin-top:1em}
</style></head><body>
<div id=s>waiting for first frame...</div>
<img id=f src="/frame.png">
<script>
async function tick(){
  try{
    const r = await fetch('/stats.json'); const s = await r.json();
    document.getElementById('s').textContent =
      `frame ${s.frame} | spp ${s.spp} | ${s.elapsed.toFixed(1)} s`;
    document.getElementById('f').src = '/frame.png?v=' + s.frame;
  }catch(e){}
  setTimeout(tick, 250);
}
tick();
</script></body></html>"""


class LiveServer:
    """Holds the latest frame; serves it over HTTP from a daemon thread."""

    def __init__(self, port: int = 0):
        self._lock = threading.Lock()
        self._png = None
        self._frame = 0
        self._spp = 0.0
        self._t0 = time.time()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/frame.png":
                    with server._lock:
                        png = server._png
                    if png is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(png)
                elif path == "/stats.json":
                    with server._lock:
                        body = json.dumps({
                            "frame": server._frame,
                            "spp": server._spp,
                            "elapsed": time.time() - server._t0,
                        }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def push(self, png: bytes, spp: float = 0.0):
        with self._lock:
            self._png = png
            self._frame += 1
            self._spp = spp

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
