"""Live view + edit server: the interactive render loop (`render --serve`).

Counterpart of `optix_renderer_tpu/serve.py`, the replacement for the
reference's ImGui screen + two-tree edit model (src/utils/ImguiScreen.cpp:
252-316 display compositing, render.cpp:613-691 render-control panel +
scene-tree property editor, object.h:142-176 touched-flag `update()`
protocol):

- the progressive display is a browser page polling a PNG of the partial
  film, encoded between sample rounds (the cadence at which the reference
  uploads its block to a GL texture);
- live property edits (emitter radiance, diffuse albedo, microfacet alpha,
  texture value) replace one row of one scene table, on the device, with
  `dataclasses.replace`; shapes and dtypes are unchanged, and only geometry
  edits would need an LBVH rebuild (out of scope for live edits);
- edits restart accumulation (`restartRender`, render.cpp:180-191);
- pause / resume / stop mirror the render-control atomics (render.h:127-133).

Stdlib only (ThreadingHTTPServer + polling). The render loop owns the
device: it builds the photon map (`render.preprocess`), moves the scene to
the device once, renders the scan path's sample rounds
(`render.scan_step`, in `MAX_LANES` chunks) and copies one layer to the
host per round for the PNG. The HTTP threads touch no device tensor:
they read the latest encoded frame and the status, and enqueue edits
checked against the tables' shapes, which are kept on the host.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render.render import (
    _layers_out,
    preprocess,
    resolve_device,
    scan_step,
)
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import imageio as iio

_PAGE = """<!doctype html>
<html><head><title>optix_renderer_tpu_torch live view</title><style>
body{font-family:sans-serif;background:#181818;color:#ddd;margin:1.2em}
img{image-rendering:pixelated;border:1px solid #444;max-width:90vw}
button,input{margin:0.2em;background:#333;color:#ddd;border:1px solid #555;padding:0.3em 0.8em}
#status{color:#8c8}</style></head><body>
<h3>optix_renderer_tpu_torch <span id=status></span></h3>
<img id=frame width=%WIDTH% src="/frame">
<div>
<button onclick="ctl('pause')">pause</button>
<button onclick="ctl('resume')">resume</button>
<button onclick="ctl('stop')">stop</button>
</div>
<div>
edit <select id=kind>
<option value=emitter_radiance>emitter radiance</option>
<option value=bsdf_kd>bsdf albedo</option>
<option value=bsdf_alpha>bsdf alpha</option>
<option value=texture_value>texture value</option>
</select>
index <input id=idx size=3 value=0>
value <input id=val size=16 value="1,1,1">
<button onclick="edit()">apply (restarts accumulation)</button>
</div>
<script>
async function tick(){
  const s = await (await fetch('/status')).json();
  document.getElementById('status').textContent =
    ` — ${s.status}, ${s.spp_done}/${s.spp} spp`;
  document.getElementById('frame').src = '/frame?t=' + Date.now();
  if (s.status != 'done' && s.status != 'stopped') setTimeout(tick, 700);
}
async function ctl(op){ await fetch('/control', {method:'POST', body: op}); tick(); }
async function edit(){
  const body = JSON.stringify({kind: document.getElementById('kind').value,
    index: +document.getElementById('idx').value,
    value: document.getElementById('val').value.split(',').map(Number)});
  await fetch('/edit', {method:'POST', body}); tick();
}
tick();
</script></body></html>"""

# editable scene tables: kind → (getter, setter). These are the parameters
# the reference edits live in its property tree (the BSDF / emitter
# getImGuiNodes implementations) and that `trainable_params` exposes to grad.
_EDITS = {
    "emitter_radiance": (
        lambda s: s.emitters.radiance,
        lambda s, v: dataclasses.replace(s, emitters=dataclasses.replace(s.emitters, radiance=v)),
    ),
    "bsdf_kd": (
        lambda s: s.bsdfs.kd,
        lambda s, v: dataclasses.replace(s, bsdfs=dataclasses.replace(s.bsdfs, kd=v)),
    ),
    "bsdf_alpha": (
        lambda s: s.bsdfs.alpha,
        lambda s, v: dataclasses.replace(s, bsdfs=dataclasses.replace(s.bsdfs, alpha=v)),
    ),
    "texture_value": (
        lambda s: s.textures.value,
        lambda s, v: dataclasses.replace(s, textures=dataclasses.replace(s.textures, value=v)),
    ),
}


class LiveRenderer:
    """Owns the render loop; HTTP handlers talk to it through thread-safe
    state (frame bytes, status) and an edit / control queue."""

    def __init__(self, scene: SceneData, config: RenderConfig, spp: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.scene = scene
        self.config = config
        self.spp = spp if spp is not None else config.sample_count
        # the editable tables' shapes, on the host: edit() checks a request
        # against them without touching the scene's tensors
        self._shapes = {kind: tuple(get(scene).shape) for kind, (get, _) in _EDITS.items()}
        self._lock = threading.Lock()
        self._frame_png = iio.encode_png(np.zeros((config.height, config.width, 3), np.float32))
        self.spp_done = 0
        self.status = "starting"
        # bumped each time accumulation restarts after an applied edit (the
        # restartRender counter analog); lets clients observe a reset even
        # when the following rounds outrun their polling cadence
        self.generation = 0
        self._queue: queue.Queue = queue.Queue()
        self._pause = threading.Event()
        self._stop = threading.Event()

    # ---- HTTP-side API -----------------------------------------------------
    def frame(self) -> bytes:
        with self._lock:
            return self._frame_png

    def state(self) -> dict:
        with self._lock:
            return {"status": self.status, "spp_done": self.spp_done, "spp": self.spp,
                    "generation": self.generation}

    def control(self, op: str) -> None:
        if op == "pause":
            self._pause.set()
        elif op == "resume":
            self._pause.clear()
        elif op == "stop":
            self._stop.set()
            self._pause.clear()

    def edit(self, kind: str, index: int, value) -> bool:
        """Validate and enqueue an edit. Returns False (→ HTTP 400) on an
        unknown kind, an out-of-range index, or a value that cannot fill the
        target row (one value broadcasts), so a malformed POST cannot take
        down the render loop."""
        if kind not in _EDITS:
            return False
        shape = self._shapes[kind]
        if not (0 <= int(index) < shape[0]):
            return False
        try:
            v = np.asarray(value, np.float32).reshape(-1)
            if v.size == 1:
                value = np.full(shape[1:], v[0], np.float32)
            else:
                value = v.reshape(shape[1:])  # raises on an element-count mismatch
        except (ValueError, TypeError):
            return False
        self._queue.put((kind, int(index), value))
        return True

    # ---- render-loop side --------------------------------------------------
    def _publish(self, acc: torch.Tensor) -> None:
        png = iio.encode_png(film.to_bitmap(acc[0]).cpu().numpy())
        with self._lock:
            self._frame_png = png

    def _apply_edits(self) -> bool:
        """Drain queued edits into the scene tables, each a copy of its table
        with one row replaced, on the table's device; True if any applied
        (accumulation must restart: restartRender, render.cpp:180-191)."""
        applied = False
        while True:
            try:
                kind, index, value = self._queue.get_nowait()
            except queue.Empty:
                return applied
            get, set_ = _EDITS[kind]
            table = get(self.scene).clone()
            table[index] = torch.as_tensor(value, dtype=table.dtype).to(table.device)
            self.scene = set_(self.scene, table)
            applied = True

    def run(self) -> dict:
        """The render loop (renderThreadMain analog). Returns the final
        layers as `render()` does, with `spp_done`."""
        config, dev = self.config, self.device
        self.scene = preprocess(self.scene, config, dev).to(dev)
        step = scan_step(self.scene, config, dev)
        acc = torch.zeros((3, config.height, config.width, 4), dtype=torch.float32, device=dev)
        with self._lock:
            self.status = "rendering"
        s_idx = 0
        while s_idx < self.spp and not self._stop.is_set():
            if self._apply_edits():
                step = scan_step(self.scene, config, dev)
                acc.zero_()
                s_idx = 0
                with self._lock:
                    self.spp_done = 0
                    self.generation += 1
            if self._pause.is_set():
                with self._lock:
                    self.status = "paused"
                # a plain sleep: _pause is set while paused, so waiting on it
                # would return at once and spin
                time.sleep(0.2)
                continue
            with self._lock:
                self.status = "rendering"
            step(acc, s_idx, 1)
            s_idx += 1
            self._publish(acc)
            with self._lock:
                self.spp_done = s_idx
        with self._lock:
            self.status = "stopped" if self._stop.is_set() else "done"
        # render()'s output contract (`_layers_out`), filter weights included,
        # so `--serve --denoise bilateral` can form the variance
        out = _layers_out(acc)
        out["spp_done"] = s_idx
        return out


def _make_handler(live: LiveRenderer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                page = _PAGE.replace("%WIDTH%", str(max(live.config.width * 2, 320)))
                self._send(200, page.encode(), "text/html")
            elif path == "/frame":
                self._send(200, live.frame(), "image/png")
            elif path == "/status":
                self._send(200, json.dumps(live.state()).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if self.path == "/control":
                live.control(body.decode().strip())
                self._send(200, b"ok", "text/plain")
            elif self.path == "/edit":
                try:
                    req = json.loads(body)
                    ok = live.edit(req["kind"], req["index"], req["value"])
                except (ValueError, KeyError, TypeError):
                    ok = False
                self._send(200 if ok else 400, b"ok" if ok else b"bad edit", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def serve_render(scene: SceneData, config: RenderConfig, port: int = 8000,
                 spp: int | None = None, open_msg: bool = True, host: str = "127.0.0.1",
                 device="cuda") -> dict:
    """Start the HTTP server and run the live render loop on `device` in the
    calling thread. Returns the final layers when the render completes or is
    stopped.

    Binds to loopback by default: the server is unauthenticated and can stop
    the render and change the scene, so remote access is an explicit opt-in
    (`--host 0.0.0.0`)."""
    live = LiveRenderer(scene, config, spp=spp, device=device)
    httpd = ThreadingHTTPServer((host, port), _make_handler(live))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    if open_msg:
        print(f"live view at http://{host}:{port}/ — rendering…")
    try:
        out = live.run()
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out
