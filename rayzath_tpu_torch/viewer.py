"""Live web viewer — the minimal interactive surface.

Counterpart of ``rayzath_tpu/viewer.py``, with the same page and endpoints.
The reference ships a GLFW/Vulkan/ImGui editor (Application/viewport.cpp:
431-465: live viewport, orbit/pan/zoom, click-to-pick, stats overlay). A
native window stack makes no sense for a GPU host you reach over SSH, so
the equivalent is a tiny zero-dependency web viewer: a background thread
renders progressively through the normal :class:`Renderer` (on the card by
default, raising without one; ``device="cpu"`` for the plain versions)
while an ``http.server`` serves

* ``GET /``            — the viewer page (canvas + mouse/keyboard bindings)
* ``GET /frame``       — current tone-mapped frame as PNG (encoded
                         without PIL, ``io/bitmap.encode_png``)
* ``GET /stats``       — pass count, rays/s, resolution (JSON)
* ``POST /orbit``      — drag: orbit the camera around its focal target
* ``POST /pan``        — shift-drag: translate camera + target
* ``POST /zoom``       — wheel: dolly toward/away from the target
* ``POST /pick``       — click: object picking via Renderer.pick
                         (reference rayCast, cuda_render_kernel.cu:130-144)
* ``POST /focus``      — double-click: autofocus via Renderer.focus
                         (reference Camera::focus, camera.cpp:80-88)
* ``GET /tree``        — scene explorer: every container's objects
                         (reference Application/explorer.cpp:1-815)
* ``GET /props``       — editable properties of one object
* ``POST /edit``       — set one property; the Versioned content-version
                         bump restarts progressive accumulation live
                         (reference Application/properties.cpp:1-908)
* ``POST /save``       — save the scene JSON + maps (save modal,
                         Application/save_modals.cpp)
* ``POST /load``       — replace the scene from a JSON path (load modal,
                         Application/load_modals.cpp:1-597)
* ``POST /new``        — create a material/mesh/light/camera/group/instance
                         (new-object modals, Application/new_modals.cpp)
* ``POST /destroy``    — destroy by container index, detaching references
                         (Observer semantics, roho.hpp:18-502)

Camera edits bump the camera version, so the renderer's temporal
reprojection (ops/reproject.py) carries the accumulated image across moves —
the same interactive-feel machinery the reference drives from its viewport.

Threads: the render thread and the server's request threads share the
world, the camera and the renderer; every access to them holds
:attr:`Viewer.lock`. Kernel launches go to the renderer's device from any
thread (``ops/_kernels.py`` ``launch``). A render cycle that raises
stops the render thread and is kept in ``stats()["error"]``; :meth:`stop`
joins the thread.

Usage: ``python -m rayzath_tpu_torch --view scene.json [port]`` or
``Viewer(world).serve()``.
"""
from __future__ import annotations

import json
import math
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .engine.config import RenderConfig
from .engine.renderer import Renderer
from .io.bitmap import encode_png
from .models.world import World
from .utils.device import DEFAULT

_PAGE = """<!DOCTYPE html>
<html><head><title>rayzath_tpu_torch live viewer</title><style>
body { background:#111; color:#ccc; font:13px monospace; margin:16px }
#frame { image-rendering:pixelated; cursor:crosshair; border:1px solid #333 }
#hud { margin-top:8px; white-space:pre }
</style></head><body>
<div>drag: orbit &nbsp; shift+drag: pan &nbsp; wheel: zoom &nbsp;
click: pick &nbsp; double-click: focus</div>
<div style="display:flex; gap:16px; align-items:flex-start">
<div>
<img id="frame" width="WIDTH" height="HEIGHT"/>
<div id="hud">connecting...</div>
</div>
<div id="panel" style="min-width:320px">
<div><button onclick="loadTree()">refresh scene</button>
<button onclick="saveScene()">save scene</button></div>
<div id="tree" style="margin-top:8px"></div>
<div id="props" style="margin-top:8px; border-top:1px solid #333"></div>
</div>
</div>
<script>
const img = document.getElementById('frame');
const hud = document.getElementById('hud');
let drag = null, moved = false;
async function post(path, body) {
  const r = await fetch(path, {method:'POST',
    headers:{'Content-Type':'application/json'}, body:JSON.stringify(body)});
  return r.json();
}
function refresh() { img.src = '/frame?' + Date.now(); }
img.onload = () => setTimeout(refresh, 250);
img.onerror = () => setTimeout(refresh, 1000);
refresh();
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  hud.textContent = `pass ${s.pass_count}  |  ` +
    `${(s.rays_per_second/1e6).toFixed(2)} Mrays/s  |  ` +
    `${s.width}x${s.height}` + (s.picked ? `  |  picked: ${s.picked}` : '');
}, 500);
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; moved = false; });
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (Math.abs(dx) + Math.abs(dy) < 2) return;
  moved = true; drag = [e.clientX, e.clientY];
  post(e.shiftKey ? '/pan' : '/orbit', {dx: dx, dy: dy});
});
img.addEventListener('click', e => {
  if (moved) return;
  const r = img.getBoundingClientRect();
  post('/pick', {x: Math.floor((e.clientX - r.left) * img.naturalWidth / r.width),
                 y: Math.floor((e.clientY - r.top) * img.naturalHeight / r.height)});
});
img.addEventListener('dblclick', e => {
  const r = img.getBoundingClientRect();
  post('/focus', {x: Math.floor((e.clientX - r.left) * img.naturalWidth / r.width),
                  y: Math.floor((e.clientY - r.top) * img.naturalHeight / r.height)});
});
img.addEventListener('wheel', e => { e.preventDefault(); post('/zoom', {d: e.deltaY}); });

async function loadTree() {
  const t = await (await fetch('/tree')).json();
  const div = document.getElementById('tree');
  div.innerHTML = '';
  for (const [type, items] of Object.entries(t)) {
    if (!items.length) continue;
    const h = document.createElement('div');
    h.textContent = type + ' (' + items.length + ')';
    h.style.color = '#8ac';
    div.appendChild(h);
    for (const it of items) {
      const a = document.createElement('div');
      a.textContent = '  ' + it.name + (it.info ? '  [' + it.info + ']' : '');
      if (it.editable) {
        a.style.cursor = 'pointer';
        a.onclick = () => loadProps(type, it.idx);
      } else { a.style.color = '#666'; }
      div.appendChild(a);
    }
  }
}
async function loadProps(type, idx) {
  const p = await (await fetch('/props?type=' + type + '&idx=' + idx)).json();
  const div = document.getElementById('props');
  div.innerHTML = '<b>' + p.name + '</b> (' + type + ')<br/>';
  for (const f of p.fields) {
    const row = document.createElement('div');
    const label = document.createElement('span');
    label.textContent = f.attr + ': ';
    row.appendChild(label);
    const vals = Array.isArray(f.value) ? f.value : [f.value];
    const inputs = [];
    for (const v of vals) {
      const inp = document.createElement('input');
      inp.size = 6; inp.value = (typeof v === 'number') ? +v.toFixed(4) : v;
      inp.onchange = () => {
        const nv = inputs.map(i => parseFloat(i.value));
        post('/edit', {type: type, idx: idx, attr: f.attr,
                       value: Array.isArray(f.value) ? nv : nv[0]});
      };
      inputs.push(inp); row.appendChild(inp);
    }
    div.appendChild(row);
  }
}
async function saveScene() {
  const path = prompt('save scene to path:', 'scene_out.json');
  if (path) { const r = await post('/save', {path: path});
              alert(JSON.stringify(r)); }
}
loadTree();
</script></body></html>"""


class Viewer:
    """Progressive renderer + HTTP control surface over one world."""

    def __init__(self, world: World, config: Optional[RenderConfig] = None,
                 rpp_per_cycle: int = 4, device=DEFAULT):
        self.world = world
        self.renderer = Renderer(world, config, device=device)
        self.camera = next(c for c in world.cameras if c.enabled)
        self.rpp = rpp_per_cycle
        self.lock = threading.Lock()        # world/camera edits vs render cycle
        self.running = False
        self.thread: Optional[threading.Thread] = None
        self.error = ""                     # what stopped the render thread
        self.picked = ""
        self._rays = 0.0                    # EMA rays/s
        # orbit target: the point the camera looks at, at focal distance
        fwd = np.asarray(self.camera.coord_system())[:, 2]
        self.target = (np.asarray(self.camera.position, np.float64)
                       + fwd * self.camera.focal_distance)

    def rebind_camera(self) -> None:
        """Re-attach to the world's first enabled camera (after /load
        replaced the scene's contents, including its cameras)."""
        self.camera = next(c for c in self.world.cameras if c.enabled)
        fwd = np.asarray(self.camera.coord_system())[:, 2]
        self.target = (np.asarray(self.camera.position, np.float64)
                       + fwd * self.camera.focal_distance)

    # -- camera controls (reference viewport.cpp drag handlers) ---------------
    def orbit(self, dx: float, dy: float) -> None:
        with self.lock:
            cam = self.camera
            off = np.asarray(cam.position, np.float64) - self.target
            r = float(np.linalg.norm(off))
            theta = math.atan2(off[0], off[2])
            phi = math.asin(np.clip(off[1] / max(r, 1e-9), -1.0, 1.0))
            theta -= dx * 0.008
            phi = float(np.clip(phi + dy * 0.008, -1.45, 1.45))
            cam.position = self.target + r * np.asarray(
                [math.cos(phi) * math.sin(theta), math.sin(phi),
                 math.cos(phi) * math.cos(theta)])
            cam.look_at(tuple(self.target))

    def pan(self, dx: float, dy: float) -> None:
        with self.lock:
            cam = self.camera
            axes = np.asarray(cam.coord_system())
            step = (axes[:, 0] * (-dx) + axes[:, 1] * dy) * 0.004 * \
                max(self.camera.focal_distance, 0.1)
            cam.position = np.asarray(cam.position, np.float64) + step
            self.target = self.target + step
            cam.touch()

    def zoom(self, d: float) -> None:
        with self.lock:
            cam = self.camera
            off = np.asarray(cam.position, np.float64) - self.target
            off = off * (1.15 if d > 0 else 1.0 / 1.15)
            cam.position = self.target + off
            cam.touch()

    def pick(self, x: int, y: int) -> dict:
        with self.lock:
            inst, mat = self.renderer.pick(self.camera, x, y)
        name = ""
        if 0 <= inst < len(self.world.instances):
            name = self.world.instances[inst].name
        self.picked = name or (f"instance {inst}" if inst >= 0 else "")
        return {"instance": inst, "material": mat, "name": name}

    def focus(self, x: int, y: int) -> dict:
        with self.lock:
            fd = self.renderer.focus(self.camera, x, y)
        return {"focal_distance": fd}

    # -- progressive render loop ----------------------------------------------
    def _render_loop(self) -> None:
        while self.running:
            t0 = time.perf_counter()
            try:
                with self.lock:
                    self.renderer.render(camera=self.camera, rpp=self.rpp)
                    rays = self.rpp * self.camera.width * self.camera.height
            except Exception as e:  # the thread's boundary: keep the server up
                traceback.print_exc(file=sys.stderr)
                self.error = f"{type(e).__name__}: {e}"
                self.running = False
                return
            rps = rays / max(time.perf_counter() - t0, 1e-6)
            self._rays = rps if not self._rays else 0.8 * self._rays + 0.2 * rps
            time.sleep(0.001)   # let a request thread waiting on the lock in

    def frame_png(self) -> bytes:
        with self.lock:
            img = self.renderer.image(self.camera)
        return encode_png(img)

    def stats(self) -> dict:
        cv = self.renderer.views.get(id(self.camera))
        return {
            "pass_count": cv.pass_count if cv else 0,
            "rays_per_second": self._rays,
            "width": self.camera.width, "height": self.camera.height,
            "picked": self.picked,
            "error": self.error,
        }

    # -- HTTP -----------------------------------------------------------------
    def make_server(self, host: str = "127.0.0.1", port: int = 8760):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/":
                    page = (_PAGE.replace("WIDTH", str(viewer.camera.width))
                            .replace("HEIGHT", str(viewer.camera.height)))
                    self._send(200, page.encode(), "text/html")
                elif path == "/frame":
                    self._send(200, viewer.frame_png(), "image/png")
                elif path == "/stats":
                    self._send(200, json.dumps(viewer.stats()).encode(),
                               "application/json")
                elif path == "/tree":
                    from . import editor
                    with viewer.lock:
                        tree = editor.scene_tree(viewer.world)
                    self._send(200, json.dumps(tree).encode(),
                               "application/json")
                elif path == "/props":
                    from . import editor
                    q = {k: v[0] for k, v in
                         parse_qs(urlparse(self.path).query).items()}
                    try:
                        with viewer.lock:
                            props = editor.get_props(viewer.world,
                                                     q.get("type", ""),
                                                     int(q.get("idx", 0)))
                        self._send(200, json.dumps(props).encode(),
                                   "application/json")
                    except (KeyError, IndexError) as e:
                        self._send(404, json.dumps(
                            {"error": str(e)}).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                path = urlparse(self.path).path
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    body = {}
                q = {k: v[0] for k, v in
                     parse_qs(urlparse(self.path).query).items()}
                body = {**q, **body}
                out = {}
                if path == "/orbit":
                    viewer.orbit(float(body.get("dx", 0)), float(body.get("dy", 0)))
                elif path == "/pan":
                    viewer.pan(float(body.get("dx", 0)), float(body.get("dy", 0)))
                elif path == "/zoom":
                    viewer.zoom(float(body.get("d", 0)))
                elif path == "/pick":
                    out = viewer.pick(int(body.get("x", 0)), int(body.get("y", 0)))
                elif path == "/focus":
                    out = viewer.focus(int(body.get("x", 0)), int(body.get("y", 0)))
                elif path == "/edit":
                    from . import editor
                    try:
                        with viewer.lock:
                            out = editor.set_prop(
                                viewer.world, body.get("type", ""),
                                int(body.get("idx", 0)),
                                body.get("attr", ""), body.get("value"))
                    except (KeyError, IndexError, AssertionError,
                            ValueError) as e:
                        self._send(400, json.dumps(
                            {"error": str(e)}).encode(), "application/json")
                        return
                elif path == "/save":
                    from . import editor
                    try:
                        with viewer.lock:
                            out = editor.save_scene(
                                viewer.world, body.get("path", "scene_out.json"))
                    except OSError as e:
                        self._send(400, json.dumps(
                            {"error": str(e)}).encode(), "application/json")
                        return
                elif path == "/load":
                    # load-modal parity (reference load_modals.cpp:1-597):
                    # replace the scene; the content-version bump restarts
                    # the render loop on the same world object
                    from . import editor
                    try:
                        with viewer.lock:
                            out = editor.load_scene(
                                viewer.world, body.get("path", ""))
                            viewer.rebind_camera()
                    except (OSError, RuntimeError, ValueError, StopIteration) as e:
                        self._send(400, json.dumps(
                            {"error": str(e)}).encode(), "application/json")
                        return
                elif path == "/new":
                    from . import editor
                    try:
                        with viewer.lock:
                            out = editor.new_object(
                                viewer.world, body.get("type", ""),
                                body.get("params", {}))
                    except (KeyError, IndexError, ValueError) as e:
                        self._send(400, json.dumps(
                            {"error": str(e)}).encode(), "application/json")
                        return
                elif path == "/destroy":
                    from . import editor
                    try:
                        with viewer.lock:
                            out = editor.destroy_object(
                                viewer.world, body.get("type", ""),
                                int(body.get("idx", 0)))
                    except (KeyError, IndexError) as e:
                        self._send(400, json.dumps(
                            {"error": str(e)}).encode(), "application/json")
                        return
                else:
                    self._send(404, b"not found", "text/plain")
                    return
                self._send(200, json.dumps(out).encode(), "application/json")

        return ThreadingHTTPServer((host, port), Handler)

    def start(self) -> None:
        self.running = True
        self.thread = threading.Thread(target=self._render_loop, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        """Stop the render loop and join its thread (raises when the
        current cycle does not end within a minute)."""
        self.running = False
        if self.thread is not None:
            self.thread.join(timeout=60.0)
            if self.thread.is_alive():
                raise RuntimeError("the render thread did not stop within 60 s")
            self.thread = None

    def serve(self, host: str = "127.0.0.1", port: int = 8760) -> None:
        """Blocking: render + serve until Ctrl-C."""
        server = self.make_server(host, port)
        self.start()
        print(f"rayzath_tpu_torch viewer on "
              f"http://{host}:{server.server_address[1]}/")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
            server.server_close()
