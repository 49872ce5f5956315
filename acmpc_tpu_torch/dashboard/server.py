"""Headless dashboard: a background renderer and an HTTP MJPEG/JSON server.

Counterpart of ``acmpc_tpu/dashboard/server.py``, with the same HTTP
surface: the feed-grid page (``/``) and the streaming layout
(``/stream``), ``/session.json``, the composite (``/feed.mjpg``), one
MJPEG stream per feed (``/feed/<name>.mjpg``) and the feed lifecycle
(``/feed/<name>/start|stop``): a feed renders only while it is enabled
and watched, so a stopped feed costs nothing.

The agent keeps its latest camera, segmentation and semantics views as
device tensors; the renderer copies what it draws to the host once a
render (``.cpu().numpy()``), draws the panels with ``dashboard/render.py``
and encodes them with the port's own JPEG encoder (``dashboard/jpeg.py``,
quality 80, as ``cv2.imencode`` was asked for).

The render loop survives an exception, as the JAX package's does (a
dashboard must not stop the car), but it does not hide one: it counts
every exception in ``render_errors`` and keeps the last in
``last_render_error``. ``encode_ms`` keeps the time of each recent
composite's encode.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from acmpc_tpu_torch.dashboard.jpeg import encode_jpeg
from acmpc_tpu_torch.dashboard.render import (
    compose_dashboard,
    render_bev,
    render_local_localisation,
    render_semantics,
    render_world_map,
)
from acmpc_tpu_torch.dashboard.session import SessionTracker

JPEG_QUALITY = 80

# the six feeds
FEED_NAMES = (
    "camera",
    "segmentation",
    "control",
    "semantics",
    "localisation",
    "map",
)

_PAGE = b"""<!doctype html>
<html><head><title>acmpc_tpu_torch dashboard</title>
<style>
body{background:#14141c;color:#ddd;font-family:system-ui,sans-serif;margin:0}
h3{margin:10px 14px}
#wrap{display:flex}
#grid{display:grid;grid-template-columns:repeat(3,1fr);gap:8px;padding:8px;flex:3}
.cell{border:1px solid slategray;border-radius:4px;padding:4px;text-align:center}
.cell img{width:100%;background:#000;min-height:120px}
.cell button{margin:4px;background:#2a2a38;color:#ddd;border:1px solid slategray;
  border-radius:4px;padding:3px 12px;cursor:pointer}
#session{flex:1;padding:14px;font-family:ui-monospace,monospace;min-width:300px}
table{border-collapse:collapse;width:100%;margin-bottom:14px}
td,th{padding:2px 8px;text-align:left;font-size:14px}
.lap-title{font-size:18px;font-weight:bold;margin:8px 0 2px}
</style></head>
<body><h3>acmpc_tpu_torch</h3>
<div id=wrap>
<div id=grid></div>
<div id=session></div>
</div>
<script>
const FEEDS=["camera","segmentation","control","semantics","localisation","map"];
const grid=document.getElementById("grid");
for(const f of FEEDS){
  const c=document.createElement("div");c.className="cell";
  c.innerHTML=`<img id="img-${f}" alt="${f}">`+
    `<div>${f} <button id="btn-${f}">Stop</button></div>`;
  grid.appendChild(c);
  const img=c.querySelector("img"),btn=c.querySelector("button");
  let on=false;
  const set=(v)=>{on=v;btn.textContent=v?"Stop":"Start";
    fetch(`/feed/${f}/${v?"start":"stop"}`);  // server-side lifecycle
    img.src=v?`/feed/${f}.mjpg`:"";};
  btn.onclick=()=>set(!on);
  set(true);
}
const row=(label,e)=>e?`<tr><td>${label}</td>`+
  `<td style="color:${e.colour}">${e.time}</td>`+
  `<td>${e.delta||""}</td></tr>`:"";
setInterval(async()=>{
  const s=await (await fetch("/session.json")).json();
  const lapTable=(title,lap)=>{
    if(!lap)return "";
    let h=`<div class=lap-title>${title}</div><table>`;
    h+=row("Time",lap);
    (lap.sectors||[]).forEach((sec,i)=>h+=row(`Sector ${i+1}`,sec));
    return h+"</table>";
  };
  document.getElementById("session").innerHTML=
    `<div class=lap-title>Lap ${s.completed_laps+1}</div>`+
    lapTable("Current Lap",s.current)+
    lapTable("Last Lap",s.last)+
    `<div class=lap-title>Best</div><table><tr><td>Lap</td>`+
    `<td style="color:purple">${s.best_lap}</td></tr>`+
    (s.best_sectors||[]).map((t,i)=>`<tr><td>Sector ${i+1}</td><td>${t}</td></tr>`).join("")+
    `</table>`;
},500);
</script></body></html>"""

# streaming layout: one large live feed with a selector strip and the
# session pane beside it
_STREAM_PAGE = b"""<!doctype html>
<html><head><title>acmpc_tpu_torch stream</title>
<style>
body{background:#14141c;color:#ddd;font-family:system-ui,sans-serif;margin:0}
h3{margin:10px 14px;display:inline-block}
#bar{padding:4px 14px}
#bar button{margin:2px;background:#2a2a38;color:#ddd;border:1px solid slategray;
  border-radius:4px;padding:4px 14px;cursor:pointer}
#bar button.active{background:#3d5a80}
#wrap{display:flex}
#main{flex:3;padding:8px}
#main img{width:100%;background:#000;min-height:400px}
#session{flex:1;padding:14px;font-family:ui-monospace,monospace;min-width:300px}
table{border-collapse:collapse;width:100%;margin-bottom:14px}
td,th{padding:2px 8px;text-align:left;font-size:14px}
.lap-title{font-size:18px;font-weight:bold;margin:8px 0 2px}
</style></head>
<body><h3>acmpc_tpu_torch stream</h3><a href="/" style="color:#8ab">grid</a>
<div id=bar></div>
<div id=wrap>
<div id=main><img id=view></div>
<div id=session></div>
</div>
<script>
const FEEDS=["composite","camera","segmentation","control","semantics",
  "localisation","map"];
const bar=document.getElementById("bar"),view=document.getElementById("view");
let current=null;
function pick(f){
  if(current&&current!==f)fetch(`/feed/${current}/stop`);
  fetch(`/feed/${f}/start`);current=f;
  view.src=f==="composite"?"/feed.mjpg":`/feed/${f}.mjpg`;
  for(const b of bar.children)b.classList.toggle("active",b.textContent===f);
}
for(const f of FEEDS){
  const b=document.createElement("button");b.textContent=f;
  b.onclick=()=>pick(f);bar.appendChild(b);
}
pick("composite");
const row=(label,e)=>e?`<tr><td>${label}</td>`+
  `<td style="color:${e.colour}">${e.time}</td>`+
  `<td>${e.delta||""}</td></tr>`:"";
setInterval(async()=>{
  const s=await (await fetch("/session.json")).json();
  const lapTable=(title,lap)=>{
    if(!lap)return "";
    let h=`<div class=lap-title>${title}</div><table>`;
    h+=row("Time",lap);
    (lap.sectors||[]).forEach((sec,i)=>h+=row(`Sector ${i+1}`,sec));
    return h+"</table>";
  };
  document.getElementById("session").innerHTML=
    `<div class=lap-title>Lap ${s.completed_laps+1}</div>`+
    lapTable("Current Lap",s.current)+
    lapTable("Last Lap",s.last)+
    `<div class=lap-title>Best</div><table><tr><td>Lap</td>`+
    `<td style="color:purple">${s.best_lap}</td></tr>`+
    (s.best_sectors||[]).map((t,i)=>`<tr><td>Sector ${i+1}</td><td>${t}</td></tr>`).join("")+
    `</table>`;
},500);
</script></body></html>"""


def _host(x) -> Optional[np.ndarray]:
    """A tensor (on any device) or array as a host array."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Dashboard:
    """Attach to an agent (and optionally the synthetic sim) and serve.
    ``port`` 0 takes a free port; ``port`` holds the bound one after
    ``start``."""

    def __init__(self, agent, sim=None, port: int = 8793, fps: float = 10.0):
        self.agent = agent
        self.sim = sim
        self.port = port
        self.fps = fps
        self.session = SessionTracker()
        self.render_errors = 0
        self.last_render_error: Optional[str] = None
        self.renders = 0
        self.encode_ms: collections.deque = collections.deque(maxlen=1000)
        self._frames: Dict[str, bytes] = {}
        self._frame_lock = threading.Lock()
        self._stop = threading.Event()
        self._render_thread: Optional[threading.Thread] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._map_polys: Optional[tuple] = None  # (map, its host polylines)
        # a feed renders only while it is enabled AND watched (a stream
        # client is attached, or the composite, which consumes every
        # panel, is)
        self._enabled: Dict[str, bool] = {n: True for n in FEED_NAMES}
        self._clients: Dict[str, int] = {n: 0 for n in FEED_NAMES}
        self._clients["composite"] = 0
        self._client_lock = threading.Lock()

    # -- feed lifecycle ----------------------------------------------------
    def set_feed_enabled(self, name: str, enabled: bool):
        if name in self._enabled or name == "composite":
            self._enabled[name] = enabled

    def _feed_active(self, name: str) -> bool:
        if not self._enabled.get(name, True):
            return False
        with self._client_lock:
            return self._clients.get(name, 0) > 0 or (
                self._clients["composite"] > 0
                and self._enabled.get("composite", True)
            )

    def _attach(self, name: str, delta: int):
        with self._client_lock:
            self._clients[name] = max(0, self._clients.get(name, 0) + delta)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), self._make_handler())
        self.port = self._server.server_address[1]
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True, name="acmpc-dashboard"
        )
        self._render_thread.start()
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def stop(self):
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._render_thread is not None:
            self._render_thread.join(timeout=10)

    def update_session(self, state: dict):
        self.session.update(state)

    # -- rendering -------------------------------------------------------
    def _render_loop(self):
        interval = 1.0 / self.fps
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.render_once()
            except Exception:  # counted, kept, and the car drives on
                self.render_errors += 1
                self.last_render_error = traceback.format_exc()
            time.sleep(max(0.0, interval - (time.monotonic() - t0)))

    def render_once(self):
        """One pass of the render loop: the session, every active panel
        and, when watched, the composite, encoded and published."""
        state = getattr(self.agent, "_latest_state", None)
        if state:
            self.session.update(state)
        panels = self._render_panels()
        encoded = {}
        for name, frame in panels.items():
            if frame is None:
                continue
            if frame.ndim == 2:
                frame = np.repeat(frame[..., None], 3, axis=2)
            if frame.dtype != np.uint8:
                frame = np.clip(frame, 0, 255).astype(np.uint8)
            encoded[name] = encode_jpeg(frame, JPEG_QUALITY)
        if panels and self._feed_active("composite"):
            composite = compose_dashboard({k: v for k, v in panels.items() if v is not None})
            t0 = time.perf_counter()
            encoded["composite"] = encode_jpeg(composite, JPEG_QUALITY)
            self.encode_ms.append(1e3 * (time.perf_counter() - t0))
        with self._frame_lock:
            self._frames.update(encoded)
        self.renders += 1

    def _map_polylines(self, track_map) -> Dict[str, np.ndarray]:
        """The localiser map's polylines on the host, copied once a map."""
        if self._map_polys is None or self._map_polys[0] is not track_map:
            self._map_polys = (
                track_map,
                {k: _host(getattr(track_map, k)) for k in ("centre", "left", "right")},
            )
        return self._map_polys[1]

    def _render_panels(self) -> Dict[str, Optional[np.ndarray]]:
        """One frame per ACTIVE feed (enabled and watched); stopped feeds
        cost nothing. Device tensors are copied to the host here."""
        agent = self.agent
        panels: Dict[str, Optional[np.ndarray]] = {}
        frames = getattr(agent, "_latest_frames", {}) or {}

        if self._feed_active("camera"):
            panels["camera"] = _host(frames.get("camera"))

        if self._feed_active("segmentation"):
            seg = _host(frames.get("segmentation"))
            panels["segmentation"] = None if seg is None else (seg * 255).astype(np.uint8)
            if panels["segmentation"] is None and self.sim is not None:
                mask = self.sim.render_drivable_mask()
                panels["segmentation"] = (np.asarray(mask) * 255).astype(np.uint8)

        if self._feed_active("semantics"):
            sem = _host(frames.get("semantics"))
            panels["semantics"] = None if sem is None else render_semantics(sem)

        if self._feed_active("control"):
            tracks = getattr(agent, "_latest_tracks", None)
            prediction = agent.controller.predicted_locations
            panels["control"] = render_bev(tracks, prediction)

        want_map = self._feed_active("map")
        want_local = self._feed_active("localisation")
        if want_map or want_local:
            map_polys = particles = estimate = None
            if agent.localiser is not None:
                map_polys = self._map_polylines(agent.localiser.map)
                particles = agent.localiser.particle_states
                estimate = agent.localiser.estimated_position
            car = self.sim.pose if self.sim is not None else None
            if want_map:
                panels["map"] = render_world_map(map_polys, particles, estimate, car)
            if want_local:
                panels["localisation"] = render_local_localisation(
                    map_polys, particles, estimate, car
                )
        return panels

    def _frame(self, name: str) -> Optional[bytes]:
        with self._frame_lock:
            return self._frames.get(name)

    # -- http ------------------------------------------------------------
    def _make_handler(self):
        dashboard = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _stream(self, name: str):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                dashboard._attach(name, +1)
                try:
                    while not dashboard._stop.is_set():
                        frame = dashboard._frame(name)
                        if frame is not None:
                            self.wfile.write(b"--frame\r\n")
                            self.send_header("Content-Type", "image/jpeg")
                            self.send_header(
                                "Content-Length", str(len(frame))
                            )
                            self.end_headers()
                            self.wfile.write(frame)
                            self.wfile.write(b"\r\n")
                        time.sleep(1.0 / dashboard.fps)
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    dashboard._attach(name, -1)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_STREAM_PAGE)
                elif self.path.startswith("/feed/") and self.path.endswith(
                    ("/start", "/stop")
                ):
                    name, _, action = self.path[len("/feed/") :].rpartition(
                        "/"
                    )
                    if name in FEED_NAMES or name == "composite":
                        dashboard.set_feed_enabled(name, action == "start")
                        self.send_response(204)
                    else:
                        self.send_response(404)
                    self.end_headers()
                elif self.path == "/session.json":
                    body = json.dumps(dashboard.session.snapshot()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/feed.mjpg":
                    self._stream("composite")
                elif self.path.startswith("/feed/") and self.path.endswith(
                    ".mjpg"
                ):
                    name = self.path[len("/feed/") : -len(".mjpg")]
                    if name in FEED_NAMES:
                        self._stream(name)
                    else:
                        self.send_response(404)
                        self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        return Handler
