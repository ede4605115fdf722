"""Live SLAM viewer: a dependency-free web GUI.

Counterpart of ``monogs_tpu/gui/slam_gui.py``: a small threaded HTTP server
in place of the reference's Open3D/OpenGL desktop GUI.

  - GET /          an auto-refreshing HTML dashboard (rendered view, input
                   frame, depth, 3D map view, stats)
  - GET /view.jpg  the map rendered from the current tracked camera, or
                   from an offset of it (?dx=&dy=&dz=&pitch=&yaw=&roll=,
                   the tangent of se3 applied on the left), by the port's
                   ``render`` on the run's device
  - GET /input.jpg the latest ground-truth frame from the frontend
  - GET /depth.jpg the rendered depth (turbo-mapped)
  - GET /map3d.jpg a free-orbit view of the map with the keyframe
                   frustums and the trajectories drawn over it
                   (?yaw=&pitch=&dist=&mode=rgb|depth|opacity|ellipsoid
                   &scale=&follow=)
  - GET /stats     JSON: Gaussian count, keyframes, window, packets, uptime
  - POST /pause, /unpause  the Packet_vis2main back-channel
  - POST /screenshot  the view and the 3D map view under
                   save_dir/screenshots

``run(params)`` drains ``q_main2vis`` to the latest ``GaussianPacket`` and
serves until a finish packet arrives; ``start(params)`` runs it on a thread
and returns the port it bound (``params.port`` 0 takes a free one). Packets carry map snapshots
(``gui_utils.snapshot``), so a view renders from the GUI's own copy while
the mapping thread goes on. Views are rendered where ``params.device``
says (the card unless the caller asks for the CPU). JPEG: on the card
nvJPEG encodes (``data/jpeg.py::encode_jpeg``), and a failure raises (the
request gets status 500 with the error); on the CPU cv2 where it is
installed, else PPM, as the JAX package does. The overlays are drawn
with numpy, without cv2. An error while serving a request is logged and
answered with 500; the server goes on.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import traceback

import numpy as np
import torch

from ..utils.logging import Log
from .gui_utils import GaussianPacket, Packet_vis2main

_PAGE = """<!DOCTYPE html>
<html><head><title>monogs-tpu (PyTorch/CUDA)</title>
<style>
 body { background:#111; color:#ddd; font-family:monospace; margin:16px; }
 img { image-rendering:pixelated; border:1px solid #333; }
 .row { display:flex; gap:12px; flex-wrap:wrap; }
 button { background:#333; color:#ddd; border:1px solid #555; padding:6px 14px; }
</style></head>
<body>
<h2>monogs-tpu live (PyTorch/CUDA port)</h2>
<div class="row">
 <div><h4>rendered view</h4><img id="v" width="480"/></div>
 <div><h4>input frame</h4><img id="i" width="480"/></div>
 <div><h4>depth</h4><img id="d" width="480"/></div>
</div>
<div class="row">
 <div><h4>3D map (drag yaw/pitch, frustums + trajectory)</h4>
  <img id="m" width="640"/><br/>
  yaw <input id="yaw" type="range" min="-3.14" max="3.14" step="0.05" value="0"/>
  pitch <input id="pitch" type="range" min="-1.4" max="1.4" step="0.05" value="0.5"/>
  mode <select id="mode"><option>rgb</option><option>depth</option>
   <option>opacity</option><option>ellipsoid</option></select>
  scale <input id="scale" type="range" min="0.05" max="1.5" step="0.05" value="1"/>
  <label><input id="follow" type="checkbox"/> follow camera</label>
 </div>
</div>
<p>
 <button onclick="fetch('/pause',{method:'POST'})">pause</button>
 <button onclick="fetch('/unpause',{method:'POST'})">unpause</button>
 <button onclick="shot()">screenshot</button> <span id="shotmsg"></span>
</p>
<pre id="s"></pre>
<script>
 async function tick() {
   const t = Date.now();
   document.getElementById('v').src = '/view.jpg?t=' + t;
   document.getElementById('i').src = '/input.jpg?t=' + t;
   document.getElementById('d').src = '/depth.jpg?t=' + t;
   document.getElementById('m').src = '/map3d.jpg?t=' + t
     + '&yaw=' + document.getElementById('yaw').value
     + '&pitch=' + document.getElementById('pitch').value
     + '&mode=' + document.getElementById('mode').value
     + '&scale=' + document.getElementById('scale').value
     + '&follow=' + (document.getElementById('follow').checked ? 1 : 0);
   const s = await (await fetch('/stats')).json();
   document.getElementById('s').textContent = JSON.stringify(s, null, 2);
 }
 async function shot() {
   const qs = '?yaw=' + document.getElementById('yaw').value
     + '&pitch=' + document.getElementById('pitch').value
     + '&mode=' + document.getElementById('mode').value
     + '&scale=' + document.getElementById('scale').value
     + '&follow=' + (document.getElementById('follow').checked ? 1 : 0);
   const r = await (await fetch('/screenshot' + qs, {method:'POST'})).json();
   document.getElementById('shotmsg').textContent = r.saved || r.error;
 }
 setInterval(tick, 1000); tick();
</script>
</body></html>"""


class _State:
    def __init__(self, params):
        self.params = params
        self.device = torch.device(params.device)
        self.latest = GaussianPacket()
        self.gaussians = params.gaussians
        self.current_T = None
        self.n_frames = 0
        self.t0 = time.time()
        self.lock = threading.Lock()
        self.finished = False
        self.n_shots = 0


def _to_u8(img_chw):
    """[3, H, W] float in [0, 1] -> [H, W, 3] uint8 on its device
    (truncated, as the JAX package's astype)."""
    img = torch.clamp(img_chw.float(), 0.0, 1.0)
    return (img.permute(1, 2, 0) * 255.0).to(torch.uint8).contiguous()


def _encode_u8(hwc):
    """[H, W, 3] uint8 RGB -> (image bytes, content type): nvJPEG for a
    tensor on the card; otherwise cv2's JPEG, or PPM without cv2."""
    from ..data.jpeg import encode_jpeg

    if torch.is_tensor(hwc) and hwc.is_cuda:
        return encode_jpeg(hwc), "image/jpeg"
    hwc = hwc.cpu().numpy() if torch.is_tensor(hwc) else np.asarray(hwc)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(hwc[..., ::-1]))
        if ok:
            return bytes(buf), "image/jpeg"
    h, w = hwc.shape[:2]
    return (b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(hwc).tobytes(),
            "image/x-portable-pixmap")


def _encode_jpg(img_chw):
    """[3, H, W] float in [0, 1] (a tensor) -> (image bytes, content
    type), on the device it lies on."""
    return _encode_u8(_to_u8(img_chw))


def _turbo(depth_hw):
    """[H, W] depth -> [3, H, W] in [0, 1], stretched between the 2nd and
    98th percentiles of the positive depths."""
    d = depth_hw.float()
    pos = d[d > 0]
    if pos.numel():
        q = torch.quantile(pos, torch.tensor([0.02, 0.98], device=d.device))
        lo, hi = float(q[0]), float(q[1])
    else:
        lo, hi = 0.0, 1.0
    t = torch.clamp((d - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    return torch.stack([t, 4 * t * (1 - t), 1 - t], dim=0)


def _lookat_w2c(eye, center, up=(0.0, -1.0, 0.0)):
    """World->camera 4x4 for a camera at ``eye`` looking at ``center``
    (OpenCV convention: +z forward, +y down; up defaults to -y world)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(center, np.float64) - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # rows: camera axes in world
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T.astype(np.float32)


def _project_pts(pts_w, T_wc, intr):
    """[n, 3] world -> ([n, 2] pixels, [n] z). No clipping."""
    pc = pts_w @ T_wc[:3, :3].T + T_wc[:3, 3]
    z = pc[:, 2]
    zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
    u = intr.fx * pc[:, 0] / zs + intr.cx
    v = intr.fy * pc[:, 1] / zs + intr.cy
    return np.stack([u, v], axis=-1), z


def _clip_segment(a, b, w, h):
    """The part of segment a-b inside [0, w-1] x [0, h-1] (Liang-Barsky),
    or None."""
    t0, t1 = 0.0, 1.0
    d = b - a
    for p, q in ((-d[0], a[0]), (d[0], w - 1 - a[0]),
                 (-d[1], a[1]), (d[1], h - 1 - a[1])):
        if p == 0:
            if q < 0:
                return None
            continue
        r = q / p
        if p < 0:
            t0 = max(t0, r)
        else:
            t1 = min(t1, r)
        if t0 > t1:
            return None
    return a + t0 * d, a + t1 * d


def _draw_segment(img_hwc, a, b, color):
    h, w = img_hwc.shape[:2]
    seg = _clip_segment(np.asarray(a, np.float64), np.asarray(b, np.float64),
                        w, h)
    if seg is None:
        return
    a, b = seg
    n = int(np.ceil(np.abs(b - a).max())) + 1
    xs = np.clip(np.rint(np.linspace(a[0], b[0], n)).astype(int), 0, w - 1)
    ys = np.clip(np.rint(np.linspace(a[1], b[1], n)).astype(int), 0, h - 1)
    img_hwc[ys, xs] = color


def _draw_polyline(img_hwc, pts_w, T_view, intr, color, closed=False):
    """Draw a 3D polyline into the uint8 image (the segments with both
    ends in front of the camera)."""
    if pts_w is None or len(pts_w) < 2:
        return
    uv, z = _project_pts(np.asarray(pts_w, np.float64), T_view, intr)
    pairs = list(zip(range(len(uv) - 1), range(1, len(uv))))
    if closed:
        pairs.append((len(uv) - 1, 0))
    for a, b in pairs:
        if z[a] > 0.05 and z[b] > 0.05:
            _draw_segment(img_hwc, uv[a], uv[b], color)


def _frustum_pts(T_kf, intr, depth=0.15):
    """The apex and the 4 image corners at ``depth`` of a camera frustum,
    in world coordinates."""
    T = np.asarray(T_kf, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    C = -R.T @ t
    corners_px = np.array([[0, 0], [intr.width, 0],
                           [intr.width, intr.height], [0, intr.height]],
                          np.float64)
    x = (corners_px[:, 0] - intr.cx) / intr.fx
    y = (corners_px[:, 1] - intr.cy) / intr.fy
    dirs = np.stack([x, y, np.ones(4)], axis=-1) * depth
    return C, C[None, :] + dirs @ R     # d_w = R^T d_c, row-wise


def _draw_frustum(img_hwc, T_kf, T_view, intr, color):
    C, corners = _frustum_pts(T_kf, intr)
    _draw_polyline(img_hwc, corners, T_view, intr, color, closed=True)
    for k in range(4):
        _draw_polyline(img_hwc, np.stack([C, corners[k]]), T_view, intr,
                       color)


def _host(T):
    return T.detach().cpu().numpy() if torch.is_tensor(T) else np.asarray(T)


def _map3d_view(state: _State, yaw, pitch, dist, mode, scale, follow=False):
    """Free-orbit render of the map with the frustums and trajectories
    drawn over it, as [H, W, 3] uint8 numpy (None before a map arrives).
    The orbit camera circles the centroid of the active Gaussians; ``mode``
    is rgb / depth / opacity / ellipsoid (every splat opaque), ``scale``
    the render's scale modifier; ``follow`` takes the current tracked
    camera's pose instead of the orbit."""
    from ..render import render

    p = state.params
    with state.lock:
        gauss = state.gaussians
        pkt = state.latest
    if gauss is None:
        return None
    gv = gauss.render_view()
    with torch.no_grad():
        xyz = gv.xyz[gv.active]
        if xyz.shape[0] == 0:
            return None
        if follow and pkt.current_frame is not None:
            T_view = _host(pkt.current_frame.T).astype(np.float32)
        else:
            center = xyz.mean(dim=0)
            spread = float(torch.quantile(
                torch.linalg.norm(xyz - center, dim=-1), 0.9))
            center = _host(center).astype(np.float64)
            d = dist if dist > 0 else max(2.5 * spread, 0.5)
            cy, sy = np.cos(yaw), np.sin(yaw)
            cp, sp = np.cos(pitch), np.sin(pitch)
            eye = center + d * np.array([sy * cp, -sp, -cy * cp])
            T_view = _lookat_w2c(eye, center)
        if mode == "ellipsoid":
            gv = gv._replace(opa_logit=torch.full_like(gv.opa_logit, 8.0))
        out = render(gv, torch.as_tensor(T_view, device=state.device),
                     p.intr, p.render_cfg._replace(with_n_touched=False),
                     scale_modifier=float(scale))
        if mode == "depth":
            img = _turbo(out.depth[0])
        elif mode == "opacity":
            img = out.opacity.expand(3, -1, -1)
        else:
            img = out.image
        hwc = _to_u8(img).cpu().numpy()
    # keyframe frustums (yellow), current camera (red), estimated
    # trajectory (green), ground truth (blue)
    for kf in pkt.keyframes:
        _draw_frustum(hwc, _host(kf.T), T_view, p.intr, (255, 220, 60))
    if pkt.current_frame is not None:
        _draw_frustum(hwc, _host(pkt.current_frame.T), T_view, p.intr,
                      (255, 60, 60))
    _draw_polyline(hwc, pkt.trajectory, T_view, p.intr, (80, 255, 120))
    _draw_polyline(hwc, pkt.trajectory_gt, T_view, p.intr, (90, 140, 255))
    return hwc


def _render_view(state: _State, offsets):
    """(image [3, H, W] in [0, 1], depth [H, W]) of the map from the
    current tracked camera moved by the se3 tangent ``offsets``, on the
    run's device; (None, None) before a map and a pose arrive."""
    from ..render import render

    p = state.params
    with state.lock:
        gauss = state.gaussians
        T = state.current_T
    if gauss is None or T is None:
        return None, None
    tau = torch.tensor(offsets, dtype=torch.float32, device=state.device)
    with torch.no_grad():
        out = render(gauss.render_view(), torch.as_tensor(
            T, dtype=torch.float32, device=state.device), p.intr,
            p.render_cfg._replace(with_n_touched=False), tau=tau)
    return torch.clamp(out.image, 0.0, 1.0), out.depth[0]


def run(params):
    """GUI thread entry: serve until a finish packet arrives."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    state = _State(params)

    def drain():
        while not state.finished:
            try:
                pkt = params.q_main2vis.get(timeout=0.05)
            except queue.Empty:
                continue
            while True:   # to the latest packet
                try:
                    pkt = params.q_main2vis.get_nowait()
                except queue.Empty:
                    break
            with state.lock:
                if pkt.finish:
                    state.finished = True
                if pkt.gaussians is not None:
                    state.gaussians = pkt.gaussians
                if pkt.current_frame is not None:
                    state.current_T = pkt.current_frame.T
                state.latest = pkt
                state.n_frames += 1

    def map3d_u8(q):
        def f(k, d="0"):
            return float(q.get(k, [d])[0])

        hwc = _map3d_view(state, yaw=f("yaw"), pitch=f("pitch", "0.5"),
                          dist=f("dist"), mode=q.get("mode", ["rgb"])[0],
                          scale=f("scale", "1"), follow=f("follow") > 0)
        if hwc is None:
            return None
        return torch.from_numpy(hwc).to(state.device)

    def save(root, stem, encoded):
        import os

        body, ct = encoded
        path = os.path.join(
            root, f"{stem}.{'jpg' if ct == 'image/jpeg' else 'ppm'}")
        with open(path, "wb") as fh:
            fh.write(body)
        return path

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body, ctype="text/html", status=200):
            try:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client gave up; not an error

        def _guarded(self, fn):
            try:
                fn()
            except Exception:  # noqa: BLE001 - the server goes on
                msg = traceback.format_exc()
                Log(f"GUI request {self.path} failed:\n{msg}", tag="Error")
                self._send(msg.encode(), "text/plain", status=500)

        def do_POST(self):
            self._guarded(self._post)

        def do_GET(self):
            self._guarded(self._get)

        def _post(self):
            url = urlparse(self.path)
            if url.path == "/pause":
                params.q_vis2main.put(Packet_vis2main(flag_pause=True))
            elif url.path == "/unpause":
                params.q_vis2main.put(Packet_vis2main(flag_pause=False))
            elif url.path == "/screenshot":
                import os

                q = parse_qs(url.query)
                root = os.path.join(params.save_dir or ".", "screenshots")
                os.makedirs(root, exist_ok=True)
                with state.lock:
                    state.n_shots += 1
                    n = state.n_shots
                saved = []
                img, _ = _render_view(state, [0.0] * 6)
                if img is not None:
                    saved.append(save(root, f"view_{n:04d}",
                                      _encode_jpg(img)))
                m3d = map3d_u8(q)
                if m3d is not None:
                    saved.append(save(root, f"map3d_{n:04d}",
                                      _encode_u8(m3d)))
                msg = ({"saved": ", ".join(saved)} if saved
                       else {"error": "nothing to save yet"})
                self._send(json.dumps(msg).encode(), "application/json")
                return
            self._send(b"ok", "text/plain")

        def _get(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                self._send(_PAGE.encode())
            elif url.path == "/stats":
                with state.lock:
                    g = state.gaussians
                    pkt = state.latest
                stats = {
                    "n_gaussians": int(g.n_active) if g is not None else 0,
                    "n_keyframes": len(pkt.keyframes),
                    "kf_window": {str(k): v for k, v in
                                  (pkt.kf_window or {}).items()},
                    "packets": state.n_frames,
                    "uptime_s": round(time.time() - state.t0, 1),
                }
                self._send(json.dumps(stats).encode(), "application/json")
            elif url.path == "/view.jpg":
                offs = [float(q.get(k, ["0"])[0]) for k in
                        ("dx", "dy", "dz", "pitch", "yaw", "roll")]
                img, _ = _render_view(state, offs)
                if img is None:
                    self._send(b"", "image/jpeg")
                    return
                self._send(*_encode_jpg(img))
            elif url.path == "/map3d.jpg":
                hwc = map3d_u8(q)
                if hwc is None:
                    self._send(b"", "image/jpeg")
                    return
                self._send(*_encode_u8(hwc))
            elif url.path == "/depth.jpg":
                _, depth = _render_view(state, [0.0] * 6)
                if depth is None:
                    self._send(b"", "image/jpeg")
                    return
                self._send(*_encode_jpg(_turbo(depth)))
            elif url.path == "/input.jpg":
                with state.lock:
                    gt = state.latest.gtcolor
                if gt is None:
                    self._send(b"", "image/jpeg")
                    return
                self._send(*_encode_jpg(torch.as_tensor(
                    gt, dtype=torch.float32, device=state.device)))
            else:
                self.send_response(404)
                self.end_headers()

    try:
        server = ThreadingHTTPServer(("0.0.0.0", params.port), Handler)
    except BaseException as e:
        params.error = e
        params.ready.set()
        raise
    # handler threads are joined when the server closes: a render in
    # flight ends before the run returns
    server.daemon_threads = False
    server.timeout = 0.5
    params.bound_port = server.server_address[1]
    params.ready.set()
    Log(f"GUI serving at http://localhost:{params.bound_port}", tag="GUI")
    drainer = threading.Thread(target=drain, name="monogs-gui-drain",
                               daemon=True)
    drainer.start()
    try:
        while not state.finished:
            server.handle_request()
    except BaseException as e:
        params.error = e
        raise
    finally:
        state.finished = True
        server.server_close()
    Log("GUI stopped", tag="GUI")


def start(params, timeout=60.0):
    """Run ``run(params)`` on a thread of its own and return
    ``(thread, port)`` once its server is bound (``params.port`` 0 binds a
    free port, the one returned). A server that could not bind raises
    here; ``params.error`` keeps an error that stops it later."""
    thread = threading.Thread(target=run, args=(params,), name="monogs-gui",
                              daemon=True)
    thread.start()
    if not params.ready.wait(timeout):
        raise RuntimeError(f"GUI: no server bound within {timeout} s")
    if params.error is not None:
        thread.join()
        raise RuntimeError(
            f"GUI could not serve on port {params.port}") from params.error
    return thread, params.bound_port
