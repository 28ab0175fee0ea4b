"""Headless visualization: map rendering, the frame overlay and the live
HTTP viewer.

Port of ``orbslam3_tpu/models/viewer.py`` without matplotlib or OpenCV (the
machine with the card has neither): a numpy rasterizer draws the map and
``utils/imageio.py`` writes the PNG.

- ``render_map`` draws what the JAX package's matplotlib figure shows: the
  map points (black), the keyframe frusta (blue), the covisibility edges of
  weight >= 100 (green) and the trajectory (red), in the axes (x, z, -y)
  seen from the same view (elevation -60°, azimuth -90°), projected
  orthographically and fitted to the image. It returns the ``MapView`` it
  drew with, whose ``project`` gives the pixel of any world point.
- ``draw_frame`` draws the pixels of the JAX function (``cv2.rectangle`` /
  ``cv2.circle``) inside the image: a 7x7 green box outline at each tracked
  keypoint, a blue radius-1 dot at each other one; below it a 22-row status
  bar in a small bitmap font.
- ``LiveViewer`` serves the page, ``/map.png``, ``/frame.png``, ``/state``,
  ``/toggle`` and ``/action`` on 127.0.0.1 (port 0: a free port, read back
  from ``LiveViewer.port``).
"""
from __future__ import annotations

import numpy as np

from ..utils import imageio

# 5x7 glyphs, one byte per row (bit 4 = leftmost column)
_GLYPHS = {
    " ": "00000000000000", "|": "04040404040404", ":": "00000400000400",
    ".": "00000000000004", "-": "00000001f00000", "_": "0000000000001f",
    "0": "0e11131519110e", "1": "040c040404040e", "2": "0e11010204081f",
    "3": "1f02040201110e", "4": "02060a121f0202", "5": "1f101e0101110e",
    "6": "0608101e11110e", "7": "1f010204080808", "8": "0e11110e11110e",
    "9": "0e11110f01020c",
}
for _c, _rows in {
        "A": "0e11111f111111", "B": "1e11111e11111e", "C": "0e11101010110e",
        "D": "1c12111111121c", "E": "1f10101e10101f", "F": "1f10101e101010",
        "G": "0e11101713110f", "H": "1111111f111111", "I": "0e04040404040e",
        "J": "0702020202120c", "K": "11121418141211", "L": "1010101010101f",
        "M": "111b1515111111", "N": "11111915131111", "O": "0e11111111110e",
        "P": "1e11111e101010", "Q": "0e111111151209", "R": "1e11111e141211",
        "S": "0f10100e01011e", "T": "1f040404040404", "U": "1111111111110e",
        "V": "11111111110a04", "W": "11111115151b11", "X": "11110a040a1111",
        "Y": "1111110a040404", "Z": "1f01020408101f"}.items():
    _GLYPHS[_c] = _rows
    _GLYPHS[_c.lower()] = _rows

_BLACK = (0, 0, 0)
_BLUE = (0, 0, 255)          # RGB
_GREEN = (0, 160, 0)
_RED = (220, 0, 0)


def _text(canvas: np.ndarray, text: str, x: int, y: int, color) -> None:
    """Draw ``text`` with its top-left corner at (x, y), clipped."""
    h, w = canvas.shape[:2]
    for ch in text:
        rows = _GLYPHS.get(ch, _GLYPHS[" "])
        for r in range(7):
            bits = int(rows[2 * r: 2 * r + 2], 16)
            for c in range(5):
                if bits >> (4 - c) & 1 and 0 <= y + r < h and 0 <= x + c < w:
                    canvas[y + r, x + c] = color
        x += 6


class MapView:
    """The orthographic view of ``render_map``: world points → the axes
    (x, z, -y) → the screen plane of (elev, azim) → pixels."""

    def __init__(self, elev: float, azim: float, lo, hi, size, margin: int = 40):
        e, a = np.deg2rad(elev), np.deg2rad(azim)
        eye = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
        up = np.array([0.0, 0.0, 1.0]) - np.sin(e) * eye
        self.up = up / np.linalg.norm(up)
        self.right = np.cross(self.up, eye)
        self.size = size
        corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])])
        s = self._screen(corners, axes=True)
        self.s_lo, s_hi = s.min(0), s.max(0)
        span = np.maximum(s_hi - self.s_lo, 1e-6)
        w, h = size
        self.scale = min((w - 2 * margin) / span[0], (h - 2 * margin) / span[1])
        self.offset = np.array([(w - self.scale * span[0]) / 2, (h - self.scale * span[1]) / 2])

    @staticmethod
    def axes(P) -> np.ndarray:
        P = np.asarray(P, np.float64).reshape(-1, 3)
        return np.stack([P[:, 0], P[:, 2], -P[:, 1]], -1)

    def _screen(self, P, axes=False):
        A = P if axes else self.axes(P)
        return np.stack([A @ self.right, A @ self.up], -1)

    def project(self, P) -> np.ndarray:
        """(N,3) world points → (N,2) float pixel (column, row)."""
        s = (self._screen(P) - self.s_lo) * self.scale + self.offset
        return np.stack([s[:, 0], self.size[1] - 1 - s[:, 1]], -1)


def _dots(canvas, px, color, radius: int = 0):
    h, w = canvas.shape[:2]
    ij = np.round(px).astype(np.int64)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            x, y = ij[:, 0] + dx, ij[:, 1] + dy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            canvas[y[ok], x[ok]] = color


def _lines(canvas, a, b, color):
    """Segments a[i] → b[i] (pixels), sampled at least once per pixel."""
    if len(a) == 0:
        return
    n = np.maximum(np.ceil(np.abs(b - a).max(1)).astype(np.int64), 1) + 1
    seg = np.repeat(np.arange(len(a)), n)
    start = np.cumsum(n) - n
    f = (np.arange(n.sum()) - np.repeat(start, n)) / np.repeat(n - 1, n)
    _dots(canvas, a[seg] + (b - a)[seg] * f[:, None], color)


def render_map(map_state, path: str, trajectory=None, show_covisibility=True,
               max_points: int = 5000, elev: float = -60, azim: float = -90,
               size=(1100, 880)) -> MapView:
    """Write a PNG of the map (points, keyframe frusta, covisibility edges of
    weight >= 100, trajectory) to ``path``; returns the view."""
    m = map_state
    mps = m.valid_mp_ids()
    if len(mps) > max_points:
        mps = mps[np.linspace(0, len(mps) - 1, max_points).astype(int)]
    P = m.mp_xyz[mps].astype(np.float64) if len(mps) else np.zeros((0, 3))
    kfs = m.valid_kf_ids()
    # frustum: 4 image-corner rays at depth 0.12
    corners = np.array([[-0.16, -0.1, 0.12], [0.16, -0.1, 0.12],
                        [0.16, 0.1, 0.12], [-0.16, 0.1, 0.12]])
    centers = np.array([-m.kf_R[k].T @ m.kf_t[k] for k in kfs]).reshape(-1, 3)
    fr = np.array([(corners @ m.kf_R[k]) + c for k, c in zip(kfs, centers)]).reshape(-1, 4, 3)
    traj = np.zeros((0, 3)) if trajectory is None else np.asarray(trajectory, np.float64)
    allp = np.concatenate([P, centers, fr.reshape(-1, 3), traj.reshape(-1, 3)])
    if len(allp) == 0:
        allp = np.zeros((1, 3))
    A = MapView.axes(allp)
    view = MapView(elev, azim, A.min(0), A.max(0), size)
    canvas = np.full((size[1], size[0], 3), 255, np.uint8)
    if len(P):
        _dots(canvas, view.project(P), (90, 90, 90))
    if show_covisibility and len(kfs) > 1:
        a, b = [], []
        for i, k in enumerate(kfs):
            row = m.covisibility_row(int(k))
            for j in np.nonzero(row >= 100)[0]:
                jj = np.nonzero(kfs == j)[0]
                if len(jj) and jj[0] > i:
                    a.append(centers[i])
                    b.append(centers[jj[0]])
        if a:
            _lines(canvas, view.project(np.array(a)), view.project(np.array(b)), _GREEN)
    if len(kfs):
        c4 = np.repeat(centers, 4, axis=0)
        edges_a = np.concatenate([fr.reshape(-1, 3), c4])
        edges_b = np.concatenate([np.roll(fr, -1, axis=1).reshape(-1, 3), fr.reshape(-1, 3)])
        _lines(canvas, view.project(edges_a), view.project(edges_b), _BLUE)
    if len(traj) > 1:
        pt = view.project(traj)
        _lines(canvas, pt[:-1], pt[1:], _RED)
    _text(canvas, f"{len(mps)} map points  {len(kfs)} keyframes", 10, 10, _BLACK)
    imageio.imwrite(path, canvas[..., ::-1])
    return view


def draw_frame(img: np.ndarray, frame, state_name: str = "OK") -> np.ndarray:
    """Per-frame overlay, (h + 22, w, 3) uint8 BGR: tracked keypoints as
    7x7 green box outlines, untracked ones as blue radius-1 dots, drawn in
    keypoint order, then the status bar."""
    g = np.clip(img, 0, 255).astype(np.uint8)
    vis = np.repeat(g[..., None], 3, axis=-1)
    h, w = g.shape
    n_tracked = 0
    for i in np.nonzero(frame.valid)[0]:
        x, y = int(frame.xy[i, 0]), int(frame.xy[i, 1])
        if frame.feat_mp[i] >= 0:
            x0, x1 = max(x - 3, 0), min(x + 3, w - 1)
            y0, y1 = max(y - 3, 0), min(y + 3, h - 1)
            if x0 <= x1 and y0 <= y1:
                for yy in (y - 3, y + 3):
                    if 0 <= yy < h:
                        vis[yy, x0: x1 + 1] = (0, 255, 0)
                for xx in (x - 3, x + 3):
                    if 0 <= xx < w:
                        vis[y0: y1 + 1, xx] = (0, 255, 0)
            n_tracked += 1
        else:
            for dx, dy in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
                if 0 <= x + dx < w and 0 <= y + dy < h:
                    vis[y + dy, x + dx] = (255, 0, 0)
    bar = np.zeros((22, w, 3), np.uint8)
    _text(bar, f"{state_name} | matches: {n_tracked} | kps: {int(frame.valid.sum())}",
          8, 8, (255, 255, 255))
    return np.concatenate([vis, bar], axis=0)


class LiveViewer:
    """The live viewer over HTTP (the reference's Pangolin viewer thread,
    headless): a thread renders the map and the current-frame overlay at
    ``fps`` and a stdlib HTTP server on 127.0.0.1 serves an auto-refreshing
    page with the reference's menu actions.

    Endpoints: ``/`` (page), ``/map.png``, ``/frame.png``, ``/state``
    (JSON), ``/toggle?key=...`` (show_points / show_kfs / show_graph /
    follow), ``/action?do=reset|localization|mapping``. ``port=0`` binds a
    free port; ``self.port`` is the bound one."""

    def __init__(self, system, port: int = 8642, fps: float = 2.0):
        import threading
        from http.server import ThreadingHTTPServer
        self.system = system
        self.period = 1.0 / max(fps, 0.1)
        self.toggles = {"show_points": True, "show_kfs": True,
                        "show_graph": True, "follow": False}
        self._map_png = b""
        self._frame_png = b""
        self._stop = threading.Event()
        self.render_errors = 0
        self.last_render_error = None
        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), self._handler())
        self.port = self._httpd.server_address[1]
        self._render_t = threading.Thread(target=self._render_loop, name="viewer-render",
                                          daemon=True)
        self._serve_t = threading.Thread(target=self._httpd.serve_forever,
                                         kwargs={"poll_interval": 0.3}, name="viewer-http",
                                         daemon=True)
        self._render_t.start()
        self._serve_t.start()

    # -- rendering -------------------------------------------------------
    def _render_once(self):
        import os
        import tempfile
        sysm = self.system
        m = sysm.map
        with m.lock:
            _, _, t_wc, _ = sysm.tracker.export_trajectory()
            fd, tmp = tempfile.mkstemp(suffix=".png")
            os.close(fd)
            try:
                render_map(m, tmp, trajectory=t_wc,
                           show_covisibility=self.toggles["show_graph"],
                           max_points=4000 if self.toggles["show_points"] else 0)
                with open(tmp, "rb") as f:
                    self._map_png = f.read()
            finally:
                os.unlink(tmp)
        lf = sysm.tracker.last_frame
        if lf is not None and lf.feat_mp is not None:
            w, h = int(sysm.tracker.wh[0]), int(sysm.tracker.wh[1])
            vis = draw_frame(np.full((h, w), 16, np.float32), lf, sysm.tracker.state.name)
            self._frame_png = imageio.encode_png(vis)

    def _render_loop(self):
        while not self._stop.is_set():
            try:
                self._render_once()
            except Exception as e:     # the viewer never stops the system; counted
                self.render_errors += 1
                self.last_render_error = repr(e)
            self._stop.wait(self.period)

    # -- http ------------------------------------------------------------
    def _handler(self):
        import json
        from http.server import BaseHTTPRequestHandler
        from urllib.parse import parse_qs, urlparse
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="text/html"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path == "/map.png":
                    self._send(200, viewer._map_png, "image/png")
                elif u.path == "/frame.png":
                    self._send(200, viewer._frame_png, "image/png")
                elif u.path == "/state":
                    st = viewer.system.stats()
                    st.pop("stage_times", None)
                    self._send(200, json.dumps(st, default=str).encode(), "application/json")
                elif u.path == "/toggle":
                    k = q.get("key", [""])[0]
                    if k in viewer.toggles:
                        viewer.toggles[k] = not viewer.toggles[k]
                    self._send(200, b"ok", "text/plain")
                elif u.path == "/action":
                    do = q.get("do", [""])[0]
                    if do == "reset":
                        viewer.system.reset()
                    elif do == "localization":
                        viewer.system.activate_localization_mode()
                    elif do == "mapping":
                        viewer.system.deactivate_localization_mode()
                    self._send(200, b"ok", "text/plain")
                else:
                    page = ("<html><head><title>orbslam3_tpu_torch</title>"
                            "<meta http-equiv='refresh' content='2'></head>"
                            "<body style='background:#111;color:#ddd;font-family:monospace'>"
                            "<h3>orbslam3_tpu_torch live viewer</h3>"
                            "<a href='/toggle?key=show_points'>points</a> | "
                            "<a href='/toggle?key=show_graph'>graph</a> | "
                            "<a href='/action?do=localization'>localization</a> | "
                            "<a href='/action?do=mapping'>mapping</a> | "
                            "<a href='/action?do=reset'>RESET</a><br>"
                            "<img src='/map.png' height='420'> "
                            "<img src='/frame.png' height='420'>"
                            "</body></html>").encode()
                    self._send(200, page)

        return Handler

    def close(self):
        """Stop both threads and free the port."""
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._render_t.join(10.0)
