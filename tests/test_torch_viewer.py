"""The port's viewer (``orbslam3_tpu_torch/models/viewer.py``: numpy
rasterizer, the port's PNG writer, no matplotlib or OpenCV) on the CPU.

``draw_frame`` draws the JAX function's pixels exactly above the status bar
(the bar's text is a bitmap font of its own). ``render_map`` writes a PNG the
port's reader and OpenCV decode, with each keyframe frustum's corners blue
where the returned view projects them. ``LiveViewer`` (port 0: a free port,
so that it never meets tests/test_viewer.py's 8698) serves the page, the map
PNG, the state and the menu actions, and ``shutdown`` frees its port."""
import socket
import time
import urllib.request
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from test_serialization import _toy_map
from orbslam3_tpu.models import viewer as jviewer
from orbslam3_tpu.utils import serialization as jser
from orbslam3_tpu_torch.models import viewer as tviewer
from orbslam3_tpu_torch.models.system import SlamSystem
from orbslam3_tpu_torch.utils import imageio
from orbslam3_tpu_torch.utils.convert import map_state_from_arrays

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)


def _frame(seed: int, n: int, w: int, h: int):
    rng = np.random.default_rng(seed)
    return SimpleNamespace(valid=rng.random(n) > 0.1,
                           xy=rng.uniform(-4, [w + 4, h + 4], (n, 2)).astype(np.float32),
                           feat_mp=np.where(rng.random(n) > 0.5, rng.integers(0, 99, n), -1))


@pytest.mark.parametrize("seed,n,w,h", [(0, 300, 100, 80), (1, 1000, 376, 240), (2, 5, 9, 7)])
def test_draw_frame_pixels_equal_jax(seed, n, w, h):
    img = np.random.default_rng(seed + 10).uniform(-20, 280, (h, w)).astype(np.float32)
    f = _frame(seed, n, w, h)
    want = jviewer.draw_frame(img, f, "OK")
    got = tviewer.draw_frame(img, f, "OK")
    assert got.shape == want.shape == (h + 22, w, 3) and got.dtype == want.dtype
    assert np.array_equal(got[:h], want[:h])
    assert got[h:].any()                        # the status bar carries text


def test_render_map_draws_the_frusta_where_the_view_projects_them(tmp_path):
    jm = _toy_map(0)
    m = map_state_from_arrays({k: v for k, v in vars(jm).items()
                               if isinstance(v, (np.ndarray, int))}, jm.cfg)
    path = str(tmp_path / "map.png")
    view = tviewer.render_map(m, path)
    img = imageio.imread(path)
    assert img.shape == (880, 1100, 3)
    assert np.array_equal(img, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    corners = np.array([[-0.16, -0.1, 0.12], [0.16, -0.1, 0.12],
                        [0.16, 0.1, 0.12], [-0.16, 0.1, 0.12]])
    for k in m.valid_kf_ids():
        c = -m.kf_R[k].T @ m.kf_t[k]
        px = np.round(view.project(corners @ m.kf_R[k] + c)).astype(int)
        for col, row in px:
            assert tuple(img[row, col]) == (255, 0, 0), (k, col, row)   # BGR blue
    # the map points are drawn: grey pixels
    assert (img == 90).all(-1).sum() >= 10


def _get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=20).read()


def test_live_viewer_serves_on_a_free_port(tmp_path):
    atlas_dir = str(tmp_path / "atlas")
    from orbslam3_tpu.models.atlas import Atlas
    a = Atlas(_toy_map(3).cfg)
    a.maps[0] = _toy_map(3)
    jser.save_atlas(a, atlas_dir)
    slam = SlamSystem(K, None, (752, 480), n_features=256, enable_loop_closing=False,
                      use_viewer=True, viewer_port=0, device="cpu")
    try:
        port = slam.viewer.port
        assert port > 0
        slam.load_map(atlas_dir)
        base = f"http://127.0.0.1:{port}"
        t0 = time.monotonic()
        while not slam.viewer._map_png and time.monotonic() - t0 < 30:
            time.sleep(0.05)
        assert b"live viewer" in _get(base + "/")
        png = _get(base + "/map.png")
        assert png[:4] == b"\x89PNG" and imageio.decode_png(png).shape == (880, 1100, 3)
        assert b"n_keyframes" in _get(base + "/state")
        g0 = slam.viewer.toggles["show_graph"]
        _get(base + "/toggle?key=show_graph")
        assert slam.viewer.toggles["show_graph"] != g0
        _get(base + "/action?do=localization")
        assert slam.tracker.only_tracking
        _get(base + "/action?do=mapping")
        assert not slam.tracker.only_tracking
        assert slam.viewer.render_errors == 0, slam.viewer.last_render_error
    finally:
        slam.shutdown(print_times=False)
    assert slam.viewer is None
    with socket.socket() as s:                # no one listens on the port again
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
