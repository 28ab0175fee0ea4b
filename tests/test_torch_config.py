"""The port's settings loader (``orbslam3_tpu_torch/utils/config.py``, no
OpenCV) against the JAX package's (``cv2.FileStorage``) on the CPU.

Tolerances: every ``SlamConfig`` field equal, types and dtypes included; the
rectification maps within 1e-3 px of ``cv2.initUndistortRectifyMap``'s and
the device resampling within 1e-3 grey levels of ``cv2.remap``'s; the
systems built from a file carry equal K, D, bf, th_depth, rig and IMU
noise."""
import dataclasses

import cv2
import numpy as np
import pytest

from test_config import EUROC_YAML, RECT_BLOCK
from orbslam3_tpu.utils import config as jcfg
from orbslam3_tpu_torch.utils import config as tcfg

STEREO_EXTRA = """Camera.bf: 47.90639384423901
ThDepth: 35.0
DepthMapFactor: 5000.0
thFarPoints: 20.0
Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
"""

KB8_RIG = """%YAML:1.0
# a two-camera KB8 rig (TUM-VI style)
Camera.type: "KannalaBrandt8"
Camera.fx: 190.978477
Camera.fy: 190.973307
Camera.cx: 254.931706
Camera.cy: 256.897442
Camera.k1: 0.003482389402
Camera.k2: 0.000715034845
Camera.k3: -0.002053236141
Camera.k4: 0.000202936736
Camera.width: 512
Camera.height: 512
Camera.fps: 20.0
Camera.RGB: 1
Camera.lappingBegin: 0
Camera.lappingEnd: 511
Camera2.fx: 190.442369
Camera2.fy: 190.4344807
Camera2.cx: 252.597872
Camera2.cy: 254.917235
Camera2.k1: 0.0034003170790442797
Camera2.k2: 0.001766278153469831
Camera2.k3: -0.00266312569781606
Camera2.k4: 0.0003299517423931039
Camera2.lappingBegin: 0
Camera2.lappingEnd: 511
Tlr: !!opencv-matrix
   rows: 3
   cols: 4
   dt: f
   data: [0.999997256477881, 0.002312067192424, 0.000376008102415, -0.101079535761,
          -0.002317135723281, 0.999898048506644, 0.014089835846648, 0.001985616929,
          -0.000343393120525, -0.014090668452683, 0.999900662637729, -0.001118386423]
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200
"""

YAMLS = {"euroc": EUROC_YAML, "euroc_stereo": EUROC_YAML + RECT_BLOCK + STEREO_EXTRA,
         "kb8_rig": KB8_RIG, "minimal": "%YAML:1.0\nCamera.fx: 100\nCamera.fy: 100.0\n"
         "Camera.cx: 50\nCamera.cy: 40.5\nCamera.type: PinHole\n"}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_load_config_field_for_field(tmp_path, name):
    path = tmp_path / f"{name}.yaml"
    path.write_text(YAMLS[name])
    j, t = jcfg.load_config(str(path)), tcfg.load_config(str(path))
    for f in dataclasses.fields(jcfg.SlamConfig):
        assert _equal(getattr(j, f.name), getattr(t, f.name)), (
            f.name, getattr(j, f.name), getattr(t, f.name))


def test_missing_required_key_raises(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text('%YAML:1.0\nCamera.fx: 100.0\n')
    with pytest.raises(ValueError, match=r"Camera\.fy.*Camera\.cx.*Camera\.cy"):
        tcfg.load_config(str(path))
    with pytest.raises(ValueError):
        jcfg.load_config(str(path))


def test_matrix_nodes_read_as_cv2_reads_them(tmp_path):
    path = tmp_path / "m.yaml"
    path.write_text(YAMLS["euroc_stereo"])
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
    got = tcfg.read_settings(str(path))
    for key in ("LEFT.K", "LEFT.P", "RIGHT.D", "Tbc"):
        want = fs.getNode(key).mat()
        assert got[key].dtype == want.dtype and np.array_equal(got[key], want), key
    assert got["Camera.type"] == fs.getNode("Camera.type").string()
    assert got["ORBextractor.nFeatures"] == fs.getNode("ORBextractor.nFeatures").real()
    fs.release()


def test_rectification_maps_and_resampling_match_cv2(tmp_path):
    path = tmp_path / "stereo.yaml"
    path.write_text(YAMLS["euroc_stereo"])
    want = jcfg.load_config(str(path)).stereo_rectify_maps()
    got = tcfg.load_config(str(path)).stereo_rectify_maps()
    for cam in range(2):
        for axis in range(2):
            assert got[cam][axis].dtype == np.float32
            np.testing.assert_allclose(got[cam][axis], want[cam][axis], rtol=0, atol=1e-3)
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.uniform(0, 255, (480, 752)).astype(np.float32), (0, 0), 2.0)
    for cam in range(2):
        ref = cv2.remap(img, want[cam][0], want[cam][1], cv2.INTER_LINEAR)
        out = tcfg.rectify(img, got[cam], device="cpu").numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["euroc_stereo", "kb8_rig"])
def test_system_from_config(tmp_path, name):
    """The same camera, depth, rig and IMU configuration in both packages'
    systems; only ``n_features`` of the ORBextractor keys reaches them."""
    path = tmp_path / f"{name}.yaml"
    path.write_text(YAMLS[name])
    j = jcfg.system_from_config(str(path), enable_loop_closing=False)
    t = tcfg.system_from_config(str(path), enable_loop_closing=False, device="cpu")
    jt, tt = j.tracker, t.tracker
    for attr in ("cam_params", "K", "D"):
        a, b = getattr(jt, attr), getattr(tt, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=attr)
    assert (jt.bf, jt.th_depth, jt.cam_type) == (tt.bf, tt.th_depth, tt.cam_type)
    assert j.orb_cfg.n_features == t.orb_cfg.n_features
    assert (jt.imu_enabled, jt.imu_freq) == (tt.imu_enabled, tt.imu_freq)
    np.testing.assert_array_equal(np.asarray(jt.imu_noise), np.asarray(tt.imu_noise))
    assert (jt.rig is None) == (tt.rig is None)
    if jt.rig is not None:
        for k in jt.rig:
            np.testing.assert_allclose(np.asarray(jt.rig[k]), np.asarray(tt.rig[k]),
                                       rtol=0, atol=1e-7, err_msg=k)
