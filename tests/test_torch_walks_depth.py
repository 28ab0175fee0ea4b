"""The stereo and RGB-D rigs in the port against the JAX package, one
configuration (752x480, 512 features, bf = 0.11 fx), so that the JAX
package's programs for it are built once per module: the stereo matchers
(``TestStereo``), the stereo and RGB-D walks end to end
(``TestE2eStereo``), the pipelined stereo walk at depth 1 and 2
(``TestE2eStereoPipeline``) and the keyframe policy of a rig with depth
(``TestE2eKfPolicy``). Each class keeps the module it came from as its
docstring, with its tolerances.
"""
import functools

import numpy as np
import pytest

from orbslam3_tpu.ops import camera as jcam
from orbslam3_tpu.ops import stereo as js
from orbslam3_tpu_torch.ops import stereo as ts
from torch_port_helpers import (J, N, T, check_depth_rig_ate, check_depth_rig_init,  # noqa: F401
                                check_depth_rig_keyframes_and_errors, depth_rig_runs,
                                torch_threads)

FX = 458.654
BF = 0.11 * FX
SF = (1.2 ** np.arange(8)).astype(np.float32)


def _stereo_features(rng, n=300):
    """Left/right features with every edge stereo_match gates on: disparity
    exactly at 0.1 and at bf/min_z, rows at the band's edge and just past it,
    octave offsets of ±1 and ±2, invalid features, and right descriptors
    duplicated (Hamming ties between columns)."""
    xy_l = rng.uniform([60, 10], [740, 470], (n, 2)).astype(np.float32)
    oct_l = rng.integers(0, 5, n).astype(np.int32)
    desc_l = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    disp = rng.uniform(0.5, 60.0, n).astype(np.float32)
    disp[::17] = 0.1
    disp[5::17] = np.float32(BF / 0.1)
    disp[9::23] = np.float32(BF / 0.1) + 1.0
    xy_r = np.stack([xy_l[:, 0] - disp, xy_l[:, 1]], 1).astype(np.float32)
    band = 2.0 * SF[oct_l]
    xy_r[3::11, 1] = xy_l[3::11, 1] + band[3::11]            # on the band's edge
    xy_r[4::13, 1] = xy_l[4::13, 1] - band[4::13] - 0.01     # just outside
    xy_r[:, 1] += rng.normal(0, 0.3, n).astype(np.float32) * (rng.random(n) < 0.5)
    oct_r = np.clip(oct_l + rng.integers(-2, 3, n), 0, 7).astype(np.int32)
    flip = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    flip &= rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    flip &= rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    desc_r = desc_l ^ (flip & rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32))
    desc_r[1::7] = desc_r[0::7][: len(desc_r[1::7])]           # duplicated columns
    xy_r[1::7] = xy_r[0::7][: len(xy_r[1::7])]
    valid_l = rng.random(n) < 0.9
    valid_r = rng.random(n) < 0.9
    perm = rng.permutation(n)                                  # columns unordered
    return (xy_l, desc_l, oct_l, valid_l,
            xy_r[perm], desc_r[perm], oct_r[perm], valid_r[perm])


@functools.lru_cache(maxsize=None)
def _rendered_pair():
    from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
    scene = RoomScene(seed=1)
    R, t = orbit_trajectory(2, radius=1.0, forward=0.04)[0]
    img_l, depth = scene.render(R, t, return_depth=True)
    Rr, tr = scene.stereo_pose(R, t, 0.11)
    img_r = scene.render(Rr, tr)
    return scene, img_l, img_r, depth


KB8 = np.asarray([190.978, 190.973, 256.0, 256.0, 0.00348, 0.000715, -0.00205, 0.000202],
                 np.float32)


class TestStereo:
    """ops/stereo.py: the port against the JAX package, on seeded inputs.

    Tolerances: stereo_match's idx / ok / ur bit-equal (ur is a gathered input
    value) and its depth within 1e-6 relative; subpixel_refine's ok equal and ur
    within 1e-3 px (the 121-pixel SAD sums run in another order in float32);
    depth_to_virtual_ur exact; fisheye_stereo_match's idx and ok equal and z
    within 1e-4 relative on at least 80% of the accepted points, within 1e-3 on
    all: the DLT's smallest eigenvector of AᵀA squares A's conditioning, and at
    depth/baseline up to 35 float32 leaves ~3e-4 of freedom in either package
    (test_torch_solvers.py::test_triangulation states the same).
    The features are synthetic and seeded: extraction differs between the
    packages at octaves >= 1 by the pyramid's rounding, so extracted features
    would test the extractor, not the matchers.
    """

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_stereo_match_exact(self, seed):
        rng = np.random.default_rng(seed)
        args = _stereo_features(rng)
        want = js.stereo_match(*[J(a) for a in args], J(SF), J(np.float32(BF)),
                               J(np.float32(0.1)))
        got = ts.stereo_match(*[T(a) for a in args], T(SF), T(np.float32(BF)),
                              T(np.float32(0.1)))
        ur_w, depth_w, ok_w = (N(x) for x in want)
        ur_g, depth_g, ok_g = (N(x) for x in got)
        assert ok_w.sum() > 50 and (~ok_w).sum() > 50
        np.testing.assert_array_equal(ok_g, ok_w)
        np.testing.assert_array_equal(ur_g, ur_w)
        np.testing.assert_allclose(depth_g, depth_w, rtol=1e-6)

    @pytest.mark.parametrize("all_matched", [False, True],
                             ids=["unmatched_features_median_off", "all_matched_median_on"])
    def test_subpixel_refine(self, all_matched):
        """Both median cases: with one unmatched feature jnp.median is NaN and the
        cut is off; with none it is the mean of the two middle values (an even
        count) and the cut is live."""
        scene, img_l, img_r, depth = _rendered_pair()
        rng = np.random.default_rng(3)
        n = 400
        xy = rng.uniform([20, 20], [scene.w - 20, scene.h - 20], (n, 2)).astype(np.float32)
        z = depth[np.round(xy[:, 1]).astype(int), np.round(xy[:, 0]).astype(int)]
        ur = (xy[:, 0] - scene.fx * 0.11 / z + rng.uniform(-1.5, 1.5, n)).astype(np.float32)
        ur[::10] += rng.uniform(-20, 20, len(ur[::10])).astype(np.float32)   # mismatches
        ok = np.ones(n, bool) if all_matched else rng.random(n) < 0.8
        want = js.subpixel_refine(J(img_l), J(img_r), J(xy), J(ur), J(ok))
        got = ts.subpixel_refine(T(img_l), T(img_r), T(xy), T(ur), T(ok))
        ok_w, ok_g = N(want[1]), N(got[1])
        np.testing.assert_array_equal(ok_g, ok_w)
        np.testing.assert_allclose(N(got[0]), N(want[0]), atol=1e-3, rtol=0)
        assert ok_w.sum() > 100

    def test_jitted_stereo_reference_is_bit_identical(self):
        """The JAX package's stereo matcher and subpixel refinement, which the
        port's module fixture runs jitted from host calls
        (``torch_port_helpers.jax_host_calls``), give bit for bit what their
        eager calls give: on this file's seeded features and both median cases,
        and on the JAX features of the first frame pairs of
        tests/test_e2e_stereo.py's stereo fixture (the frames the end-to-end
        stereo tests track)."""
        import jax
        from orbslam3_tpu.ops import features as jf
        from torch_port_helpers import DEPTH_RIG_BASELINE, depth_rig_inputs
        assert js.stereo_match.__wrapped__ is not js.stereo_match

        def same(call_a, call_b):
            a, b = call_a(), call_b()
            for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
                assert np.array_equal(N(x), N(y))
        gates = (J(SF), J(np.float32(BF)), J(np.float32(0.1)))
        for seed in (0, 1, 2):
            args = [J(a) for a in _stereo_features(np.random.default_rng(seed))] + list(gates)
            same(lambda: js.stereo_match.__wrapped__(*args), lambda: js.stereo_match(*args))
        scene, img_l, img_r, depth = _rendered_pair()
        rng = np.random.default_rng(3)
        xy = rng.uniform([20, 20], [scene.w - 20, scene.h - 20], (400, 2)).astype(np.float32)
        ur = (xy[:, 0] - rng.uniform(1, 40, 400)).astype(np.float32)
        for ok in (np.ones(400, bool), rng.random(400) < 0.8):
            args = (J(img_l), J(img_r), J(xy), J(ur), J(ok))
            same(lambda: js.subpixel_refine.__wrapped__(*args), lambda: js.subpixel_refine(*args))
        scene, _, frames = depth_rig_inputs("stereo")
        extract = jf.make_extractor(scene.h, scene.w, jf.OrbConfig(n_features=512))
        for left, right in frames[:3]:
            L, R = J(np.float32(left)), J(np.float32(right))
            fl, fr = extract(L), extract(R)
            args = (fl.xy, fl.desc, fl.octave, fl.valid, fr.xy, fr.desc, fr.octave, fr.valid,
                    J(SF), J(np.float32(DEPTH_RIG_BASELINE * scene.fx)), J(np.float32(0.1)))
            same(lambda: js.stereo_match.__wrapped__(*args), lambda: js.stereo_match(*args))
            ur_, _, ok_ = js.stereo_match(*args)
            same(lambda: js.subpixel_refine.__wrapped__(L, R, fl.xy, ur_, ok_),
                 lambda: js.subpixel_refine(L, R, fl.xy, ur_, ok_))

    def test_median_as_jax(self):
        """The median helper reproduces jnp.median: NaN in → NaN, odd and even
        counts (the even one is the mean of the two middle values)."""
        import jax.numpy as jnp
        rng = np.random.default_rng(4)
        for n in (1, 2, 7, 400):
            x = rng.normal(0, 100, n).astype(np.float32)
            np.testing.assert_array_equal(N(ts._median_as_jax(T(x))), np.asarray(jnp.median(J(x))))
            x[n // 2] = np.nan
            assert np.isnan(N(ts._median_as_jax(T(x))))

    def test_depth_to_virtual_ur(self):
        rng = np.random.default_rng(5)
        xy = rng.uniform(0, 700, (200, 2)).astype(np.float32)
        z = rng.uniform(-1.0, 8.0, 200).astype(np.float32)
        z[::9] = 0.0
        for g, w in zip(ts.depth_to_virtual_ur(T(xy), T(z), float(np.float32(BF))),
                        js.depth_to_virtual_ur(J(xy), J(z), J(np.float32(BF)))):
            np.testing.assert_array_equal(N(g), N(w))

    def test_fisheye_stereo_match(self):
        from orbslam3_tpu.ops import lie as jlie
        rng = np.random.default_rng(6)
        n = 320
        R_rl = np.asarray(jlie.so3_exp(J(np.float32([0.0, 0.008, 0.0]))))
        t_rl = np.float32([-0.101, 0.0, 0.0])
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(0.8, 3.5, n)], 1).astype(np.float32)
        uv_l = np.asarray(jcam.kb8_project(J(KB8), J(X)))
        uv_r = np.asarray(jcam.kb8_project(J(KB8), J(X @ R_rl.T + t_rl)))
        uv_l = (uv_l + rng.normal(0, 0.2, uv_l.shape)).astype(np.float32)
        uv_r = (uv_r + rng.normal(0, 0.2, uv_r.shape)).astype(np.float32)
        uv_r[::8] += rng.normal(0, 30, uv_r[::8].shape).astype(np.float32)  # bad geometry
        oct_l = rng.integers(0, 4, n).astype(np.int32)
        oct_r = np.clip(oct_l + rng.integers(-2, 3, n), 0, 7).astype(np.int32)
        desc_l = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        flip = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        flip &= rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        flip &= rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        desc_r = desc_l ^ (flip & rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32))
        desc_r[3::13] = desc_r[2::13][: len(desc_r[3::13])]         # duplicated right rows
        valid_l = rng.random(n) < 0.92
        valid_r = rng.random(n) < 0.92
        perm = rng.permutation(n)
        uv_r, desc_r, oct_r, valid_r = uv_r[perm], desc_r[perm], oct_r[perm], valid_r[perm]
        lap_l = np.float32([20.0, 490.0])
        lap_r = np.float32([0.0, 511.0])
        ls2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
        args = (uv_l, desc_l, oct_l, valid_l, uv_r, desc_r, oct_r, valid_r,
                KB8, KB8, R_rl, t_rl, lap_l, lap_r, ls2)
        idx_w, ok_w, z_w, _ = js.fisheye_stereo_match(
            *[J(a) for a in args], J(np.float32(0.7)), J(np.int32(50)))
        idx_g, ok_g, z_g, _ = ts.fisheye_stereo_match(*[T(a) for a in args], 0.7, 50)
        ok_w = N(ok_w)
        assert ok_w.sum() > 100 and (~ok_w).sum() > 30, (ok_w.sum(), (~ok_w).sum())
        np.testing.assert_array_equal(N(idx_g), N(idx_w))
        np.testing.assert_array_equal(N(ok_g), ok_w)
        rel = np.abs(N(z_g)[ok_w] / N(z_w)[ok_w] - 1.0)
        assert (rel < 1e-4).mean() >= 0.8 and rel.max() < 1e-3, (np.sort(rel)[-5:])
        np.testing.assert_array_equal(N(z_g)[~ok_w], -1.0)


class TestE2eStereo:
    """Stereo and RGB-D end to end: the JAX SlamSystem and the port's on
    tests/test_e2e_stereo.py's fixtures, both on the CPU with the same rendered
    frames — RoomScene(seed=2) (stereo, baseline 0.11, right eye from
    scene.stereo_pose) and RoomScene(seed=3) (RGB-D, the renderer's depth), each
    orbit_trajectory(14, radius=0.6, forward=0.03), 512 features, bf = 0.11·fx,
    th_depth = 0.11·40, dense_tracking_params() (no software pipeline), loop
    closing on (the default).

    Bounds (torch_port_helpers.check_depth_rig_*): both initialize on frame 0;
    the port's metric ATE is no worse than max(1.5 x JAX, JAX + 0.02); keyframe
    counts within ±2; every thread and query error count 0.
    """

    @pytest.fixture(scope="class", params=["stereo", "rgbd"])
    def runs(self, request):
        return depth_rig_runs(request.param)

    def test_initializes_on_the_same_frame(self, runs):
        check_depth_rig_init(runs)

    def test_metric_ate_within_reference(self, runs):
        check_depth_rig_ate(runs)

    def test_keyframes_and_errors(self, runs):
        check_depth_rig_keyframes_and_errors(runs)


class TestE2eStereoPipeline:
    """The pipelined stereo front end (``TrackingParams(pipeline=True)``, the
    configuration of bench.py's stereo rig) at pipeline depth 1 and 2, the JAX
    SlamSystem against the port's on tests/test_e2e_stereo.py's stereo fixture,
    both on the CPU with the same rendered frames and sync mapping.

    The port keeps each frame's right-x vector on the device for the fused step
    and reads it back only where host code needs depth; at depth 2 two frames
    are in flight, each with its own vector. Bounds as in
    ``TestE2eStereo`` of this module (torch_port_helpers.check_depth_rig_*), and
    the pipeline holds ``depth`` frames after the last call in both packages and
    tracks through the fused path.
    """

    @pytest.fixture(scope="class", params=[1, 2])
    def runs(self, request):
        return depth_rig_runs("stereo", pipeline=True, pipeline_depth=request.param)

    def test_initializes_on_the_same_frame(self, runs):
        check_depth_rig_init(runs)
        depth = runs["params"]["pipeline_depth"]
        assert runs["jax"]["in_flight"] == runs["torch"]["in_flight"] == depth
        assert runs["torch"]["paths"]["fused"] >= 8, runs["torch"]["paths"]

    def test_metric_ate_within_reference(self, runs):
        check_depth_rig_ate(runs)

    def test_keyframes_and_errors(self, runs):
        check_depth_rig_keyframes_and_errors(runs)


class TestE2eKfPolicy:
    """The keyframe policy of a rig with depth (``kf_interval_override=0``: the
    reference's c1a/c1b/c1c/c2 conditions with the close-point triggers), the
    JAX SlamSystem against the port's on tests/test_e2e_stereo.py's stereo and
    RGB-D fixtures, both on the CPU with the same rendered frames.

    After a stereo initialization the map has one keyframe, whose points have one
    observation each, so no point passes the reference-points filter and only the
    close-point trigger (fewer than 100 tracked and more than 70 untracked
    features closer than th_depth) can make a keyframe. With the fixtures' 40
    baselines (4.4 m) about 5 features of this 6 m deep room are close and the
    trigger never fires in 14 frames; at 50 baselines (5.5 m) it fires in both
    packages (JAX: stereo at frames 9 and 12, RGB-D at frame 13), so the policy
    runs here at 50. The stereo case runs the software pipeline at depth 1, so
    the policy reads each tracked frame's depth back from the fused step's copy.
    Bounds as in ``TestE2eStereo`` of this module (torch_port_helpers.check_depth_rig_*),
    and the policy made a keyframe after the first in both packages.
    """

    @pytest.fixture(scope="class", params=["stereo", "rgbd"])
    def runs(self, request):
        params = dict(kf_interval_override=0)
        if request.param == "stereo":
            params.update(pipeline=True, pipeline_depth=1)
        return depth_rig_runs(request.param, th_depth_baselines=50.0, **params)

    def test_initializes_on_the_same_frame(self, runs):
        check_depth_rig_init(runs)

    def test_metric_ate_within_reference(self, runs):
        check_depth_rig_ate(runs)

    def test_keyframes_and_errors(self, runs):
        check_depth_rig_keyframes_and_errors(runs)
        for name in ("jax", "torch"):
            assert runs[name]["stats"]["n_keyframes"] >= 2, (name, runs[name]["stats"])
