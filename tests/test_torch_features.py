"""ops/features.py: the port's ORB extractor against the JAX package.

The pyramid is compared level by level (the port rebuilds JAX's antialiased
resize weights; the matrix products sum in another order). Everything
downstream of the pyramid — FAST, NMS, top-k, IC angle, steered BRIEF — is
compared on the SAME level image, where it must be exact except the IC
angle's float sums. The whole extractor is compared with a stated mismatch
rate, since a 1e-5 pyramid difference can flip a BRIEF comparison of two
equal blurred pixels in the texture's flat regions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.ops import features as jf
from orbslam3_tpu_torch.ops import features as tf
from torch_port_helpers import J, N, T, as_i32, room_frames, torch_threads  # noqa: F401

CFG = jf.OrbConfig(n_features=512)
TCFG = tf.OrbConfig(n_features=512)


@pytest.fixture(scope="module")
def image():
    _, frames = room_frames()
    return frames[1]["img"]


_jax_extract = jax.jit(lambda im: jf.extract_orb(im, CFG))


def _jax_levels(img):
    shapes = jf._level_shapes(*img.shape, CFG)
    out = [jnp.asarray(img)]
    for s in shapes[1:]:
        out.append(jax.image.resize(out[-1], s, method="bilinear"))
    return [np.asarray(x) for x in out]


def test_config_and_capacities_match():
    assert TCFG.capacities == CFG.capacities
    assert TCFG.total_capacity == CFG.total_capacity
    for a, b in zip(tf.scale_factors(8, 1.2), jf.scale_factors(8, 1.2)):
        np.testing.assert_array_equal(a, b)


def test_pyramid_levels(image):
    """Each level, resized from the previous JAX level: |diff| <= 2e-5 x 255
    (float32 rounding of 3-4 tap sums in another order)."""
    ref = _jax_levels(image)
    W = tf.pyramid_weights(*image.shape, TCFG, "cpu")
    for lvl in range(1, 8):
        got = N(tf.resize_level(T(ref[lvl - 1]), *W[lvl - 1]))
        assert got.shape == ref[lvl].shape
        np.testing.assert_allclose(got, ref[lvl], rtol=0, atol=2e-5 * 255, err_msg=f"level {lvl}")


@pytest.mark.parametrize("kind", ["noise", "steps", "flat"])
def test_fast_response_exact(kind):
    """FAST's two corner masks and arc score, bit-equal to JAX's ring bit
    masks on seeded images whose ring differences often equal a threshold
    (integer noise; steps of 60 against thresholds 60 and 0; a flat image),
    down to a 7x9 level, where the ring wraps around the border."""
    rng = np.random.default_rng(11)
    for h, w in ((120, 188), (7, 9)):
        if kind == "noise":
            img = rng.integers(0, 256, (h, w)).astype(np.float32)
        elif kind == "steps":
            img = np.round(rng.random((h, w)) * 4).astype(np.float32) * 60
        else:
            img = np.full((h, w), 9.0, np.float32)
        for th_hi, th_lo in ((20.0, 7.0), (60.0, 0.0)):
            got = tf.fast_response(T(img), th_hi, th_lo)
            ref = jax.jit(lambda im: jf.fast_response(im, th_hi, th_lo))(J(img))
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(N(g), N(r), err_msg=f"{h}x{w} {th_hi}/{th_lo}")
            np.testing.assert_array_equal(N(got[2]).view(np.int32), N(ref[2]).view(np.int32))


@pytest.mark.parametrize("lvl", [0, 2, 5])
def test_level_detection_angle_descriptor(image, lvl):
    """Same level image: keypoints, scores and validity exact; IC angle to
    1e-4 rad (sum order); blur exact to 1e-4; BRIEF exact given the same
    blurred image, keypoints and angles."""
    level = _jax_levels(image)[lvl]
    cap = CFG.capacities[lvl]
    xy_j, s_j, v_j = jax.jit(lambda im: jf.detect_level(im, CFG, cap))(J(level))
    xy_t, s_t, v_t = tf.detect_level(T(level), TCFG, cap)
    np.testing.assert_array_equal(N(xy_t), N(xy_j))
    np.testing.assert_array_equal(N(s_t), N(s_j))
    np.testing.assert_array_equal(N(v_t), N(v_j))
    ang_j = jax.jit(jf.ic_angles)(J(level), xy_j)
    np.testing.assert_allclose(N(tf.ic_angles(T(level), T(N(xy_j)))), N(ang_j), rtol=0, atol=1e-4)
    bl = jax.jit(jf.gaussian_blur7)(J(level))
    np.testing.assert_allclose(N(tf.gaussian_blur7(T(level))), N(bl), rtol=0, atol=1e-4)
    d_j = as_i32(jax.jit(jf.brief_descriptors)(bl, xy_j, ang_j))
    d_t = N(tf.brief_descriptors(T(N(bl)), T(N(xy_j)), T(N(ang_j))))
    np.testing.assert_array_equal(d_t, d_j)


def test_extract_orb_whole_image(image):
    """End to end on one 752x480 frame: level-0 output exact in position;
    over all levels at most 2% of keypoints move and at most 1% of the
    descriptor bits of unmoved keypoints differ."""
    fj = _jax_extract(J(image))
    ft = tf.extract_orb(T(image), TCFG)
    np.testing.assert_array_equal(N(ft.octave), N(fj.octave))
    same_xy = (N(ft.xy) == N(fj.xy)).all(-1)
    lvl0 = N(fj.octave) == 0
    assert same_xy[lvl0].all()
    assert (~same_xy).mean() <= 0.02, (~same_xy).mean()
    bits = np.unpackbits((N(ft.desc) ^ as_i32(fj.desc)).view(np.uint8), axis=-1)
    assert bits[same_xy].mean() <= 0.01, bits[same_xy].mean()
    np.testing.assert_array_equal(N(ft.valid)[lvl0], N(fj.valid)[lvl0])


def test_pack_roundtrip_and_layout(image):
    """The packed host buffer has the reference's layout word for word."""
    fj = _jax_extract(J(image))
    ft = tf.OrbFeatures(*(T(N(getattr(fj, k))) for k in fj._fields))
    got = N(tf.pack_features_for_host(ft))
    want = np.asarray(jf.pack_features_for_host(fj)).view(np.int32)
    np.testing.assert_array_equal(got, want)
    xy, angle, response, octave, desc, valid = tf.unpack_features_host(got)
    np.testing.assert_array_equal(xy, N(fj.xy))
    np.testing.assert_array_equal(desc, N(fj.desc))
    assert desc.dtype == np.uint32
    np.testing.assert_array_equal(valid, N(fj.valid))


def test_extractor_undistorts_keypoints(image):
    """With radtan D the extractor returns undistorted pixels, as the
    reference's extractor does (1e-3 px: ten fixed-point iterations in
    float32)."""
    K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)
    D = np.array([-0.283, 0.0739, 0.0002, 1.76e-05, 0.0], np.float32)
    fj = jf.make_extractor(480, 752, CFG, K=K, D=D)(J(image))
    ft = tf.make_extractor(480, 752, TCFG, K=K, D=D, device="cpu")(T(image))
    lvl0 = N(fj.octave) == 0
    np.testing.assert_allclose(N(ft.xy)[lvl0], N(fj.xy)[lvl0], rtol=0, atol=1e-3)
