"""ops/matching.py: the port against the JAX package.

Tolerance: none. Distances, indices and masks are integers and booleans and
must agree exactly; the only float inputs (positions, angles) are identical
on both sides and go through the same float32 comparisons.
"""
import numpy as np
import pytest

from orbslam3_tpu.ops import matching as jm
from orbslam3_tpu_torch.ops import matching as tm
from torch_port_helpers import J, N, T, room_frames, torch_threads  # noqa: F401


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a, b = _desc(rng, 130), _desc(rng, 97)
    b[:5] = a[:5]                                   # zero distances
    b[5] = ~a[5]                                    # 256
    np.testing.assert_array_equal(N(tm.hamming_matrix(T(a), T(b))),
                                  N(jm.hamming_matrix(J(a), J(b))))
    # batched form (triangulation): each batch entry equals the 2-D call
    A = np.stack([_desc(rng, 40) for _ in range(3)])
    B = np.stack([_desc(rng, 30) for _ in range(3)])
    got = N(tm.hamming_matrix(T(A), T(B)))
    for i in range(3):
        np.testing.assert_array_equal(got[i], N(jm.hamming_matrix(J(A[i]), J(B[i]))))


@pytest.mark.parametrize("ratio", [None, 0.8, 1.0])
def test_masked_match_and_resolve_duplicates(ratio):
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 120, (200, 150)).astype(np.int32)
    dist[:, 3] = dist[:, 4]                         # ties between columns
    mask = rng.random((200, 150)) < 0.3
    mask[::9] = False                               # empty rows
    got = tm.masked_match(T(dist), T(mask), 80, ratio)
    want = jm.masked_match(J(dist), J(mask), 80, ratio)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), N(w))
    idx, best, ok = want
    np.testing.assert_array_equal(N(tm.resolve_duplicates(got[0], got[1], got[2], 150)),
                                  N(jm.resolve_duplicates(idx, best, ok, 150)))


def test_resolve_duplicates_batched():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 20, (3, 50)).astype(np.int32)
    best = rng.integers(0, 6, (3, 50)).astype(np.int32)   # many equal distances
    ok = rng.random((3, 50)) < 0.8
    got = N(tm.resolve_duplicates(T(idx), T(best), T(ok), 20))
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], N(jm.resolve_duplicates(J(idx[b]), J(best[b]), J(ok[b]), 20)))


def test_masks_and_rotation_consistency():
    rng = np.random.default_rng(3)
    p = rng.uniform(0, 700, (60, 2)).astype(np.float32)
    q = rng.uniform(0, 700, (80, 2)).astype(np.float32)
    rad = rng.uniform(5, 80, 60).astype(np.float32)
    np.testing.assert_array_equal(N(tm.window_mask(T(p), T(q), T(rad))),
                                  N(jm.window_mask(J(p), J(q), J(rad))))
    np.testing.assert_array_equal(N(tm.window_mask(T(p), T(q), 40.0)),
                                  N(jm.window_mask(J(p), J(q), 40.0)))
    o1 = rng.integers(0, 8, 60).astype(np.int32)
    o2 = rng.integers(0, 8, 80).astype(np.int32)
    np.testing.assert_array_equal(N(tm.octave_mask(T(o1), T(o2), 1, 1)),
                                  N(jm.octave_mask(J(o1), J(o2), 1, 1)))
    a1 = rng.uniform(-np.pi, np.pi, 60).astype(np.float32)
    a2 = rng.uniform(-np.pi, np.pi, 80).astype(np.float32)
    idx = rng.integers(0, 80, 60).astype(np.int32)
    a1[:40] = a2[idx[:40]] + 0.3                    # one dominant rotation bin
    ok = rng.random(60) < 0.9
    np.testing.assert_array_equal(N(tm.rotation_consistency(T(a1), T(a2), T(idx), T(ok))),
                                  N(jm.rotation_consistency(J(a1), J(a2), J(idx), J(ok))))


def test_search_for_initialization_and_by_descriptor_on_real_frames():
    """Two rendered frames' real ORB features (JAX extractor output fed to
    both sides)."""
    _, frames = room_frames()
    f0, f1 = frames[0], frames[2]
    args = [f0["desc"], f0["valid"], f0["xy"], f0["angle"],
            f1["desc"], f1["valid"], f1["xy"], f1["angle"]]
    got = tm.search_for_initialization(*map(T, args))
    want = jm.search_for_initialization(*map(J, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), N(w))
    assert N(want[2]).sum() > 100
    got = tm.search_by_descriptor(T(f0["desc"]), T(f0["valid"]), T(f1["desc"]), T(f1["valid"]),
                                  angle_a=T(f0["angle"]), angle_b=T(f1["angle"]),
                                  check_rotation=True)
    want = jm.search_by_descriptor(J(f0["desc"]), J(f0["valid"]), J(f1["desc"]), J(f1["valid"]),
                                   angle_a=J(f0["angle"]), angle_b=J(f1["angle"]),
                                   check_rotation=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), N(w))
