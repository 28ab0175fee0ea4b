"""match_rows: the port's plain version against the JAX Pallas kernel (run in
interpret mode on the CPU, as tests/test_matching_pallas.py runs it). The
Hopper kernel against the plain version is tests/test_torch_gpu.py.

Tolerance: none. The outputs are integers (column index, best and second
distance), so every row must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import matching_pallas
from orbslam3_tpu_torch.ops import match_rows as mr
from torch_port_helpers import J, T, torch_threads  # noqa: F401


def _inputs(seed, M, N, ties=False):
    rng = np.random.default_rng(seed)
    mp_desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    feat_desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    uv = rng.uniform([0, 0], [752, 480], (M, 2)).astype(np.float32)
    feat_xy = rng.uniform([0, 0], [752, 480], (N, 2)).astype(np.float32)
    if ties:
        # exact duplicate features and map points equal to them: equal best
        # distances in several columns (lowest column must win, second ==
        # best); every 7th row is placed far outside every window (empty row)
        feat_desc[1::4] = feat_desc[0::4][: len(feat_desc[1::4])]
        feat_xy[1::4] = feat_xy[0::4][: len(feat_xy[1::4])]
        src = rng.integers(0, N, M)
        mp_desc[:] = feat_desc[src]
        uv[:] = feat_xy[src] + rng.normal(0, 2, (M, 2)).astype(np.float32)
        uv[::7] = -1000.0
    rad = rng.uniform(5, 40, M).astype(np.float32)
    lvl = rng.integers(0, 8, M, dtype=np.int32)
    row_ok = rng.random(M) < 0.7
    feat_oct = rng.integers(0, 8, N, dtype=np.int32)
    feat_ok = rng.random(N) < 0.9
    return (mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct, feat_ok)


@pytest.mark.parametrize("seed,M,N,ties", [(3, 300, 200, False), (5, 260, 150, True)])
def test_plain_equals_pallas_interpret(seed, M, N, ties):
    args = _inputs(seed, M, N, ties)
    want = matching_pallas.match_rows(*map(J, args), interpret=True)
    got = mr.match_rows(*map(T, args))
    for name, w, g in zip(("idx", "best", "second"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    best = got[1].numpy()
    assert (best >= mr.BIG).any(), "the case must include rows with no candidate"
    if ties:
        assert ((got[2].numpy() == best) & (best < mr.BIG)).any(), "no tie exercised"


@pytest.mark.parametrize("seed,M,N,ties", [(3, 300, 200, False), (5, 260, 150, True)])
def test_dual_plain_equals_two_pallas_interpret_calls(seed, M, N, ties):
    """The dual-radius form at ``rad`` and ``2 * rad`` against two runs of
    the Pallas kernel at those radii, bit for bit, ties and empty rows
    included. ``2.0 * rad`` is exact in float32, so both sides see the same
    wide radius."""
    args = _inputs(seed, M, N, ties)
    wide_args = args[:2] + (np.float32(2.0) * args[2],) + args[3:]
    want = (matching_pallas.match_rows(*map(J, args), interpret=True),
            matching_pallas.match_rows(*map(J, wide_args), interpret=True))
    got = mr.match_rows_dual(*map(T, args), wide=2.0)
    for radius, w3, g3 in zip(("r", "2r"), want, got):
        for name, w, g in zip(("idx", "best", "second"), w3, g3):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} at {radius}")
    narrow_best, wide_best = got[0][1].numpy(), got[1][1].numpy()
    assert (wide_best <= narrow_best).all(), "the wide window contains the narrow one"
    assert (wide_best < narrow_best).any(), "the wide window must add candidates somewhere"
    assert (wide_best >= mr.BIG).any(), "the case must include rows empty at both radii"
    if ties:
        assert ((got[1][2].numpy() == wide_best) & (wide_best < mr.BIG)).any()


def test_dual_plain_batched_and_single_agree():
    """The dual form with a batch dimension equals single-radius calls per
    entry at both radii (what the tracker relied on before the one-launch
    form)."""
    per = [_inputs(21 + b, 80, 60, ties=bool(b % 2)) for b in range(2)]
    batched = [T(np.stack([p[i] for p in per])) for i in range(9)]
    narrow, wide = mr.match_rows_dual(*batched, wide=2.0)
    for b, p in enumerate(per):
        t = list(map(T, p))
        for got, rad in ((narrow, t[2]), (wide, 2.0 * t[2])):
            want = mr.match_rows(t[0], t[1], rad, *t[3:])
            for g, w in zip(got, want):
                assert torch.equal(g[b], w)


def test_plain_batched_equals_per_entry():
    """The optional leading batch dimension (one launch for all fuse
    targets) computes each entry as an unbatched call would."""
    per = [_inputs(11 + b, 90, 70, ties=bool(b % 2)) for b in range(3)]
    batched = [T(np.stack([p[i] for p in per])) for i in range(9)]
    got = mr.match_rows(*batched)
    for b, p in enumerate(per):
        want = mr.match_rows(*map(T, p))
        for g, w in zip(got, want):
            assert torch.equal(g[b], w)


def test_wrapper_counts_only_kernel_launches():
    """The CPU path is the plain version and leaves the launch count alone."""
    before = mr.match_rows.launches, mr.match_rows_dual.launches
    mr.match_rows(*map(T, _inputs(3, 40, 30)))
    mr.match_rows_dual(*map(T, _inputs(3, 40, 30)))
    assert (mr.match_rows.launches, mr.match_rows_dual.launches) == before
