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
    before = mr.match_rows.launches
    mr.match_rows(*map(T, _inputs(3, 40, 30)))
    assert mr.match_rows.launches == before
