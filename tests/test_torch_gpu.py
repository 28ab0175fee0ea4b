"""The port's hand-written CUDA kernel on the card: ``match_rows`` against its
plain PyTorch version on the same CUDA tensors. Marked ``gpu``; without a
CUDA device every test skips (the kernel has no CPU mode).

This file imports neither JAX nor the test helpers, so it also runs on a
machine without JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: none — the outputs are integers and must be bit-identical.
"""
import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.ops import match_rows as mr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the match_rows kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, M, N, lead=()):
    """Map points copied from features with a few bits flipped, features
    duplicated in descriptor and position (exact ties), rows outside every
    window (empty)."""
    rng = np.random.default_rng(seed)
    feat_desc = rng.integers(0, 2**32, lead + (N, 8), dtype=np.uint32)
    feat_desc[..., 1::4, :] = feat_desc[..., 0::4, :][..., : feat_desc[..., 1::4, :].shape[-2], :]
    feat_xy = rng.uniform([0, 0], [752, 480], lead + (N, 2)).astype(np.float32)
    feat_xy[..., 1::4, :] = feat_xy[..., 0::4, :][..., : feat_xy[..., 1::4, :].shape[-2], :]
    src = rng.integers(0, N, lead + (M,))
    mp_desc = np.take_along_axis(feat_desc, src[..., None], axis=-2)
    mp_desc ^= rng.integers(0, 2**32, mp_desc.shape, dtype=np.uint32) & \
        rng.integers(0, 2**32, mp_desc.shape, dtype=np.uint32) & \
        rng.integers(0, 2**32, mp_desc.shape, dtype=np.uint32)
    uv = (np.take_along_axis(feat_xy, src[..., None], axis=-2)
          + rng.normal(0, 2, lead + (M, 2))).astype(np.float32)
    uv[..., ::7, :] = -1000.0
    rad = rng.uniform(5, 40, lead + (M,)).astype(np.float32)
    lvl = rng.integers(0, 8, lead + (M,)).astype(np.int32)
    row_ok = rng.random(lead + (M,)) < 0.8
    feat_oct = rng.integers(0, 8, lead + (N,)).astype(np.int32)
    feat_ok = rng.random(lead + (N,)) < 0.9
    arrays = (mp_desc.view(np.int32), uv, rad, lvl, row_ok, feat_desc.view(np.int32),
              feat_xy, feat_oct, feat_ok)
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("M,N,lead", [(4096, 1024, ()), (1024, 1024, ()), (1024, 1000, ()),
                                      (300, 200, ()), (512, 300, (4,))])
def test_kernel_equals_plain(cuda, M, N, lead):
    args = [a.to(cuda) for a in _inputs(9, M, N, lead)]
    before = mr.match_rows.launches
    got = mr.match_rows(*args)
    torch.cuda.synchronize()
    assert mr.match_rows.launches == before + 1
    want = mr.match_rows_reference(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    best, second = want[1], want[2]
    assert (best >= mr.BIG).any() and ((second == best) & (best < mr.BIG)).any()


def test_kernel_rejects_what_it_does_not_take(cuda):
    args = [a.to(cuda) for a in _inputs(1, 64, 32)]
    bad = list(args)
    bad[1] = bad[1].double()
    with pytest.raises(TypeError):
        mr.match_rows(*bad)
    bad = list(args)
    bad[6] = bad[6][:-1]
    with pytest.raises(ValueError):
        mr.match_rows(*bad)
