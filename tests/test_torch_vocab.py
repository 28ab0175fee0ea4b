"""The port's vocabulary (orbslam3_tpu_torch/ops/vocab.py) against the JAX
package's, both on the CPU, on the same seeded descriptors.

Tolerances: word ids, sparse BoW ids and common-word counts are integers and
must be equal bit for bit; tf-idf weights and L1 scores agree within 1e-6
(one float32 sum, summed in another order); a trained tree is equal word for
word (the same numpy code from the same seed).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import vocab as jv
from orbslam3_tpu_torch.ops import vocab as tv
from torch_port_helpers import T, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vocabs():
    path = os.path.join(REPO, "orbslam3_tpu_torch", "data", "vocab_synth.npz")
    return jv.BinaryVocabulary.load(path), tv.BinaryVocabulary.load(path)


def _descriptors(n, seed):
    """ORB-like descriptors: structured random, a fifth of them exact
    duplicates (equal-weight words and repeated ids)."""
    d = jv.random_descriptors(n, seed=seed)
    d[1::5] = d[0::5][: len(d[1::5])]
    return d


def test_packaged_vocabulary_is_the_references():
    with open(os.path.join(REPO, "orbslam3_tpu_torch", "data", "vocab_synth.npz"), "rb") as a, \
            open(os.path.join(REPO, "orbslam3_tpu", "data", "vocab_synth.npz"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("seed,n,top_t", [(1, 1200, 512), (2, 300, 512), (3, 1200, 64)])
def test_words_and_sparse_bow_bit_equal(vocabs, seed, n, top_t):
    jvoc, tvoc = vocabs
    desc = _descriptors(n, seed)
    valid = np.random.default_rng(seed).random(n) < 0.9
    wj = np.asarray(jvoc.transform_fn()(jnp.asarray(desc), jnp.asarray(valid)))
    wt = tvoc.transform_fn(device="cpu")(T(desc), T(valid)).numpy()
    np.testing.assert_array_equal(wt, wj)
    assert (wj >= 0).sum() == valid.sum()
    pj = np.asarray(jvoc.sparse_bow_fn(top_t)(jnp.asarray(wj)))
    pt = tvoc.sparse_bow_fn(top_t, device="cpu")(torch.as_tensor(wt)).numpy()
    Tn = len(pj) // 2
    np.testing.assert_array_equal(pt[:Tn], pj[:Tn])                  # word ids
    np.testing.assert_allclose(pt[Tn:].view(np.float32), pj[Tn:].view(np.float32),
                               rtol=0, atol=1e-6)                     # weights
    dj = np.asarray(jvoc.bow_fn()(jnp.asarray(wj)))
    dt = tvoc.bow_fn(device="cpu")(torch.as_tensor(wt)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-6)


def test_sparse_scores_agree(vocabs):
    """Host scoring of a query against a sparse database built by each
    package: equal common-word counts, scores within 1e-6."""
    jvoc, tvoc = vocabs
    rows_j, rows_t = [], []
    for seed in range(6):
        d = _descriptors(600, 10 + seed)
        if seed % 2:
            d[:300] = _descriptors(600, 10)[:300]        # overlap with row 0
        ok = np.ones(len(d), bool)
        wj = jvoc.transform_fn()(jnp.asarray(d), jnp.asarray(ok))
        rows_j.append(np.asarray(jvoc.sparse_bow_fn(256)(wj)))
        wt = tvoc.transform_fn(device="cpu")(T(d), T(ok))
        rows_t.append(tvoc.sparse_bow_fn(256, device="cpu")(wt).numpy())
    out = []
    for rows, mod in ((rows_j, jv), (rows_t, tv)):
        ids = np.stack([r[:256] for r in rows])
        w = np.stack([r[256:].view(np.float32) for r in rows])
        qd = mod.sparse_to_dense_np(ids[0], w[0], jvoc.n_words)
        out.append(mod.sparse_scores_np(qd, ids, w))
    (sj, cj), (st, ct) = out
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    assert cj[1] > cj[2] and sj[0] > sj[1] > sj[2]


def test_training_gives_the_same_tree():
    train = jv.random_descriptors(4000, seed=5)
    a = jv.BinaryVocabulary(k=4, levels=3).train(train, seed=3)
    b = tv.BinaryVocabulary(k=4, levels=3).train(train, seed=3)
    for ca, cb in zip(a.children, b.children):
        np.testing.assert_array_equal(cb, ca)
    corpus = [np.asarray(a.transform_fn()(jnp.asarray(jv.random_descriptors(200, seed=s)),
                                          jnp.ones(200, bool))) for s in range(8)]
    np.testing.assert_array_equal(b.compute_idf(corpus).idf, a.compute_idf(corpus).idf)


def _desc_line(parent, leaf, desc_bytes, weight):
    return (f"{parent} {int(leaf)} " + " ".join(str(int(b)) for b in desc_bytes)
            + f" {weight}")


def test_load_dbow2_text_roundtrip(tmp_path):
    """tests/test_vocab_io.py's tree, loaded and queried by both packages."""
    rng = np.random.default_rng(0)
    d = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    d[0][:] = 0x00
    d[1][:] = 0xFF
    d[2][:] = 0x00; d[2][0] = 0x01
    d[3][:] = 0x00; d[3][0] = 0x0F
    d[4][:] = 0xFF; d[4][0] = 0xFE
    d[5][:] = 0xFF; d[5][0] = 0xF0
    lines = ["2 2 0 0", _desc_line(0, 0, d[0], 0.0), _desc_line(0, 0, d[1], 0.0),
             _desc_line(1, 1, d[2], 0.4), _desc_line(1, 1, d[3], 0.3),
             _desc_line(2, 1, d[4], 0.2), _desc_line(2, 1, d[5], 0.1)]
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    jvoc, tvoc = jv.load_dbow2_text(str(p)), tv.load_dbow2_text(str(p))
    assert tvoc.n_words == jvoc.n_words == 4 and tvoc.levels == jvoc.levels == 2
    np.testing.assert_array_equal(tvoc.word_weight, jvoc.word_weight)
    queries = np.concatenate([d[2:6].copy().view(np.uint32).reshape(4, 8),
                              rng.integers(0, 2 ** 32, (60, 8), dtype=np.uint32)])
    ok = np.ones(len(queries), bool)
    wj = np.asarray(jvoc.transform_fn()(jnp.asarray(queries), jnp.asarray(ok)))
    wt = tvoc.transform_fn(device="cpu")(T(queries), T(ok)).numpy()
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(wt[:4], [0, 1, 2, 3])
    v = tvoc.bow_fn(device="cpu")(torch.as_tensor(wt[:4])).numpy()
    np.testing.assert_allclose(v, np.asarray([0.4, 0.3, 0.2, 0.1]) / 1.0, rtol=1e-5)
    pj = np.asarray(jvoc.sparse_bow_fn(8)(jnp.asarray(wj)))
    pt = tvoc.sparse_bow_fn(8, device="cpu")(torch.as_tensor(wt)).numpy()
    np.testing.assert_array_equal(pt[:4], pj[:4])
    np.testing.assert_allclose(pt[4:].view(np.float32), pj[4:].view(np.float32), atol=1e-6)
