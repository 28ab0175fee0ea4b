"""Binary visual vocabulary: array-form tree + sparse bag-of-words scoring.

Port of ``orbslam3_tpu/ops/vocab.py`` (DBoW2's ``TemplatedVocabulary``
``transform`` / TF-IDF L1 scoring and the ``KeyFrameDatabase``'s BowVector):

- The tree is flat arrays: per-level child descriptors (+ index tables for a
  loaded DBoW2 tree). A whole frame's descriptors descend it in parallel, one
  gather + Hamming argmin per level, on the device.
- A keyframe's BowVector is sparse: its top-T (word id, tf-idf weight) pairs,
  packed with the weights' bit patterns into one int32 buffer, so one
  read-back brings a row to the host.
- Training (hierarchical k-medians), idf weights, save/load and the DBoW2
  text loader are host numpy, copied from the reference so the two packages
  build the same tree from the same seed.

Descriptors are (N, 8) words: uint32 on the host, their int32 bit patterns on
the device (``view(np.int32)``). Word ids and sparse ids are integers and equal
the reference's bit for bit; weights agree to float32 rounding of one sum.
``l1_scores`` is the dense L1 scorer of one BoW vector against a database.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# popcount of every byte value, for the descriptors' Hamming distances
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_centroid(desc: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid of (N,8) uint32 descriptors."""
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # (N,256)
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians_binary(desc: np.ndarray, k: int, rng, iters: int = 8):
    """k-medians clustering of binary descriptors; returns (k,8) centroids."""
    n = len(desc)
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = desc
        return out
    centroids = desc[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d = _popcount_np(desc[:, None, :] ^ centroids[None, :, :])  # (N,k)
        assign = d.argmin(1)
        for j in range(k):
            sel = assign == j
            if sel.any():
                centroids[j] = _majority_centroid(desc[sel])
    return centroids


def _as_i32(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def _hamming_to_children(cents: torch.Tensor, desc: torch.Tensor,
                         pop8: torch.Tensor) -> torch.Tensor:
    """(N,k) Hamming distances of (N,8) int32 descriptors to their (N,k,8)
    candidate children, by a byte-popcount table."""
    x = torch.bitwise_xor(cents, desc[:, None, :]).contiguous()
    return pop8[x.view(torch.uint8).long()].sum(-1)


class BinaryVocabulary:
    """Trained tree: levels list of (nodes_at_level, k, 8) child descriptors."""

    def __init__(self, k: int = 10, levels: int = 3):
        self.k = k
        self.levels = levels
        self.n_words = k ** levels
        self.children: list[np.ndarray] = []   # level l: (k**l, k, 8) uint32
        self.idf: np.ndarray | None = None

    def train(self, desc: np.ndarray, seed: int = 0, max_per_node: int = 20000):
        """Hierarchical k-medians (DBoW2 TemplatedVocabulary::create)."""
        rng = np.random.default_rng(seed)
        self.children = []
        groups = [desc]
        for lvl in range(self.levels):
            n_nodes = self.k ** lvl
            child = np.zeros((n_nodes, self.k, 8), np.uint32)
            next_groups = []
            for node in range(n_nodes):
                g = groups[node]
                if len(g) > max_per_node:
                    g = g[rng.choice(len(g), max_per_node, replace=False)]
                cents = _kmedians_binary(g, self.k, rng)
                child[node] = cents
                if len(groups[node]):
                    d = _popcount_np(groups[node][:, None, :] ^ cents[None, :, :])
                    assign = d.argmin(1)
                else:
                    assign = np.zeros(0, int)
                for j in range(self.k):
                    next_groups.append(groups[node][assign == j])
            self.children.append(child)
            groups = next_groups
        # uniform idf until stats accumulate
        self.idf = np.ones(self.n_words, np.float32)
        return self

    def compute_idf(self, word_id_arrays: list[np.ndarray]):
        """TF-IDF weights from a corpus pass: idf[w] = ln(N / Nᵢ) with Nᵢ the
        number of corpus images containing word w (DBoW2
        TemplatedVocabulary::setNodeWeights)."""
        n_imgs = max(len(word_id_arrays), 1)
        df = np.zeros(self.n_words, np.float64)
        for w in word_id_arrays:
            w = np.asarray(w)
            df[np.unique(w[w >= 0])] += 1.0
        self.idf = np.log(n_imgs / np.maximum(df, 1.0)).astype(np.float32)
        return self

    def save(self, path: str):
        np.savez_compressed(
            path, k=self.k, levels=self.levels, idf=self.idf,
            **{f"children_{l}": c for l, c in enumerate(self.children)})

    @classmethod
    def load(cls, path: str) -> "BinaryVocabulary":
        z = np.load(path)
        v = cls(k=int(z["k"]), levels=int(z["levels"]))
        v.children = [z[f"children_{l}"] for l in range(v.levels)]
        v.idf = z["idf"].astype(np.float32)
        return v

    # -- device side ---------------------------------------------------------
    def transform_fn(self, device=None):
        """fn(desc (N,8) int32, valid (N,) bool) → word ids (N,) int32, -1
        where invalid. The tree's tensors are uploaded once, here."""
        dev = resolve_device(device)
        children = [torch.as_tensor(_as_i32(c), device=dev) for c in self.children]
        pop8 = torch.as_tensor(_POP8, device=dev)
        _settle(dev)
        k = self.k

        def fn(desc, valid):
            node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
            for lvl in range(self.levels):
                d = _hamming_to_children(children[lvl][node], desc, pop8)
                node = node * k + torch.argmin(d, dim=-1)
            return torch.where(valid, node, -1).to(torch.int32)

        return fn

    def bow_fn(self, device=None):
        """fn(word_ids (N,)) → tf-idf L1-normalized dense (W,) vector."""
        idf = torch.as_tensor(self.idf, device=resolve_device(device))
        W = self.n_words

        def fn(word_ids):
            return _tfidf(word_ids, idf, W)

        return fn

    def sparse_bow_fn(self, top_t: int, device=None):
        """Sparse BowVector (DBoW2's ``BowVector`` is a sparse word→weight
        map): fn(word_ids (N,)) → packed int32 (2·T,) = [word ids (T,) in
        descending weight order, bit patterns of the weights (T,)], ids
        padded with −1. Per-keyframe storage is O(features), not
        O(n_words)."""
        return _sparse_bow_fn(self.idf, self.n_words, min(top_t, self.n_words),
                              resolve_device(device))


def _settle(dev: torch.device):
    """Constant tensors uploaded here are read from other threads' streams:
    let the upload finish before anyone can."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _tfidf(word_ids: torch.Tensor, idf: torch.Tensor, W: int) -> torch.Tensor:
    ok = word_ids >= 0
    hist = torch.zeros(W, dtype=torch.float32, device=word_ids.device).index_add_(
        0, torch.where(ok, word_ids, 0).long(), ok.to(torch.float32))
    v = hist * idf
    return v / torch.clamp(torch.sum(v), min=1e-9)


def _sparse_bow_fn(idf: np.ndarray, W: int, T: int, dev: torch.device):
    idf_d = torch.as_tensor(np.asarray(idf, np.float32), device=dev)
    _settle(dev)

    def fn(word_ids):
        v = _tfidf(word_ids, idf_d, W)
        # the reference's top_k: descending weight, the lower word id first
        # among equal weights (a stable sort gives exactly that order)
        w_top, i_top = torch.sort(v, descending=True, stable=True)
        w_top, i_top = w_top[:T], i_top[:T]
        ids = torch.where(w_top > 0, i_top, -1).to(torch.int32)
        return torch.cat([ids, w_top.view(torch.int32)])

    return fn


def sparse_scores_np(q_dense: np.ndarray, db_ids: np.ndarray, db_w: np.ndarray):
    """Host-side exact L1 scores + common-word counts of a dense query vector
    against a sparse database ((K,T) ids / weights). min(q,d) is nonzero only
    on d's support, so iterating the rows' supports is exact."""
    valid = db_ids >= 0
    qg = q_dense[np.where(valid, db_ids, 0)]
    scores = 2.0 * np.sum(np.minimum(qg, db_w) * valid, axis=-1)
    common = np.sum((qg > 0) & (db_w > 0) & valid, axis=-1)
    return scores.astype(np.float32), common.astype(np.int64)


def sparse_to_dense_np(ids: np.ndarray, w: np.ndarray, n_words: int):
    """Scatter one sparse BowVector to a dense (W,) numpy vector."""
    out = np.zeros(n_words, np.float32)
    sel = ids >= 0
    out[ids[sel]] = w[sel]
    return out


class GeneralVocabulary:
    """Array-form DBoW2 tree of arbitrary shape (loaded from ORBvoc.txt).

    Real trees are not complete k-ary trees, so the descent uses per-node
    child tables with validity masks; each level is one gather + masked
    argmin over (N, k) Hamming distances."""

    def __init__(self, levels, k, child_desc, child_id, child_valid, word_weight):
        self.levels = levels
        self.k = k
        # per level l: (n_nodes_l, k, 8) uint32 child descriptors;
        # (n_nodes_l, k) int32 child codes: ≥0 → row in level l+1's table,
        # ≤ −2 → leaf with word id −code−2; (n_nodes_l, k) bool validity
        self.child_desc = child_desc
        self.child_id = child_id
        self.child_valid = child_valid
        self.word_weight = word_weight   # (n_words,) float32 (idf)
        self.n_words = len(word_weight)

    def transform_fn(self, device=None):
        dev = resolve_device(device)
        cd = [torch.as_tensor(_as_i32(c), device=dev) for c in self.child_desc]
        ci = [torch.as_tensor(np.asarray(c, np.int64), device=dev) for c in self.child_id]
        cv = [torch.as_tensor(np.asarray(c, bool), device=dev) for c in self.child_valid]
        pop8 = torch.as_tensor(_POP8, device=dev)
        _settle(dev)

        def fn(desc, valid):
            n = desc.shape[0]
            node = torch.zeros(n, dtype=torch.int64, device=desc.device)
            word = torch.full((n,), -1, dtype=torch.int64, device=desc.device)
            for lvl in range(self.levels):
                d = _hamming_to_children(cd[lvl][node], desc, pop8)
                d = torch.where(cv[lvl][node], d, 1 << 20)
                best = torch.argmin(d, dim=-1)
                nxt = torch.gather(ci[lvl][node], 1, best[:, None])[:, 0]
                word = torch.where((word < 0) & (nxt <= -2), -nxt - 2, word)
                node = torch.where(nxt >= 0, nxt, 0)
            word = torch.clamp(word, min=0)
            return torch.where(valid, word, -1).to(torch.int32)

        return fn

    def bow_fn(self, device=None):
        weight = torch.as_tensor(np.asarray(self.word_weight, np.float32),
                                 device=resolve_device(device))
        W = self.n_words

        def fn(word_ids):
            return _tfidf(word_ids, weight, W)

        return fn

    def sparse_bow_fn(self, top_t: int, device=None):
        """Sparse BowVector (see BinaryVocabulary.sparse_bow_fn): what makes a
        ~1M-word ORBvoc usable."""
        return _sparse_bow_fn(self.word_weight, self.n_words, min(top_t, self.n_words),
                              resolve_device(device))


def load_dbow2_text(path: str) -> GeneralVocabulary:
    """Parse the DBoW2 text vocabulary format (TemplatedVocabulary::
    loadFromTextFile): first line ``k L scoring weighting``; then one node per
    line: ``parent_id is_leaf b0..b31 weight`` (32 descriptor bytes). Word ids
    are assigned to leaves in file order, exactly like DBoW2."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, is_leaf, descs, weights = [], [], [], []
        for line in f:
            ps = line.split()
            if len(ps) < 35:
                continue
            parents.append(int(ps[0]))
            is_leaf.append(bool(int(ps[1])))
            descs.append(np.asarray(ps[2:34], np.uint32).astype(np.uint8))
            weights.append(float(ps[34]))
    n = len(parents)
    parents = np.asarray(parents, np.int64)
    is_leaf = np.asarray(is_leaf, bool)
    desc = np.stack(descs).view(np.uint32) if n else np.zeros((0, 8), np.uint32)
    desc = desc.reshape(n, 8)
    weights = np.asarray(weights, np.float32)

    # node ids in file order; node 0 (root) is implicit. File nodes are 1..n.
    depth = np.zeros(n + 1, np.int32)
    for i in range(n):
        depth[i + 1] = depth[parents[i]] + 1
    levels = int(depth.max())

    # per-level node tables: level l holds nodes at depth l (root at level 0)
    level_nodes = [np.nonzero(depth == l)[0] for l in range(levels + 1)]
    node_row = np.full(n + 1, -1, np.int64)        # node id → row in its level
    for l, ids in enumerate(level_nodes):
        node_row[ids] = np.arange(len(ids))

    word_of_node = np.full(n + 1, -1, np.int64)
    word_of_node[1:][is_leaf] = np.arange(int(is_leaf.sum()))
    word_weight = weights[is_leaf]

    child_desc, child_id, child_valid = [], [], []
    for l in range(levels):
        ids = level_nodes[l]
        nn = max(len(ids), 1)
        cdesc = np.zeros((nn, k, 8), np.uint32)
        cid = np.full((nn, k), -1, np.int32)
        cval = np.zeros((nn, k), bool)
        slot = np.zeros(nn, np.int32)
        for i in np.nonzero(depth[1:] == l + 1)[0]:
            r = node_row[parents[i]]
            s = slot[r]
            if s >= k:
                continue
            cdesc[r, s] = desc[i]
            # leaf slots encode the word id as −(word+2); interior slots the
            # row of the child node in level l+1's table
            cid[r, s] = (-(int(word_of_node[i + 1]) + 2) if is_leaf[i]
                         else int(node_row[i + 1]))
            cval[r, s] = True
            slot[r] += 1
        child_desc.append(cdesc)
        child_id.append(cid)
        child_valid.append(cval)

    return GeneralVocabulary(levels, k, child_desc, child_id, child_valid, word_weight)


def l1_scores(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of one dense BoW vector (W,) against a database
    (K,W) → (K,): s = 2·Σ min(vᵢ, wᵢ), which is 1 − ½|v−w|₁ for
    L1-normalized vectors (the reference's TemplatedVocabulary score)."""
    return 2.0 * torch.sum(torch.minimum(query[None, :], database), dim=-1)


def random_descriptors(n: int, seed: int = 0) -> np.ndarray:
    """Structured random descriptors for default vocab training (bits with
    spatially-correlated probabilities, closer to ORB statistics than iid)."""
    rng = np.random.default_rng(seed)
    p = rng.beta(2, 2, size=(1, 256))
    bits = (rng.random((n, 256)) < p).astype(np.uint8)
    return np.packbits(bits, axis=-1).view(np.uint32).reshape(n, 8)
