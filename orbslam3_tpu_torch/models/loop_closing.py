"""Loop closing: place recognition, Sim3 verification, pose-graph correction.

Port of ``orbslam3_tpu/models/loop_closing.py`` (the reference's
``LoopClosing`` thread and ``KeyFrameDatabase``) as host code over device
steps on torch tensors:

- Database: a sparse BoW row per keyframe (top-T word ids + tf-idf weights),
  kept on the host and mirrored on the device; a query scores against every
  stored keyframe in one device step with one packed read-back.
- Candidates (DetectNBestCandidates): exclude covisible and recent
  keyframes, keep > 0.8·max common words, accumulate covisibility-group
  scores, keep > 0.75·best, take the 3 best group leads.
- Geometric verification with the reference's A.5 gates: descriptor matching
  (nBoWMatches), Sim3 RANSAC (nBoWInliers), OptimizeSim3 (nSim3Inliers), the
  guided projection through the refined Sim3 (nProjMatches; SearchBySim3:
  the ``match_rows`` kernel through ``kernels.projection_matcher``), a
  re-optimization and a tight recount (nProjOptMatches).
- Temporal consistency: a verified candidate is held pending; each later
  keyframe re-verifies the propagated Sim3; correction fires after 3
  consecutive successes, the pending candidate is dropped after 2 misses.
- Correction (CorrectLoop): the essential graph over all keyframes
  (odometry + spanning tree + covisibility ≥ 100 + every stored loop edge +
  the new loop edge) in Sim(3) (``ops/posegraph.py``), keyframes and map
  points moved through their reference keyframe, then SearchAndFuse of the
  loop-side landmarks into the corrected current group.
- Merge detection: the same database query against every stored Atlas map,
  verified here, executed by the system (``merge_fn``).

Every device tensor of this closer is made and used by the thread that calls
it: the loop-closing thread in async mode, the tracker's in sync mode
(``detect_relocalization_candidates`` runs in the tracker's, on host rows and
its own query). The vocabulary's constant tensors are read-only.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..ops import matching, posegraph, sim3 as sim3_ops, vocab as vocab_ops
from ..utils.timing import StageTimer
from .map import MapState

_DEFAULT_VOCAB = None
_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _pair_bucket(n: int, caps=(64, 128, 256, 512, 1024, 2048)) -> int:
    """Padded length of a matched-pair set: the reference pads to a few
    fixed shapes so its compiled kernels are reused; the padding is masked,
    so the port keeps it and runs the very same problems."""
    for c in caps:
        if n <= c:
            return c
    return caps[-1]


def _pad_to(a: np.ndarray, cap: int, fill: float = 0.0, fill_z1: bool = False) -> np.ndarray:
    """Pad axis 0 of ``a`` to ``cap`` (truncating if longer). With ``fill_z1``
    pad 3D points with (0,0,1) so camera projection of masked rows stays
    finite."""
    a = np.asarray(a, np.float32)[:cap]
    if len(a) == cap:
        return a
    pad = np.full((cap - len(a),) + a.shape[1:], fill, np.float32)
    if fill_z1:
        pad[..., -1] = 1.0
    return np.concatenate([a, pad])


def _db_scores(db_ids: torch.Tensor, db_w: torch.Tensor, k: int, n_words: int) -> torch.Tensor:
    """L1 similarity and common-word counts of row ``k`` against the whole
    device-resident sparse database ((K,T) word ids + weights), packed into
    one int32 buffer [bit patterns of the scores (K,), common (K,)] for one
    read-back. The query is scattered to a dense (W,) vector once; each row
    then scores by a (K,T) gather: exact L1, O(K·T) memory.

    The reference scatters its padded query with one ``.at[].set`` whose -1
    slots land on word 0 with weight 0 after the real entries; its CPU
    backend applies the updates in order, so a query with any padding slot
    carries word 0's weight as 0. The port reproduces that order, so both
    packages rank the same candidates."""
    q_ids, q_w = db_ids[k], db_w[k]
    ok = q_ids >= 0
    qd = torch.zeros(n_words, dtype=torch.float32, device=db_ids.device)
    qd.index_put_((torch.where(ok, q_ids, 0).long(),), torch.where(ok, q_w, 0.0))
    qd[0] = torch.where(torch.all(ok), qd[0], 0.0)
    valid = db_ids >= 0
    qg = qd[torch.where(valid, db_ids, 0).long()]
    scores = 2.0 * torch.sum(torch.minimum(qg, db_w) * valid, dim=-1)
    common = torch.sum((qg > 0) & (db_w > 0) & valid, dim=-1, dtype=torch.int32)
    return torch.cat([scores.to(torch.float32).view(torch.int32), common])


def _default_vocabulary():
    """The packaged 10k-word vocabulary (``data/vocab_synth.npz``, trained on
    rendered-scene ORB descriptors with tf-idf weights). A real DBoW2
    vocabulary takes precedence: ``ORBSLAM3_VOCAB`` naming an ORBvoc.txt or a
    trained .npz, or an ORBvoc.txt in the package's data directory. Falls
    back to a small random-trained tree only if the data file is missing."""
    global _DEFAULT_VOCAB
    if _DEFAULT_VOCAB is None:
        env = os.environ.get("ORBSLAM3_VOCAB", "")
        candidates = ([env] if env else []) + [os.path.join(_DATA_DIR, "ORBvoc.txt")]
        for c in candidates:
            if c and os.path.exists(c):
                if c.endswith(".npz"):
                    _DEFAULT_VOCAB = vocab_ops.BinaryVocabulary.load(c)
                else:
                    _DEFAULT_VOCAB = vocab_ops.load_dbow2_text(c)
                return _DEFAULT_VOCAB
        path = os.path.join(_DATA_DIR, "vocab_synth.npz")
        if os.path.exists(path):
            _DEFAULT_VOCAB = vocab_ops.BinaryVocabulary.load(path)
        else:
            _DEFAULT_VOCAB = vocab_ops.BinaryVocabulary(k=8, levels=3).train(
                vocab_ops.random_descriptors(20000, seed=1), seed=1)
    return _DEFAULT_VOCAB


class LoopCloser:
    def __init__(self, map_state: MapState, K: np.ndarray, wh, vocab=None,
                 fix_scale: bool = False, min_kfs: int = 12, exclude_recent: int = 8,
                 seed: int = 0, cam_type: int = 0, n_bow_matches: int = 20,
                 n_bow_inliers: int = 15, n_sim3_inliers: int = 20,
                 n_proj_matches: int = 50, n_proj_opt_matches: int = 80,
                 consistency_needed: int = 3, device=None):
        self.map = map_state
        self.device = resolve_device(device)
        self.cam_type = int(cam_type)
        self.cam_params = np.asarray(K, np.float32)
        self.K = np.asarray(K, np.float32)[:4]
        self.wh = np.asarray(wh, np.float32)
        # the reference's A.5 gates (src/LoopClosing.cc:734-738)
        self.n_bow_matches = n_bow_matches
        self.n_bow_inliers = n_bow_inliers
        self.n_sim3_inliers = n_sim3_inliers
        self.n_proj_matches = n_proj_matches
        self.n_proj_opt_matches = n_proj_opt_matches
        self.consistency_needed = consistency_needed
        self.fix_scale = fix_scale
        self.min_kfs = min_kfs
        self.exclude_recent = exclude_recent
        # RANSAC samples come from this host generator, as in the reference
        self.rng = np.random.default_rng(seed)
        if vocab is None:
            vocab = _default_vocabulary()
        self.vocab = vocab
        self.transform = vocab.transform_fn(device=self.device)
        # sparse BowVectors: per-keyframe top-T (word id, tf-idf weight)
        self.bow_t = min(512, map_state.cfg.n_features, vocab.n_words)
        self.sbow = vocab.sparse_bow_fn(self.bow_t, device=self.device)
        cap = map_state.cfg.max_keyframes
        self.bow_ids = np.full((cap, self.bow_t), -1, np.int32)
        self.bow_w = np.zeros((cap, self.bow_t), np.float32)
        self.bow_filled = np.zeros(cap, bool)
        self.stats = {"loops_detected": 0, "loops_corrected": 0, "candidates_checked": 0}
        self.last_loop_kf = -1
        # bound by the system to the tracker's IMU state: an IMU-initialized
        # map corrects with the 4DoF essential graph
        self.is_inertial = lambda: False
        self.timer = StageTimer()
        # temporal-consistency state: a verified candidate pending
        # confirmation by later keyframes {"cand","kf1","S21","count","misses"}
        self.pending = None
        # accepted loop edges, fed into every later essential-graph solve
        self.loop_edges: list[tuple[int, int]] = []
        # SearchAndFuse hook, bound by the system to the mapper's fuse
        self.fuse_fn = None
        self._guided = None
        # device mirror of the BoW database and how many rows are synced
        self._db_dev = None
        self._db_rows = 0
        # cross-map merge detection: stored-map source and merge executor,
        # bound by the system; per-stored-map databases built lazily
        self.stored_maps_fn = None     # () -> list[MapState]
        self.merge_fn = None           # (kf_id, old_map, kf2, S21, ...) -> bool
        self._merge_dbs: dict = {}     # map_id -> (n_kf, ids, db_ids, db_w)
        map_state.on_remap["loop_closer"] = self._on_map_remap

    def _t(self, a, dtype=None) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _sparse_row(self, desc, valid):
        """(T,) ids + (T,) weights of one keyframe/frame: one transform +
        sparse-BoW step, one packed read-back."""
        words = self.transform(self._t(desc), self._t(np.asarray(valid, bool)))
        out = self.sbow(words).cpu().numpy()
        T = self.bow_t
        return out[:T], out[T:].view(np.float32)

    def _db_sync(self, n_kf: int):
        """Device sparse BoW database covering rows [0, n_kf); rows appended
        incrementally. Returns (ids (cap,T) int32, weights (cap,T) float32)."""
        cap = self.bow_ids.shape[0]
        if self._db_dev is None or self._db_dev[0].shape[0] != cap:
            self._db_dev = (self._t(self.bow_ids), self._t(self.bow_w))
            self._db_rows = n_kf
        elif self._db_rows < n_kf:
            lo = self._db_rows
            ids_d, w_d = self._db_dev
            ids_d[lo:n_kf] = self._t(self.bow_ids[lo:n_kf])
            w_d[lo:n_kf] = self._t(self.bow_w[lo:n_kf])
            self._db_rows = n_kf
        return self._db_dev

    def _db_mark_dirty(self, k: int):
        """Row ``k`` (re)written on the host after it was synced: shrink the
        synced prefix so the next query uploads from there."""
        self._db_rows = min(self._db_rows, int(k))

    def _db_invalidate(self):
        self._db_dev = None
        self._db_rows = 0

    def _on_map_remap(self, kf_remap: np.ndarray, mp_remap: np.ndarray):
        """Map pools compacted or grown: reorder the database rows and remap
        held keyframe ids (under the map lock)."""
        new_cap = self.map.cfg.max_keyframes
        new_ids = np.full((new_cap, self.bow_t), -1, np.int32)
        new_w = np.zeros((new_cap, self.bow_t), np.float32)
        new_filled = np.zeros(new_cap, bool)
        old = np.nonzero(self.bow_filled)[0]
        old = old[old < len(kf_remap)]
        tgt = kf_remap[old]
        keep = tgt >= 0
        new_ids[tgt[keep]] = self.bow_ids[old[keep]]
        new_w[tgt[keep]] = self.bow_w[old[keep]]
        new_filled[tgt[keep]] = True
        self.bow_ids = new_ids
        self.bow_w = new_w
        self.bow_filled = new_filled
        self._db_invalidate()
        if self.last_loop_kf >= 0:
            r = int(kf_remap[self.last_loop_kf])
            if r < 0:   # culled: nearest surviving position keeps the recency gate
                r = int(np.searchsorted(np.nonzero(kf_remap >= 0)[0], self.last_loop_kf)) - 1
            self.last_loop_kf = r
        if self.pending is not None:
            c = int(kf_remap[self.pending["cand"]])
            k1 = int(kf_remap[self.pending["kf1"]])
            if c < 0 or k1 < 0:
                self.pending = None
            else:
                self.pending["cand"] = c
                self.pending["kf1"] = k1
        edges = []
        for (a, b) in self.loop_edges:
            a2, b2 = int(kf_remap[a]), int(kf_remap[b])
            if a2 >= 0 and b2 >= 0:
                edges.append((a2, b2))
        self.loop_edges = edges

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int, pre_correct=None, post_correct=None) -> bool:
        """Detect + verify + correct for one keyframe (the reference's
        LoopClosing Run body). ``pre_correct`` / ``post_correct`` bracket the
        map mutation: the async runtime pauses the mapper and kills a running
        global BA there, and releases the mapper afterwards."""
        m = self.map
        with m.lock:
            snap_epoch = m.remap_epoch
            if not m.kf_valid[kf_id]:
                return False
            self.bow_ids[kf_id], self.bow_w[kf_id] = self._sparse_row(
                m.kf_feat_desc[kf_id], m.kf_feat_valid[kf_id])
            self.bow_filled[kf_id] = True
            self._db_mark_dirty(kf_id)
            # backfill keyframes that never passed through here (the
            # bootstrap pair, merge-migrated keyframes): without rows the
            # start of every map is invisible to the database
            missing = np.nonzero(m.kf_valid[: m.n_kf] & ~self.bow_filled[: m.n_kf])[0]
            for k in missing[:8]:
                self.bow_ids[int(k)], self.bow_w[int(k)] = self._sparse_row(
                    m.kf_feat_desc[int(k)], m.kf_feat_valid[int(k)])
                self.bow_filled[int(k)] = True
                self._db_mark_dirty(int(k))

            # a young map cannot close loops on itself yet, but it can merge
            # into a stored map
            merge_only = m.n_kf < self.min_kfs
            if self.last_loop_kf >= 0 and kf_id - self.last_loop_kf < self.exclude_recent:
                return False
            hit = None
            if merge_only:
                self.pending = None
            # temporal consistency: refine the pending candidate's Sim3
            # against this keyframe; accept after `consistency_needed`
            # consecutive verifications
            if self.pending is not None:
                with self.timer.stage("12.lc_sim3_verify"):
                    ok_ref, S21n = self._refine_pending(kf_id)
                if ok_ref:
                    self.pending["count"] += 1
                    self.pending["misses"] = 0
                    self.pending["kf1"] = kf_id
                    self.pending["S21"] = S21n
                    if self.pending["count"] >= self.consistency_needed:
                        self.stats["loops_detected"] += 1
                        hit = (self.pending["cand"], S21n)
                else:
                    self.pending["misses"] += 1
                    if self.pending["misses"] >= 2:
                        self.pending = None
            if hit is None and self.pending is None and not merge_only:
                with self.timer.stage("11.lc_detect"):
                    cands = self._detect_candidates(kf_id)
                for c in cands:
                    self.stats["candidates_checked"] += 1
                    with self.timer.stage("12.lc_sim3_verify"):
                        ok, S21 = self._verify_candidate(kf_id, int(c))
                    if ok:
                        self.pending = {"cand": int(c), "kf1": kf_id, "S21": S21,
                                        "count": 1, "misses": 0}
                        if self.pending["count"] >= self.consistency_needed:
                            self.stats["loops_detected"] += 1
                            hit = (int(c), S21)
                        break
        if hit is None:
            # no same-map loop: cross-map place recognition (merge
            # verification belongs to this thread, never the tracker's)
            if self.stored_maps_fn is not None and self.merge_fn is not None \
                    and self.pending is None:
                self._try_merge(kf_id)
            return False
        if pre_correct is not None:
            pre_correct()   # outside the map lock (the mapper may hold it)
        try:
            with m.lock:
                if m.remap_epoch != snap_epoch:
                    # pools compacted between detection and correction: the
                    # candidate ids are stale (re-detected next keyframe)
                    return False
                with self.timer.stage("13.lc_correct"):
                    self._correct_loop(kf_id, hit[0], hit[1])
                    self.loop_edges.append((int(kf_id), int(hit[0])))
                    self._search_and_fuse(kf_id, hit[0])
            self.stats["loops_corrected"] += 1
            self.last_loop_kf = kf_id
            self.pending = None
        finally:
            if post_correct is not None:
                post_correct()
        return True

    # ------------------------------------------------------------------
    def detect_relocalization_candidates(self, desc: np.ndarray, valid: np.ndarray,
                                         n_best: int = 5) -> np.ndarray:
        """The reference's DetectRelocalizationCandidates: the loop scheme's
        common-words > 0.8·max and group-score > 0.75·best gates for a lost
        frame, without the covisible-group or recency exclusions. Returns
        candidate keyframe ids, best first."""
        m = self.map
        valid_ids = np.nonzero(self.bow_filled[: m.n_kf] & m.kf_valid[: m.n_kf])[0]
        if len(valid_ids) == 0:
            return np.zeros(0, np.int64)
        q_ids, q_w = self._sparse_row(desc, valid)
        qd = vocab_ops.sparse_to_dense_np(q_ids, q_w, self.vocab.n_words)
        scores, common = vocab_ops.sparse_scores_np(
            qd, self.bow_ids[valid_ids], self.bow_w[valid_ids])
        eligible = common > 0
        if not eligible.any():
            return np.zeros(0, np.int64)
        eligible &= common > 0.8 * common[eligible].max()
        cand = valid_ids[eligible]
        if len(cand) == 0:
            return np.zeros(0, np.int64)
        sc = np.zeros(m.n_kf, np.float32)
        sc[valid_ids] = scores
        acc = np.zeros(len(cand), np.float32)
        leads = np.zeros(len(cand), np.int64)
        for i, c in enumerate(cand):
            group = [int(c)] + [int(g) for g in m.best_covisible(int(c), 10, min_weight=15)]
            gsc = [sc[g] for g in group]
            acc[i] = float(np.sum(gsc))
            leads[i] = group[int(np.argmax(gsc))]
        keep = acc > 0.75 * acc.max()
        order = np.argsort(-acc[keep])
        out: list[int] = []
        for lead in leads[keep][order]:
            if lead not in out:
                out.append(int(lead))
            if len(out) >= n_best:
                break
        return np.asarray(out, np.int64)

    # ------------------------------------------------------------------
    def _stored_map_db(self, old):
        """Sparse BoW database of a stored map (ids, (n,T) word ids, (n,T)
        weights), built once: stored maps are frozen until a merge retires
        or revives them."""
        key = old.map_id
        ids = old.valid_kf_ids()
        cached = self._merge_dbs.get(key)
        if cached is not None and cached[0] == len(ids) and np.array_equal(cached[1], ids):
            return cached[1], cached[2], cached[3]
        db_ids = np.full((len(ids), self.bow_t), -1, np.int32)
        db_w = np.zeros((len(ids), self.bow_t), np.float32)
        for i, k in enumerate(ids):
            db_ids[i], db_w[i] = self._sparse_row(old.kf_feat_desc[int(k)],
                                                  old.kf_feat_valid[int(k)])
        self._merge_dbs[key] = (len(ids), ids.copy(), db_ids, db_w)
        return ids, db_ids, db_w

    def detect_merge_candidates(self, kf_id: int, n_best: int = 3):
        """Database query of the new keyframe against every stored map (the
        reference DetectNBestCandidates' merge split): common-words >
        0.8·max per map, L1-score ranked. Returns [(map, kf2), ...] best
        first."""
        if self.stored_maps_fn is None:
            return []
        qd = vocab_ops.sparse_to_dense_np(self.bow_ids[kf_id], self.bow_w[kf_id],
                                          self.vocab.n_words)
        out = []
        for old in self.stored_maps_fn():
            ids, db_ids, db_w = self._stored_map_db(old)
            if len(ids) == 0:
                continue
            scores, common = vocab_ops.sparse_scores_np(qd, db_ids, db_w)
            if common.max() == 0:
                continue
            eligible = common > 0.8 * common.max()
            scores = np.where(eligible, scores, -np.inf)
            order = np.argsort(-scores)[:n_best]
            for i in order:
                if np.isfinite(scores[i]):
                    out.append((float(scores[i]), old, int(ids[i])))
        out.sort(key=lambda x: -x[0])
        return [(old, k2) for (_, old, k2) in out[:n_best]]

    def _try_merge(self, kf_id: int) -> bool:
        """Merge detection at keyframe rate, in the loop-closing thread (the
        reference's NewDetectCommonRegions merge branch)."""
        if self.merge_fn is None:
            return False
        m = self.map
        for old, k2 in self.detect_merge_candidates(kf_id):
            with m.lock, old.lock:
                # the compaction epoch the Sim3 is verified against: a
                # compaction or a new Atlas map before the merge executes
                # would make kf_id index a remapped slot
                epoch1 = m.remap_epoch
                ok, S21 = self._verify_candidate(kf_id, k2, map1=m, map2=old)
            if not ok:
                continue
            self.stats["merges_detected"] = self.stats.get("merges_detected", 0) + 1
            if self.merge_fn(kf_id, old, k2, S21, cur_map=m, cur_epoch=epoch1):
                return True
        return False

    # ------------------------------------------------------------------
    def _detect_candidates(self, kf_id: int, n_best: int = 3) -> np.ndarray:
        """The reference's DetectNBestCandidates: count keyframes sharing
        words (excluding the query's covisible group), keep >
        0.8·maxCommonWords, accumulate covisibility-group scores, keep >
        0.75·bestAccScore, return the n-best group leads."""
        m = self.map
        covis = m.covisibility_row(kf_id)
        neighbors = np.nonzero(covis >= 15)[0]
        valid_ids = np.nonzero(self.bow_filled[: m.n_kf] & m.kf_valid[: m.n_kf])[0]
        if len(valid_ids) == 0:
            return np.zeros(0, np.int64)
        db_ids, db_w = self._db_sync(m.n_kf)
        out = _db_scores(db_ids, db_w, kf_id, self.vocab.n_words).cpu().numpy()
        cap = db_ids.shape[0]
        scores = out[:cap].view(np.float32)[valid_ids]
        common = out[cap:][valid_ids]

        eligible = np.ones(len(valid_ids), bool)
        eligible &= ~np.isin(valid_ids, neighbors)
        eligible &= valid_ids != kf_id
        eligible &= valid_ids < kf_id - self.exclude_recent
        eligible &= common > 0
        if not eligible.any():
            return np.zeros(0, np.int64)
        max_common = common[eligible].max()
        eligible &= common > 0.8 * max_common
        cand = valid_ids[eligible]
        if len(cand) == 0:
            return np.zeros(0, np.int64)
        sc = np.zeros(m.n_kf, np.float32)
        sc[valid_ids] = scores
        shares = np.zeros(m.n_kf, bool)
        shares[valid_ids[common > 0]] = True
        # accumulate scores over each candidate's top-10 covisible group;
        # the group lead is its best-scoring member
        acc_scores = np.zeros(len(cand), np.float32)
        leads = np.zeros(len(cand), np.int64)
        neighbor_set = set(int(x) for x in neighbors)
        for i, c in enumerate(cand):
            group = [int(c)] + [int(g) for g in m.best_covisible(int(c), 10, min_weight=15)]
            # group members satisfy the query's own exclusions, or the lead
            # can degenerate to a covisible keyframe (a no-op self-loop)
            group = [g for g in group if g < kf_id - self.exclude_recent
                     and g not in neighbor_set and g != kf_id]
            gsc = [(sc[g] if shares[g] else 0.0) for g in group]
            acc_scores[i] = float(np.sum(gsc))
            leads[i] = group[int(np.argmax(gsc))] if group else int(c)
        best_acc = acc_scores.max()
        keep = acc_scores > 0.75 * best_acc
        order = np.argsort(-acc_scores[keep])
        res = []
        for lead in leads[keep][order]:
            if lead not in res:
                res.append(int(lead))
            if len(res) >= n_best:
                break
        return np.asarray(res, np.int64)

    # ------------------------------------------------------------------
    def _verify_candidate(self, kf1: int, kf2: int, map1=None, map2=None):
        """Full geometric verification (the reference's
        DetectCommonRegionsFromBoW): descriptor match → Sim3 RANSAC →
        OptimizeSim3 → guided projection → re-optimize → tight recount, with
        the A.5 gates. ``map2`` other than this closer's map verifies a
        cross-map (Atlas merge) candidate."""
        def _fail(stage):
            self.stats[f"lc_vfail_{stage}"] = self.stats.get(f"lc_vfail_{stage}", 0) + 1
            return False, None

        m = map1 if map1 is not None else self.map
        m2 = map2 if map2 is not None else self.map
        has1 = m.kf_feat_valid[kf1] & (m.kf_feat_mp[kf1] >= 0)
        has2 = m2.kf_feat_valid[kf2] & (m2.kf_feat_mp[kf2] >= 0)
        if has1.sum() < self.n_bow_matches or has2.sum() < self.n_bow_matches:
            return _fail("has")
        idx, _, ok = matching.search_by_descriptor(
            self._t(m.kf_feat_desc[kf1]), self._t(has1),
            self._t(m2.kf_feat_desc[kf2]), self._t(has2),
            max_dist=matching.TH_LOW, ratio=0.9)
        okn = ok.cpu().numpy()
        if okn.sum() < self.n_bow_matches:
            return _fail("bow")
        f1 = np.nonzero(okn)[0]
        f2 = idx.cpu().numpy()[f1]
        mp1 = m.kf_feat_mp[kf1][f1]
        mp2 = m2.kf_feat_mp[kf2][f2]
        sel = m.mp_valid[mp1] & m2.mp_valid[mp2]
        f1, f2, mp1, mp2 = f1[sel], f2[sel], mp1[sel], mp2[sel]
        n = len(mp1)
        if n < self.n_bow_inliers:
            return _fail("pairs")
        # a same-map "loop" whose matches are mostly the same landmarks
        # carries no closure information
        if m is m2 and n and (mp1 == mp2).mean() > 0.5:
            return _fail("samemp")
        x1 = m.mp_xyz[mp1] @ m.kf_R[kf1].T + m.kf_t[kf1]
        x2 = m2.mp_xyz[mp2] @ m2.kf_R[kf2].T + m2.kf_t[kf2]
        sig1 = m.level_sigma2[m.kf_feat_octave[kf1, f1]]
        sig2 = m2.level_sigma2[m2.kf_feat_octave[kf2, f2]]
        cap = _pair_bucket(n)
        n = min(n, cap)
        valid = np.zeros(cap, bool)
        valid[:n] = True
        x1p, x2p = _pad_to(x1, cap, fill_z1=True), _pad_to(x2, cap, fill_z1=True)
        sig1p, sig2p = _pad_to(sig1, cap, 1.0), _pad_to(sig2, cap, 1.0)
        rand = self.rng.integers(0, n, (100, 3)).astype(np.int32)
        camp = self._t(self.cam_params)
        res = sim3_ops.sim3_ransac(
            self._t(x1p), self._t(x2p), self._t(valid), self._t(rand),
            self._t((9.21 * sig1p).astype(np.float32)),
            self._t((9.21 * sig2p).astype(np.float32)),
            camp, fix_scale=self.fix_scale, min_inliers=self.n_bow_inliers,
            cam_type=self.cam_type)
        if not bool(res.success):
            log = self.stats.setdefault("lc_vfail_log", [])
            log.append(("ransac", int(kf1), int(kf2), float(m.kf_ts[kf1]), float(m2.kf_ts[kf2]),
                        dict(has1=int(has1.sum()), has2=int(has2.sum()), raw=int(okn.sum()),
                             pairs=int(n), inl=int(res.n_inliers))))
            if len(log) > 32:
                del log[:-32]
            return _fail("ransac")
        opt = sim3_ops.optimize_sim3(
            self._t(x1p), self._t(x2p),
            self._t(_pad_to(m.kf_feat_xy[kf1, f1], cap)),
            self._t(_pad_to(m2.kf_feat_xy[kf2, f2], cap)),
            self._t(_pad_to(1.0 / sig1, cap)), self._t(_pad_to(1.0 / sig2, cap)),
            self._t(valid), res.s, res.R, res.t, camp, fix_scale=self.fix_scale,
            cam_type=self.cam_type)
        if int(opt.n_inliers) < self.n_sim3_inliers:
            return _fail("sim3opt")
        S21 = (float(opt.s), opt.R.cpu().numpy(), opt.t.cpu().numpy())
        if not np.isfinite(S21[0]) or not np.isfinite(S21[1]).all():
            return _fail("finite")
        n_guided, g_mp2, g_feat1 = self._guided_projection(kf1, kf2, S21, map1=m, map2=m2,
                                                           radius=8.0)
        if n_guided < self.n_proj_matches:
            return _fail("guided")
        S21b = self._optimize_pairs(kf1, kf2, S21, g_mp2, g_feat1, m, m2)
        if S21b is None:
            return _fail("optpairs")
        n_final, _, _ = self._guided_projection(kf1, kf2, S21b, map1=m, map2=m2, radius=3.0)
        if n_final < self.n_proj_opt_matches:
            self.stats["lc_vfail_last_n_final"] = int(n_final)
            return _fail("final")
        return True, S21b

    # ------------------------------------------------------------------
    def _guided_matcher(self):
        if self._guided is None:
            from . import kernels
            self._guided = kernels.projection_matcher(
                self.cam_type, self.map.cfg.n_levels, self.map.cfg.scale, device=self.device)
        return self._guided

    def _guided_projection(self, kf1: int, kf2: int, S21, map1=None, map2=None,
                           radius: float = 8.0, cap: int = 2048):
        """Project the candidate-side local landmarks into kf1 through S21⁻¹
        and descriptor-match within a window (the reference's SearchBySim3):
        one ``match_rows`` launch over ``cap`` rows. Returns (n_matches,
        matched mp2 ids, matched kf1 feature indices)."""
        m = map1 if map1 is not None else self.map
        m2 = map2 if map2 is not None else self.map
        s, R, t = S21
        locals2 = m2.local_map_points(np.concatenate(
            [[kf2], m2.best_covisible(kf2, 5, min_weight=15)]).astype(np.int32))
        locals2 = locals2[:cap]
        if len(locals2) == 0:
            return 0, np.zeros(0, np.int64), np.zeros(0, np.int64)
        n = len(locals2)
        pad = cap - n
        # candidate points into kf1's camera frame (S21⁻¹ of their cam2
        # position); the matcher then runs with an identity frame pose
        xc2 = m2.mp_xyz[locals2] @ m2.kf_R[kf2].T + m2.kf_t[kf2]
        xc1 = (xc2 - t) @ R / s
        n2_cam = m2.mp_normal[locals2] @ m2.kf_R[kf2].T
        n1 = n2_cam @ R

        def pk(a, fill=0.0):
            if pad:
                return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            return a

        valid = np.zeros(cap, bool)
        valid[:n] = True
        idx, ok, _, _, _ = self._guided_matcher()(
            self._t(pk(xc1.astype(np.float32))),
            self._t(pk(m2.mp_desc[locals2])),
            self._t(pk(n1.astype(np.float32))),
            self._t(pk((m2.mp_min_dist[locals2] / s).astype(np.float32))),
            self._t(pk((m2.mp_max_dist[locals2] / s).astype(np.float32), 1.0)),
            self._t(valid),
            self._t(np.eye(3, dtype=np.float32)), self._t(np.zeros(3, np.float32)),
            self._t(self.cam_params),
            self._t(m.kf_feat_xy[kf1]), self._t(m.kf_feat_desc[kf1]),
            self._t(m.kf_feat_octave[kf1]), self._t(m.kf_feat_valid[kf1]),
            self._t(self.wh),
            float(radius), 1.0,            # no ratio test (reference)
            int(matching.TH_HIGH), -1.0)   # no view-cos gate
        okn = ok.cpu().numpy()[:n]
        src_i = np.nonzero(okn)[0]
        return (len(src_i), locals2[src_i].astype(np.int64),
                idx.cpu().numpy()[:n][src_i].astype(np.int64))

    def _optimize_pairs(self, kf1: int, kf2: int, S21, g_mp2, g_feat1, m, m2,
                        cap: int = 512):
        """OptimizeSim3 on guided-match pairs: kf1 features with map points
        matched to candidate-side landmarks (the reference's second
        OptimizeSim3 after SearchBySim3)."""
        mp1 = m.kf_feat_mp[kf1][g_feat1]
        sel = (mp1 >= 0)
        sel[sel] &= m.mp_valid[mp1[sel]]
        if sel.sum() < 10:
            return S21   # keep the previous estimate
        f1 = g_feat1[sel][:cap]
        mp1 = m.kf_feat_mp[kf1][f1]
        mp2 = g_mp2[sel][:cap]
        x1 = m.mp_xyz[mp1] @ m.kf_R[kf1].T + m.kf_t[kf1]
        x2 = m2.mp_xyz[mp2] @ m2.kf_R[kf2].T + m2.kf_t[kf2]
        uv1 = m.kf_feat_xy[kf1, f1]
        sig1 = m.level_sigma2[m.kf_feat_octave[kf1, f1]]
        # uv2: the observation of mp2 in kf2, where it exists (the reference
        # adds the e21 edge only then)
        row2 = m2.kf_feat_mp[kf2]
        lut2 = np.full(m2.cfg.max_map_points, -1, np.int64)
        obs_feats = np.nonzero(row2 >= 0)[0]
        lut2[row2[obs_feats]] = obs_feats
        f2 = lut2[mp2]
        has2 = f2 >= 0
        uv2 = np.zeros((len(mp2), 2), np.float32)
        uv2[has2] = m2.kf_feat_xy[kf2, f2[has2]]
        sig2 = np.ones(len(mp2), np.float32)
        sig2[has2] = m2.level_sigma2[m2.kf_feat_octave[kf2, f2[has2]]]
        s, R, t = S21
        nn = len(mp1)
        capb = _pair_bucket(nn)
        validb = np.zeros(capb, bool)
        validb[:nn] = True
        has2b = np.zeros(capb, bool)
        has2b[:nn] = has2
        opt = sim3_ops.optimize_sim3(
            self._t(_pad_to(x1, capb, fill_z1=True)), self._t(_pad_to(x2, capb, fill_z1=True)),
            self._t(_pad_to(uv1, capb)), self._t(_pad_to(uv2, capb)),
            self._t(_pad_to(1.0 / sig1, capb)), self._t(_pad_to(1.0 / sig2, capb)),
            self._t(validb), float(s), self._t(np.asarray(R, np.float32)),
            self._t(np.asarray(t, np.float32)), self._t(self.cam_params),
            valid21=self._t(has2b), fix_scale=self.fix_scale, cam_type=self.cam_type)
        sN = float(opt.s)
        RN = opt.R.cpu().numpy()
        tN = opt.t.cpu().numpy()
        if not (np.isfinite(sN) and np.isfinite(RN).all() and np.isfinite(tN).all()
                and 0.01 < sN < 100.0):
            return None
        # the re-optimization refines an already-verified similarity: a large
        # scale jump means the solve left the basin
        if abs(np.log(max(sN, 1e-9) / max(s, 1e-9))) > 0.7:
            return None
        return (sN, RN, tN)

    def _refine_pending(self, kf_new: int):
        """Temporal re-verification of the pending candidate against a new
        keyframe (the reference's DetectAndReffineSim3FromLastKF: propagate
        the Sim3 by odometry, guided-project (≥30), OptimizeSim3, tight
        recount (≥100))."""
        m = self.map
        p = self.pending
        kf_prev, cand = p["kf1"], p["cand"]
        if not (m.kf_valid[kf_new] and m.kf_valid[kf_prev] and m.kf_valid[cand]):
            return False, None
        s, R, t = p["S21"]
        # S21' = S21 ∘ T_prev_new (points in the new keyframe's camera frame)
        R_rel = m.kf_R[kf_prev] @ m.kf_R[kf_new].T
        t_rel = m.kf_t[kf_prev] - R_rel @ m.kf_t[kf_new]
        S21g = (s, (R @ R_rel).astype(np.float32), (s * (R @ t_rel) + t).astype(np.float32))
        n_guided, g_mp2, g_feat1 = self._guided_projection(kf_new, cand, S21g, radius=8.0)
        if n_guided < 30:
            self.stats["lc_refine_fail_guided"] = self.stats.get("lc_refine_fail_guided", 0) + 1
            return False, None
        S21b = self._optimize_pairs(kf_new, cand, S21g, g_mp2, g_feat1, m, m)
        if S21b is None:
            self.stats["lc_refine_fail_opt"] = self.stats.get("lc_refine_fail_opt", 0) + 1
            return False, None
        n_final, _, _ = self._guided_projection(kf_new, cand, S21b, radius=3.0)
        if n_final < min(100, self.n_proj_opt_matches):
            self.stats["lc_refine_fail_final"] = self.stats.get("lc_refine_fail_final", 0) + 1
            self.stats["lc_refine_last_n_final"] = int(n_final)
            return False, None
        return True, S21b

    def _search_and_fuse(self, kf1: int, kf2: int):
        """Fuse the loop-side landmarks into the corrected current covisible
        group (the reference's SearchAndFuse → ORBmatcher::Fuse): after the
        correction both sides live in one frame, so duplicated landmarks
        project onto the same features and merge."""
        if self.fuse_fn is None:
            return
        m = self.map
        loop_mps = m.local_map_points(np.concatenate(
            [[kf2], m.best_covisible(kf2, 5, min_weight=15)]).astype(np.int32))
        if len(loop_mps) == 0:
            return
        group1 = [int(kf1)] + [int(g) for g in m.best_covisible(kf1, 10, min_weight=15)]
        for k in group1:
            self.fuse_fn(loop_mps, k)
        fused = m.kf_feat_mp[kf1]
        m.refresh_map_points(np.unique(fused[fused >= 0]))

    # ------------------------------------------------------------------
    def _correct_loop(self, kf1: int, kf2: int, S21):
        """Pose-graph correction (the reference's CorrectLoop +
        OptimizeEssentialGraph)."""
        s21, R21, t21 = S21
        s12 = 1.0 / s21
        R12 = R21.T
        t12 = -s12 * (R12 @ t21)
        self._essential_graph(fixed_ids=[int(kf2)],
                              extra_edge=(int(kf1), int(kf2), s12, R12, t12, 5.0))

    def optimize_essential_graph(self, fixed_ids, meas=None):
        """Distribute residual stress over the whole map after a merge (the
        reference's MergeLocal essential graph outside the welding window):
        odometry + spanning-tree + covisibility + stored loop edges, the
        welding-window keyframes fixed. ``meas`` = (R (cap,3,3), t (cap,3)):
        a pose snapshot to measure the edges from (the non-corrected poses,
        with the nodes starting at the corrected ones)."""
        self._essential_graph(fixed_ids=[int(k) for k in fixed_ids], meas=meas)

    def _essential_graph(self, fixed_ids, extra_edge=None, meas=None):
        m = self.map
        kfs = m.valid_kf_ids()
        K = len(kfs)
        lut = np.full(m.cfg.max_keyframes, -1, np.int32)
        lut[kfs] = np.arange(K)

        s0 = np.ones(K, np.float32)
        R0 = m.kf_R[kfs].copy()
        t0 = m.kf_t[kfs].copy()

        mRs = m.kf_R if meas is None else meas[0]
        mts = m.kf_t if meas is None else meas[1]
        edges_i, edges_j, ms, mR, mt, wts = [], [], [], [], [], []

        def add_edge(a, b, w=1.0):
            ia, ib = lut[a], lut[b]
            if ia < 0 or ib < 0:
                return
            # measured relative from the measurement poses: S_ab = S_a ∘ S_b⁻¹
            Ra, ta = mRs[a], mts[a]
            Rb, tb = mRs[b], mts[b]
            Rab = Ra @ Rb.T
            tab = ta - Rab @ tb
            edges_i.append(ia); edges_j.append(ib)
            ms.append(1.0); mR.append(Rab); mt.append(tab); wts.append(w)

        # odometry chain + spanning tree + covisibility (≥100 shared) edges
        for a, b in zip(kfs[1:], kfs[:-1]):
            add_edge(int(a), int(b))
        seen_parent = set()
        for a in kfs:
            pa = int(m.kf_parent[int(a)])
            if pa >= 0 and m.kf_valid[pa] and abs(pa - int(a)) > 1:
                key = (min(int(a), pa), max(int(a), pa))
                if key not in seen_parent:
                    seen_parent.add(key)
                    add_edge(int(a), pa, w=1.0)
        for a in kfs:
            row = m.covisibility_row(int(a))
            for b in np.nonzero(row >= 100)[0]:
                if b > a:
                    add_edge(int(a), int(b), w=1.0)
        # loop edges from earlier corrections
        for (a, b) in self.loop_edges:
            add_edge(int(a), int(b), w=5.0)
        # the loop edge with the measured Sim3: S_12 = S21⁻¹ relates nodes
        # S_kf1 ∘ S_kf2⁻¹
        if extra_edge is not None:
            e1, e2, s12, R12, t12, w12 = extra_edge
            edges_i.append(lut[e1]); edges_j.append(lut[e2])
            ms.append(s12); mR.append(R12); mt.append(t12); wts.append(w12)

        fixed = np.zeros(K, bool)
        for fk in fixed_ids:
            if lut[fk] >= 0:
                fixed[lut[fk]] = True
        if not fixed.any():
            fixed[0] = True

        if self.is_inertial():
            # yaw + translation only: gravity pins roll/pitch, the IMU scale
            dof = np.array([0, 0, 1, 1, 1, 1, 0], bool)
        elif self.fix_scale:
            dof = np.array([1, 1, 1, 1, 1, 1, 0], bool)
        else:
            dof = np.ones(7, bool)
        # the reference's size buckets (same padded problem; edges beyond the
        # largest bucket drop lowest-weight first, never the loop edges)
        E = len(ms)
        Kb = next((b for b in (16, 32, 64, 96, 128, 192, 256, 384, 512, 1024) if K <= b), None)
        Eb = next((b for b in (256, 512, 1024, 2048, 4096, 8192) if E <= b), 8192)
        if Kb is None:
            return
        edges_i = np.asarray(edges_i, np.int32)
        edges_j = np.asarray(edges_j, np.int32)
        ms_a = np.asarray(ms, np.float32)
        mR_a = np.stack(mR).astype(np.float32)
        mt_a = np.stack(mt).astype(np.float32)
        wts_a = np.asarray(wts, np.float32)
        if E > Eb:
            keep = np.argsort(-wts_a)[:Eb]
            edges_i, edges_j = edges_i[keep], edges_j[keep]
            ms_a, mR_a, mt_a, wts_a = ms_a[keep], mR_a[keep], mt_a[keep], wts_a[keep]
            E = Eb

        def padn(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        eyeK = np.tile(np.eye(3, dtype=np.float32), (Kb, 1, 1))
        eyeK[:K] = R0
        eyeE = np.tile(np.eye(3, dtype=np.float32), (Eb, 1, 1))
        eyeE[:E] = mR_a
        s_n, R_n, t_n, _ = posegraph.optimize_pose_graph(
            self._t(padn(s0, Kb, 1.0)), self._t(eyeK), self._t(padn(t0, Kb)),
            self._t(padn(np.ones(K, bool), Kb, False)), self._t(padn(fixed, Kb, True)),
            self._t(padn(edges_i, Eb)), self._t(padn(edges_j, Eb)),
            self._t(padn(ms_a, Eb, 1.0)), self._t(eyeE), self._t(padn(mt_a, Eb)),
            self._t(padn(np.ones(E, bool), Eb, False)), self._t(padn(wts_a, Eb)),
            iters=15, dof_mask=self._t(dof))
        s_n = s_n.cpu().numpy()[:K]
        R_n = R_n.cpu().numpy()[:K]
        t_n = t_n.cpu().numpy()[:K]

        # map points through their reference keyframe: x' = S_new⁻¹(S_old(x))
        mp_ids = m.valid_mp_ids()
        ref = m.mp_ref_kf[mp_ids]
        ref = np.where((ref >= 0) & (lut[np.clip(ref, 0, None)] >= 0), ref, kfs[0])
        ri = lut[ref]
        x = m.mp_xyz[mp_ids]
        x_old_cam = np.einsum("nij,nj->ni", m.kf_R[ref], x) + m.kf_t[ref]
        Rn = R_n[ri]; tn = t_n[ri]; sn = s_n[ri]
        x_new = np.einsum("nij,nj->ni", Rn.transpose(0, 2, 1), (x_old_cam - tn) / sn[:, None])
        m.mp_xyz[mp_ids] = x_new.astype(np.float32)
        m.touch()

        # SE3 keyframe poses: R, t/s
        m.kf_R[kfs] = R_n
        m.kf_t[kfs] = (t_n / s_n[:, None]).astype(np.float32)
