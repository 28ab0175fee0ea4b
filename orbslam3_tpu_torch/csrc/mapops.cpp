// Native host-side map bookkeeping kernels.
//
// The reference implements its map data structures in C++ (KeyFrame/MapPoint
// pointer graphs with per-object mutexes, reference src/KeyFrame.cc,
// src/MapPoint.cc). This framework's map is flat SoA arrays; the few
// host-side operations that are genuinely hot in the SLAM driver loop —
// covisibility counting, observation lookup, fuse/replace with per-keyframe
// de-duplication — are implemented here in C++ and bound via ctypes
// (no pybind11 in the image; plain C ABI).
//
// Build: g++ -O3 -march=native -shared -fPIC mapops.cpp -o libmapops.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Shared-map-point counts between keyframe `kf` and every other keyframe.
// feat_mp: (n_kf, n_feat) int32 map-point id per feature (-1 = none).
// out: (n_kf,) int32.
void covisibility_row(const int32_t* feat_mp, const uint8_t* kf_valid,
                      int64_t n_kf, int64_t n_feat, int64_t kf, int64_t max_mp,
                      int32_t* out) {
    std::vector<uint8_t> in_kf(max_mp, 0);
    const int32_t* row = feat_mp + kf * n_feat;
    for (int64_t i = 0; i < n_feat; ++i) {
        int32_t mp = row[i];
        if (mp >= 0 && mp < max_mp) in_kf[mp] = 1;
    }
    for (int64_t k = 0; k < n_kf; ++k) {
        int32_t c = 0;
        if (kf_valid[k] && k != kf) {
            const int32_t* r = feat_mp + k * n_feat;
            for (int64_t i = 0; i < n_feat; ++i) {
                int32_t mp = r[i];
                if (mp >= 0 && mp < max_mp && in_kf[mp]) ++c;
            }
        }
        out[k] = c;
    }
}

// Observation count per map point over valid keyframes. out: (max_mp,) int32.
void obs_counts(const int32_t* feat_mp, const uint8_t* kf_valid,
                int64_t n_kf, int64_t n_feat, int64_t max_mp, int32_t* out) {
    std::memset(out, 0, sizeof(int32_t) * max_mp);
    for (int64_t k = 0; k < n_kf; ++k) {
        if (!kf_valid[k]) continue;
        const int32_t* r = feat_mp + k * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp >= 0 && mp < max_mp) ++out[mp];
        }
    }
}

// All observations of a set of map points (marked in `wanted`, size max_mp).
// Writes up to cap (kf_idx, feat_idx) pairs; returns the count.
int64_t observations_of(const int32_t* feat_mp, const uint8_t* kf_valid,
                        int64_t n_kf, int64_t n_feat, const uint8_t* wanted,
                        int64_t max_mp, int32_t* out_kf, int32_t* out_feat,
                        int64_t cap) {
    int64_t n = 0;
    for (int64_t k = 0; k < n_kf; ++k) {
        if (!kf_valid[k]) continue;
        const int32_t* r = feat_mp + k * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp >= 0 && mp < max_mp && wanted[mp]) {
                if (n < cap) {
                    out_kf[n] = (int32_t)k;
                    out_feat[n] = (int32_t)i;
                }
                ++n;
            }
        }
    }
    return n < cap ? n : cap;
}

// Point replacement (fuse): rewrite ids via lut, then de-duplicate per
// keyframe (keep the first occurrence; reference MapPoint::Replace keeps a
// single observation per KF). feat_mp modified in place.
void replace_points(int32_t* feat_mp, int64_t n_kf, int64_t n_feat,
                    const int32_t* lut, int64_t max_mp) {
    std::vector<int32_t> seen(max_mp, -1);
    for (int64_t k = 0; k < n_kf; ++k) {
        int32_t* r = feat_mp + k * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp < 0 || mp >= max_mp) continue;
            int32_t nid = lut[mp];
            if (nid < 0 || nid >= max_mp) { r[i] = -1; continue; }
            if (seen[nid] == (int32_t)k) {
                r[i] = -1;  // duplicate within this keyframe
            } else {
                seen[nid] = (int32_t)k;
                r[i] = nid;
            }
        }
    }
}


// ---------------------------------------------------------------------------
// Map-point refresh: distinctive descriptor (min-median Hamming), viewing
// normal, scale-invariance range (reference MapPoint::
// ComputeDistinctiveDescriptors + UpdateNormalAndDepth, src/MapPoint.cc).
// Replaces the per-point Python loop that dominated mapper host time.
// Outputs are written in place at the mp_ids rows; alive[j] = 0 when the
// point has no remaining observation (caller invalidates it).
void refresh_points(const int32_t* feat_mp, const uint8_t* kf_valid,
                    const uint32_t* kf_desc, const int32_t* kf_octave,
                    const float* kf_R, const float* kf_t,
                    int64_t n_kf, int64_t n_feat,
                    const int64_t* mp_ids, int64_t n_ids,
                    const float* mp_xyz, const float* scale_factors,
                    int64_t n_levels, int64_t max_mp,
                    uint32_t* mp_desc, float* mp_normal,
                    float* mp_min, float* mp_max, uint8_t* alive) {
    std::vector<int32_t> local(max_mp, -1);
    for (int64_t j = 0; j < n_ids; ++j) {
        int64_t id = mp_ids[j];
        if (id >= 0 && id < max_mp) local[id] = (int32_t)j;
    }
    // collect observations per wanted point (CSR)
    std::vector<int32_t> cnt(n_ids + 1, 0);
    for (int64_t k = 0; k < n_kf; ++k) {
        if (!kf_valid[k]) continue;
        const int32_t* r = feat_mp + k * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp >= 0 && mp < max_mp && local[mp] >= 0) ++cnt[local[mp] + 1];
        }
    }
    for (int64_t j = 0; j < n_ids; ++j) cnt[j + 1] += cnt[j];
    int64_t total = cnt[n_ids];
    std::vector<int32_t> obs_kf(total), obs_feat(total);
    std::vector<int32_t> fill(cnt.begin(), cnt.end() - 1);
    for (int64_t k = 0; k < n_kf; ++k) {
        if (!kf_valid[k]) continue;
        const int32_t* r = feat_mp + k * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp >= 0 && mp < max_mp && local[mp] >= 0) {
                int32_t p = fill[local[mp]]++;
                obs_kf[p] = (int32_t)k;
                obs_feat[p] = (int32_t)i;
            }
        }
    }
    std::vector<int32_t> ham;    // scratch pairwise distances
    std::vector<int32_t> med;
    for (int64_t j = 0; j < n_ids; ++j) {
        int64_t id = mp_ids[j];
        int32_t a = cnt[j], b = cnt[j + 1];
        int32_t kobs = b - a;
        if (kobs <= 0) { alive[j] = 0; continue; }
        alive[j] = 1;
        // pairwise Hamming; best descriptor = min median row
        ham.assign((size_t)kobs * kobs, 0);
        for (int32_t u = 0; u < kobs; ++u) {
            const uint32_t* du = kf_desc
                + ((int64_t)obs_kf[a + u] * n_feat + obs_feat[a + u]) * 8;
            for (int32_t v = u + 1; v < kobs; ++v) {
                const uint32_t* dv = kf_desc
                    + ((int64_t)obs_kf[a + v] * n_feat + obs_feat[a + v]) * 8;
                int32_t d = 0;
                for (int w = 0; w < 8; ++w)
                    d += __builtin_popcount(du[w] ^ dv[w]);
                ham[u * kobs + v] = d;
                ham[v * kobs + u] = d;
            }
        }
        int32_t best = 0, best_med = INT32_MAX;
        for (int32_t u = 0; u < kobs; ++u) {
            med.assign(ham.begin() + (size_t)u * kobs,
                       ham.begin() + (size_t)(u + 1) * kobs);
            std::nth_element(med.begin(), med.begin() + kobs / 2, med.end());
            int32_t m = med[kobs / 2];
            if (m < best_med) { best_med = m; best = u; }
        }
        const uint32_t* db = kf_desc
            + ((int64_t)obs_kf[a + best] * n_feat + obs_feat[a + best]) * 8;
        for (int w = 0; w < 8; ++w) mp_desc[id * 8 + w] = db[w];
        // normal = normalized mean of unit viewing directions
        const float* x = mp_xyz + id * 3;
        double nx = 0, ny = 0, nz = 0;
        float last_dist = 1.0f;
        for (int32_t u = 0; u < kobs; ++u) {
            const float* R = kf_R + (int64_t)obs_kf[a + u] * 9;
            const float* t = kf_t + (int64_t)obs_kf[a + u] * 3;
            // camera center c = -R^T t
            float c0 = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
            float c1 = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
            float c2 = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
            float dx = x[0] - c0, dy = x[1] - c1, dz = x[2] - c2;
            float nrm = std::sqrt(dx * dx + dy * dy + dz * dz);
            if (nrm < 1e-9f) nrm = 1e-9f;
            nx += dx / nrm; ny += dy / nrm; nz += dz / nrm;
            if (u == kobs - 1) last_dist = nrm;
        }
        double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
        if (nn < 1e-9) nn = 1e-9;
        mp_normal[id * 3 + 0] = (float)(nx / nn);
        mp_normal[id * 3 + 1] = (float)(ny / nn);
        mp_normal[id * 3 + 2] = (float)(nz / nn);
        // scale range from the last (reference) observation
        int32_t lvl = kf_octave[(int64_t)obs_kf[b - 1] * n_feat + obs_feat[b - 1]];
        if (lvl < 0) lvl = 0;
        if (lvl >= n_levels) lvl = (int32_t)n_levels - 1;
        float sf = scale_factors[lvl];
        mp_max[id] = last_dist * sf;
        mp_min[id] = last_dist * sf / scale_factors[n_levels - 1];
    }
}

// ---------------------------------------------------------------------------
// Keyframe redundancy (reference KeyFrameCulling src/LocalMapping.cc:1218):
// for each candidate keyframe, the fraction of its (>=3-observer) map points
// also seen by >=3 OTHER keyframes at the same or finer scale
// (scaleLevel_other <= scaleLevel_own + 1). kf_depth/th_depth reproduce the
// reference's far-stereo-point exclusion (th_depth <= 0 disables it).
void kf_redundancy(const int32_t* feat_mp, const uint8_t* kf_valid,
                   const int32_t* kf_octave, const float* kf_depth,
                   double th_depth, int64_t n_kf, int64_t n_feat,
                   const int32_t* cand, int64_t n_cand, int64_t max_mp,
                   int32_t* out_red, int32_t* out_total) {
    // union of candidate points
    std::vector<int32_t> local(max_mp, -1);
    int32_t n_pts = 0;
    for (int64_t c = 0; c < n_cand; ++c) {
        const int32_t* r = feat_mp + (int64_t)cand[c] * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp >= 0 && mp < max_mp && local[mp] < 0) local[mp] = n_pts++;
        }
    }
    // CSR of observations (kf, octave) per wanted point
    std::vector<int32_t> cnt(n_pts + 1, 0);
    for (int64_t k = 0; k < n_kf; ++k) {
        if (!kf_valid[k]) continue;
        const int32_t* r = feat_mp + k * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp >= 0 && mp < max_mp && local[mp] >= 0) ++cnt[local[mp] + 1];
        }
    }
    for (int32_t j = 0; j < n_pts; ++j) cnt[j + 1] += cnt[j];
    std::vector<int32_t> okf(cnt[n_pts]), ooct(cnt[n_pts]);
    std::vector<int32_t> fill(cnt.begin(), cnt.end() - 1);
    for (int64_t k = 0; k < n_kf; ++k) {
        if (!kf_valid[k]) continue;
        const int32_t* r = feat_mp + k * n_feat;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp >= 0 && mp < max_mp && local[mp] >= 0) {
                int32_t p = fill[local[mp]]++;
                okf[p] = (int32_t)k;
                ooct[p] = kf_octave[k * n_feat + i];
            }
        }
    }
    for (int64_t c = 0; c < n_cand; ++c) {
        int32_t k = cand[c];
        const int32_t* r = feat_mp + (int64_t)k * n_feat;
        const int32_t* oct = kf_octave + (int64_t)k * n_feat;
        const float* dep = kf_depth + (int64_t)k * n_feat;
        int32_t red = 0, total = 0;
        for (int64_t i = 0; i < n_feat; ++i) {
            int32_t mp = r[i];
            if (mp < 0 || mp >= max_mp || local[mp] < 0) continue;
            if (th_depth > 0 && (dep[i] > th_depth || dep[i] < 0)) continue;
            // reference KeyFrameCulling: nMPs counts EVERY good tracked
            // point (the denominator), and only the redundancy check is
            // gated on nObs > thObs(3). Fresh 2-obs frontier points thus
            // lower the redundancy fraction and protect their keyframe —
            // counting them out (the old behavior) made every frontier
            // keyframe look redundant and collapsed the map to 3 KFs on
            // exploratory paths (r4 longrun root cause).
            ++total;
            int32_t a = cnt[local[mp]], b = cnt[local[mp] + 1];
            if (b - a <= 3) continue;   // reference nObs > thObs(3)
            int32_t own = oct[i], n_scale = 0;
            for (int32_t u = a; u < b; ++u) {
                if (okf[u] == k) continue;
                if (ooct[u] <= own + 1) {
                    if (++n_scale >= 3) break;
                }
            }
            if (n_scale >= 3) ++red;
        }
        out_red[c] = red;
        out_total[c] = total;
    }
}

}  // extern "C"
