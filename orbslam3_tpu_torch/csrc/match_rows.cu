// Masked windowed Hamming top-2 per row ("match_rows") for Hopper (sm_90a),
// in a single-radius and a dual-radius form.
//
// Replaces orbslam3_tpu/ops/matching_pallas.py::match_rows, the Pallas TPU
// kernel behind projection matching. For each row i (a projected map point)
// over the columns j (frame features) that pass
//     |u_i - x_j| <= rad_i  and  |v_i - y_j| <= rad_i   (float32)
//     -octave_lo <= oct_j - lvl_i <= octave_hi
//     row_ok_i and feat_ok_j
// the distance is popcount(desc_i XOR desc_j) over 8 x 32-bit words; every
// other column counts as BIG = 10000. Per row it returns
//     idx    = lowest column among the minimum distances
//     best   = that minimum
//     second = minimum over all other columns (BIG when there are none)
// so a row with no candidate gives (0, BIG, BIG), exactly as the TPU kernel.
// The dual form returns this triple twice from one pass, for the radius
// rad_i and for wide * rad_i (the tracker's motion-model retry), bit for bit
// what two single-radius launches return.
//
// What bounds it on this card: the inputs are well under 1 MB, and on a
// 752x480 image a window of 7-15 px * 1.2^level admits well under 1% of the
// M x N pairs, so the work the inputs need is one window + octave test per
// pair (a few float32 compares, ~1e7-1e8 operations a call) and 8 POPC on
// the few survivors: operations, not bytes, and so few of them that launch
// latency and the longest warp's loop decide the time. The design therefore
//   * tests validity, octave and window FIRST and touches descriptors only
//     for the survivors (the earlier version popcounted every pair: at
//     4096 x 1024 that is 33.5 M POPC on a pipe that issues 16 per SM per
//     clock, the whole kernel time);
//   * gives a warp kRows rows and lets its 32 lanes stride over the columns;
//     a block of kWarps warps stages each chunk of 1024 columns once in
//     shared memory (12 KB: coordinates, and the octave with the column's
//     validity folded in) with cp.async, so all of a chunk's loads are in
//     flight together whatever the compiler schedules;
//   * runs two passes per chunk: a branch-free streaming pass over shared
//     memory that leaves one mask bit per column that passed, then a pass
//     over the set bits only, so the descriptor latency is paid once or
//     twice per row. (Measured on the way here: with the descriptor branch
//     inside the streaming loop, or with the columns read straight from
//     global memory, the compiler kept one or two steps' loads per basic
//     block and the kernel took 8-15 us whatever M was, each warp waiting
//     out 16-32 load latencies in a row.)
//   * keeps a running (best, col, second) per lane and row (two of them in
//     the dual form: a survivor of the wide window is popcounted once and
//     offered to both) and merges the 32 lanes with 5 warp shuffles in the
//     lexicographic order (distance, column), which reproduces the TPU
//     kernel's packed-key tie-break without its d*8192+col key and N<8192
//     limit;
//   * takes an optional leading batch dimension (gridDim.y) so the fuse runs
//     all its target keyframes in one launch;
//   * writes all outputs into ONE buffer the caller allocated:
//     (3, T, M) int32, or (2, 3, T, M) for the dual form (narrow, wide).
// It allocates nothing and never synchronises: the caller owns the outputs
// and the stream. Pointers: descriptors 16-byte, coordinates 8-byte aligned.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Block shape. scripts/match_rows_device_time.py builds and times variants of
// these two; 1 row per warp and 8 warps per block was the fastest pair over
// the tracking path's two shapes on an H100 (PERF.md).
#ifndef MR_ROWS_PER_WARP
#define MR_ROWS_PER_WARP 1
#endif
#ifndef MR_WARPS_PER_BLOCK
#define MR_WARPS_PER_BLOCK 8
#endif

namespace {

constexpr int kBig = 10000;
constexpr int kNone = 0x7fffffff;             // "no candidate yet"
constexpr int kRows = MR_ROWS_PER_WARP;       // rows per warp
constexpr int kWarps = MR_WARPS_PER_BLOCK;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = kRows * kWarps;
constexpr int kSteps = 32;                    // columns per lane and chunk: one mask bit each
constexpr int kChunk = 32 * kSteps;           // columns staged per chunk
constexpr int kNoOctave = -(1 << 30);         // fails every octave test (see launch)
static_assert(kChunk % kThreads == 0, "a block stages a chunk in whole rounds");

struct Top2 {
  int bd, bc, sd;                             // best distance, its column, second
};

__device__ __forceinline__ void take(int d, int c, Top2& s) {
  // lexicographic (d, c) minimum; the loser's distance is a second-best
  // candidate
  const bool better = (d < s.bd) || (d == s.bd && c < s.bc);
  s.sd = min(s.sd, better ? s.bd : d);
  s.bc = better ? c : s.bc;
  s.bd = better ? d : s.bd;
}

__device__ __forceinline__ void merge_lanes(Top2& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int od = __shfl_xor_sync(0xffffffffu, s.bd, off);
    const int oc = __shfl_xor_sync(0xffffffffu, s.bc, off);
    const int os = __shfl_xor_sync(0xffffffffu, s.sd, off);
    s.sd = min(s.sd, os);
    take(od, oc, s);
  }
}

__device__ __forceinline__ void store(const Top2& s, int32_t* out, int64_t plane,
                                      int64_t at) {
  const bool none = s.bd > kBig;
  out[at] = none ? 0 : s.bc;
  out[plane + at] = none ? kBig : s.bd;
  out[2 * plane + at] = s.sd;
}

__device__ __forceinline__ int hamming256(const int4& a0, const int4& a1,
                                          const int4& b0, const int4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

template <bool kDual>
__global__ void __launch_bounds__(kThreads)
match_rows_kernel(const int4* __restrict__ mp_desc, const float2* __restrict__ uv,
                  const float* __restrict__ rad, const int32_t* __restrict__ lvl,
                  const uint8_t* __restrict__ row_ok,
                  const int4* __restrict__ feat_desc, const float2* __restrict__ feat_xy,
                  const int32_t* __restrict__ feat_oct, const uint8_t* __restrict__ feat_ok,
                  int32_t* __restrict__ out, int M, int N, int octave_lo, int octave_hi,
                  float wide) {
  // one chunk of columns, staged for the whole block: coordinates, and the
  // octave with validity folded in (a switched-off or out-of-range column
  // carries an octave no row can accept)
  __shared__ float2 s_xy[kChunk];
  __shared__ int32_t s_oct[kChunk];

  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  const int64_t T = gridDim.y;
  const int64_t rbase = (int64_t)blockIdx.y * M;
  const int64_t cbase = (int64_t)blockIdx.y * N;
  mp_desc += rbase * 2;
  feat_desc += cbase * 2;
  feat_xy += cbase;
  feat_oct += cbase;
  feat_ok += cbase;

  float u[kRows], v[kRows], rn[kRows], rw[kRows];
  int lv[kRows];
  int4 a0[kRows], a1[kRows];                   // the rows' descriptors
  Top2 narrow[kRows], wider[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const bool live = row0 + k < M;              // a dead row matches nothing
    const int rr = live ? row0 + k : M - 1;
    const int64_t r = rbase + rr;
    const float2 p = uv[r];
    u[k] = p.x;
    v[k] = p.y;
    const bool ok = live && row_ok[r] != 0;
    const float rd = rad[r];
    // a switched-off row gets a radius no |difference| is below
    rn[k] = ok ? rd : -1.0f;
    rw[k] = kDual ? (ok ? __fmul_rn(wide, rd) : -1.0f) : rn[k];
    lv[k] = lvl[r];
    a0[k] = mp_desc[2 * rr];
    a1[k] = mp_desc[2 * rr + 1];
    narrow[k] = Top2{kNone, kNone, kBig};
    wider[k] = Top2{kNone, kNone, kBig};
  }

  // Columns go by in chunks of kChunk = 32 per lane. The block stages a
  // chunk in shared memory with asynchronous copies (every copy in flight
  // at once, no register waits on one). Pass 1 then streams the chunk with
  // no branch in the loop and leaves one bit per (step, row, radius) that
  // passed. Pass 2 visits only the set bits: survivors are few and spread
  // over the lanes, so the descriptor loads' latency is paid once or twice
  // per row, not once per survivor.
  for (int base = 0; base < N; base += kChunk) {
    if (base) __syncthreads();                   // the last chunk is read out
    uint8_t cok[kChunk / kThreads];
#pragma unroll
    for (int q = 0; q < kChunk / kThreads; ++q) {
      const int c = q * kThreads + threadIdx.x;
      const int j = min(base + c, N - 1);
      __pipeline_memcpy_async(&s_xy[c], &feat_xy[j], sizeof(float2));
      __pipeline_memcpy_async(&s_oct[c], &feat_oct[j], sizeof(int32_t));
      cok[q] = feat_ok[j];
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
#pragma unroll
    for (int q = 0; q < kChunk / kThreads; ++q) {
      const int c = q * kThreads + threadIdx.x;  // this thread's own copies
      if (cok[q] == 0 || base + c >= N) s_oct[c] = kNoOctave;
    }
    __syncthreads();

    unsigned mw[kRows], mn[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) mw[k] = mn[k] = 0u;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const float2 c = s_xy[32 * i + lane];
      const int oc = s_oct[32 * i + lane];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float du = fabsf(u[k] - c.x);
        const float dv = fabsf(v[k] - c.y);
        const int doct = oc - lv[k];
        const bool gate = (doct >= -octave_lo) & (doct <= octave_hi);
        mw[k] |= ((gate & (du <= rw[k]) & (dv <= rw[k])) ? 1u : 0u) << i;
        if (kDual) mn[k] |= ((gate & (du <= rn[k]) & (dv <= rn[k])) ? 1u : 0u) << i;
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      unsigned todo = kDual ? (mw[k] | mn[k]) : mw[k];
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int j = base + 32 * i + lane;
        const int dist = hamming256(a0[k], a1[k], feat_desc[2 * j], feat_desc[2 * j + 1]);
        if ((mw[k] >> i) & 1u) take(dist, j, wider[k]);
        if (kDual && ((mn[k] >> i) & 1u)) take(dist, j, narrow[k]);
      }
    }
  }

  const int64_t plane = T * M;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    merge_lanes(wider[k]);
    if (kDual) merge_lanes(narrow[k]);
    if (lane == 0 && row0 + k < M) {
      const int64_t at = rbase + row0 + k;
      if (kDual) {
        store(narrow[k], out, plane, at);
        store(wider[k], out + 3 * plane, plane, at);
      } else {
        store(wider[k], out, plane, at);
      }
    }
  }
}

template <bool kDual>
int launch(const void* mp_desc, const void* uv, const void* rad, const void* lvl,
           const void* row_ok, const void* feat_desc, const void* feat_xy,
           const void* feat_oct, const void* feat_ok, void* out, int T, int M, int N,
           int octave_lo, int octave_hi, float wide, void* stream) {
  if (T <= 0 || M <= 0) return (int)cudaSuccess;
  // lvl and feat_oct are pyramid levels: with these limits kNoOctave fails
  // the octave test of every row
  if (N <= 0 || T > 65535 || octave_lo < 0 || octave_lo > 64 || octave_hi < 0 ||
      octave_hi > 64)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, T);
  match_rows_kernel<kDual><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)mp_desc, (const float2*)uv, (const float*)rad, (const int32_t*)lvl,
      (const uint8_t*)row_ok, (const int4*)feat_desc, (const float2*)feat_xy,
      (const int32_t*)feat_oct, (const uint8_t*)feat_ok, (int32_t*)out, M, N,
      octave_lo, octave_hi, wide);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (3, T, M) int32 = idx, best, second.
extern "C" int match_rows_launch(const void* mp_desc, const void* uv, const void* rad,
                                 const void* lvl, const void* row_ok,
                                 const void* feat_desc, const void* feat_xy,
                                 const void* feat_oct, const void* feat_ok, void* out,
                                 int T, int M, int N, int octave_lo, int octave_hi,
                                 void* stream) {
  return launch<false>(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct,
                       feat_ok, out, T, M, N, octave_lo, octave_hi, 1.0f, stream);
}

// out: (2, 3, T, M) int32 = (idx, best, second) at rad, then at wide * rad.
extern "C" int match_rows_dual_launch(const void* mp_desc, const void* uv, const void* rad,
                                      const void* lvl, const void* row_ok,
                                      const void* feat_desc, const void* feat_xy,
                                      const void* feat_oct, const void* feat_ok,
                                      void* out, int T, int M, int N, int octave_lo,
                                      int octave_hi, float wide, void* stream) {
  return launch<true>(mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct,
                      feat_ok, out, T, M, N, octave_lo, octave_hi, wide, stream);
}
