// Masked windowed Hamming top-2 per row ("match_rows") for Hopper (sm_90a).
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
//
// What bounds it on this card: one call on the tracking path is about
// 4096 x 1024 pairs x (8 XOR + 8 POPC + window/octave tests) ~ 1e8 integer
// operations and reads well under 1 MB, so it is latency-bound: the launch,
// the per-column loop and the final row reduction, not bytes. The design
// therefore keeps everything on chip in one pass:
//   * one block = 32 rows x 8 column slices (256 threads); the 8 threads of a
//     row sit in one warp and each walks every 8th column, keeping its own
//     running (best, col, second) in registers;
//   * the feature columns stream through shared memory in tiles of 256,
//     descriptors stored word-major so the 8 slices read 8 consecutive
//     banks;
//   * the 8 partial top-2s of a row merge with 3 warp shuffles in the
//     lexicographic order (distance, column), which reproduces the TPU
//     kernel's packed-key tie-break without its d*8192+col key and N<8192
//     limit;
//   * an optional leading batch dimension (gridDim.y) lets the fuse run all
//     its target keyframes in one launch.
// It allocates nothing and never synchronises: the caller owns the outputs
// and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 10000;
constexpr int kSlices = 8;                    // threads per row
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kSlices * kRowsPerBlock;
constexpr int kTile = 256;                    // feature columns per smem tile
constexpr int kWords = 8;

__device__ __forceinline__ void take(int d, int c, int& bd, int& bc, int& sd) {
  // lexicographic (d, c) minimum; the loser's distance is a second-best
  // candidate
  const bool better = (d < bd) || (d == bd && c < bc);
  const int loser = better ? bd : d;
  sd = min(sd, loser);
  bc = better ? c : bc;
  bd = better ? d : bd;
}

__global__ void __launch_bounds__(kThreads)
match_rows_kernel(const int32_t* __restrict__ mp_desc, const float* __restrict__ uv,
                  const float* __restrict__ rad, const int32_t* __restrict__ lvl,
                  const uint8_t* __restrict__ row_ok,
                  const int32_t* __restrict__ feat_desc, const float* __restrict__ feat_xy,
                  const int32_t* __restrict__ feat_oct, const uint8_t* __restrict__ feat_ok,
                  int32_t* __restrict__ out_idx, int32_t* __restrict__ out_best,
                  int32_t* __restrict__ out_second,
                  int M, int N, int octave_lo, int octave_hi) {
  __shared__ uint32_t s_desc[kWords][kTile];
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ int32_t s_oct[kTile];
  __shared__ uint8_t s_ok[kTile];

  const int b = blockIdx.y;                       // batch entry
  const int slice = threadIdx.x % kSlices;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kSlices;
  const bool live = row < M;
  const int64_t r = (int64_t)b * M + (live ? row : 0);
  mp_desc += (int64_t)b * M * kWords;
  feat_desc += (int64_t)b * N * kWords;
  feat_xy += (int64_t)b * N * 2;
  feat_oct += (int64_t)b * N;
  feat_ok += (int64_t)b * N;

  uint32_t a[kWords];
  const int64_t rr = live ? row : 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) a[k] = (uint32_t)mp_desc[rr * kWords + k];
  const float u = uv[r * 2 + 0];
  const float v = uv[r * 2 + 1];
  const float rd = rad[r];
  const int lv = lvl[r];
  const bool rok = live && row_ok[r] != 0;

  int bd = 0x7fffffff, bc = 0x7fffffff, sd = kBig;

  for (int base = 0; base < N; base += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int col = base + j;
      if (col < N) {
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          s_desc[k][j] = (uint32_t)feat_desc[(int64_t)col * kWords + k];
        s_x[j] = feat_xy[(int64_t)col * 2 + 0];
        s_y[j] = feat_xy[(int64_t)col * 2 + 1];
        s_oct[j] = feat_oct[col];
        s_ok[j] = feat_ok[col];
      }
    }
    __syncthreads();
    const int n_here = min(kTile, N - base);
    for (int j = slice; j < n_here; j += kSlices) {
      int dist = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) dist += __popc(a[k] ^ s_desc[k][j]);
      const float du = fabsf(u - s_x[j]);
      const float dv = fabsf(v - s_y[j]);
      const int doct = s_oct[j] - lv;
      const bool cand = rok && s_ok[j] != 0 && du <= rd && dv <= rd &&
                        doct >= -octave_lo && doct <= octave_hi;
      take(cand ? dist : kBig, base + j, bd, bc, sd);
    }
  }

  // merge the 8 slices of this row (lanes 8q..8q+7 of one warp)
#pragma unroll
  for (int off = kSlices / 2; off > 0; off >>= 1) {
    const int od = __shfl_xor_sync(0xffffffffu, bd, off);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
    const int os = __shfl_xor_sync(0xffffffffu, sd, off);
    sd = min(sd, os);
    take(od, oc, bd, bc, sd);
  }
  if (live && slice == 0) {
    const bool none = bd > kBig;                  // N == 0
    out_idx[r] = none ? 0 : bc;
    out_best[r] = none ? kBig : bd;
    out_second[r] = sd;
  }
}

}  // namespace

extern "C" int match_rows_launch(const void* mp_desc, const void* uv, const void* rad,
                                 const void* lvl, const void* row_ok,
                                 const void* feat_desc, const void* feat_xy,
                                 const void* feat_oct, const void* feat_ok,
                                 void* out_idx, void* out_best, void* out_second,
                                 int T, int M, int N, int octave_lo, int octave_hi,
                                 void* stream) {
  if (T <= 0 || M <= 0) return (int)cudaSuccess;
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, T);
  match_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)mp_desc, (const float*)uv, (const float*)rad,
      (const int32_t*)lvl, (const uint8_t*)row_ok, (const int32_t*)feat_desc,
      (const float*)feat_xy, (const int32_t*)feat_oct, (const uint8_t*)feat_ok,
      (int32_t*)out_idx, (int32_t*)out_best, (int32_t*)out_second, M, N,
      octave_lo, octave_hi);
  return (int)cudaGetLastError();
}
