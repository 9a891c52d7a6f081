// Segment sum (K4a) and segment max (K4b) for Hopper (sm_90a).
//
// mpqe_segment_sum replaces the Pallas TPU kernel
// mpqe_tpu/ops/pallas_segment.py segment_sum_pallas (:56; kernel body
// _segment_sum_kernel :39); mpqe_segment_max replaces segment_max_pallas
// (:120; kernel body _segment_max_kernel :100).
//
//   K4a:  out[s] = sum of data[e] over the rows e with id_e == s, f32;
//   K4b:  out[s] = max(-1e30, max of data[e] over the same rows), with a
//         NaN in any term giving NaN (jnp.maximum's rule; fmaxf would
//         drop it), so an empty segment keeps -1e30 (the reference's
//         NEG_INF, not -inf).
// Rows whose id is outside [0, S) belong to no segment.  The wrapper
// (ops/segment_kernels.py) prepares the layout: a stable sort of the ids
// gives `perm`, the row numbers grouped by segment and in ascending row
// order within a segment, and `offs[s]` .. `offs[s + 1]` is segment s's
// range of `perm` (out-of-range rows sort after segment S - 1).
//
// The TPU kernel adds a chunk's rows into all segments at once with a
// one-hot matmul, chunks in grid order.  There is no one-hot matmul here:
// each (segment, 128-column tile) has one owner warp that adds its rows
// in ascending row order, one rounding per add (__fadd_rn), starting from
// 0.  So the sums have one fixed order and no atomics, and the plain
// version (a stable sort and one index_add_ per rank within a segment)
// adds in the same order: the two agree bit for bit.  A max is exact, so
// only NaN needs care there.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes, E d 4 of rows and E 4 of
// ids in, S d 4 out (chip_smoke.py k4_work); one add or compare per input
// element is far below the f32 rate.  The owner warp reads each of its
// rows once as 32 lanes x 4 strided columns (128-byte transactions), and
// takes its row numbers 32 at a time with one load and warp shuffles;
// eight rows are loaded before they are added, so the loads overlap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // four warps, one (segment, tile) each
constexpr int WARPS = THREADS / 32;
constexpr int CPL = 4;        // columns per lane
constexpr int TILE = 32 * CPL;  // columns per warp
constexpr int UNROLL = 8;     // rows loaded before they are added
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <bool MAX>
__device__ __forceinline__ float combine(float acc, float v) {
  if (MAX) return (v > acc || isnan(v)) ? v : acc;  // NaN sticks in acc
  return __fadd_rn(acc, v);
}

template <bool MAX>
__global__ void __launch_bounds__(THREADS)
segment_kernel(const float* __restrict__ data, const int* __restrict__ perm,
               const int* __restrict__ offs, int n_seg, int d, int n_tiles,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= (long long)n_seg * n_tiles) return;  // whole warps leave
  const int s = (int)(w / n_tiles);
  const int col0 = (int)(w % n_tiles) * TILE + lane;
  bool ok[CPL];
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    ok[j] = col0 + 32 * j < d;
    acc[j] = MAX ? NEG_INF : 0.f;
  }
  const int lo = offs[s], hi = offs[s + 1];
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int n = min(32, hi - r0);  // the same in every lane
    const int my_row = lane < n ? perm[r0 + lane] : 0;
    for (int i = 0; i < n; i += UNROLL) {
      float v[UNROLL][CPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long row = __shfl_sync(FULL, my_row, (i + u) & 31);
        const float* p = data + row * d + col0;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          v[u][j] = (i + u < n && ok[j]) ? p[32 * j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u < n) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[j] = combine<MAX>(acc[j], v[u][j]);
        }
      }
    }
  }
  float* o = out + (long long)s * d + col0;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (ok[j]) o[32 * j] = acc[j];
}

template <bool MAX>
int launch(const float* data, const int* perm, const int* offs, int n_seg,
           int d, float* out, void* stream) {
  if (n_seg < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  const int n_tiles = (d + TILE - 1) / TILE;
  const long long warps = (long long)n_seg * n_tiles;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_kernel<MAX><<<(unsigned)blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      data, perm, offs, n_seg, d, n_tiles, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K4a.  data [E][d] f32; perm [E] int32 (rows grouped by segment, each
// segment's rows ascending); offs [n_seg + 1] int32; out [n_seg][d] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpqe_segment_sum(const float* data, const int* perm,
                                const int* offs, int n_seg, int d,
                                float* out, void* stream) {
  return launch<false>(data, perm, offs, n_seg, d, out, stream);
}

// K4b.  The same arguments; empty segments get -1e30.
extern "C" int mpqe_segment_max(const float* data, const int* perm,
                                const int* offs, int n_seg, int d,
                                float* out, void* stream) {
  return launch<true>(data, perm, offs, n_seg, d, out, stream);
}
