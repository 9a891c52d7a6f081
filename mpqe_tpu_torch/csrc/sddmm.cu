// Sampled dense-dense matmul, per-edge scores (K7), for Hopper (sm_90a).
//
// mpqe_sddmm replaces the Pallas TPU kernel mpqe_tpu/ops/pallas_sddmm.py
// sddmm_pallas (:48; kernel body _sddmm_kernel :34):
//   out[e] = sum_k x[src_e][k] * y[dst_e][k]   (f32, [E])
// and out[e] = 0 when src_e or dst_e lies outside [0, N) (the TPU kernel
// scores such an endpoint against a zero padding row).
//
// The TPU kernel gathers a chunk's rows with one-hot matmuls and sums the
// products of a row on the vector unit.  Here a warp owns 32 edges.  For
// each 32-wide slice of k it forms the products of all 32 edges, lane k
// of each edge's two rows at a time (two 128-byte loads per edge), rounds
// each product (__fmul_rn) and parks it in shared memory; then lane i adds
// edge i's 32 products in ascending k (__fadd_rn, no FMA contraction),
// continuing the sum of the slices before.  So every score is summed over
// k = 0, 1, ..., d - 1 from 0 with one rounding per operation, which the
// plain version (ops/sddmm.py) repeats: the two agree bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32): the larger of the
// bytes, x and y once (2 N d 4, at most 8,191 rows each: they stay in the
// 50 MB L2) plus src, dst and out (12 E), and 2 E d f32 operations
// (chip_smoke.py k7_work).  The gathers make the kernel read 2 E d 4
// bytes, from L2 once x and y are resident.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KT = 32;      // k per slice
constexpr int UNROLL = 8;   // edges whose rows are loaded together
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const int* __restrict__ src, const int* __restrict__ dst,
             int n_rows, int d, long long n_edges, float* __restrict__ out) {
  __shared__ float prod[WARPS][32][KT + 1];  // +1: lane i reads row i
  const int lane = threadIdx.x & 31, wid = threadIdx.x / 32;
  const long long e0 = ((long long)blockIdx.x * WARPS + wid) * 32;
  if (e0 >= n_edges) return;  // whole warps leave
  const long long e = e0 + lane;
  int s = 0, t = 0;
  bool valid = false;
  if (e < n_edges) {
    s = src[e];
    t = dst[e];
    valid = s >= 0 && s < n_rows && t >= 0 && t < n_rows;
  }
  const unsigned live = __ballot_sync(FULL, valid);
  float (*tile)[KT + 1] = prod[wid];
  float acc = 0.f;
  for (int k0 = 0; k0 < d; k0 += KT) {
    const int k = k0 + lane;
    for (int i = 0; i < 32; i += UNROLL) {
      float a[UNROLL], b[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long si = __shfl_sync(FULL, s, i + u);
        const long long ti = __shfl_sync(FULL, t, i + u);
        const bool ok = ((live >> (i + u)) & 1u) && k < d;
        a[u] = ok ? x[si * d + k] : 0.f;
        b[u] = ok ? y[ti * d + k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) tile[i + u][lane] = __fmul_rn(a[u], b[u]);
    }
    __syncwarp();
    const int kn = min(KT, d - k0);
    for (int j = 0; j < kn; ++j) acc = __fadd_rn(acc, tile[lane][j]);
    __syncwarp();  // the tile is rewritten by the next slice
  }
  if (e < n_edges) out[e] = valid ? acc : 0.f;
}

}  // namespace

// K7.  x, y [n_rows][d] f32; src, dst [n_edges] int32; out [n_edges] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpqe_sddmm(const float* x, const float* y, const int* src,
                          const int* dst, int n_rows, int d,
                          long long n_edges, float* out, void* stream) {
  if (n_rows <= 0 || d <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const long long warps = (n_edges + 31) / 32;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sddmm_kernel<<<(unsigned)blocks, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, y, src, dst, n_rows, d, n_edges, out);
  return (int)cudaGetLastError();
}
