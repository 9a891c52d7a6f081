// Sampled dense-dense matmul, per-edge scores (K7), for Hopper (sm_90a).
//
// mpqe_sddmm replaces the Pallas TPU kernel mpqe_tpu/ops/pallas_sddmm.py
// sddmm_pallas (:48; kernel body _sddmm_kernel :34):
//   out[e] = sum_k x[src_e][k] * y[dst_e][k]   (f32, [E])
// and out[e] = 0 when src_e or dst_e lies outside [0, N) (the TPU kernel
// scores such an endpoint against a zero padding row).
//
// The sum order (the plain version in ops/sddmm.py repeats it, so the two
// agree bit for bit).  A group of G = 8 lanes owns an edge; lane g of the
// group owns the positions k = 32 j + 4 g + v (j = 0 .. ceil(d / 32) - 1,
// v = 0 .. 3).  Lane g sums its products from 0 over j ascending, then v
// ascending: acc_g = fl(acc_g + fl(x[k] y[k])), each product and each add
// rounded once (__fmul_rn / __fadd_rn, no contraction); a position k >= d
// adds the product of two zeros, +0.  Then a fixed butterfly over the
// group: acc_g += acc_(g xor m) for m = 4, 2, 1, i.e.
//   score = ((acc_0 + acc_4) + (acc_2 + acc_6))
//           + ((acc_1 + acc_5) + (acc_3 + acc_7)),
// the same bits in every lane (an IEEE add is commutative).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32): the larger of the
// bytes, x and y once (2 N d 4, at most 8,191 rows each: they stay in the
// 50 MB L2) plus src, dst and out (12 E), and 2 E d f32 operations
// (chip_smoke.py k7_work).  The gathers make the kernel read 2 E d 4
// bytes, from L2 once x and y are resident, so the L2's gather rate sets
// its pace.  What the design does about it: each lane loads 16 bytes of a
// row at a time (d % 4 == 0 and 16-byte aligned rows; 4-byte loads
// otherwise, same order), a group covers 512 contiguous bytes of a row
// per slice, and every lane has U = 2 edges' rows (up to 128 floats of
// each) in flight before it adds; no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int G = 8;                 // lanes per edge
constexpr int GROUPS = THREADS / G;  // edges per block and round
constexpr int U = 2;                 // rounds of edges in flight per lane
constexpr int JC = 4;                // 32-wide k slices loaded at once
constexpr unsigned FULL = 0xffffffffu;

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int k, int d,
                                        bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok) return v;
  if (VEC) {  // d % 4 == 0: k < d means all four lie inside the row
    if (k < d) v = __ldg(reinterpret_cast<const float4*>(row + k));
  } else {
    if (k < d) v.x = __ldg(row + k);
    if (k + 1 < d) v.y = __ldg(row + k + 1);
    if (k + 2 < d) v.z = __ldg(row + k + 2);
    if (k + 3 < d) v.w = __ldg(row + k + 3);
  }
  return v;
}

__device__ __forceinline__ float add_prod(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const int* __restrict__ src, const int* __restrict__ dst,
             int n_rows, int d, long long n_edges, float* __restrict__ out) {
  const int g = threadIdx.x % G, grp = threadIdx.x / G;
  const long long base = (long long)blockIdx.x * GROUPS * U;
  const int J = (d + 31) / 32;
  long long e[U];
  bool ok[U];
  const float* xr[U];
  const float* yr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    e[u] = base + u * GROUPS + grp;
    int s = 0, t = 0;
    ok[u] = false;
    if (e[u] < n_edges) {
      s = src[e[u]];
      t = dst[e[u]];
      ok[u] = s >= 0 && s < n_rows && t >= 0 && t < n_rows;
    }
    if (!ok[u]) s = t = 0;
    xr[u] = x + (size_t)s * d;
    yr[u] = y + (size_t)t * d;
  }
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  for (int j0 = 0; j0 < J; j0 += JC) {
    float4 a[U][JC], b[U][JC];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int k = 32 * (j0 + jj) + 4 * g;
        a[u][jj] = load4<VEC>(xr[u], k, d, ok[u]);
        b[u][jj] = load4<VEC>(yr[u], k, d, ok[u]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        if (j0 + jj >= J) break;  // the same J for every lane
        acc[u] = add_prod(acc[u], a[u][jj].x, b[u][jj].x);
        acc[u] = add_prod(acc[u], a[u][jj].y, b[u][jj].y);
        acc[u] = add_prod(acc[u], a[u][jj].z, b[u][jj].z);
        acc[u] = add_prod(acc[u], a[u][jj].w, b[u][jj].w);
      }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1)
      acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(FULL, acc[u], m));
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (g == 0 && e[u] < n_edges) out[e[u]] = ok[u] ? acc[u] : 0.f;
}

}  // namespace

// K7.  x, y [n_rows][d] f32; src, dst [n_edges] int32; out [n_edges] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpqe_sddmm(const float* x, const float* y, const int* src,
                          const int* dst, int n_rows, int d,
                          long long n_edges, float* out, void* stream) {
  if (n_rows <= 0 || d <= 0 || n_edges < 0) return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const long long blocks = (n_edges + GROUPS * U - 1) / (GROUPS * U);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    sddmm_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        x, y, src, dst, n_rows, d, n_edges, out);
  else
    sddmm_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        x, y, src, dst, n_rows, d, n_edges, out);
  return (int)cudaGetLastError();
}
