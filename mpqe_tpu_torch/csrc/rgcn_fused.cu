// Relation-chunked R-GCN edge messages (K5a, K5b) for Hopper (sm_90a).
//
// mpqe_rgcn_msg_basis replaces the Pallas TPU kernel
// mpqe_tpu/ops/pallas_rgcn.py _messages_pallas_basis (:145; kernel body
// _msg_kernel_basis :105); mpqe_rgcn_msg_wrel replaces
// _messages_pallas_wrel (:193; kernel body _msg_kernel_wrel :126).
//
// The edges come in chunks of `chunk` rows that share one relation
// (ops/rgcn_fused.py chunk_by_relation, ops/template_layout.py
// template_chunked).  Per chunk c, with K = d_in and N = d_out, all f32:
//   K5a:  W = c_0 V_0 + c_1 V_1 + ... (b ascending; ccoeff [n_chunks][Bb]
//         is pad-masked by the wrapper, so a padding chunk gets W = 0);
//   K5b:  W = w_rel[crel[c]] (crel clamped by the wrapper; padding edges
//         rely on norm == 0);
//   out[e] = (xs[e] @ W) * norm[e], xs[e] = x[clamp(src[e])] (the gather
//   is fused here; with src == nullptr xs[e] = x[e], the backward's dxs).
// Every f32 value has one fixed order and one rounding per operation:
// W's terms b ascending, the product over k ascending, then * norm, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction).  The plain versions in ops/rgcn_fused.py run the same
// operations in the same order, so kernel and plain version agree bit
// for bit.  This is the Pallas kernel's Precision.HIGHEST: no TF32, no
// bf16.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores), counting the function's own work (chip_smoke.py k5_work): the
// bytes of xs (the gathered rows), norm, the chunk coefficients or
// relation ids, the weights (the basis once, or each distinct relation's
// W once) and the output, and 2 E K N FLOP.  At d = 128 an edge does
// 32,768 FLOP for about 1 KB of row in and out, 32 FLOP per byte, over the
// f32 balance point of 20: the f32 operations bound it (E = 1M: 0.51 ms
// against 0.31 ms of bytes).  This design is the simple
// one: products on the f32 pipes (no tensor cores, so that the sum order
// is fixed), one block per (chunk, 64-column tile, row split) that first
// builds its W column tile in shared memory (for K5a from the L2-resident
// basis) and then streams the chunk's rows through it in tiles of 32
// gathered rows.  The row split gives a chunk several blocks when there
// are few chunks (the train batch of 512 has one to four).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CT = 64;              // output columns per block
constexpr int NPAIR = CT / 2;       // threads per row group (column pairs)
constexpr int RG = THREADS / NPAIR; // row groups
constexpr int RPT = 4;              // rows per thread
constexpr int TR = RG * RPT;        // rows per pass (32)

size_t smem_bytes(int K) {
  return (size_t)K * CT * sizeof(float) + (size_t)TR * K * sizeof(float);
}

// grid.x = chunk * split + s, grid.y = column tile.
template <bool BASIS>
__global__ void __launch_bounds__(THREADS)
msg_kernel(const float* __restrict__ x, int n_rows,
           const int* __restrict__ src, const float* __restrict__ w,
           int bb, const float* __restrict__ ccoeff,
           const int* __restrict__ crel, const float* __restrict__ norm,
           int chunk, int split, int rps, int K, int N,
           float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                  // [K][CT] W column tile
  float* xs = smem + (size_t)K * CT; // [TR][K] gathered rows
  const int c = blockIdx.x / split, s = blockIdx.x % split;
  const int col0 = blockIdx.y * CT;
  const int tid = threadIdx.x;

  // W column tile; for K5a one sweep of the tile per basis, b ascending
  // (each thread owns the same elements in every sweep, so the loads of a
  // sweep are independent and in flight together)
  if (BASIS) {
    const float* cf = ccoeff + (size_t)c * bb;
    for (int b = 0; b < bb; ++b) {
      const float cb = cf[b];
      const float* vb = w + (size_t)b * K * N;
#pragma unroll 4
      for (int i = tid; i < K * CT; i += THREADS) {
        const int col = col0 + i % CT;
        const float p = col < N ? __fmul_rn(cb, vb[(size_t)(i / CT) * N + col])
                                : 0.f;
        ws[i] = b == 0 ? p : __fadd_rn(ws[i], p);
      }
    }
  } else {
    const float* wr = w + (size_t)crel[c] * K * N;
#pragma unroll 4
    for (int i = tid; i < K * CT; i += THREADS) {
      const int col = col0 + i % CT;
      ws[i] = col < N ? wr[(size_t)(i / CT) * N + col] : 0.f;
    }
  }

  const int tc = tid % NPAIR, rg = tid / NPAIR;
  const int col = col0 + 2 * tc;
  const long long lo = (long long)c * chunk + (long long)s * rps;
  const long long hi = min((long long)(c + 1) * chunk, lo + rps);
  __shared__ long long rows[TR];
  for (long long r0 = lo; r0 < hi; r0 += TR) {
    __syncthreads();  // W built; the previous tile's rows read
    if (tid < TR) {  // one index lookup per row, not per element
      const long long e = r0 + tid;
      rows[tid] = e >= hi ? -1 : (src ? min(max(src[e], 0), n_rows - 1) : e);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < TR * K; i += THREADS) {
      const long long row = rows[i / K];
      xs[i] = row >= 0 ? x[row * K + i % K] : 0.f;
    }
    __syncthreads();
    float acc[RPT][2];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = 0.f;
    const float* xr = xs + (size_t)rg * RPT * K;
    for (int k = 0; k < K; ++k) {
      const float2 wv = *reinterpret_cast<const float2*>(ws + k * CT + 2 * tc);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float xv = xr[i * K + k];
        acc[i][0] = __fadd_rn(acc[i][0], __fmul_rn(xv, wv.x));
        acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(xv, wv.y));
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long e = r0 + rg * RPT + i;
      if (e >= hi) continue;
      const float nv = norm[e];
      if (col < N) out[e * N + col] = __fmul_rn(acc[i][0], nv);
      if (col + 1 < N) out[e * N + col + 1] = __fmul_rn(acc[i][1], nv);
    }
  }
}

template <bool BASIS>
int launch(const float* x, int n_rows, const int* src, const float* w,
           int bb, const float* ccoeff, const int* crel, const float* norm,
           int n_chunks, int chunk, int split, int K, int N, float* out,
           void* stream) {
  if (n_chunks < 0 || chunk <= 0 || split <= 0 || K <= 0 || N <= 0 ||
      n_rows <= 0 || (BASIS && bb <= 0))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  // rows per split, a whole number of passes
  const int rps = ((chunk + split - 1) / split + TR - 1) / TR * TR;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      msg_kernel<BASIS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_chunks * split, (N + CT - 1) / CT);
  msg_kernel<BASIS><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n_rows, src, w, bb, ccoeff, crel, norm, chunk, split, rps, K, N, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs at input width K.
extern "C" long long mpqe_rgcn_msg_smem_bytes(int K) {
  return (long long)smem_bytes(K);
}

extern "C" long long mpqe_rgcn_msg_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (long long)optin;
}

// K5a.  x [n_rows][K]; src [n_chunks * chunk] or null; basis [bb][K][N];
// ccoeff [n_chunks][bb]; norm [n_chunks * chunk]; out [n_chunks * chunk][N].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpqe_rgcn_msg_basis(const float* x, int n_rows, const int* src,
                                   const float* basis, int bb,
                                   const float* ccoeff, const float* norm,
                                   int n_chunks, int chunk, int split, int K,
                                   int N, float* out, void* stream) {
  return launch<true>(x, n_rows, src, basis, bb, ccoeff, nullptr, norm,
                      n_chunks, chunk, split, K, N, out, stream);
}

// K5b.  As K5a with w_rel [R][K][N] and crel [n_chunks] in [0, R).
extern "C" int mpqe_rgcn_msg_wrel(const float* x, int n_rows, const int* src,
                                  const float* w_rel, const int* crel,
                                  const float* norm, int n_chunks, int chunk,
                                  int split, int K, int N, float* out,
                                  void* stream) {
  return launch<false>(x, n_rows, src, w_rel, 0, nullptr, crel, norm,
                       n_chunks, chunk, split, K, N, out, stream);
}
