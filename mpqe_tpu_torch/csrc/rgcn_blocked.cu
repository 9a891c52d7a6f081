// Blocked bf16 R-GCN messages (K6a) and their weight gradients (K6b) for
// Hopper (sm_90a).
//
// mpqe_rgcn_blocked_forward replaces the Pallas TPU kernel
// mpqe_tpu/ops/pallas_rgcn_blocked.py _messages_blocked_pallas (:253;
// kernel body _blocked_kernel :209); mpqe_rgcn_blocked_grad replaces
// _grad_blocked_pallas (:384; kernel body _grad_kernel :324).
//
// Layout (ops/rgcn_blocked.py bucket_edges_blocked, ops/template_layout.py
// template_blocked): edges in chunks of `chunk`; chunk i reads source
// block c_src[i] and writes destination block c_dst[i] (node blocks of sb
// rows); per edge a block-local src/dst id, a relation and a norm.  The
// chunks of one destination block are contiguous (blk_lo[g] .. blk_hi[g]).
// Padding edges have src_local == dst_local == sb and rel == n_rels.
//
// K6a, per edge e (rounding points of the reference):
//   xs = bf16 row x[c_src * sb + src_local] (0 for a padding src),
//   ce = coeff[rel] (f32; 0 for rel outside [0, n_rels)),
//   h_b = xs @ V_b (bf16 x bf16 products, exact in f32, summed over k
//         ascending), acc = sum_b ce_b * h_b (b ascending, each product
//         and sum rounded on its own), msg = bf16(acc * norm);
//   out[dst] = sum of msg over the edges into dst, f32, in edge order.
// K6b, with gn = bf16(g[c_dst * sb + dst_local]) * norm (f32):
//   dbasis[b] = sum_e xs^T bf16(ce_b * gn), edges in order within each
//               fixed partition, then the partitions in order;
//   s_eb = sum_o (h_b * gn)_o (o ascending), dcoeff[rel_e, b] = sum of
//               bf16(s_eb) the same way.
// The plain versions in ops/rgcn_blocked.py run the same operations in
// the same order, so kernel and plain version agree bit for bit.  No
// float atomics anywhere: the result is the same run to run.
//
// Bound on an H100 SXM, counting the function's own work
// (chip_smoke.py k6_work): bf16 x and basis, f32 coeff, the per-edge
// arrays and f32 outputs for bytes; 2 E Bb K N bf16 FLOP for K6a and
// about twice that for K6b (989 TFLOP/s on the tensor cores).  At d = 128
// and 16 bases an edge does 524,288 FLOP for ~270 bytes of its own:
// operations bound it.  This design is far from that bound on purpose:
// it runs the products on the f32 FMA pipes (1/15 of the bf16 tensor
// rate) so that every sum has a fixed order, because each message is
// rounded to bf16 before it is summed and last-bit noise would flip it.
//
// Parallelism: the train batch of 512 gives one node block and, for
// 1-chain, one chunk, so a grid over node blocks alone would use one SM.
// K6a's grid is (destination block) x (slice of RS destination rows) x
// (column tile of CT): each (row, column) of the output has exactly one
// owner block.  A block scans its destination block's edges in order,
// keeps those into its rows (an ordered compaction), computes their
// messages QN at a time and adds them to its rows in shared memory in
// edge order.  K6b runs four passes: s per (64-edge tile, basis); the
// per-partition dcoeff (one thread per basis, edges in order); the
// per-partition dbasis per (basis, 32-row x 64-column tile); then the
// partitions' partial sums in partition order (as K2 in fused_tgt.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CT = 64;           // output columns per block
constexpr int NPAIR = CT / 2;    // threads per edge group (column pairs)
constexpr int EG = THREADS / NPAIR;  // edge groups (8)
constexpr int QN = 64;           // edges per message batch
constexpr int EPT = QN / EG;     // edges per thread (8)
constexpr int RS = 32;           // destination rows per K6a block
constexpr int KT = 32;           // dbasis rows per pass-D block
constexpr int KPT = KT / EG;     // dbasis rows per thread (4)
constexpr int RED_THREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Layout {
  const int* src_l;
  const int* dst_l;
  const int* rel;
  const float* norm;
  const int* c_src;
  const int* c_dst;
  int chunk, sb, n_rels, bb, K, N, n_rows;
};

// Global node row of edge e's block-local id (src or dst), -1 for a
// padding id.  Looked up once per edge, so that the row loads that follow
// do not wait on a chain of three dependent loads each.
__device__ __forceinline__ int node_row(const int* local, const int* blk,
                                        long long e, const Layout& L) {
  const int l = local[e];
  const long long row = (long long)blk[e / L.chunk] * L.sb + l;
  return (l >= 0 && l < L.sb && row < L.n_rows) ? (int)row : -1;
}

// Rows rows[0 .. nq) of t ([n_rows][W] bf16) -> tile[q * W + c] as f32
// (0 for row -1).
__device__ __forceinline__ void gather_rows(float* tile, const int* rows,
                                            int nq,
                                            const __nv_bfloat16* __restrict__ t,
                                            int W) {
#pragma unroll 4
  for (int i = threadIdx.x; i < nq * W; i += THREADS) {
    const int q = i / W, c = i % W, row = rows[q];
    tile[i] = row >= 0 ? __bfloat162float(t[(size_t)row * W + c]) : 0.f;
  }
}

// V_b[:, col0 .. col0 + CT) -> vt[k * CT + c] (bf16; zero past N), 16 bytes
// a load where N allows it.
__device__ __forceinline__ void load_basis_tile(
    __nv_bfloat16* vt, const __nv_bfloat16* __restrict__ basis, int b,
    int col0, const Layout& L) {
  const __nv_bfloat16* vb = basis + (size_t)b * L.K * L.N;
  if ((L.N & 7) == 0) {
    constexpr int V = CT / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < L.K * V; i += THREADS) {
      const int k = i / V, c = (i % V) * 8, col = col0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col < L.N)
        v = *reinterpret_cast<const uint4*>(vb + (size_t)k * L.N + col);
      *reinterpret_cast<uint4*>(vt + k * CT + c) = v;
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < L.K * CT; i += THREADS) {
    const int k = i / CT, c = i % CT, col = col0 + c;
    vt[i] = col < L.N ? vb[(size_t)k * L.N + col] : zero;
  }
}

// h[i][j] = sum_k xs[(eg * EPT + i) * K + k] * vt[k][2 tc + j], k ascending.
__device__ __forceinline__ void edge_products(float (&h)[EPT][2],
                                              const float* xs,
                                              const __nv_bfloat16* vt, int K,
                                              int eg, int tc) {
#pragma unroll
  for (int i = 0; i < EPT; ++i) h[i][0] = h[i][1] = 0.f;
  const float* xr = xs + (size_t)eg * EPT * K;
  for (int k = 0; k < K; ++k) {
    const float2 wv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(vt + k * CT + 2 * tc));
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const float xv = xr[i * K + k];
      h[i][0] = fmaf(xv, wv.x, h[i][0]);  // exact product: one rounding
      h[i][1] = fmaf(xv, wv.y, h[i][1]);
    }
  }
}

size_t fwd_smem_bytes(int K, int bb) {
  return (size_t)RS * CT * 4            // outs
         + (size_t)(QN + THREADS) * 4   // queue
         + (size_t)QN * K * 4           // xs
         + (size_t)QN * bb * 4          // ce
         + (size_t)QN * CT * 4          // msg
         + (size_t)K * CT * 2;          // vt
}

// K6a.  grid.x = slice * n_ct + column tile, grid.y = destination block.
__global__ void __launch_bounds__(THREADS)
blocked_forward_kernel(Layout L, const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ basis,
                       const float* __restrict__ coeff,
                       const int* __restrict__ blk_lo,
                       const int* __restrict__ blk_hi, int n_ct,
                       int n_out_rows, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* outs = smem;
  int* queue = reinterpret_cast<int*>(outs + RS * CT);
  float* xs = reinterpret_cast<float*>(queue + QN + THREADS);
  float* ce = xs + (size_t)QN * L.K;
  float* msg = ce + (size_t)QN * L.bb;
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(msg + QN * CT);
  __shared__ int warp_cnt[THREADS / 32];
  __shared__ int q_row[QN], q_rel[QN], q_dst[QN];
  __shared__ float q_norm[QN];

  const int g = blockIdx.y;
  const int ct = blockIdx.x % n_ct, r0 = (blockIdx.x / n_ct) * RS;
  const int col0 = ct * CT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tc = tid % NPAIR, eg = tid / NPAIR;
  for (int i = tid; i < RS * CT; i += THREADS) outs[i] = 0.f;

  const long long e_lo = (long long)blk_lo[g] * L.chunk;
  const long long e_hi = (long long)blk_hi[g] * L.chunk;
  // queue[0 .. qlen): offsets from e_lo of the edges into rows
  // [r0, r0 + RS) not yet summed, in edge order; a batch of QN is
  // processed as soon as it is full, the rest after the last scan step
  int qlen = 0;
  for (long long base = e_lo; base < e_hi; base += THREADS) {
    const long long e = base + tid;
    bool hit = false;
    if (e < e_hi) {
      const int dl = L.dst_l[e];
      hit = dl >= r0 && dl < r0 + RS && dl < L.sb;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int off = 0, nq = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) off += warp_cnt[w];
      nq += warp_cnt[w];
    }
    if (hit)
      queue[qlen + off + __popc(m & ((1u << lane) - 1u))] = (int)(e - e_lo);
    qlen += nq;
    __syncthreads();
    const bool last = base + THREADS >= e_hi;
    while (qlen >= QN || (last && qlen > 0)) {
      const int nb = min(QN, qlen);
      if (tid < nb) {
        const long long ee = e_lo + queue[tid];
        q_row[tid] = node_row(L.src_l, L.c_src, ee, L);
        q_rel[tid] = L.rel[ee];
        q_dst[tid] = L.dst_l[ee] - r0;
        q_norm[tid] = L.norm[ee];
      }
      __syncthreads();
      gather_rows(xs, q_row, nb, x, L.K);
      for (int i = tid; i < nb * L.bb; i += THREADS) {
        const int q = i / L.bb, b = i % L.bb, r = q_rel[q];
        ce[i] = (r >= 0 && r < L.n_rels) ? coeff[(size_t)r * L.bb + b] : 0.f;
      }
      float acc[EPT][2];
#pragma unroll
      for (int i = 0; i < EPT; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int b = 0; b < L.bb; ++b) {
        __syncthreads();  // rows loaded; the previous basis tile read
        load_basis_tile(vt, basis, b, col0, L);
        __syncthreads();
        float h[EPT][2];
        edge_products(h, xs, vt, L.K, eg, tc);
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          const float c = ce[(eg * EPT + i) * L.bb + b];
          acc[i][0] = __fadd_rn(acc[i][0], __fmul_rn(c, h[i][0]));
          acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(c, h[i][1]));
        }
      }
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int q = eg * EPT + i;
        if (q < nb) {
          const float nv = q_norm[q];
          msg[q * CT + 2 * tc] = bf16_round(__fmul_rn(acc[i][0], nv));
          msg[q * CT + 2 * tc + 1] = bf16_round(__fmul_rn(acc[i][1], nv));
        }
      }
      __syncthreads();
      if (tid < CT) {  // one owner per column: edges in order
        for (int q = 0; q < nb; ++q) {
          const int r = q_dst[q];
          outs[r * CT + tid] = __fadd_rn(outs[r * CT + tid], msg[q * CT + tid]);
        }
      }
      // drop the summed edges, keep the rest in order
      const int rest = qlen - nb;
      const int keep = tid < rest ? queue[nb + tid] : 0;
      __syncthreads();
      if (tid < rest) queue[tid] = keep;
      __syncthreads();
      qlen = rest;
    }
  }
  __syncthreads();
  for (int i = tid; i < RS * CT; i += THREADS) {
    const int r = i / CT, c = i % CT;
    const long long row = (long long)g * L.sb + r0 + r;
    if (r0 + r < L.sb && row < n_out_rows && col0 + c < L.N)
      out[row * L.N + col0 + c] = outs[i];
  }
}

size_t s_smem_bytes(int K, int N) {
  return (size_t)QN * K * 4 + (size_t)QN * N * 4 * 2 + (size_t)K * CT * 2;
}

// K6b pass A.  grid = (64-edge tile, basis b): s[e][b] = bf16(sum_o
// (h_b * gn)_o), o ascending, for every edge of the tile.
__global__ void __launch_bounds__(THREADS)
grad_s_kernel(Layout L, const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ g16,
              const __nv_bfloat16* __restrict__ basis, long long E,
              float* __restrict__ s_out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [QN][K]
  float* gn = xs + (size_t)QN * L.K;      // [QN][N]
  float* prod = gn + (size_t)QN * L.N;    // [QN][N]
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(prod + (size_t)QN * L.N);
  __shared__ int q_src[QN], q_dst[QN];
  __shared__ float q_norm[QN];
  const int b = blockIdx.y;
  const long long e0 = (long long)blockIdx.x * QN;
  const int nq = (int)min((long long)QN, E - e0);
  const int tid = threadIdx.x, tc = tid % NPAIR, eg = tid / NPAIR;
  if (tid < nq) {
    q_src[tid] = node_row(L.src_l, L.c_src, e0 + tid, L);
    q_dst[tid] = node_row(L.dst_l, L.c_dst, e0 + tid, L);
    q_norm[tid] = L.norm[e0 + tid];
  }
  __syncthreads();
  gather_rows(xs, q_src, nq, x, L.K);
  gather_rows(gn, q_dst, nq, g16, L.N);
  __syncthreads();
  for (int i = tid; i < nq * L.N; i += THREADS)
    gn[i] = __fmul_rn(gn[i], q_norm[i / L.N]);
  for (int col0 = 0; col0 < L.N; col0 += CT) {
    __syncthreads();
    load_basis_tile(vt, basis, b, col0, L);
    __syncthreads();
    float h[EPT][2];
    edge_products(h, xs, vt, L.K, eg, tc);
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int q = eg * EPT + i, col = col0 + 2 * tc;
      if (q >= nq) continue;
      if (col < L.N)
        prod[q * L.N + col] = __fmul_rn(h[i][0], gn[q * L.N + col]);
      if (col + 1 < L.N)
        prod[q * L.N + col + 1] = __fmul_rn(h[i][1], gn[q * L.N + col + 1]);
    }
  }
  __syncthreads();
  if (tid < nq) {
    float s = 0.f;
    for (int o = 0; o < L.N; ++o) s = __fadd_rn(s, prod[tid * L.N + o]);
    s_out[(e0 + tid) * L.bb + b] = bf16_round(s);
  }
}

// K6b pass B.  Block p: dcoeff partial of the edges [p P, (p + 1) P), one
// thread per basis, edges in order, into partial[p][off + r * bb + b].
__global__ void grad_dcoeff_kernel(Layout L, const float* __restrict__ s,
                                   long long E, long long P,
                                   float* __restrict__ partial, long long T,
                                   long long off) {
  extern __shared__ __align__(16) float dc[];
  const int p = blockIdx.x, tid = threadIdx.x;
  const int n = L.n_rels * L.bb;
  for (int i = tid; i < n; i += blockDim.x) dc[i] = 0.f;
  __syncthreads();
  if (tid < L.bb) {
    const long long lo = (long long)p * P, hi = min(E, lo + P);
    for (long long e = lo; e < hi; ++e) {
      const int r = L.rel[e];
      if (r >= 0 && r < L.n_rels)
        dc[r * L.bb + tid] = __fadd_rn(dc[r * L.bb + tid], s[e * L.bb + tid]);
    }
  }
  __syncthreads();
  float* dst = partial + (size_t)p * T + off;
  for (int i = tid; i < n; i += blockDim.x) dst[i] = dc[i];
}

// K6b pass C.  grid = (partition p * n_kt * n_ct + tile, basis b): rows
// [k0, k0 + KT) x columns [col0, col0 + CT) of dbasis[b], summed over the
// partition's edges in order into partial[p][(b * K + k) * N + col].
__global__ void __launch_bounds__(THREADS)
grad_dbasis_kernel(Layout L, const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ g16,
                   const float* __restrict__ coeff, long long E, long long P,
                   int n_kt, int n_ct, float* __restrict__ partial,
                   long long T) {
  __shared__ __align__(16) float xs[QN * KT];
  __shared__ __align__(16) float rhs[QN * CT];
  const int b = blockIdx.y;
  const int per_p = n_kt * n_ct;
  const int p = blockIdx.x / per_p, t = blockIdx.x % per_p;
  const int k0 = (t / n_ct) * KT, col0 = (t % n_ct) * CT;
  const int tid = threadIdx.x, tc = tid % NPAIR, eg = tid / NPAIR;
  const long long lo = (long long)p * P, hi = min(E, lo + P);
  float acc[KPT][2];
#pragma unroll
  for (int i = 0; i < KPT; ++i) acc[i][0] = acc[i][1] = 0.f;
  __shared__ int q_src[QN], q_dst[QN];
  __shared__ float q_norm[QN], q_c[QN];
  for (long long e0 = lo; e0 < hi; e0 += QN) {
    const int nq = (int)min((long long)QN, hi - e0);
    __syncthreads();  // the previous tile is consumed
    if (tid < nq) {
      const long long e = e0 + tid;
      const int r = L.rel[e];
      q_src[tid] = node_row(L.src_l, L.c_src, e, L);
      q_dst[tid] = node_row(L.dst_l, L.c_dst, e, L);
      q_norm[tid] = L.norm[e];
      q_c[tid] = (r >= 0 && r < L.n_rels) ? coeff[(size_t)r * L.bb + b] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < nq * KT; i += THREADS) {
      const int q = i / KT, k = k0 + i % KT, row = q_src[q];
      xs[i] = (k < L.K && row >= 0)
                  ? __bfloat162float(x[(size_t)row * L.K + k]) : 0.f;
    }
#pragma unroll 4
    for (int i = tid; i < nq * CT; i += THREADS) {
      const int q = i / CT, o = col0 + i % CT, row = q_dst[q];
      const float v = (o < L.N && row >= 0)
                          ? __bfloat162float(g16[(size_t)row * L.N + o]) : 0.f;
      rhs[i] = bf16_round(__fmul_rn(q_c[q], __fmul_rn(v, q_norm[q])));
    }
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      const float2 rv = *reinterpret_cast<const float2*>(rhs + q * CT + 2 * tc);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float xv = xs[q * KT + eg * KPT + i];
        acc[i][0] = fmaf(xv, rv.x, acc[i][0]);  // exact product
        acc[i][1] = fmaf(xv, rv.y, acc[i][1]);
      }
    }
  }
  float* dst = partial + (size_t)p * T;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int k = k0 + eg * KPT + i, col = col0 + 2 * tc;
    if (k >= L.K) continue;
    const size_t at = ((size_t)b * L.K + k) * L.N + col;
    if (col < L.N) dst[at] = acc[i][0];
    if (col + 1 < L.N) dst[at + 1] = acc[i][1];
  }
}

// out[i] = sum_p partial[p][i], p ascending.
__global__ void __launch_bounds__(RED_THREADS)
reduce_partials_kernel(const float* __restrict__ partial, int n_part,
                       long long T, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= T) return;
  float acc = 0.f;
  for (int p = 0; p < n_part; ++p)
    acc = __fadd_rn(acc, partial[(size_t)p * T + i]);
  out[i] = acc;
}

bool make_layout(Layout& L, const void* src_l, const void* dst_l,
                 const void* rel, const void* norm, const void* c_src,
                 const void* c_dst, int chunk, int sb, int n_rels, int bb,
                 int K, int N, int n_rows) {
  if (chunk <= 0 || sb <= 0 || n_rels <= 0 || bb <= 0 || K <= 0 || N <= 0 ||
      n_rows <= 0)
    return false;
  L.src_l = static_cast<const int*>(src_l);
  L.dst_l = static_cast<const int*>(dst_l);
  L.rel = static_cast<const int*>(rel);
  L.norm = static_cast<const float*>(norm);
  L.c_src = static_cast<const int*>(c_src);
  L.c_dst = static_cast<const int*>(c_dst);
  L.chunk = chunk;
  L.sb = sb;
  L.n_rels = n_rels;
  L.bb = bb;
  L.K = K;
  L.N = N;
  L.n_rows = n_rows;
  return true;
}

template <typename F>
cudaError_t set_smem(F kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" long long mpqe_rgcn_blocked_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (long long)optin;
}

// Dynamic shared memory of the largest K6a / K6b block at these widths.
extern "C" long long mpqe_rgcn_blocked_smem_bytes(int K, int N, int bb,
                                                  int n_rels) {
  size_t m = fwd_smem_bytes(K, bb);
  m = m > s_smem_bytes(K, N) ? m : s_smem_bytes(K, N);
  const size_t dc = (size_t)n_rels * bb * 4;
  return (long long)(m > dc ? m : dc);
}

// K6a.  x [n_rows][K] bf16 (n_rows nodes; out has n_rows rows), basis
// [bb][K][N] bf16, coeff [n_rels][bb] f32; the layout's per-edge arrays;
// blk_lo / blk_hi [n_blocks] the chunk range of each destination block;
// out [n_rows][N] f32.  Returns cudaGetLastError() after the launch.
extern "C" int mpqe_rgcn_blocked_forward(
    const void* x, int n_rows, const void* basis, const void* coeff,
    int n_rels, int bb, int K, int N, const void* src_l, const void* dst_l,
    const void* rel, const void* norm, const void* c_src, const void* c_dst,
    const void* blk_lo, const void* blk_hi, int n_blocks, int chunk, int sb,
    float* out, void* stream) {
  Layout L;
  if (!make_layout(L, src_l, dst_l, rel, norm, c_src, c_dst, chunk, sb,
                   n_rels, bb, K, N, n_rows) ||
      n_blocks <= 0 || n_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(K, bb);
  cudaError_t err = set_smem(blocked_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (N + CT - 1) / CT, n_slices = (sb + RS - 1) / RS;
  const dim3 grid((unsigned)n_slices * n_ct, n_blocks);
  blocked_forward_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(basis),
      static_cast<const float*>(coeff), static_cast<const int*>(blk_lo),
      static_cast<const int*>(blk_hi), n_ct, n_rows, out);
  return (int)cudaGetLastError();
}

// K6b: passes A to D in stream order.  x [n_rows][K] and g [n_rows][N]
// bf16; the forward layout of E edges; partitions of P edges (n_part of
// them); s [E][bb] and partial [n_part][T] f32 scratch with T = bb K N +
// n_rels bb; out [T] = dbasis [bb][K][N] then dcoeff [n_rels][bb].
extern "C" int mpqe_rgcn_blocked_grad(
    const void* x, const void* g, int n_rows, const void* basis,
    const void* coeff, int n_rels, int bb, int K, int N, const void* src_l,
    const void* dst_l, const void* rel, const void* norm, const void* c_src,
    const void* c_dst, long long E, int chunk, int sb, long long P,
    int n_part, float* s, float* partial, float* out, void* stream) {
  Layout L;
  if (!make_layout(L, src_l, dst_l, rel, norm, c_src, c_dst, chunk, sb,
                   n_rels, bb, K, N, n_rows) ||
      E <= 0 || P <= 0 || n_part <= 0 || (long long)n_part * P < E ||
      bb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(basis);
  const float* cf = static_cast<const float*>(coeff);
  const long long T = (long long)bb * K * N + (long long)n_rels * bb;

  const size_t smem_s = s_smem_bytes(K, N);
  cudaError_t err = set_smem(grad_s_kernel, smem_s);
  if (err != cudaSuccess) return (int)err;
  grad_s_kernel<<<dim3((unsigned)((E + QN - 1) / QN), bb), THREADS, smem_s,
                  st>>>(L, xb, gb, vb, E, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_dc = (size_t)n_rels * bb * 4;
  if ((err = set_smem(grad_dcoeff_kernel, smem_dc)) != cudaSuccess)
    return (int)err;
  grad_dcoeff_kernel<<<n_part, 32 * ((bb + 31) / 32), smem_dc, st>>>(
      L, s, E, P, partial, T, (long long)bb * K * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int n_kt = (K + KT - 1) / KT, n_ct = (N + CT - 1) / CT;
  grad_dbasis_kernel<<<dim3((unsigned)n_part * n_kt * n_ct, bb), THREADS, 0,
                       st>>>(L, xb, gb, cf, E, P, n_kt, n_ct, partial, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  reduce_partials_kernel<<<(unsigned)((T + RED_THREADS - 1) / RED_THREADS),
                           RED_THREADS, 0, st>>>(partial, n_part, T, out);
  return (int)cudaGetLastError();
}
