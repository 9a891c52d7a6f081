// One hop of the ring-halo R-GCN aggregation (K8) for Hopper (sm_90a).
//
// mpqe_ring_hop replaces the aggregation of the Pallas TPU kernel
// mpqe_tpu/ops/pallas_ring.py rgcn_ring_halo_rdma (:159; kernel body
// _ring_kernel :54, aggregate() :87).  The TPU kernel runs the whole ring
// inside one pallas_call per chip, with remote DMAs between two VMEM
// slots and ack tokens.  Here the copies run outside the kernel, on a copy
// stream ordered by CUDA events (ops/ring.py), and this kernel is one
// hop's aggregation for every part that lives on this device: one launch
// per hop, P launches per layer call on one card.
//
// At hop s, part p holds in slot `cur` the node block of part
// sb = (p - s) mod P and aggregates the edge bucket [p, sb], all f32:
//   xs_e   = slot[src_e]             (a zero row when src_e is outside
//                                     [0, block): the TPU's one-hot gather)
//   c_eb   = coeff[rel_e, b]         (0 when rel_e is outside [0, n_rels):
//                                     the zero rows of the TPU's coeff_p)
//   h_ebo  = sum_k xs_ek * V_b[k, o]       k ascending
//   acc_eo = sum_b c_eb * h_ebo            b ascending, from 0
//   m_eo   = acc_eo * norm_e
//   out[dst_e, o] += m_eo            per destination row the bucket's
//                                     edges in bucket order, hops in ring
//                                     order; dst_e outside [0, block)
//                                     (padding: dst == block) is dropped.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction), so the plain version in ops/ring.py, which runs the
// same operations in the same order, agrees bit for bit.  No atomics: the
// wrapper sorts each bucket's edges stably by destination once per layer
// call (perm, and offs[r] .. offs[r + 1] for row r) and every block owns
// one (part, 64 destination rows, 16 output columns) tile: it walks its
// rows' edges in bucket order and keeps one running sum per column,
// started from the row's current value in `out`.
//
// The transform is per edge (xs_e @ V_b for each edge of the bucket), as
// the TPU body computes it, not per source row of the held block followed
// by a gather.  Both give the same numbers; per row would do fewer
// products when a bucket holds more edges than the block has rows (the
// reference's 2^20-edge general graph: 8x fewer at P = 2, 2x at P = 8)
// but needs the [block, Bb, d_out] transform in device memory and a
// second pass; per edge is one pass and wins on the template batches,
// whose buckets hold fewer edges than rows.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores), counted in chip_smoke.py k8_work: the products, 2 d d_out Bb per
// edge, bound it on the general graph; the template batches are bound by
// their bytes.  This design is the simple one: products on the f32 pipes
// (no tensor cores, so that the sum order is fixed) and no FMA (one
// multiply and one add per term, half the FMA rate).  A block gathers 64
// edges' source rows into shared memory (row stride d + 1, no bank
// conflicts), then per basis loads V_b's 16-column tile (from L2: the
// whole basis is 1 MB at d = 128, Bb = 16, more than shared memory holds,
// hence the column tiles) and each thread computes 4 edges x 2 columns.
// Shared memory per block is (80 d + 64 Bb + 1,280) x 4 bytes, 49 KB at
// d = 128, Bb = 16; widths beyond the card's per-block limit (d = 697 at
// Bb = 16 on an H100) raise in the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CT = 16;                 // output columns per block
constexpr int NPAIR = CT / 2;          // threads across a column tile
constexpr int EG = THREADS / NPAIR;    // edge groups
constexpr int EPT = 4;                 // edges per thread
constexpr int ER = EG * EPT;           // edges per chunk (64)
constexpr int RT = 64;                 // destination rows per block

size_t smem_bytes(int K, int bb) {
  return sizeof(float) * ((size_t)ER * (K + 1)  // xs, row stride K + 1
                          + (size_t)K * CT      // V_b column tile
                          + (size_t)ER * bb     // coefficients
                          + (size_t)ER * CT     // messages
                          + (size_t)ER)         // norms
         + sizeof(int) * 2 * ER;                // src, dst
}

// grid.x = local part * row_tiles + row tile, grid.y = column tile.
__global__ void __launch_bounds__(THREADS)
ring_hop_kernel(const float* __restrict__ comm, const int* __restrict__ parts,
                int n_parts, int hop, int cur, int block, int K, int N,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ rel, const float* __restrict__ norm,
                const int* __restrict__ perm, const int* __restrict__ offs,
                int e_max, int row_tiles, const float* __restrict__ basis,
                int bb, const float* __restrict__ coeff, int n_rels,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int KP = K + 1;
  float* xs = smem;                         // [ER][KP]
  float* vs = xs + (size_t)ER * KP;         // [K][CT]
  float* cs = vs + (size_t)K * CT;          // [ER][bb]
  float* ms = cs + (size_t)ER * bb;         // [ER][CT]
  float* ns = ms + (size_t)ER * CT;         // [ER]
  int* ss = reinterpret_cast<int*>(ns + ER);  // [ER] src
  int* ds = ss + ER;                          // [ER] dst

  const int i = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * RT;
  const int r1 = min(r0 + RT, block);
  const int col0 = blockIdx.y * CT;
  const int p = parts[i];
  const int sb = ((p - hop) % n_parts + n_parts) % n_parts;
  const long long bucket = (long long)i * n_parts + sb;
  const int* o = offs + bucket * (block + 1);
  const int lo = o[r0], hi = o[r1];
  if (lo >= hi) return;  // the whole block: no edge into these rows
  const long long ebase = bucket * e_max;
  const float* slot = comm + ((long long)i * 2 + cur) * block * K;
  float* orow = out + (long long)i * block * N;
  const int tid = threadIdx.x;
  const int cp = tid % NPAIR, eg = tid / NPAIR;

  int run_dst = -1;  // the ordered sum: thread tid < CT owns column tid
  float run = 0.f;
  for (int c0 = lo; c0 < hi; c0 += ER) {
    const int n = min(ER, hi - c0);
    __syncthreads();  // the previous chunk's shared rows are consumed
    if (tid < ER) {
      int s = -1, d = -1, r = -1;
      float nv = 0.f;
      if (tid < n) {
        const long long e = ebase + perm[ebase + c0 + tid];
        s = src[e];
        d = dst[e];
        r = rel[e];
        nv = norm[e];
      }
      ss[tid] = s;
      ds[tid] = d;
      ns[tid] = nv;
      const bool ok = r >= 0 && r < n_rels;
      for (int b = 0; b < bb; ++b)
        cs[tid * bb + b] = ok ? coeff[(size_t)r * bb + b] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < ER * K; idx += THREADS) {
      const int j = idx / K, k = idx % K;
      const int s = ss[j];
      xs[j * KP + k] = (s >= 0 && s < block) ? slot[(long long)s * K + k]
                                             : 0.f;
    }
    float acc[EPT][2];
#pragma unroll
    for (int u = 0; u < EPT; ++u) acc[u][0] = acc[u][1] = 0.f;
    for (int b = 0; b < bb; ++b) {
      __syncthreads();  // xs gathered; the previous basis tile is read
      const float* vb = basis + (size_t)b * K * N;
      for (int idx = tid; idx < K * CT; idx += THREADS) {
        const int col = col0 + idx % CT;
        vs[idx] = col < N ? vb[(size_t)(idx / CT) * N + col] : 0.f;
      }
      __syncthreads();
      float h[EPT][2];
#pragma unroll
      for (int u = 0; u < EPT; ++u) h[u][0] = h[u][1] = 0.f;
      const float* xr = xs + (size_t)eg * EPT * KP;
      for (int k = 0; k < K; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(vs + k * CT + 2 * cp);
#pragma unroll
        for (int u = 0; u < EPT; ++u) {
          const float xv = xr[u * KP + k];
          h[u][0] = __fadd_rn(h[u][0], __fmul_rn(xv, v.x));
          h[u][1] = __fadd_rn(h[u][1], __fmul_rn(xv, v.y));
        }
      }
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const float c = cs[(eg * EPT + u) * bb + b];
        acc[u][0] = __fadd_rn(acc[u][0], __fmul_rn(c, h[u][0]));
        acc[u][1] = __fadd_rn(acc[u][1], __fmul_rn(c, h[u][1]));
      }
    }
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int j = eg * EPT + u;
      const float nv = ns[j];
      ms[j * CT + 2 * cp] = __fmul_rn(acc[u][0], nv);
      ms[j * CT + 2 * cp + 1] = __fmul_rn(acc[u][1], nv);
    }
    __syncthreads();
    if (tid < CT && col0 + tid < N) {
      const int col = col0 + tid;
      for (int j = 0; j < n; ++j) {
        const int d = ds[j];
        if (d != run_dst) {
          if (run_dst >= 0) orow[(long long)run_dst * N + col] = run;
          run_dst = d;
          run = orow[(long long)d * N + col];
        }
        run = __fadd_rn(run, ms[j * CT + tid]);
      }
    }
  }
  if (tid < CT && col0 + tid < N && run_dst >= 0)
    orow[(long long)run_dst * N + col0 + tid] = run;
}

}  // namespace

// Dynamic shared memory one block needs at input width K with bb bases.
extern "C" long long mpqe_ring_smem_bytes(int K, int bb) {
  return (long long)smem_bytes(K, bb);
}

extern "C" long long mpqe_ring_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (long long)optin;
}

// One hop for the n_local parts on this device.
//   comm   [n_local][2][block][K]  the parts' double buffers (slot `cur`
//                                  read);
//   parts  [n_local] int32         their global part ids in [0, n_parts);
//   src, dst, rel [n_local][n_parts][e_max] int32, norm the same f32: the
//                                  parts' rows of the [dst block, src
//                                  block, edge] buckets;
//   perm   [n_local][n_parts][e_max] int32: each bucket's edge positions
//                                  stably sorted by destination (out of
//                                  range last);
//   offs   [n_local][n_parts][block + 1] int32: row r's edges are
//                                  perm[offs[r] .. offs[r + 1]];
//   basis  [bb][K][N], coeff [n_rels][bb] f32;
//   out    [n_local][block][N] f32, added to.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpqe_ring_hop(const float* comm, const int* parts, int n_local,
                             int n_parts, int hop, int cur, int block, int K,
                             int N, const int* src, const int* dst,
                             const int* rel, const float* norm,
                             const int* perm, const int* offs, int e_max,
                             const float* basis, int bb, const float* coeff,
                             int n_rels, float* out, void* stream) {
  if (n_local <= 0 || n_parts <= 0 || block <= 0 || K <= 0 || N <= 0 ||
      e_max <= 0 || bb <= 0 || n_rels <= 0 || (cur != 0 && cur != 1))
    return (int)cudaErrorInvalidValue;
  const int row_tiles = (block + RT - 1) / RT;
  const long long gx = (long long)n_local * row_tiles;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, bb);
  cudaError_t err = cudaFuncSetAttribute(
      ring_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)gx, (N + CT - 1) / CT);
  ring_hop_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      comm, parts, n_parts, hop, cur, block, K, N, src, dst, rel, norm, perm,
      offs, e_max, row_tiles, basis, bb, coeff, n_rels, out);
  return (int)cudaGetLastError();
}
