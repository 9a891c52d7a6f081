// Blocked bf16 R-GCN messages (K6a) and their weight gradients (K6b) for
// Hopper (sm_90a), on the tensor cores.
//
// mpqe_rgcn_blocked_forward replaces the Pallas TPU kernel
// mpqe_tpu/ops/pallas_rgcn_blocked.py _messages_blocked_pallas (:253;
// kernel body _blocked_kernel :209); mpqe_rgcn_blocked_grad replaces
// _grad_blocked_pallas (:384; kernel body _grad_kernel :324).
//
// The function (ops/rgcn_blocked.py, plain versions), per real edge e:
//   xs = bf16 row x[src], ce = coeff[rel] (f32; 0 for rel outside
//   [0, n_rels)), h_b = xs @ V_b (bf16 x bf16, f32 sums),
//   acc = sum_b ce_b * h_b (b ascending, each product and sum rounded on
//   its own), msg = bf16(acc * norm);
//   out[dst] = sum of msg over the edges into dst, f32, in edge order.
// K6b, with gn = bf16(g[dst]) * norm (f32):
//   dbasis[b] = sum_e xs^T bf16(ce_b * gn), edges in order within each
//               fixed partition, then the partitions in order;
//   s_eb = bf16(sum_o (h_b * gn)_o), dcoeff[rel_e, b] = sum of s_eb the
//               same way.
// Every step runs in the plain versions' order and rounding except the
// K-deep sums inside the products h_b = xs @ V_b and xs^T @ rhs, which the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) take in their
// own order.  A message or an s_eb can therefore land one bf16 step from
// the plain one; ops/rgcn_blocked.py blocked_error_bound, grad_s_bound and
// the gates k6a_gate / k6b_gate state how far.  No float atomics: the
// result is the same bits run to run.
//
// Input lists (ops/rgcn_blocked.py layout_on, built once per layout): the
// layout's edges as rows (global src row, dst row, rel, norm's bits), the
// real ones first and the padding after them, never read.  K6a reads them
// sorted stably by destination (a CSR: csr_ptr, and cta_rows, the whole
// rows of each block, up to ~2048 edges a block); K6b in edge order with
// the first edge of each partition (part_ptr), and sorted by (partition,
// relation) for dcoeff.
//
// Bound on an H100 SXM (chip_smoke.py k6_work): 2 E Bb K N bf16 FLOP for
// K6a, twice that for K6b, over ~270 bytes of an edge's own data: at
// d = 128 and 16 bases 524,288 FLOP an edge, so the tensor cores' 989
// TFLOP/s bound it.  What the design does about it:
// * K6a: a block owns whole destination rows and one tile of CW (32 or
//   16) output columns.  It keeps that column slice of all Bb bases in
//   shared memory for its life (Bb x K x CW bf16, 128 KB at the flagship,
//   loaded once by cp.async, XOR-swizzled against bank conflicts), and
//   walks exactly its rows' edges in tiles of 128, the next tile's rows
//   gathered by cp.async into a second buffer while this one computes.
//   Each warp takes 32 edges and half the columns: their A fragments stay
//   in registers across all bases (K <= 128), each B fragment serves both
//   16-edge halves, two bases run side by side (independent mma.sync
//   chains), acc and msg stay in registers.  Messages go to shared
//   memory, and one thread per (column, run of a row's edges, found from
//   ballot masks of the row ends) adds them into the row in edge order;
//   a row that continues into the next tile is carried.  Each output row
//   is written once; rows without edges are written as 0.
// * K6b: one block per (edge partition, basis b).  V_b stays in shared
//   memory; per 64-edge tile the x and g rows are gathered once
//   (cp.async, four tiles in flight); h_b = xs @ V_b on the tensor cores
//   gives s_eb (products in registers, a fixed shuffle order), written
//   out, then rhs = bf16(ce_b * gn) and dbasis_p[b] += xs^T @ rhs on the
//   tensor cores with the [K, N] f32 sum in registers.  dcoeff_p[rel, b] is a
//   second pass: one thread per (partition, relation, basis) adds that
//   run's s_eb in edge order (layout_on sorts the edges into runs), in
//   place of a serial walk over every tile's edges inside the block that
//   the other warps waited on; the pass needs no shared memory per
//   relation, so the relation count has no limit.  The partitions'
//   partial sums are then added in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int FT = 128;     // K6a edges per tile (4 warp rows x 32)
constexpr int KS_REG = 8;   // k-steps of 16 whose A fragments K6a holds
constexpr int GT = 64;      // K6b edges per tile
constexpr int GS_N = 4;     // K6b tiles in flight (gathers 3 tiles ahead)
constexpr int GW = 128;     // K6b's largest (padded) K and N
constexpr int RED_THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float edge_ce(const float* __restrict__ coeff,
                                         int r, int b, int n_rels, int bb) {
  return (r >= 0 && r < n_rels) ? __ldg(coeff + (size_t)r * bb + b) : 0.f;
}

// ---------------------------------------------------------------- K6a
struct Fwd {
  const bf16* x;       // [n_rows][KP]
  const bf16* basis;   // [bb][KP][NP]
  const float* coeff;  // [n_rels][bb]
  const int4* csr;     // destination-sorted edges, real ones first:
                       //   (global src row, dst row, rel, norm's bits)
  const int* ptr;      // [n_cap + 1] first edge of each row
  const int* cta_rows; // [n_cta + 1] first row of each block
  float* out;          // [n_rows][N]
  int n_rows, n_rels, bb, KP, NP, N;
};

// 16-byte piece pc of basis row k in a CW-column slice, XOR-swizzled so
// that the 8 rows an ldmatrix reads fall in 8 different bank groups.
template <int CW>
__device__ __forceinline__ int vswz(int pc, int k) {
  return pc ^ ((k / (64 / CW)) & (CW / 8 - 1));
}

size_t fwd_smem_bytes(int nt, int KP, int bb) {
  const size_t CW = 8 * (size_t)nt;
  return (size_t)bb * KP * CW * 2           // the basis slice
         + 2 * (size_t)FT * (KP + 8) * 2    // xs, two buffers
         + (size_t)FT * CW * 2              // messages
         + 2 * (size_t)FT * 16              // src, dst, rel, norm, 2 buffers
         + 2 * CW * 4;                      // carried row sums
}

// The B fragments (16 k x 8 n each) of the NW n-tiles [n0, n0 + NW) at
// k-step ks of a CW-column basis slice (k rows of CW bf16, swizzled).
template <int CW, int NW>
__device__ __forceinline__ void load_slice_b(uint32_t (&bq)[NW][2],
                                             const bf16* vb, int ks, int n0,
                                             int lane) {
  const int k = ks * 16 + (lane & 15);
  if constexpr (NW == 1) {
    ldsm_x2_t(bq[0], vb + k * CW + vswz<CW>(n0, k) * 8);
  } else {
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, vb + k * CW + vswz<CW>(n0 + j + (lane >> 4), k) * 8);
      bq[j][0] = r[0];
      bq[j][1] = r[1];
      bq[j + 1][0] = r[2];
      bq[j + 1][1] = r[3];
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1) k6a_messages_kernel(Fwd P) {
  constexpr int CW = 8 * NT, NW = NT / 2;  // n-tiles a warp
  constexpr int SEGS = THREADS / CW, SL = FT / SEGS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = P.KP, XS = KP + 8, KSTEPS = KP / 16;
  bf16* vs = reinterpret_cast<bf16*>(smem);
  bf16* xs = vs + (size_t)P.bb * KP * CW;
  bf16* msg = xs + 2 * FT * XS;
  int* src_s = reinterpret_cast<int*>(msg + FT * CW);  // [2][FT] each
  int* dst_s = src_s + 2 * FT;
  int* rel_s = dst_s + 2 * FT;
  float* norm_s = reinterpret_cast<float*>(rel_s + 2 * FT);
  float* carry = norm_s + 2 * FT;  // [2][CW]
  __shared__ int carry_row[2];
  __shared__ unsigned run_end[FT / 32];  // bit q: edge q ends its row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.y * CW;
  const int r_lo = P.cta_rows[blockIdx.x];
  const int r_hi = min(P.cta_rows[blockIdx.x + 1], P.n_rows);
  if (r_lo >= r_hi) return;
  const int e_lo = P.ptr[r_lo], e_hi = P.ptr[r_hi];

  for (int r = r_lo + tid; r < r_hi; r += THREADS) {  // rows without edges
    if (P.ptr[r] != P.ptr[r + 1]) continue;
    float* o = P.out + (size_t)r * P.N;
    for (int c = col0; c < min(col0 + CW, P.N); ++c) o[c] = 0.f;
  }
  if (e_lo == e_hi) return;

  constexpr int VP = CW / 8;  // 16-byte pieces per basis row
  for (int i = tid; i < P.bb * KP * VP; i += THREADS) {
    const int row = i / VP, pc = i % VP, k = row % KP;
    cp_async16(vs + (size_t)row * CW + vswz<CW>(pc, k) * 8,
               P.basis + (size_t)row * P.NP + col0 + pc * 8, true);
  }
  // a tile's per-edge lists: loaded into registers one tile ahead (thread
  // q < FT holds edge q), stored to shared memory before its rows are
  // gathered
  int m_src = -1, m_dst = -1, m_rel = -1;
  float m_norm = 0.f;
  auto fetch = [&](int t) {
    const int e = e_lo + t * FT + tid;
    const int4 v = tid < FT && e < e_hi ? P.csr[e] : make_int4(-1, -1, -1, 0);
    m_src = v.x;
    m_dst = v.y;
    m_rel = v.z;
    m_norm = __int_as_float(v.w);
  };
  auto stage = [&](int t) {
    const int buf = t & 1;
    if (tid < FT) {
      src_s[buf * FT + tid] = m_src;
      dst_s[buf * FT + tid] = m_dst;
      rel_s[buf * FT + tid] = m_rel;
      norm_s[buf * FT + tid] = m_norm;
    }
  };
  const int XP = KP / 8;
  auto gather = [&](int t) {  // after stage(t) and a barrier
    const int buf = t & 1;
    bf16* xb = xs + buf * FT * XS;
    for (int i = tid; i < FT * XP; i += THREADS) {
      const int q = i / XP, pc = i % XP, row = src_s[buf * FT + q];
      const bool ok = row >= 0 && row < P.n_rows;
      cp_async16(xb + q * XS + pc * 8,
                 P.x + (ok ? (size_t)row * KP + pc * 8 : 0), ok);
    }
  };

  const int n_tiles = (e_hi - e_lo + FT - 1) / FT;
  if (tid == 0) carry_row[0] = -1;
  fetch(0);
  stage(0);
  __syncthreads();
  gather(0);
  cp_async_commit();
  if (n_tiles > 1) fetch(1);
  uint32_t af[2][KS_REG][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, cin = buf, cout = buf ^ 1;
    if (tid == 0) carry_row[cout] = -1;
    if (t + 1 < n_tiles) {
      stage(t + 1);
      __syncthreads();
      gather(t + 1);
      cp_async_commit();
      if (t + 2 < n_tiles) fetch(t + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // this warp's 32 edges x NW n-tiles (warp w: edges [32 (w % 4),
    // +32), n-tiles [NW (w / 4), +NW)): h_b on the tensor cores, acc and
    // msg in registers; fragment rows g, g + 8 of each 16-edge m-tile
    const bf16* xb = xs + buf * FT * XS;
    const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * NW;
    int row[2][2], rel[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        row[m][i] = m0 + 16 * m + 8 * i + (lane >> 2);
        rel[m][i] = rel_s[buf * FT + row[m][i]];
      }
    float acc[2][NW][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    // two bases at a time: 4 NW independent mma chains a warp
    for (int b = 0; b < P.bb; b += 2) {
      const bool two = b + 1 < P.bb;
      float ce[2][2][2];  // [basis][m][row]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ce[u][m][i] =
                (u == 0 || two)
                    ? edge_ce(P.coeff, rel[m][i], b + u, P.n_rels, P.bb)
                    : 0.f;
      float h[2][2][NW][4];  // [basis][m][n-tile]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < NW; ++j)
            h[u][m][j][0] = h[u][m][j][1] = h[u][m][j][2] = h[u][m][j][3] = 0.f;
      const bf16* vb0 = vs + (size_t)b * KP * CW;
      const bf16* vb1 = two ? vb0 + (size_t)KP * CW : vb0;
      for (int kc = 0; kc < KSTEPS; kc += KS_REG) {
        const int nks = min(KS_REG, KSTEPS - kc);
        if (b == 0 || KSTEPS > KS_REG) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int s = 0; s < KS_REG; ++s)
              if (s < nks)
                ldsm_x4(af[m][s], xb + (m0 + 16 * m + (lane & 15)) * XS +
                                      (kc + s) * 16 + (lane >> 4) * 8);
        }
        uint32_t bq[2][2][NW][2];  // [stage][basis][n-tile]
        load_slice_b<CW, NW>(bq[0][0], vb0, kc, n0, lane);
        load_slice_b<CW, NW>(bq[0][1], vb1, kc, n0, lane);
#pragma unroll
        for (int s = 0; s < KS_REG; ++s) {
          if (s < nks) {
            if (s + 1 < nks) {
              const int ks = kc + s + 1;
              load_slice_b<CW, NW>(bq[(s + 1) & 1][0], vb0, ks, n0, lane);
              load_slice_b<CW, NW>(bq[(s + 1) & 1][1], vb1, ks, n0, lane);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int j = 0; j < NW; ++j)
                  mma16816(h[u][m][j], af[m][s], bq[s & 1][u][j]);
          }
        }
      }
      // acc += ce_b * h_b, basis b, then basis b + 1
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)  // rows g (q < 2) and g + 8
              acc[m][j][q] = __fadd_rn(
                  acc[m][j][q], __fmul_rn(ce[u][m][q >> 1], h[u][m][j][q]));
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int ra = row[m][0], rb = row[m][1];
      const float na = norm_s[buf * FT + ra], nb = norm_s[buf * FT + rb];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int c = (n0 + j) * 8 + 2 * (lane & 3);
        msg[ra * CW + c] = __float2bfloat16_rn(__fmul_rn(acc[m][j][0], na));
        msg[ra * CW + c + 1] = __float2bfloat16_rn(__fmul_rn(acc[m][j][1], na));
        msg[rb * CW + c] = __float2bfloat16_rn(__fmul_rn(acc[m][j][2], nb));
        msg[rb * CW + c + 1] = __float2bfloat16_rn(__fmul_rn(acc[m][j][3], nb));
      }
    }
    {
      const int nt = min(FT, e_hi - (e_lo + t * FT));
      const int* dq = dst_s + buf * FT;
      if (tid < FT) {
        const bool end = tid < nt && (tid + 1 == nt || dq[tid + 1] != dq[tid]);
        const unsigned m = __ballot_sync(0xffffffffu, end);
        if (lane == 0) run_end[warp] = m;
      }
    }
    __syncthreads();

    // destination sums: thread (segment, column) adds every row whose run
    // of edges starts in its segment, in edge order; the tile's last row
    // is carried into the next tile unless this is the last one
    {
      const int c = tid % CW, seg = tid / CW, col = col0 + c;
      const int* dq = dst_s + buf * FT;
      const int nt = min(FT, e_hi - (e_lo + t * FT));
      const bool last = t + 1 == n_tiles;
      const int crow = carry_row[cin];
      if (seg == 0 && crow >= 0 && dq[0] != crow && col < P.N)
        P.out[(size_t)crow * P.N + col] = carry[cin * CW + c];
      // one past the first row end at or after edge i (i < nt)
      auto end_after = [&](int i) {
        int w = i >> 5;
        unsigned m = run_end[w] & (~0u << (i & 31));
        while (m == 0) m = run_end[++w];
        return (w << 5) + __ffs(m);
      };
      const int e_end = min(seg * SL + SL, nt);
      int e = seg * SL == 0 ? 0 : (seg * SL < nt ? end_after(seg * SL - 1)
                                                 : nt);
      while (e < e_end) {
        const int r = dq[e], f = end_after(e);
        float s = (e == 0 && r == crow) ? carry[cin * CW + c] : 0.f;
#pragma unroll 4
        for (int q = e; q < f; ++q)
          s = __fadd_rn(s, __bfloat162float(msg[q * CW + c]));
        if (f == nt && !last) {
          carry[cout * CW + c] = s;
          if (c == 0) carry_row[cout] = r;
        } else if (col < P.N) {
          P.out[(size_t)r * P.N + col] = s;
        }
        e = f;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K6b
struct Grad {
  const bf16* x;       // [n_rows][KP]
  const bf16* g;       // [n_rows][NP]
  const bf16* basis;   // [bb][KP][NP]
  const float* coeff;  // [n_rels][bb]
  const int4* edges;   // edges in edge order, real ones first: (global
                       //   src row, dst row, rel, norm's bits)
  const int* pos;      //   and each one's layout position
  const int* part_ptr; // [n_part + 1]
  float* s_out;        // [E][bb]: s_eb at each real edge's position
  float* partial;      // [n_part][T]
  int n_rows, n_rels, bb, K, N, KP, NP;
  long long T;
};

// 16-byte piece pc of row k of a 128-column bf16 tile (256-byte rows).
__device__ __forceinline__ int gswz(int pc, int k) { return pc ^ (k & 7); }

size_t grad_smem_bytes(int KP, int NP) {
  return (size_t)KP * GW * 2                // V_b
         + GS_N * (size_t)GT * (KP + 8) * 2 // xs, GS_N buffers
         + GS_N * (size_t)GT * (NP + 8) * 2 // g rows, GS_N buffers
         + (size_t)GT * GW * 2              // rhs
         + GS_N * (size_t)GT * 20           // src, dst, pos, norm, ce
         + 2 * (size_t)GT * 4;              // s halves
}

// B fragments of the 8 n-tiles [8 n0, 8 n0 + 8) at rows [r0, r0 + 16) of
// a 128-column swizzled tile (V_b: rows k; rhs: rows e); tiles at or past
// NP are left alone.
__device__ __forceinline__ void load_tile_b(uint32_t (&bq)[8][2],
                                            const bf16* t, int r0, int n0,
                                            int NP, int lane) {
  const int r = r0 + (lane & 15);
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    if ((n0 + j) * 8 < NP) {
      uint32_t q[4];
      ldsm_x4_t(q, t + r * GW + gswz(n0 + j + (lane >> 4), r) * 8);
      bq[j][0] = q[0];
      bq[j][1] = q[1];
      bq[j + 1][0] = q[2];
      bq[j + 1][1] = q[3];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) k6b_grad_kernel(Grad P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = P.KP, NP = P.NP, XS = KP + 8, GS = NP + 8;
  bf16* vs = reinterpret_cast<bf16*>(smem);
  bf16* xs = vs + (size_t)KP * GW;
  bf16* gs = xs + GS_N * GT * XS;
  bf16* rhs = gs + GS_N * GT * GS;
  int* src_s = reinterpret_cast<int*>(rhs + GT * GW);  // [GS_N][GT] each
  int* dst_s = src_s + GS_N * GT;
  int* pos_s = dst_s + GS_N * GT;
  float* norm_s = reinterpret_cast<float*>(pos_s + GS_N * GT);
  float* ce_s = norm_s + GS_N * GT;
  float* s_half = ce_s + GS_N * GT;  // [2][GT]

  const int p = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e_lo = P.part_ptr[p], e_hi = P.part_ptr[p + 1];

  const bf16* vg = P.basis + (size_t)b * KP * NP;
  for (int i = tid; i < KP * (NP / 8); i += THREADS) {
    const int k = i / (NP / 8), pc = i % (NP / 8);
    cp_async16(vs + k * GW + gswz(pc, k) * 8, vg + (size_t)k * NP + pc * 8,
               true);
  }
  // a tile's per-edge lists, one tile ahead in registers (thread q < GT
  // holds edge q), staged to shared memory before its rows are gathered
  int m_src = -1, m_dst = -1, m_rel = -1, m_pos = 0;
  float m_norm = 0.f, m_ce = 0.f;
  auto fetch = [&](int t) {
    const int e = e_lo + t * GT + tid;
    const bool ok = tid < GT && e < e_hi;
    const int4 v = ok ? P.edges[e] : make_int4(-1, -1, -1, 0);
    m_src = v.x;
    m_dst = v.y;
    m_rel = v.z;
    m_norm = __int_as_float(v.w);
    m_pos = ok ? P.pos[e] : 0;
    m_ce = edge_ce(P.coeff, m_rel, b, P.n_rels, P.bb);
  };
  auto stage = [&](int t) {
    const int buf = t % GS_N;
    if (tid < GT) {
      src_s[buf * GT + tid] = m_src;
      dst_s[buf * GT + tid] = m_dst;
      pos_s[buf * GT + tid] = m_pos;
      norm_s[buf * GT + tid] = m_norm;
      ce_s[buf * GT + tid] = m_ce;
    }
  };
  auto gather = [&](int t) {
    const int buf = t % GS_N;
    bf16* xb = xs + buf * GT * XS;
    bf16* gb = gs + buf * GT * GS;
    for (int i = tid; i < GT * (KP / 8); i += THREADS) {
      const int q = i / (KP / 8), pc = i % (KP / 8), row = src_s[buf * GT + q];
      const bool ok = row >= 0 && row < P.n_rows;
      cp_async16(xb + q * XS + pc * 8,
                 P.x + (ok ? (size_t)row * KP + pc * 8 : 0), ok);
    }
    for (int i = tid; i < GT * (NP / 8); i += THREADS) {
      const int q = i / (NP / 8), pc = i % (NP / 8), row = dst_s[buf * GT + q];
      const bool ok = row >= 0 && row < P.n_rows;
      cp_async16(gb + q * GS + pc * 8,
                 P.g + (ok ? (size_t)row * NP + pc * 8 : 0), ok);
    }
  };

  // dbasis[b] rows [32 wm, 32 wm + 32) x columns [64 wn, 64 wn + 64)
  const int wm = warp & 3, wn = warp >> 2;
  float dacc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dacc[m][j][0] = dacc[m][j][1] = dacc[m][j][2] = dacc[m][j][3] = 0.f;

  // GS_N - 1 tiles in flight ahead of the one computed; one commit group
  // per tile (empty past the last), the basis in the first
  const int n_tiles = (e_hi - e_lo + GT - 1) / GT;
  for (int i = 0; i < GS_N - 1 && i < n_tiles; ++i) {
    fetch(i);
    stage(i);
  }
  __syncthreads();
  for (int i = 0; i < GS_N - 1; ++i) {
    if (i < n_tiles) gather(i);
    cp_async_commit();
  }
  if (GS_N - 1 < n_tiles) fetch(GS_N - 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % GS_N, e0 = e_lo + t * GT, nt = min(GT, e_hi - e0);
    const int ahead = t + GS_N - 1;
    if (ahead < n_tiles) stage(ahead);
    __syncthreads();
    if (ahead < n_tiles) gather(ahead);
    cp_async_commit();
    if (ahead + 1 < n_tiles) fetch(ahead + 1);
    cp_async_wait<GS_N - 1>();
    __syncthreads();
    const bf16* xb = xs + buf * GT * XS;
    const bf16* gb = gs + buf * GT * GS;
    const float* nq = norm_s + buf * GT;

    // h_b = xs @ V_b for edges [16 wm, 16 wm + 16) x columns
    // [64 wn, 64 wn + 64); the partial sums of h_b * gn over them
    {
      float h[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
      const int m0 = wm * 16;
      uint32_t bq[2][8][2], a[2][4];
      const bf16* xa = xb + (m0 + (lane & 15)) * XS + (lane >> 4) * 8;
      load_tile_b(bq[0], vs, 0, wn * 8, NP, lane);
      ldsm_x4(a[0], xa);
      const int ksteps = KP / 16;
#pragma unroll
      for (int ks = 0; ks < GW / 16; ++ks) {
        if (ks < ksteps) {
          if (ks + 1 < ksteps) {
            load_tile_b(bq[(ks + 1) & 1], vs, (ks + 1) * 16, wn * 8, NP, lane);
            ldsm_x4(a[(ks + 1) & 1], xa + (ks + 1) * 16);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if ((wn * 8 + j) * 8 < NP) mma16816(h[j], a[ks & 1], bq[ks & 1][j]);
        }
      }
      const int r0 = m0 + (lane >> 2), r1 = r0 + 8;
      const float n0 = nq[r0], n1 = nq[r1];
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (wn * 8 + j) * 8 + 2 * (lane & 3);
        if (col < NP) {
          const float2 g0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(gb + r0 * GS + col));
          const float2 g1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(gb + r1 * GS + col));
          p0 = __fadd_rn(p0, __fmul_rn(h[j][0], __fmul_rn(g0.x, n0)));
          p0 = __fadd_rn(p0, __fmul_rn(h[j][1], __fmul_rn(g0.y, n0)));
          p1 = __fadd_rn(p1, __fmul_rn(h[j][2], __fmul_rn(g1.x, n1)));
          p1 = __fadd_rn(p1, __fmul_rn(h[j][3], __fmul_rn(g1.y, n1)));
        }
      }
      p0 = __fadd_rn(p0, __shfl_xor_sync(0xffffffffu, p0, 1));
      p1 = __fadd_rn(p1, __shfl_xor_sync(0xffffffffu, p1, 1));
      p0 = __fadd_rn(p0, __shfl_xor_sync(0xffffffffu, p0, 2));
      p1 = __fadd_rn(p1, __shfl_xor_sync(0xffffffffu, p1, 2));
      if ((lane & 3) == 0) {
        s_half[wn * GT + r0] = p0;
        s_half[wn * GT + r1] = p1;
      }
    }
    // rhs = bf16(ce_b * gn), per element as the plain version; thread
    // tid takes the column pair 2 (tid % 64) of every fourth edge
    if (2 * (tid & 63) < NP) {
      const int c = 2 * (tid & 63);
#pragma unroll 4
      for (int q = tid >> 6; q < GT; q += THREADS / 64) {
        const float ce = ce_s[buf * GT + q], nv = nq[q];
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gb + q * GS + c));
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(__fmul_rn(ce, __fmul_rn(gv.x, nv)));
        v.y = __float2bfloat16_rn(__fmul_rn(ce, __fmul_rn(gv.y, nv)));
        *reinterpret_cast<__nv_bfloat162*>(
            rhs + q * GW + gswz(c / 8, q) * 8 + (c & 7)) = v;
      }
    }
    __syncthreads();

    if (tid < nt)  // s_eb = bf16(left half + right half)
      P.s_out[(size_t)pos_s[buf * GT + tid] * P.bb + b] = __bfloat162float(
          __float2bfloat16_rn(__fadd_rn(s_half[tid], s_half[GT + tid])));
    // dbasis[b] += xs^T @ rhs over the tile's 64 edges
    {
      uint32_t bq[2][8][2];
      load_tile_b(bq[0], rhs, 0, wn * 8, NP, lane);
      const int kq = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < GT / 16; ++ks) {
        const int e = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (wm * 32 + m * 16 < KP)
            ldsm_x4_t(a[m], xb + e * XS + wm * 32 + m * 16 + kq);
        if (ks + 1 < GT / 16)
          load_tile_b(bq[(ks + 1) & 1], rhs, (ks + 1) * 16, wn * 8, NP, lane);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (wm * 32 + m * 16 < KP)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if ((wn * 8 + j) * 8 < NP)
                mma16816(dacc[m][j], a[m], bq[ks & 1][j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* dst = P.partial + (size_t)p * P.T;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = wm * 32 + m * 16 + (lane >> 2);
      const int col = (wn * 8 + j) * 8 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k + (i >> 1) * 8, cc = col + (i & 1);
        if (kk < P.K && cc < P.N)
          dst[((size_t)b * P.K + kk) * P.N + cc] = dacc[m][j][i];
      }
    }
  }
  const size_t off = (size_t)P.bb * P.K * P.N;  // dcoeff: 0 unless
  for (int r = tid; r < P.n_rels; r += THREADS)   // k6b_dcoeff_kernel adds
    dst[off + (size_t)r * P.bb + b] = 0.f;
}

// dcoeff partials.  The real edges sorted by (partition, relation), edge
// order kept within each run (layout_on, which also gives each entry its
// run's end): the thread of (first entry of a run, basis b) adds the
// run's s_eb in edge order into partial[p][off + r bb + b]; runs of
// out-of-range relations, and the padding entries after the real ones
// (rel -1), add nothing.
__global__ void __launch_bounds__(RED_THREADS)
k6b_dcoeff_kernel(const float* __restrict__ s, const int* __restrict__ pos,
                  const int4* __restrict__ dc, int E, int bb, int n_rels,
                  long long T, long long off, float* __restrict__ partial) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= (long long)E * bb) return;
  const int e = (int)(i / bb), b = (int)(i % bb);
  const int4 d = dc[e];  // (partition, relation, end of its run, 0)
  if (d.y < 0 || d.y >= n_rels || (e > 0 && dc[e - 1].z == d.z)) return;
  float acc = 0.f;  // the loads run ahead of the ordered adds
#pragma unroll 8
  for (int j = e; j < d.z; ++j)
    acc = __fadd_rn(acc, s[(size_t)pos[j] * bb + b]);
  partial[(size_t)d.x * T + off + (size_t)d.y * bb + b] = acc;
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

template <typename F>
cudaError_t set_smem(F kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

long long device_optin(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

template <int NT>
int launch_forward(const Fwd& P, int n_cta, size_t smem, cudaStream_t st) {
  cudaError_t err = set_smem(k6a_messages_kernel<NT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_cta, (unsigned)(P.NP / (8 * NT)));
  k6a_messages_kernel<NT><<<grid, THREADS, smem, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long mpqe_rgcn_blocked_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (long long)optin;
}

// Dynamic shared memory of the smallest K6a block at these widths (16
// columns), and with grad != 0 of the K6b block too: the larger.
extern "C" long long mpqe_rgcn_blocked_smem_bytes(int K, int N, int bb,
                                                  int grad) {
  const int KP = (K + 15) / 16 * 16, NP = (N + 31) / 32 * 32;
  size_t m = fwd_smem_bytes(2, KP, bb);
  if (grad) {
    const size_t g = grad_smem_bytes(KP, NP);
    m = m > g ? m : g;
  }
  return (long long)m;
}

// K6a.  x [n_rows][KP] and basis [bb][KP][NP] bf16, zero-padded (KP a
// multiple of 16, NP of 32), coeff [n_rels][bb] f32; the destination
// CSR of the layout's edges (csr [E] rows of (src, dst, rel, norm's
// bits), real ones first; ptr; cta_rows [n_cta + 1]); out [n_rows][N]
// f32.  The widest column tile (32 or 16) whose basis slice fits in
// shared memory.  Returns cudaGetLastError() after the launch.
extern "C" int mpqe_rgcn_blocked_forward(
    const void* x, int n_rows, const void* basis, const void* coeff,
    int n_rels, int bb, int KP, int NP, int N, const void* csr,
    const void* ptr, const void* cta_rows, int n_cta, float* out,
    void* stream) {
  if (n_rows <= 0 || n_rels <= 0 || bb <= 0 || KP <= 0 || KP % 16 ||
      NP <= 0 || NP % 32 || N <= 0 || N > NP || n_cta <= 0)
    return (int)cudaErrorInvalidValue;
  Fwd P{static_cast<const bf16*>(x), static_cast<const bf16*>(basis),
        static_cast<const float*>(coeff), static_cast<const int4*>(csr),
        static_cast<const int*>(ptr), static_cast<const int*>(cta_rows), out,
        n_rows, n_rels, bb, KP, NP, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long have = device_optin();
  for (int nt = 4; nt >= 2; nt /= 2) {
    const size_t smem = fwd_smem_bytes(nt, KP, bb);
    if ((long long)smem > have) continue;
    if (nt == 4) return launch_forward<4>(P, n_cta, smem, st);
    return launch_forward<2>(P, n_cta, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K6b: dbasis partials and s_eb, then the dcoeff partials, then the
// partitions' sum.  x [n_rows][KP], g [n_rows][NP] and basis [bb][KP][NP]
// bf16, zero-padded (K, N <= 128); the layout's E edges in edge order,
// real ones first (edges: rows of (src, dst, rel, norm's bits); pos) and
// part_ptr [n_part + 1]; the same E entries sorted by (partition,
// relation) (dc_pos; dc: rows of (partition, relation, run end, 0)); s
// [E][bb] f32 gets each real edge's s_eb at its layout position; partial
// [n_part][T] f32 scratch with T = bb K N + n_rels bb; out [T] = dbasis
// [bb][K][N] then dcoeff [n_rels][bb].
extern "C" int mpqe_rgcn_blocked_grad(
    const void* x, const void* g, int n_rows, const void* basis,
    const void* coeff, int n_rels, int bb, int K, int N, const void* edges,
    const void* pos, const void* part_ptr, int n_part, const void* dc_pos,
    const void* dc, int E, float* s, float* partial, float* out,
    void* stream) {
  const int KP = (K + 15) / 16 * 16, NP = (N + 31) / 32 * 32;
  if (n_rows <= 0 || n_rels <= 0 || bb <= 0 || bb > 65535 || K <= 0 ||
      N <= 0 || KP > GW || NP > GW || n_part <= 0 || E <= 0)
    return (int)cudaErrorInvalidValue;
  const long long T = (long long)bb * K * N + (long long)n_rels * bb;
  Grad P{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
         static_cast<const bf16*>(basis), static_cast<const float*>(coeff),
         static_cast<const int4*>(edges), static_cast<const int*>(pos),
         static_cast<const int*>(part_ptr), s, partial, n_rows, n_rels, bb, K,
         N, KP, NP, T};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = grad_smem_bytes(KP, NP);
  cudaError_t err = set_smem(k6b_grad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  k6b_grad_kernel<<<dim3((unsigned)n_part, (unsigned)bb), THREADS, smem,
                    st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n_dc = (long long)E * bb;
  k6b_dcoeff_kernel<<<(unsigned)((n_dc + RED_THREADS - 1) / RED_THREADS),
                      RED_THREADS, 0, st>>>(
      s, static_cast<const int*>(dc_pos), static_cast<const int4*>(dc), E,
      bb, n_rels, T, (long long)bb * K * N, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(unsigned)((T + RED_THREADS - 1) / RED_THREADS),
                           RED_THREADS, 0, st>>>(partial, n_part, T, out);
  return (int)cudaGetLastError();
}
