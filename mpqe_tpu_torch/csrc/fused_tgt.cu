// Shared-relation fused TGT forward (K1) and its backward (K2) for Hopper
// (sm_90a), on the tensor cores.
//
// mpqe_tgt_forward replaces the Pallas TPU kernel
// mpqe_tpu/ops/pallas_fused_fwd.py fused_tgt_forward (:704; kernel body
// _make_kernel :158).  mpqe_tgt_backward replaces fused_tgt_backward
// (:569; kernel body _make_bwd_kernel :473).
//
// Both take the layer chain that ops/fused_fwd.py assembles on the host:
// the layer-0 operand X_0 [B, k_0] bf16 (anchor rows, then the variable
// one-hot block), per layer a block weight matrix W_l [k_l, n_l] bf16 and
// an f32 bias row b_l [n_l].
//   K1:  Y_l = X_l W_l + b_l (bf16 x bf16 products summed in f32),
//        X_{l+1} = bf16(relu(Y_l)); out = Y_last[:, :d].
//   K2:  recompute the chain, then from the last layer down
//        gb = bf16(g); dW_l = X_l^T gb; db_l = sum_rows g;
//        g <- (gb W_l^T) * [X_l > 0]; at layer 0 the anchor column blocks
//        of gb W_0^T are dA.
// K1's variants, the reference's out_bf16 and fold_bias: with out_bf16
// the last layer's output is stored as bf16 pairs (round to nearest even;
// the f32 sums are unchanged), so it is the bf16 rounding of the f32
// output bit for bit.  fold_bias needs nothing here: the wrapper moves
// layer 0's bias into a row of W_0 fed by a constant-1 column of X_0 and
// hands a zero bias row, which the epilogue adds as any other (y + 0 is
// y); the wrapper's block list then holds the one-hot block against every
// output block of layer 0.
// The mask X_l > 0 is the plain version's Y_{l-1} > 0 except where
// 0 < Y_{l-1} is so small that bf16 rounds it to 0 (below ~2^-133): bf16
// keeps f32's exponent range, so no larger positive value rounds to 0.
//
// Only the d_pad x d_pad blocks of W_l that the weight assembly can make
// nonzero are multiplied (ops/fused_fwd.py chain_blocks derives them from
// the structure's plan, once): a zero block adds exact zeros, so the
// function is unchanged.  The wrapper hands the kernels tile tables built
// from that list: one int4 per weight tile (layer | direction | flags,
// output column, contraction start).  dW blocks off the list reach no
// parameter and are written as 0.
//
// The K-deep sums inside each product run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate) in their own order, so a value can
// differ from the plain version's one-by-one sum in its last bits, and a
// bf16 rounding between layers can turn that into a one-step flip.
// ops/fused_fwd.py chain_gate states how far kernel and plain version may
// differ.  Every other sum has a fixed order and there are no float
// atomics: a repeat launch gives the same bits.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor), counting the
// function's own work (chip_smoke.py chain_work: 2 B d^2 FLOP per nonzero
// block, bytes for the anchor rows, one mode id per variable slot and
// row, the nonzero weights and the output): bytes bound K1 at every
// batch, and K2 except 3-chain at B = 131,072.  What the design does:
// * a block owns TQ rows (8 to 128, chosen by the wrapper from B and the
//   widths) and keeps their activations in shared memory as bf16 for the
//   whole chain, so K1 reads only X_0, the weights and the bias and
//   writes only the output;
// * the weights stream through shared memory in stages of 64 x 128 (or
//   128 x 64 for W^T; 32 at TQ = 8) by 16-byte cp.async, 3 deep (2 at
//   TQ = 8), in ONE pipeline over every stage of the launch (across
//   chunks, layers and K2's turn from recompute to reverse sweep), so no
//   layer waits for its first weights; each stage serves all TQ rows;
// * 8 warps split a TQ x 128 output chunk; fragments come from ldmatrix
//   (.trans for W, plain for W^T: the same W tile layout serves both, so
//   no transposed copy of W_l exists), those of the next 16-deep step
//   loaded before the products of this one; rows of shared memory are
//   padded by 16 bytes against bank conflicts;
// * a chunk's sums stay in the mma registers over its stages and are
//   written once, by the epilogue, with every load it needs issued
//   before its first store.
//
// K2's dW is a reduction over rows, i.e. across blocks, which on Hopper
// run in no order.  Three launches, all by mpqe_tgt_backward:
//   A  per row tile: recompute, walk back, write dA, the activations X_l
//      (l >= 1) and bf16(g_l) to scratch, and per tile the column sums
//      of g_l (db), rows in a fixed tree order;
//   B  per (listed 128 x 128 block of dW_l, row partition): X_l^T
//      bf16(g_l) over the partition's rows on the tensor cores;
//   C  per element: the partitions' dW in partition order, 0 off the
//      list; per element of db, a warp: the tiles' sums in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int NC = 128;       // output columns per chunk
constexpr int KT = 32;        // contraction rows of one tile-table entry
constexpr int PAD = 8;        // bf16 of padding per shared-memory row
constexpr int MAXL = 8;       // layers
constexpr int DW_ROWS = 64;   // pass B: batch rows per staged tile
constexpr int DW_STAGES = 3;
constexpr int RED_THREADS = 256;

// Table entries per pipeline stage: 2 (64 rows of contraction a barrier)
// with tiles of 16 rows or more, 1 with 8 (the narrowest footprint: the
// widest chains).  Every chunk has a multiple of d_pad / KT >= 4 entries,
// so a stage never spans two chunks.
__host__ __device__ constexpr int entries_per_stage(int tq) {
  return tq >= 16 ? 2 : 1;
}
__host__ __device__ constexpr int fwd_stage(int ks) { return ks * (NC + PAD); }
__host__ __device__ constexpr int rev_stage(int ks) { return NC * (ks + PAD); }

// tile-table flags (bits 8.. of int4.x)
constexpr int T_LAST = 1;      // the chunk's last tile: epilogue after it
constexpr int T_NEWLAYER = 2;  // the layer's (or direction's) first tile

struct Chain {
  int L, B, d, dpad, n_a;
  int out_bf16;          // K1: the output in bf16 (else f32)
  int k[MAXL], n[MAXL];
  const bf16* w[MAXL];   // W_l [k_l][n_l]
  const float* b[MAXL];  // b_l [n_l]
};

// Shared-memory layout of one chain block (bf16 elements): two
// activation buffers (K2 also reuses them for the cotangents), then the
// weight stages.
struct Lay {
  int buf1;   // offset of activation buffer 1
  int gbuf1;  // offset of cotangent buffer 1 (K2)
  int act;    // elements of the activation region
  int stage;  // elements of one weight stage
};

struct Bwd {
  const float* g;        // [B][d]
  float* da;             // [B][n_a][d]
  bf16* xs[MAXL];        // X_l [B][k_l] for l >= 1 (written here)
  bf16* gs[MAXL];        // bf16(g_l) [B][n_l] (written here)
  float* dbp;            // [row tiles][db_T] column sums of g_l
  int db_off[MAXL];
  int db_T;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
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

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [0, rows) of a shared-memory matrix (row pitch `pitch`, `width`
// bf16 a row) to global rows q0 + r < B (row pitch `width`).
__device__ __forceinline__ void copy_out(const bf16* src, int pitch,
                                         bf16* dst, int width, int rows,
                                         int q0, int B) {
  const int per = width / 8;
  for (int i = threadIdx.x; i < rows * per; i += THREADS) {
    const int r = i / per, v = i % per;
    if (q0 + r < B)
      *reinterpret_cast<uint4*>(dst + (size_t)(q0 + r) * width + v * 8) =
          *reinterpret_cast<const uint4*>(src + r * pitch + v * 8);
  }
}

constexpr int DB_GROUPS = THREADS / 32;  // row groups of the g load

// K2, the turn to the reverse sweep: the output cotangent's rows [q0,
// q0 + TQ) (rows past B and columns past d zero) as bf16 into `dst`
// (pitch n + PAD) and to scratch, and their column sums, f32, into the
// row tile's db_{L-1}.  Thread (row group, column quad): float4 loads of
// every DB_GROUPS-th row, all in flight at once; the groups' sums are
// then added in group order.  Ends with a barrier.
template <int TQ>
__device__ __forceinline__ void load_cotangent(const Bwd& bw, bf16* gs,
                                               bf16* dst, float* sums, int n,
                                               int d, int q0, int B,
                                               int db_off) {
  constexpr int RPG = TQ / DB_GROUPS > 0 ? TQ / DB_GROUPS : 1;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int pitch = n + PAD;
  for (int c0 = 0; c0 < n; c0 += NC) {
    const int c = c0 + 4 * lane;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v[RPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int r = grp + i * DB_GROUPS, q = q0 + r;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r >= TQ || q >= B || c >= d) continue;
      const float* src = bw.g + (size_t)q * d + c;
      if (d % 4 == 0) {
        v[i] = *reinterpret_cast<const float4*>(src);
      } else {
        v[i].x = src[0];
        if (c + 1 < d) v[i].y = src[1];
        if (c + 2 < d) v[i].z = src[2];
        if (c + 3 < d) v[i].w = src[3];
      }
    }
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int r = grp + i * DB_GROUPS, q = q0 + r;
      if (r >= TQ) continue;
      s.x = __fadd_rn(s.x, v[i].x);
      s.y = __fadd_rn(s.y, v[i].y);
      s.z = __fadd_rn(s.z, v[i].z);
      s.w = __fadd_rn(s.w, v[i].w);
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[i].x, v[i].y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[i].z, v[i].w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + r * pitch + c) = packed;
      if (q < B)
        *reinterpret_cast<uint2*>(gs + (size_t)q * n + c) = packed;
    }
    *reinterpret_cast<float4*>(sums + grp * NC + 4 * lane) = s;
    __syncthreads();
    if (threadIdx.x < NC) {
      float t = 0.f;
      for (int k = 0; k < DB_GROUPS; ++k)
        t = __fadd_rn(t, sums[k * NC + threadIdx.x]);
      bw.dbp[(size_t)blockIdx.x * bw.db_T + db_off + c0 + threadIdx.x] = t;
    }
    __syncthreads();
  }
}

// K1 and K2's pass A.  MT m-tiles of 16 rows per block (MT = 0: one tile
// of 8 rows, the upper half of each A fragment zero).  Warps: WM along
// the rows x WN along the chunk's 128 columns; each holds MW x NW
// fragments of 16 x 8.  The tile table drives everything: stage t's
// weights are staged STAGES - 1 iterations ahead; after the chunk's last
// stage the epilogue writes the chunk.
template <int MT, bool BWD>
__global__ void __launch_bounds__(THREADS, 1)
tgt_mma_chain_kernel(Chain ch, const int4* __restrict__ tiles, int n_tiles,
                     const bf16* __restrict__ x0, void* __restrict__ out,
                     Lay lay, Bwd bw) {
  constexpr int TQ = MT ? 16 * MT : 8;
  constexpr int STAGES = MT ? 3 : 2;
  constexpr int EPS = entries_per_stage(TQ);
  constexpr int KS = KT * EPS;  // contraction rows a stage
  constexpr int WM = MT >= 4 ? 4 : (MT >= 1 ? MT : 1);
  constexpr int WN = 8 / WM;
  constexpr int MW = MT >= 1 ? MT / WM : 1;
  constexpr int NW = NC / 8 / WN;
  static_assert(NW % 2 == 0, "B fragments are loaded two n-tiles at a time");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  // activation buffer p and cotangent buffer p, as offsets from the
  // shared-memory base (an array of pointers would live in local memory,
  // and every store through it would go generic)
  auto buf = [&](int p) { return smem + p * lay.buf1; };
  auto gbuf = [&](int p) { return smem + p * lay.gbuf1; };
  bf16* const stage = smem + lay.act;
  float* const dbs = reinterpret_cast<float*>(stage + STAGES * lay.stage);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int row_base = wm * MW * 16, col_base = wn * NW * 8;
  const int gq = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const int L = ch.L, B = ch.B;

  // X_0 rows [q0, q0 + TQ) -> buf(0) (rows past B zero-filled), in the
  // first commit group, so the first tile's wait covers it
  {
    const int k0 = ch.k[0], per = k0 / 8, pitch = k0 + PAD;
    for (int i = threadIdx.x; i < TQ * per; i += THREADS) {
      const int r = i / per, v = i % per;
      const bool ok = q0 + r < B;
      cp_async16(buf(0) + r * pitch + v * 8,
                 x0 + (size_t)(ok ? q0 + r : 0) * k0 + v * 8, ok);
    }
  }

  // stage s covers table entries [s EPS, s EPS + EPS): one stretch of KS
  // contraction rows of one chunk
  const int n_steps = n_tiles / EPS;
  auto entry = [&](int s) {
    return s < n_steps ? __ldg(tiles + s * EPS) : make_int4(0, 0, 0, 0);
  };
  auto stage_tile = [&](int s, int4 e) {
    if (s < n_steps) {
      const int l = e.x & 15, rev = (e.x >> 4) & 1;
      bf16* dst = stage + (s % STAGES) * lay.stage;
      const bf16* w = ch.w[l];
      const int nl = ch.n[l];
      if (!rev) {  // W rows [e.z, e.z + KS) x columns [e.y, e.y + NC)
        for (int i = threadIdx.x; i < KS * (NC / 8); i += THREADS) {
          const int r = i / (NC / 8), v = i % (NC / 8);
          cp_async16(dst + r * (NC + PAD) + v * 8,
                     w + (size_t)(e.z + r) * nl + e.y + v * 8);
        }
      } else {  // W rows [e.y, e.y + NC) x columns [e.z, e.z + KS)
        for (int i = threadIdx.x; i < NC * (KS / 8); i += THREADS) {
          const int r = i / (KS / 8), v = i % (KS / 8);
          cp_async16(dst + r * (KS + PAD) + v * 8,
                     w + (size_t)(e.y + r) * nl + e.z + v * 8);
        }
      }
    }
    cp_async_commit();
  };

  float acc[MW][NW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // a forward chunk's bias pairs, and a reverse chunk's ReLU masks (bf16
  // pairs of X_l from scratch), loaded when the chunk starts, so their
  // latency hides behind its products
  float2 bias[NW];
  __nv_bfloat162 xm[MW][NW][2];
  auto load_masks = [&](const int4& e, int l) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + row_base + mi * 16 + gq + 8 * h;
          const int col = e.y + col_base + j * 8 + 2 * t4;
          xm[mi][j][h] = __floats2bfloat162_rn(0.f, 0.f);
          if ((MT || h == 0) && q < B)
            xm[mi][j][h] = *reinterpret_cast<const __nv_bfloat162*>(
                bw.xs[l] + (size_t)q * ch.k[l] + col);
        }
  };
  // after a chunk's last stage: write the output columns [e.y, e.y + NC)
  // of layer l (forward or reverse)
  auto epilogue = [&](const int4& e, int l, int rev) {
    if (!rev) {
      const bool last = !BWD && l == L - 1;
      const int pitch = last ? 0 : ch.k[l + 1] + PAD;
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int col = e.y + col_base + j * 8 + 2 * t4;
          const float b0 = bias[j].x, b1 = bias[j].y;
#pragma unroll
          for (int h = 0; h < (MT ? 2 : 1); ++h) {
            const int r = row_base + mi * 16 + gq + 8 * h;
            const float y0 = __fadd_rn(acc[mi][j][2 * h], b0);
            const float y1 = __fadd_rn(acc[mi][j][2 * h + 1], b1);
            if (last) {
              // pairs where d is even (every pair then starts on an even
              // element: 8-byte f32 / 4-byte bf16 alignment), else by
              // element; rows past B and columns past d are not written
              const int q = q0 + r;
              const size_t o = (size_t)q * ch.d + col;
              const bool pair = col + 1 < ch.d && ch.d % 2 == 0;
              if (q < B && ch.out_bf16) {
                bf16* ob = static_cast<bf16*>(out);
                if (pair) {
                  *reinterpret_cast<__nv_bfloat162*>(ob + o) =
                      __floats2bfloat162_rn(y0, y1);
                } else {
                  if (col < ch.d) ob[o] = __float2bfloat16_rn(y0);
                  if (col + 1 < ch.d) ob[o + 1] = __float2bfloat16_rn(y1);
                }
              } else if (q < B) {
                float* of = static_cast<float*>(out);
                if (pair) {
                  *reinterpret_cast<float2*>(of + o) = make_float2(y0, y1);
                } else {
                  if (col < ch.d) of[o] = y0;
                  if (col + 1 < ch.d) of[o + 1] = y1;
                }
              }
            } else {
              *reinterpret_cast<__nv_bfloat162*>(buf((l + 1) & 1) +
                                                 r * pitch + col) =
                  __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
            }
          }
        }
    } else if (BWD && l > 0) {
      // g_{l-1} = dX * [X_l > 0]; bf16(g) to the other cotangent buffer;
      // the chunk's column sums of g into db_{l-1}
      const int kl = ch.k[l], pitch = kl + PAD;
      bf16* gdst = gbuf((L - l) & 1);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int col = e.y + col_base + j * 8 + 2 * t4;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row_base + mi * 16 + gq + 8 * h;
            const __nv_bfloat162 m = xm[mi][j][h];
            const float g0 = __bfloat162float(m.x) > 0.f ? acc[mi][j][2 * h]
                                                         : 0.f;
            const float g1 = __bfloat162float(m.y) > 0.f
                                 ? acc[mi][j][2 * h + 1]
                                 : 0.f;
            if (MT || h == 0)
              *reinterpret_cast<__nv_bfloat162*>(gdst + r * pitch + col) =
                  __floats2bfloat162_rn(g0, g1);
            s0 = __fadd_rn(s0, g0);
            s1 = __fadd_rn(s1, g1);
          }
        // the 8 row groups of the warp (the xor tree gives every lane
        // the same bits)
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, m));
          s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
        }
        if (gq == 0) {
          dbs[wm * NC + col_base + j * 8 + 2 * t4] = s0;
          dbs[wm * NC + col_base + j * 8 + 2 * t4 + 1] = s1;
        }
      }
      __syncthreads();
      if (threadIdx.x < NC) {
        float s = dbs[threadIdx.x];
#pragma unroll
        for (int w = 1; w < WM; ++w)
          s = __fadd_rn(s, dbs[w * NC + threadIdx.x]);
        bw.dbp[(size_t)blockIdx.x * bw.db_T + bw.db_off[l - 1] + e.y +
               threadIdx.x] = s;
      }
    } else if (BWD) {
      // layer 0: the anchor column blocks of gb W_0^T are dA
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int col = e.y + col_base + j * 8 + 2 * t4;
          const int a = col / ch.dpad, c = col % ch.dpad;
#pragma unroll
          for (int h = 0; h < (MT ? 2 : 1); ++h) {
            const int q = q0 + row_base + mi * 16 + gq + 8 * h;
            if (q >= B) continue;
            float* dst = bw.da + ((size_t)q * ch.n_a + a) * ch.d;
            if (c < ch.d) dst[c] = acc[mi][j][2 * h];
            if (c + 1 < ch.d) dst[c + 1] = acc[mi][j][2 * h + 1];
          }
        }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage_tile(s, entry(s));

  // the table entries of this stage and of the one to stage next are
  // loaded an iteration ahead
  int4 e = entry(0), e_st = entry(STAGES - 1);
  int fl_last = EPS > 1 && n_steps > 0 ? __ldg(tiles + EPS - 1).x >> 8 : 0;
  // one pass of the outer loop per chunk: its sums start at 0 and stay
  // in the mma's own registers over the chunk's stages (a zeroing
  // inside the stage loop would make every stage copy them out)
  int t = 0;
#pragma unroll 1
  while (t < n_steps) {
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    if (!((e.x >> 4) & 1)) {
#pragma unroll
      for (int j = 0; j < NW; ++j)
        bias[j] = __ldg(reinterpret_cast<const float2*>(
            ch.b[e.x & 15] + e.y + col_base + j * 8 + 2 * t4));
    }
    int4 chunk;
    bool last, first = true;
#pragma unroll 1
    do {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage t landed; stage t - 1's buffer is free
      stage_tile(t + STAGES - 1, e_st);
      e_st = entry(t + STAGES);
      const int4 e_next = entry(t + 1);
      const int fl_next = EPS > 1 && t + 1 < n_steps
                              ? __ldg(tiles + (t + 1) * EPS + EPS - 1).x >> 8
                              : 0;
      const int l = e.x & 15, rev = (e.x >> 4) & 1;
      const int fl = (e.x >> 8) | fl_last;

      if (BWD && (fl & T_NEWLAYER)) {
        if (!rev) {
          // X_l (l >= 1) is complete: to scratch for the masks and pass B
          if (l >= 1)
            copy_out(buf(l & 1), ch.k[l] + PAD, bw.xs[l], ch.k[l], TQ, q0,
                     B);
        } else if (l == L - 1) {
          // the turn to the reverse sweep: X_{L-1} out, then the output
          // cotangent in (rows past B, columns past d zero), its bf16
          // copy to scratch and its column sums (db_{L-1}, rows ascending)
          if (L >= 2)
            copy_out(buf((L - 1) & 1), ch.k[L - 1] + PAD, bw.xs[L - 1],
                     ch.k[L - 1], TQ, q0, B);
          __syncthreads();
          load_cotangent<TQ>(bw, bw.gs[L - 1], gbuf(0), dbs, ch.n[L - 1],
                             ch.d, q0, B, bw.db_off[L - 1]);
        } else {
          // bf16(g_l) is complete: to scratch for pass B
          copy_out(gbuf((L - 1 - l) & 1), ch.n[l] + PAD, bw.gs[l], ch.n[l],
                   TQ, q0, B);
        }
      }

      // the masks once X_l is in scratch (for l = L - 1: just above)
      if (BWD && first && rev && l > 0) load_masks(e, l);
      first = false;

      // ---- products of this stage: one straight-line loop per direction
      // (a branch per fragment load would split the loads from the mmas)
      const bf16* Bs = stage + (t % STAGES) * lay.stage;
      auto products = [&](auto rev_c) {
        constexpr bool REV = decltype(rev_c)::value;
        const bf16* A = REV ? gbuf((L - 1 - l) & 1) : buf(l & 1);
        const int apitch = (REV ? ch.n[l] : ch.k[l]) + PAD;
        // fragments of k-step ks + 1 are loaded before the products of ks
        uint32_t fa[2][MW][4], fb[2][NW][2];
        auto load_frags = [&](int ks, uint32_t (&a)[MW][4],
                              uint32_t (&bq)[NW][2]) {
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            const int r = MT ? row_base + mi * 16 + (lane & 15) : (lane & 7);
            ldsm_x4(a[mi], A + r * apitch + e.z + ks * 16 + (lane >> 4) * 8);
            if (!MT) a[mi][1] = a[mi][3] = 0u;
          }
#pragma unroll
          for (int j = 0; j < NW; j += 2) {
            uint32_t r4[4];
            if constexpr (!REV) {
              ldsm_x4_t(r4, Bs + (ks * 16 + (lane & 15)) * (NC + PAD) +
                                col_base + (j + (lane >> 4)) * 8);
            } else {
              ldsm_x4(r4, Bs + (col_base + j * 8 + (lane & 7) +
                                ((lane >> 4) & 1) * 8) * (KS + PAD) +
                              ks * 16 + ((lane >> 3) & 1) * 8);
            }
            bq[j][0] = r4[0];
            bq[j][1] = r4[1];
            bq[j + 1][0] = r4[2];
            bq[j + 1][1] = r4[3];
          }
        };
        load_frags(0, fa[0], fb[0]);
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks) {
          if (ks + 1 < KS / 16)
            load_frags(ks + 1, fa[(ks + 1) & 1], fb[(ks + 1) & 1]);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
#pragma unroll
            for (int j = 0; j < NW; ++j)
              mma16816(acc[mi][j], fa[ks & 1][mi], fb[ks & 1][j]);
        }
      };
      if constexpr (BWD) {
        if (rev)
          products(std::true_type{});
        else
          products(std::false_type{});
      } else {
        products(std::false_type{});
      }
      last = fl & T_LAST;
      chunk = e;
      e = e_next;
      fl_last = fl_next;
      ++t;
    } while (!last && t < n_steps);
    epilogue(chunk, chunk.x & 15, (chunk.x >> 4) & 1);
  }
  cp_async_wait<0>();
}

// K2, pass B.  Block (job = one listed 128 x 128 block of dW_l: layer,
// first row, first column; row partition blockIdx.y): X_l^T bf16(g_l)
// over the partition's rows, DW_ROWS rows a staged tile, into
// partial[p][job].  Warps 2 x 4, each 64 x 32 of the block.
struct DwArgs {
  const int4* jobs;
  int n_jobs;
  const bf16* xs[MAXL];  // X_0 = the input, X_l (l >= 1) from pass A
  const bf16* gs[MAXL];
  int k[MAXL], n[MAXL];
  int B, R;
  float* partial;  // [P][n_jobs][NC][NC]
};

__global__ void __launch_bounds__(THREADS, 2) tgt_mma_dw_kernel(DwArgs a) {
  constexpr int PITCH = NC + PAD;
  constexpr int TILE = 2 * DW_ROWS * PITCH;  // X and G tiles of one stage
  constexpr int MW = 4, NW = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int4 job = __ldg(a.jobs + blockIdx.x);
  const int l = job.x, row0 = job.y, col0 = job.z;
  const int kl = a.k[l], nl = a.n[l];
  const bf16* X = a.xs[l];
  const bf16* G = a.gs[l];
  const int p = blockIdx.y;
  const int r_lo = p * a.R, r_hi = min(a.B, r_lo + a.R);
  const int nt = (r_hi - r_lo + DW_ROWS - 1) / DW_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m_base = (warp / 4) * 64, n_base = (warp % 4) * 32;

  auto stage_tile = [&](int t) {
    if (t < nt) {
      bf16* sx = smem + (t % DW_STAGES) * TILE;
      bf16* sg = sx + DW_ROWS * PITCH;
      for (int i = threadIdx.x; i < DW_ROWS * (NC / 8); i += THREADS) {
        const int r = i / (NC / 8), v = i % (NC / 8);
        const int q = r_lo + t * DW_ROWS + r;
        const bool ok = q < r_hi;
        const size_t qq = ok ? q : r_lo;
        cp_async16(sx + r * PITCH + v * 8, X + qq * kl + row0 + v * 8, ok);
        cp_async16(sg + r * PITCH + v * 8, G + qq * nl + col0 + v * 8, ok);
      }
    }
    cp_async_commit();
  };

  float acc[MW][NW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) stage_tile(s);
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();
    stage_tile(t + DW_STAGES - 1);
    const bf16* sx = smem + (t % DW_STAGES) * TILE;
    const bf16* sg = sx + DW_ROWS * PITCH;
    uint32_t dfa[2][MW][4], dfb[2][NW][2];
    auto load_frags = [&](int ks, uint32_t (&af)[MW][4],
                          uint32_t (&bq)[NW][2]) {
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
        ldsm_x4_t(af[mi], sx + (ks * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   PITCH +
                              m_base + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        uint32_t r4[4];
        ldsm_x4_t(r4, sg + (ks * 16 + (lane & 15)) * PITCH + n_base +
                          (j + (lane >> 4)) * 8);
        bq[j][0] = r4[0];
        bq[j][1] = r4[1];
        bq[j + 1][0] = r4[2];
        bq[j + 1][1] = r4[3];
      }
    };
    load_frags(0, dfa[0], dfb[0]);
#pragma unroll
    for (int ks = 0; ks < DW_ROWS / 16; ++ks) {
      if (ks + 1 < DW_ROWS / 16)
        load_frags(ks + 1, dfa[(ks + 1) & 1], dfb[(ks + 1) & 1]);
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int j = 0; j < NW; ++j)
          mma16816(acc[mi][j], dfa[ks & 1][mi], dfb[ks & 1][j]);
    }
  }
  cp_async_wait<0>();
  float* dst = a.partial + ((size_t)p * a.n_jobs + blockIdx.x) * NC * NC;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m_base + mi * 16 + gq + 8 * h;
        const int n = n_base + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dst + m * NC + n) =
            make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
      }
}

// K2, pass C: one element of the flat output (per layer dW_l [k_l][n_l]
// then db_l [n_l]) per thread.
struct RedArgs {
  int L;
  int k[MAXL], n[MAXL];
  long long off[MAXL + 1];  // each layer's first element; off[L] = T
  const int* jobmap;        // per layer [k_l / NC][n_l / NC]: job or -1
  int jm_off[MAXL];
  const float* partial;
  int P, n_jobs;
  const float* dbp;
  int n_tiles, db_T;
  int db_off[MAXL];
  float* out;
};

__global__ void __launch_bounds__(RED_THREADS)
tgt_mma_reduce_kernel(RedArgs a) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= a.off[a.L]) return;
  int l = 0;
  while (i >= a.off[l + 1]) ++l;
  const long long e = i - a.off[l];
  const int kl = a.k[l], nl = a.n[l];
  if (e >= (long long)kl * nl) return;  // db: tgt_mma_reduce_db_kernel
  float acc = 0.f;
  const int r = (int)(e / nl), c = (int)(e % nl);
  const int job = a.jobmap[a.jm_off[l] + (r / NC) * (nl / NC) + c / NC];
  if (job >= 0) {
    const float* src = a.partial + (size_t)job * NC * NC + (r % NC) * NC +
                       c % NC;
    const size_t step = (size_t)a.n_jobs * NC * NC;
#pragma unroll 8
    for (int p = 0; p < a.P; ++p) acc = __fadd_rn(acc, src[p * step]);
  }
  a.out[i] = acc;
}

// K2, pass C for db: one warp per element of db_l (over all layers);
// lane j adds the row tiles j, j + 32, ... in order, then the lanes'
// sums meet in a fixed xor tree.
__global__ void __launch_bounds__(RED_THREADS)
tgt_mma_reduce_db_kernel(RedArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (RED_THREADS / 32) + (threadIdx.x >> 5);
  if (i >= a.db_T) return;
  int l = 0;
  while (l + 1 < a.L && i >= a.db_off[l + 1]) ++l;
  float s = 0.f;
  for (int t = lane; t < a.n_tiles; t += 32)
    s = __fadd_rn(s, a.dbp[(size_t)t * a.db_T + i]);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
  if (lane == 0)
    a.out[a.off[l] + (long long)a.k[l] * a.n[l] + (i - a.db_off[l])] = s;
}

bool make_chain(Chain& ch, int L, int B, const int* k, const int* n,
                const void* const* w, const void* const* b) {
  if (L <= 0 || L > MAXL) return false;
  ch.L = L;
  ch.B = B;
  ch.d = ch.dpad = ch.n_a = ch.out_bf16 = 0;
  for (int l = 0; l < L; ++l) {
    if (k[l] <= 0 || n[l] <= 0 || k[l] % NC || n[l] % NC) return false;
    if (l > 0 && k[l] != n[l - 1]) return false;
    ch.k[l] = k[l];
    ch.n[l] = n[l];
    ch.w[l] = static_cast<const bf16*>(w ? w[l] : nullptr);
    ch.b[l] = static_cast<const float*>(b ? b[l] : nullptr);
  }
  return true;
}

// The chain block's layout at TQ rows: X_l (l < L) in buffer l & 1
// (row pitch k_l + PAD); K2 also bf16(g_l) in buffer (L - 1 - l) & 1
// (pitch n_l + PAD), over the same memory (the sweeps do not overlap).
Lay make_lay(bool bwd, int tq, const Chain& ch) {
  int p[2] = {0, 0}, gp[2] = {0, 0};
  for (int l = 0; l < ch.L; ++l) {
    p[l & 1] = max(p[l & 1], ch.k[l] + PAD);
    gp[(ch.L - 1 - l) & 1] = max(gp[(ch.L - 1 - l) & 1], ch.n[l] + PAD);
  }
  Lay lay;
  lay.buf1 = tq * p[0];
  lay.gbuf1 = tq * gp[0];
  lay.act = tq * (p[0] + p[1]);
  if (bwd) lay.act = max(lay.act, tq * (gp[0] + gp[1]));
  const int ks = KT * entries_per_stage(tq);
  lay.stage = bwd ? max(fwd_stage(ks), rev_stage(ks)) : fwd_stage(ks);
  return lay;
}

size_t chain_smem(bool bwd, int tq, const Chain& ch) {
  const Lay lay = make_lay(bwd, tq, ch);
  const int stages = tq >= 16 ? 3 : 2;
  return ((size_t)lay.act + (size_t)stages * lay.stage) * sizeof(bf16) +
         (bwd ? DB_GROUPS * NC * sizeof(float) : 0);
}

constexpr size_t DW_SMEM = (size_t)DW_STAGES * 2 * DW_ROWS * (NC + PAD) *
                           sizeof(bf16);

template <int MT, bool BWD>
cudaError_t launch_chain(const Chain& ch, const int4* tiles, int n_tiles,
                         const bf16* x0, void* out, const Bwd& bw,
                         cudaStream_t s) {
  constexpr int TQ = MT ? 16 * MT : 8;
  const size_t smem = chain_smem(BWD, TQ, ch);
  cudaError_t err = cudaFuncSetAttribute(
      tgt_mma_chain_kernel<MT, BWD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ch.B + TQ - 1) / TQ);
  tgt_mma_chain_kernel<MT, BWD><<<grid, THREADS, smem, s>>>(
      ch, tiles, n_tiles, x0, out, make_lay(BWD, TQ, ch), bw);
  return cudaGetLastError();
}

template <bool BWD>
cudaError_t launch_tq(int tq, const Chain& ch, const int4* tiles,
                      int n_tiles, const bf16* x0, void* out, const Bwd& bw,
                      cudaStream_t s) {
  switch (tq) {
    case 8: return launch_chain<0, BWD>(ch, tiles, n_tiles, x0, out, bw, s);
    case 16: return launch_chain<1, BWD>(ch, tiles, n_tiles, x0, out, bw, s);
    case 32: return launch_chain<2, BWD>(ch, tiles, n_tiles, x0, out, bw, s);
    case 64: return launch_chain<4, BWD>(ch, tiles, n_tiles, x0, out, bw, s);
    case 128:
      return launch_chain<8, BWD>(ch, tiles, n_tiles, x0, out, bw, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_tq(int tq) {
  return tq == 8 || tq == 16 || tq == 32 || tq == 64 || tq == 128;
}

}  // namespace

// Rows of contraction in one staged weight tile (the wrapper's tile
// tables step by it).
extern "C" int mpqe_tgt_k_tile() { return KT; }

// Dynamic shared memory one block needs (bwd: 0 = K1, 1 = K2 pass A) for
// a chain of L layers of k x n at a row tile of tq rows; -1 if invalid.
extern "C" long long mpqe_tgt_smem_bytes(int bwd, int tq, int L,
                                         const int* k, const int* n) {
  Chain ch;
  if (!valid_tq(tq) || !make_chain(ch, L, 0, k, n, nullptr, nullptr))
    return -1;
  const size_t s = chain_smem(bwd != 0, tq, ch);
  return (long long)(bwd ? (s > DW_SMEM ? s : DW_SMEM) : s);
}

// Dynamic shared memory a block may have on `device`.
extern "C" long long mpqe_tgt_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (long long)optin;
}

// K1: out [B][d], bf16 when out_bf16 is 1 (the reference's out_bf16:
// the f32 result rounded to nearest even), else f32.  `tiles` (device,
// int4 [n_tiles]) is the forward tile table.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int mpqe_tgt_forward(const void* x0, int B, int L, const int* k,
                                const int* n, const void* const* w,
                                const void* const* b, const void* tiles,
                                int n_tiles, void* out, int out_bf16, int d,
                                int tq, void* stream) {
  Chain ch;
  if (!make_chain(ch, L, B, k, n, w, b) || d <= 0 || d > n[L - 1] ||
      !valid_tq(tq) || n_tiles <= 0 || (out_bf16 != 0 && out_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  ch.d = d;
  ch.out_bf16 = out_bf16;
  Bwd bw = {};
  return (int)launch_tq<false>(tq, ch, static_cast<const int4*>(tiles),
                               n_tiles, static_cast<const bf16*>(x0), out,
                               bw, static_cast<cudaStream_t>(stream));
}

// K2: passes A, B and C (two launches), in stream order.
//   da [B][n_a][d]; xg[l] (l >= 1) [B][k_l] and gg[l] [B][n_l] bf16
//   scratch (xg[0] is x0); dbp [ceil(B / tq)][sum n_l] f32; partial
//   [P][n_jobs][128][128] f32; out [T] with, per layer in order, dW_l
//   [k_l][n_l] then db_l [n_l].  tiles: pass A's table; jobs (int4:
//   layer, row, column) pass B's listed 128 x 128 blocks of dW; jobmap
//   per layer [k_l / 128][n_l / 128] (job or -1) from jm_off[l].  Rows of
//   partition p are [p R, min(B, (p + 1) R)).
extern "C" int mpqe_tgt_backward(
    const void* x0, int B, int L, const int* k, const int* n,
    const void* const* w, const void* const* b, const void* tiles,
    int n_tiles, const void* jobs, int n_jobs, const void* jobmap,
    const int* jm_off, const float* g, int d, int dp, int n_a, float* da,
    void* const* xg, void* const* gg, float* dbp, int tq, int R, int P,
    float* partial, float* out, void* stream) {
  Chain ch;
  if (!make_chain(ch, L, B, k, n, w, b) || d <= 0 || d > n[L - 1] ||
      dp <= 0 || dp % NC || n_a <= 0 || n_a * dp > k[0] || !valid_tq(tq) ||
      n_tiles <= 0 || n_jobs <= 0 || R <= 0 || P <= 0 ||
      (long long)P * R < B)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  ch.d = d;
  ch.dpad = dp;
  ch.n_a = n_a;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x0);
  const int n_row_tiles = (B + tq - 1) / tq;

  Bwd bw = {};
  bw.g = g;
  bw.da = da;
  bw.dbp = dbp;
  int db_T = 0;
  for (int l = 0; l < L; ++l) {
    bw.xs[l] = static_cast<bf16*>(xg[l]);
    bw.gs[l] = static_cast<bf16*>(gg[l]);
    bw.db_off[l] = db_T;
    db_T += n[l];
  }
  bw.db_T = db_T;
  cudaError_t err = launch_tq<true>(tq, ch, static_cast<const int4*>(tiles),
                                    n_tiles, xp, nullptr, bw, s);
  if (err != cudaSuccess) return (int)err;

  DwArgs dw = {};
  dw.jobs = static_cast<const int4*>(jobs);
  dw.n_jobs = n_jobs;
  for (int l = 0; l < L; ++l) {
    dw.xs[l] = l == 0 ? xp : bw.xs[l];
    dw.gs[l] = bw.gs[l];
    dw.k[l] = k[l];
    dw.n[l] = n[l];
  }
  dw.B = B;
  dw.R = R;
  dw.partial = partial;
  err = cudaFuncSetAttribute(tgt_mma_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  tgt_mma_dw_kernel<<<dim3(n_jobs, P), THREADS, DW_SMEM, s>>>(dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  RedArgs ra = {};
  ra.L = L;
  long long T = 0;
  for (int l = 0; l < L; ++l) {
    ra.k[l] = k[l];
    ra.n[l] = n[l];
    ra.off[l] = T;
    ra.jm_off[l] = jm_off[l];
    ra.db_off[l] = bw.db_off[l];
    T += (long long)k[l] * n[l] + n[l];
  }
  ra.off[L] = T;
  ra.jobmap = static_cast<const int*>(jobmap);
  ra.partial = partial;
  ra.P = P;
  ra.n_jobs = n_jobs;
  ra.dbp = dbp;
  ra.n_tiles = n_row_tiles;
  ra.db_T = db_T;
  ra.out = out;
  tgt_mma_reduce_kernel<<<(unsigned)((T + RED_THREADS - 1) / RED_THREADS),
                          RED_THREADS, 0, s>>>(ra);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr int WARPS = RED_THREADS / 32;
  tgt_mma_reduce_db_kernel<<<(unsigned)((db_T + WARPS - 1) / WARPS),
                             RED_THREADS, 0, s>>>(ra);
  return (int)cudaGetLastError();
}
