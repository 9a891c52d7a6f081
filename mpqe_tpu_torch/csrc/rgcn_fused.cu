// Relation-chunked R-GCN edge messages (K5a, K5b) for Hopper (sm_90a), on
// the tensor cores in split TF32.
//
// mpqe_rgcn_msg_basis replaces the Pallas TPU kernel
// mpqe_tpu/ops/pallas_rgcn.py _messages_pallas_basis (:145; kernel body
// _msg_kernel_basis :105); mpqe_rgcn_msg_wrel replaces
// _messages_pallas_wrel (:193; kernel body _msg_kernel_wrel :126).
//
// The edges come in chunks of `chunk` rows that share one relation
// (ops/rgcn_fused.py chunk_by_relation, ops/template_layout.py
// template_chunked).  Per chunk c, with K = d_in and N = d_out, all f32:
//   K5a:  W = c_0 V_0 + c_1 V_1 + ... (b ascending, each product and sum
//         rounded on its own, as combine_basis) with c = coeff[crel[c]],
//         crel clamped into [0, n_rels]; a padding chunk (crel >= n_rels)
//         takes zero coefficients, as _masked_chunk_coeff does;
//   K5b:  W = w_rel[crel[c]] (crel clamped into [0, R); padding edges rely
//         on norm == 0);
//   out[e] = (xs[e] @ W) * norm[e], xs[e] = x[clamp(src[e])] (the gather
//   is fused here; with src == nullptr xs[e] = x[e], the backward's dxs).
// With w_transposed the weights are read as W[k][n] = w[.][n][k]: the
// backward's dxs = g @ W^T takes the layer's own basis or w_rel, with no
// transposed copy.
//
// Numerics.  The Pallas kernel is an f32 product at Precision.HIGHEST.
// Here every product xs @ W runs on the tensor cores in split TF32: each
// f32 operand a becomes hi = a rounded to TF32 (to nearest, ties away, as
// cvt.rna, by integer operations) and lo = a - hi (exact in f32, read by
// the tensor core truncated to TF32); per 8-deep k step three
// mma.sync.m16n8k8 TF32 products (lo.hi, hi.lo, hi.hi, in that order) add
// into f32 accumulators; the lo.lo term (~2^-22 of a product) is dropped.
// The sum order is the tensor cores', not the plain version's k
// ascending, so the kernel is held to gates, not to the plain bits: <=
// 1e-4 of the plain version and <= 1e-5 of the f32 batched oracle
// (max|diff| / max|ref|; chip_smoke.py phase 4,
// tests/test_torch_port_cuda.py).  An emulation of this product in the
// kernel's order, each mma's sum added to the accumulator and rounded
// toward zero (a model of the tensor core's f32 accumulation: 3 K / 8
// such roundings an output), lies within 1.2e-6 - 1.7e-6 of both at
// d = 128, as the card does; one TF32 pass ~3e-4 off, failing both gates
// (tools/k5_probe.py emulate).  W and the * norm keep the plain version's
// f32 operations and order.  No float atomics, one fixed tile order: a
// repeat launch gives the same bits.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 on the tensor cores,
// 67 TFLOP/s f32 outside them), counting the function's own work
// (chip_smoke.py k5_work): the distinct source rows once, src and norm,
// the coefficients or relation ids, the weights once and the f32 output,
// and 2 E K N FLOP.  At d = 128 an edge writes 512 B and reads 8 B, plus
// its share of the source rows, for 32,768 FLOP: on the f32 pipes the
// operations bound it; in split TF32 (3 x 2 E K N at 495 TFLOP/s) the
// bytes do on a template batch (each edge gathers a row of its own: 1.6x
// the operations), the operations on the general graph (16 edges share a
// source row: 1.16x the bytes).  The design, by what held the first
// (f32-pipe) design back:
// * (1) Two instructions per multiply-add and (2) shared-memory loads
//   setting the pace: the products run on the tensor cores; a thread
//   loads its fragments of two k steps with one float4 load per row
//   (logical k j of an m16n8k8 step is physical k0 + 4 (j & 3) + 2 s +
//   (j >> 2) on both operands) and splits them in registers; a warp owns
//   a 32 x 32 output tile (8 independent mma chains).  In exploratory
//   builds on the card, splitting with cvt.rna was slower than the
//   integer rounding and a W tile kept pre-split in shared memory gained
//   nothing, so both operands split as they load.
// * (3) A slow, unoverlapped gather: a warp copies whole rows with
//   16-byte cp.async, the row index read once per row (one load per lane,
//   a tile ahead, broadcast by shuffle); two row buffers, so the next
//   tile lands while this one is multiplied.  Row pitch P: K rounded up to
//   an odd multiple of 16 floats, so that every float4 fragment load is
//   free of bank conflicts (its 8-lane phases cover 32 banks).
// * (4) W rebuilt in every block: K5a's prologue (k5_combine_kernel)
//   combines each relation's W once, at the first chunk of each run of
//   chunks with one relation slot, from that relation's own coefficient
//   row, into a scratch buffer the wrapper keeps ((n_rels + 1) K N floats,
//   17 MB at the flagship; slot n_rels, the padding chunks', has zero
//   coefficients), elementwise over the basis as stored.  Runs of one
//   relation that are not adjacent write the same slot with the same bits
//   from the same inputs.  The messages kernel then treats K5a like K5b: a
//   block loads its W column tile (float4 loads, 8 in flight a thread)
//   when it enters a chunk of another slot than the last, so it loads W
//   once per relation run it meets.  Building W inside every block
//   instead, from all Bb bases, was in exploratory builds the largest part
//   of K5a's time at B = 512 and a quarter of it at the large shapes: far
//   more than the prologue's extra launch.
// * Blocks: one wave of blocks, each walking an equal, contiguous share of
//   the row tiles (a tile never straddles a chunk).  Two tile shapes: 128
//   rows x 128 columns, 16 warps, one block an SM, where that gives every
//   SM a tile (x is gathered once for all N <= 128 columns; 16 warps hide
//   the mma and load latencies better than 8: exploratory builds of 64 x
//   64, 64 x 128 and 128 x 128 tiles with 4 or 8 warps were slower); else
//   32 x 32 tiles with 4 warps (the train batch of 512 has one to four
//   chunks: narrow tiles put 64 to 256 blocks on the card, each loading
//   16 KB of W).
// What holds it back now: the products and the gather overlap only in
// part (one synchronous pipeline per block); PERF.md has the phase
// figures.  mma.sync reaches well under the TF32 peak; wgmma with
// asynchronous accumulators and a producer warp are the levers left.
// Widths: whole K-wide rows and W tiles take (CT + 2 TM) P 4 bytes of
// shared memory, so the 32 x 32 tile holds K <= 592 on an H100 (232,448
// bytes a block) and the 128 x 128 tile K <= 144; at those widths the
// kernel runs as above.  Wider rows go in k stages (128 columns for the
// big tile, 256 for the small): per tile and stage the stage's W columns
// and row slices are loaded (the next stage's rows in flight during this
// one) and added into the same accumulators, k ascending, so every
// output's sum order is the one-stage order; W is then reloaded per stage
// of every tile.  N has no limit (column tiles), K none but int32 rows.
//
// K8 (ops/ring.py) uses this file's combine and messages kernels through
// mpqe_rgcn_combine and mpqe_rgcn_msg_live (the chunk count read on the
// device).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int MAX_DEVICES = 64;

// Row pitch (floats) of the shared tiles.
__host__ __device__ __forceinline__ int pitch_of(int K) {
  const int kp = (K + 15) / 16 * 16;
  return (kp / 16) % 2 ? kp : kp + 16;
}

// A block tile of TM rows x CT columns: WM x WN warps, each MT m16 x NT n8
// mma tiles; W's f32 column tile and two row buffers in shared memory.
template <int WM_, int WN_, int MT_, int NT_>
struct Shape {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_;
  static constexpr int WARPS = WM * WN, THREADS = 32 * WARPS;
  static constexpr int TM = WM * 16 * MT, CT = WN * 8 * NT;
  static constexpr int RPW = TM / WARPS;  // rows each warp gathers
  static_assert(RPW >= 1 && RPW <= 32 && TM % WARPS == 0, "row split");
  static size_t smem(int KS) {  // KS: the widest k stage
    return (size_t)(CT + 2 * TM) * pitch_of(KS) * sizeof(float);
  }
};

// 128 x 128 tiles, 16 warps, one block an SM (K <= 144), for row ranges
// that give every SM a tile; 32 x 32 tiles, 4 warps, for fewer rows or a
// wider K (<= 592).  Wider rows go in k stages of these widths.
using Big = Shape<4, 4, 2, 4>;
using Small = Shape<2, 2, 1, 2>;
constexpr int BIG_STAGE = 128, SMALL_STAGE = 256;

struct Args {
  const float* x;     // [n_rows][K]
  const int* src;     // [E] or null (x holds one row per edge)
  const float* w;     // [.][K][N] ([.][N][K] if trans): w_rel, or K5a's W
  const int* crel;    // [n_chunks] each chunk's matrix of w, clamped into
  int crel_hi;        // [0, crel_hi]
  const float* norm;  // [E]
  float* out;         // [E][N]
  const int* live;    // device count of the chunks to compute (the first
                      // ones; null: all n_chunks)
  long long q;        // row tiles a row block walks (the first r: q + 1)
  int r;
  int n_rows, chunk, tpc, K, N, P;
  int KS, n_st;       // k stages: n_st of KS columns (the last: the rest);
                      // one stage of K where whole rows fit
  int trans;  // W[k][n] = w[.][n][k]
  int xvec;   // rows by 16-byte copies (K % 4 == 0, x 16-byte aligned)
  int wvec;   // W by float4 loads (its contiguous extent % 4 == 0, aligned)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a ~ hi + lo: hi = a rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna: half of the 13 dropped bits' range added to the magnitude,
// then the 13 bits cleared), lo = a - hi exactly in f32, passed whole: the
// tensor core reads its top 19 bits (lo truncated to TF32).  Three integer
// and float operations at full rate, no conversion instruction.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a (16 x 8, row) @ b (8 x 8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int clamp_rel(const int* crel, long long c,
                                         int hi) {
  return min(max(__ldg(crel + c), 0), hi);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// s (+)= c * v, one rounding per product and per sum.
__device__ __forceinline__ void axpy4(float4& s, float c, const float4& v,
                                      bool first) {
  const float4 p = make_float4(__fmul_rn(c, v.x), __fmul_rn(c, v.y),
                               __fmul_rn(c, v.z), __fmul_rn(c, v.w));
  s = first ? p
            : make_float4(__fadd_rn(s.x, p.x), __fadd_rn(s.y, p.y),
                          __fadd_rn(s.z, p.z), __fadd_rn(s.w, p.w));
}

// K5a's prologue: W_s = c_0 V_0 + c_1 V_1 + ... (b ascending, each product
// and sum rounded on its own, as combine_basis) into scratch[s], for each
// slot s = clamp(crel[c], 0, n_rels) where a run of chunks begins (its
// slot differs from chunk c - 1's), from coeff[s] (zeros for s = n_rels,
// the padding slot); elementwise over the matrix as stored, 4 elements a
// thread.  grid.x: element groups; grid.y: CB_CHUNKS chunks.
constexpr int CB_THREADS = 128, CB_CHUNKS = 64;

__global__ void __launch_bounds__(CB_THREADS)
    k5_combine_kernel(const float* __restrict__ basis, int bb,
                      const float* __restrict__ coeff,
                      const int* __restrict__ crel, int n_chunks, int n_rels,
                      long long mat, int vec, float* __restrict__ scratch) {
  const long long e =
      ((long long)blockIdx.x * CB_THREADS + threadIdx.x) * 4;
  if (e >= mat) return;
  const int c1 = min(n_chunks, (int)(blockIdx.y + 1) * CB_CHUNKS);
  for (int c = blockIdx.y * CB_CHUNKS; c < c1; ++c) {
    const int s = clamp_rel(crel, c, n_rels);
    if (c > 0 && clamp_rel(crel, c - 1, n_rels) == s) continue;
    const float* cf = coeff + (size_t)s * bb;
    const bool pad = s == n_rels;
    float* dst = scratch + (size_t)s * mat + e;
    if (vec) {  // mat % 4 == 0 and 16-byte aligned
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int b0 = 0; b0 < bb; b0 += 8) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = b0 + j < bb ? ldg4(basis + (b0 + j) * mat + e)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (b0 + j < bb)
            axpy4(acc, pad ? 0.f : __ldg(cf + b0 + j), v[j], b0 + j == 0);
      }
      *reinterpret_cast<float4*>(dst) = acc;
    } else {
      for (int j = 0; j < 4 && e + j < mat; ++j) {
        float v = __fmul_rn(pad ? 0.f : __ldg(cf), __ldg(basis + e + j));
        for (int b = 1; b < bb; ++b)
          v = __fadd_rn(v, __fmul_rn(pad ? 0.f : __ldg(cf + b),
                                     __ldg(basis + b * mat + e + j)));
        dst[j] = v;
      }
    }
  }
}

// The block's W column tile into ws[n][k] (n < CT, k < P): matrix slot of
// w, rows k0 .. k0 + kw - 1 (one k stage); 0 for k >= kw and for columns
// >= N.  Each thread has GB groups of 4 elements in flight.
template <class S>
__device__ void build_w(const Args& a, int slot, int col0, int k0, int kw,
                        float* ws) {
  constexpr int CT = S::CT, THREADS = S::THREADS, GB = 8;
  const int K = a.K, N = a.N, P = a.P, tid = threadIdx.x;
  const float* w = a.w + (size_t)slot * K * N +
                   (a.trans ? (size_t)k0 : (size_t)k0 * N);
  if (!a.wvec) {
    for (int i = tid; i < CT * P; i += THREADS) {
      const int n = i / P, k = i - n * P;
      float v = 0.f;
      if (k < kw && col0 + n < N)
        v = __ldg(a.trans ? w + (size_t)(col0 + n) * K + k
                          : w + (size_t)k * N + col0 + n);
      ws[i] = v;
    }
    return;
  }
  // groups of 4 elements: (n, 4 k) with the source rows along k (trans),
  // consecutive threads along k; else (k, 4 n), a warp reading 8 k rows x
  // 16 columns (64 contiguous bytes a row) and storing them transposed
  const int total = P * CT / 4, kq = P / 4, nq = CT / 16;
  for (int i0 = tid; i0 < total; i0 += GB * THREADS) {
    float4 v[GB];
    int at[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const int i = i0 + g * THREADS;
      int n, k;
      if (a.trans) {
        n = i / kq;
        k = (i - n * kq) * 4;
      } else {
        const int rest = i >> 5;
        k = (rest / nq) * 8 + (i & 7);
        n = ((rest % nq) * 4 + ((i >> 3) & 3)) * 4;
      }
      at[g] = i < total ? n * P + k : -1;
      v[g] = i < total && k < kw && col0 + n < N
                 ? ldg4(a.trans ? w + (size_t)(col0 + n) * K + k
                                : w + (size_t)k * N + col0 + n)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (at[g] < 0) continue;
      const int st = a.trans ? 1 : P;  // the 4 elements' stride in the tile
      ws[at[g]] = v[g].x;
      ws[at[g] + st] = v[g].y;
      ws[at[g] + 2 * st] = v[g].z;
      ws[at[g] + 3 * st] = v[g].w;
    }
  }
}

// The source row of this warp's lane-th row of row tile T (-1: none).
template <class S>
__device__ __forceinline__ int row_index(const Args& a, long long T,
                                         int warp, int lane) {
  if (lane >= S::RPW) return -1;
  const long long c = T / a.tpc;
  const int rr = (int)(T - c * a.tpc) * S::TM + warp + S::WARPS * lane;
  if (rr >= a.chunk) return -1;
  const long long e = c * a.chunk + rr;
  if (!a.src) return (int)e;
  return min(max(__ldg(a.src + e), 0), a.n_rows - 1);
}

// Columns k0 .. k0 + kw - 1 of rows of x into xs (whole rows in one
// stage): this warp's rows warp, warp + WARPS, ...; in k stages (ST) the
// pad [kw, kpad) of a partial last stage is zeroed here (earlier stages
// wrote it).
template <class S, bool ST>
__device__ __forceinline__ void gather(const Args& a, float* xs, int idx,
                                       int k0, int kw, int kpad, int warp,
                                       int lane) {
#pragma unroll 4
  for (int j = 0; j < S::RPW; ++j) {
    const int row = __shfl_sync(0xffffffffu, idx, j);
    if (row < 0) continue;
    const float* s = a.x + (size_t)row * a.K + k0;
    float* d = xs + (warp + S::WARPS * j) * a.P;
    if (a.xvec) {
      for (int p = lane * 4; p < kw; p += 128) cp_async16(d + p, s + p);
    } else {
      for (int p = lane; p < kw; p += 32) cp_async4(d + p, s + p);
    }
    if (ST)
      for (int p = kw + lane; p < kpad; p += 32) d[p] = 0.f;
  }
}

// acc += xs (this warp's rows) @ W (its columns) in split TF32.  Logical
// k j of an m16n8k8 step maps to physical k0 + 4 (j & 3) + 2 s + (j >> 2)
// (step s of the 16-wide slice k0): a float4 load gives a thread its
// fragments of two steps, the same map on both operands.
template <class S>
__device__ __forceinline__ void tile_products(const float* xs,
                                              const float* ws, int P, int KP,
                                              int wm, int wn, int lane,
                                              float (&acc)[S::MT][S::NT][4]) {
  constexpr int MT = S::MT, NT = S::NT;
  const int g = lane >> 2, t = lane & 3;
  const float* xa = xs + (wm * 16 * MT + g) * P + 4 * t;
  const float* wb = ws + (wn * 8 * NT + g) * P + 4 * t;
#pragma unroll 2
  for (int k0 = 0; k0 < KP; k0 += 16) {
    float4 av[MT][2], bv[NT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      av[mi][0] = *reinterpret_cast<const float4*>(xa + mi * 16 * P + k0);
      av[mi][1] = *reinterpret_cast<const float4*>(xa + (mi * 16 + 8) * P + k0);
    }
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
      bv[nj] = *reinterpret_cast<const float4*>(wb + nj * 8 * P + k0);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        split_tf32(s ? av[mi][0].z : av[mi][0].x, ah[mi][0], al[mi][0]);
        split_tf32(s ? av[mi][1].z : av[mi][1].x, ah[mi][1], al[mi][1]);
        split_tf32(s ? av[mi][0].w : av[mi][0].y, ah[mi][2], al[mi][2]);
        split_tf32(s ? av[mi][1].w : av[mi][1].y, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        split_tf32(s ? bv[nj].z : bv[nj].x, bh[nj][0], bl[nj][0]);
        split_tf32(s ? bv[nj].w : bv[nj].y, bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], al[mi], bh[nj]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], ah[mi], bl[nj]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], ah[mi], bh[nj]);
    }
  }
}

// grid.x: column tile; grid.y: row block, which walks row tiles
// [T0, T1) in order (tile T: rows (T % tpc) TM .. of chunk T / tpc), each
// in n_st k stages (ST; else one): step i is tile T0 + i / n_st, stage
// i % n_st.  The stages add into the same accumulators in ascending k, so
// the sum order of every output is the one-stage order.
template <class S, bool ST>
__global__ void __launch_bounds__(S::THREADS) k5_msg_kernel(const Args a) {
  constexpr int TM = S::TM, CT = S::CT, MT = S::MT, NT = S::NT;
  extern __shared__ __align__(16) float smem[];
  const int P = a.P, ns = ST ? a.n_st : 1, KP = (a.K + 15) / 16 * 16;
  // ws [CT][P]: ws[n][k] = W[k0 + k][col0 + n]; then two buffers [TM][P]
  // of gathered rows
  float* ws = smem;
  float* xs0 = smem + CT * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / S::WN, wn = warp % S::WN, g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * CT;
  long long q = a.q, rr = a.r;
  if (a.live) {  // the first *live chunks, shared out as run() does
    const long long n_tiles = (long long)__ldg(a.live) * a.tpc;
    q = n_tiles / gridDim.y;
    rr = n_tiles % gridDim.y;
  }
  const long long rb = blockIdx.y;
  const long long T0 = rb * q + min(rb, rr);
  const long long T1 = T0 + q + (rb < rr ? 1 : 0);
  if (T0 >= T1) return;
  if (ns == 1 && KP != a.K) {  // the k padding [K, KP): zero once, no
    for (int i = tid; i < 2 * TM * P; i += S::THREADS) xs0[i] = 0.f;
    __syncthreads();            // gather writes it
  }
  auto kw_of = [&](int st) {
    return ST ? min(a.KS, a.K - st * a.KS) : a.K;
  };
  const long long n_steps = (T1 - T0) * ns;
  // the first step in flight; idx: the next step's rows
  int idx = row_index<S>(a, T0, warp, lane);
  gather<S, ST>(a, xs0, idx, 0, kw_of(0), (kw_of(0) + 15) / 16 * 16, warp,
                lane);
  cp_async_commit();
  idx = n_steps > 1 ? row_index<S>(a, T0 + (ns == 1), warp, lane) : -1;
  // the slot whose W the tile holds, and the next tile's slot, read a tile
  // ahead
  int wslot = -1, slot = -1;
  int next_slot = clamp_rel(a.crel, T0 / a.tpc, a.crel_hi);
  float acc[MT][NT][4];
  for (long long i = 0; i < n_steps; ++i) {
    const long long T = T0 + i / ns;
    const int st = (int)(i % ns), buf = (int)(i & 1);
    if (i + 1 < n_steps) {  // the next step's rows land during this one
      const int st1 = (int)((i + 1) % ns), kw1 = kw_of(st1);
      gather<S, ST>(a, xs0 + (buf ^ 1) * TM * P, idx, st1 * a.KS, kw1,
                    (kw1 + 15) / 16 * 16, warp, lane);
      idx = i + 2 < n_steps ? row_index<S>(a, T0 + (i + 2) / ns, warp, lane)
                            : -1;
    }
    cp_async_commit();
    const long long c = T / a.tpc;
    const int r0 = (int)(T - c * a.tpc) * TM;
    const int rows = min(TM, a.chunk - r0);
    const long long e0 = c * a.chunk + r0;
    if (st == 0) {
      slot = next_slot;
      if (T + 1 < T1)
        next_slot = clamp_rel(a.crel, (T + 1) / a.tpc, a.crel_hi);
    }
    const int kw = kw_of(st);
    if (ns > 1 || slot != wslot) build_w<S>(a, slot, col0, st * a.KS, kw, ws);
    wslot = slot;
    float nv[MT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 * MT + mi * 16 + g + 8 * h;
        nv[mi][h] = r < rows ? __ldg(a.norm + e0 + r) : 0.f;
      }
    cp_async_wait<1>();
    __syncthreads();  // this step's rows and W visible to every warp
    if (st == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[mi][nj][u] = 0.f;
    }
    tile_products<S>(xs0 + buf * TM * P, ws, P, (kw + 15) / 16 * 16, wm, wn,
                     lane, acc);
    if (st == ns - 1) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 16 * MT + mi * 16 + g + 8 * h;
          if (r >= rows) continue;
          float* o = a.out + (size_t)(e0 + r) * a.N;
#pragma unroll
          for (int nj = 0; nj < NT; ++nj) {
            const int col = col0 + wn * 8 * NT + nj * 8 + 2 * t;
            const float v0 = __fmul_rn(acc[mi][nj][2 * h], nv[mi][h]);
            const float v1 = __fmul_rn(acc[mi][nj][2 * h + 1], nv[mi][h]);
            if (!(a.N & 1) && col + 1 < a.N) {
              *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
            } else {
              if (col < a.N) o[col] = v0;
              if (col + 1 < a.N) o[col + 1] = v1;
            }
          }
        }
    }
    __syncthreads();  // every warp done with this buffer and with W
  }
}

// Per device: SM count, shared memory a block may opt into, and for each
// kernel instantiation whether its attribute is set and its occupancy at
// the shared-memory sizes seen so far.  Filled once, read every launch.
struct Occupancy {
  const void* fn;
  size_t smem;
  int blocks;
};
struct DeviceInfo {
  int n_sm = 0, optin = 0;
  std::vector<const void*> attr_set;
  std::vector<Occupancy> occ;
};
std::mutex info_mu;
DeviceInfo infos[MAX_DEVICES];

// Fills the device's SM count and opt-in shared memory; for fn, sets its
// shared-memory attribute once and returns its blocks per SM at smem bytes
// (0 on error; 1 for fn == nullptr).
int device_occupancy(int dev, const void* fn, int threads, size_t smem,
                     int* n_sm, int* optin) {
  std::lock_guard<std::mutex> lock(info_mu);
  DeviceInfo& d = infos[dev];
  if (d.n_sm == 0) {
    if (cudaDeviceGetAttribute(&d.n_sm, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&d.optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      d.n_sm = 0;
      return 0;
    }
  }
  *n_sm = d.n_sm;
  *optin = d.optin;
  if (fn == nullptr) return 1;
  bool set = false;
  for (const void* f : d.attr_set) set |= f == fn;
  if (!set) {
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d.optin) != cudaSuccess)
      return 0;
    d.attr_set.push_back(fn);
  }
  for (const Occupancy& o : d.occ)
    if (o.fn == fn && o.smem == smem) return o.blocks;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    smem) != cudaSuccess ||
      blocks <= 0)
    return 0;
  d.occ.push_back({fn, smem, blocks});
  return blocks;
}

template <class S, bool ST>
int run(Args a, int dev, int n_chunks, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(k5_msg_kernel<S, ST>);
  const size_t smem = S::smem(a.KS);
  int n_sm = 0, optin = 0;
  const int occ = device_occupancy(dev, fn, S::THREADS, smem, &n_sm, &optin);
  if (occ <= 0) return (int)cudaErrorInvalidValue;
  a.tpc = (a.chunk + S::TM - 1) / S::TM;
  const long long n_tiles = (long long)n_chunks * a.tpc;
  const int n_ct = (a.N + S::CT - 1) / S::CT;
  // one wave of blocks, each walking an equal share of the row tiles
  const long long blocks = ((long long)n_sm * occ + n_ct - 1) / n_ct;
  const long long n_rb = n_tiles < blocks ? n_tiles : blocks;
  a.q = n_tiles / n_rb;
  a.r = (int)(n_tiles % n_rb);
  const dim3 grid((unsigned)n_ct, (unsigned)n_rb);
  k5_msg_kernel<S, ST><<<grid, S::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// k stages of KS columns (KS a multiple of 16: the row copies and the
// fragment map stay aligned).
void stage(Args& a, int KS) {
  a.KS = KS;
  a.n_st = (a.K + KS - 1) / KS;
  a.P = pitch_of(KS);
}

// The messages through w [.][K][N] (trans: [.][N][K]) and crel.  The
// tile: the big one where whole rows fit and it gives every SM a tile
// (with big_ok), else the small one; rows wider than the small tile's
// shared memory holds go in k stages.
int launch(Args a, int n_chunks, cudaStream_t stream, bool big_ok) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int n_sm = 0, optin = 0;
  if (device_occupancy(dev, nullptr, 0, 0, &n_sm, &optin) <= 0)
    return (int)cudaErrorInvalidValue;
  stage(a, a.K);
  a.xvec = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.wvec = (a.trans ? a.K : a.N) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  const long long big_tiles = (long long)n_chunks *
                              ((a.chunk + Big::TM - 1) / Big::TM) *
                              ((a.N + Big::CT - 1) / Big::CT);
  const bool big = big_ok && big_tiles >= n_sm;
  if (big && Big::smem(a.K) <= (size_t)optin)
    return run<Big, false>(a, dev, n_chunks, stream);
  if (Small::smem(a.K) <= (size_t)optin)
    return run<Small, false>(a, dev, n_chunks, stream);
  if (big) {
    stage(a, BIG_STAGE);
    return run<Big, true>(a, dev, n_chunks, stream);
  }
  stage(a, SMALL_STAGE);
  return run<Small, true>(a, dev, n_chunks, stream);
}

bool bad_shape(int n_rows, int n_chunks, int chunk, int K, int N) {
  return n_chunks < 0 || chunk <= 0 || K <= 0 || N <= 0 || n_rows <= 0;
}

// K5a's prologue for n_chunks chunks of relations crel (scratch as in
// mpqe_rgcn_msg_basis).
int combine(const float* basis, int bb, const float* coeff, const int* crel,
            int n_chunks, int n_rels, int K, int N, float* scratch,
            cudaStream_t s) {
  const long long mat = (long long)K * N;
  const int vec = mat % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(basis) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  const dim3 grid((unsigned)((mat + 4 * CB_THREADS - 1) / (4 * CB_THREADS)),
                  (unsigned)((n_chunks + CB_CHUNKS - 1) / CB_CHUNKS));
  k5_combine_kernel<<<grid, CB_THREADS, 0, s>>>(basis, bb, coeff, crel,
                                                n_chunks, n_rels, mat, vec,
                                                scratch);
  return (int)cudaGetLastError();
}

Args wrel_args(const float* x, int n_rows, const int* src, const float* w,
               const int* crel, int crel_hi, const float* norm, int chunk,
               int K, int N, int w_transposed, float* out) {
  Args a{};
  a.x = x;
  a.n_rows = n_rows;
  a.src = src;
  a.w = w;
  a.crel = crel;
  a.crel_hi = crel_hi;
  a.norm = norm;
  a.chunk = chunk;
  a.K = K;
  a.N = N;
  a.trans = w_transposed != 0;
  a.out = out;
  return a;
}

}  // namespace

// K5a.  x [n_rows][K]; src [n_chunks * chunk] or null; basis [bb][K][N]
// ([bb][N][K] with w_transposed); coeff [n_rels][bb]; crel [n_chunks],
// each chunk's relation (>= n_rels: padding, W = 0); scratch
// [n_rels + 1][K][N] (as basis is stored), written for the slots that
// occur; norm [n_chunks * chunk]; out [n_chunks * chunk][N].  Two
// launches: the prologue, then the messages.  Returns cudaGetLastError()
// after them (0 on success).
extern "C" int mpqe_rgcn_msg_basis(const float* x, int n_rows, const int* src,
                                   const float* basis, int bb,
                                   const float* coeff, const int* crel,
                                   int n_rels, float* scratch,
                                   const float* norm, int n_chunks, int chunk,
                                   int K, int N, int w_transposed, float* out,
                                   void* stream) {
  if (bad_shape(n_rows, n_chunks, chunk, K, N) || bb <= 0 || n_rels <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = combine(basis, bb, coeff, crel, n_chunks, n_rels, K, N,
                          scratch, s);
  if (err != 0) return err;
  return launch(wrel_args(x, n_rows, src, scratch, crel, n_rels, norm, chunk,
                          K, N, w_transposed, out),
                n_chunks, s, true);
}

// K5b.  As K5a with w_rel [R][K][N] ([R][N][K] with w_transposed) and
// crel [n_chunks], clamped into [0, R); one launch.
extern "C" int mpqe_rgcn_msg_wrel(const float* x, int n_rows, const int* src,
                                  const float* w_rel, int R, const int* crel,
                                  const float* norm, int n_chunks, int chunk,
                                  int K, int N, int w_transposed, float* out,
                                  void* stream) {
  if (bad_shape(n_rows, n_chunks, chunk, K, N) || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  return launch(wrel_args(x, n_rows, src, w_rel, crel, R - 1, norm, chunk, K,
                          N, w_transposed, out),
                n_chunks, static_cast<cudaStream_t>(stream), true);
}

// K8's two uses of this file (ops/ring.py).  The combine alone: W_s for
// the slots s = clamp(crel[c], 0, n_rels) of n_chunks chunks (K8: every
// relation and the zero slot n_rels) into scratch [n_rels + 1][K][N], as
// K5a's prologue; one launch.
extern "C" int mpqe_rgcn_combine(const float* basis, int bb,
                                 const float* coeff, const int* crel,
                                 int n_chunks, int n_rels, int K, int N,
                                 float* scratch, void* stream) {
  if (n_chunks <= 0 || bb <= 0 || n_rels <= 0 || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  return combine(basis, bb, coeff, crel, n_chunks, n_rels, K, N, scratch,
                 static_cast<cudaStream_t>(stream));
}

// The messages of K5b (w [R][K][N] as stored) over the first *live of
// n_chunks chunks, *live read on the device (chunks past it are neither
// read nor written); the big tile only for chunks of whole big tiles.
// One launch.
extern "C" int mpqe_rgcn_msg_live(const float* x, int n_rows, const int* src,
                                  const float* w, int R, const int* crel,
                                  const int* live, const float* norm,
                                  int n_chunks, int chunk, int K, int N,
                                  float* out, void* stream) {
  if (bad_shape(n_rows, n_chunks, chunk, K, N) || R <= 0 || !live)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  Args a = wrel_args(x, n_rows, src, w, crel, R - 1, norm, chunk, K, N, 0,
                     out);
  a.live = live;
  return launch(a, n_chunks, static_cast<cudaStream_t>(stream),
                chunk % Big::TM == 0);
}
