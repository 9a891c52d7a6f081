// Per-query-relation fused TGT forward (K3) for Hopper (sm_90a), with its
// products on the tensor cores.
//
// Replaces the Pallas TPU kernel mpqe_tpu/ops/pallas_fused_fwd.py
// fused_tgt_forward_multi (:335; kernel body _make_multi_kernel :230).
// It computes the same function, with the same bf16 rounding points:
//   * anchor rows  x = bf16(ent[node_entity[:, s]])   (gathered here, ids
//     clamped as the reference's gather)
//   * layer-0 variable slots are never materialized: their self term is
//     the row bf16(var @ w_self_0)[mode] and their message source the
//     rows bf16(var @ basis_0[b])[mode] (tables prepared on the host; an
//     out-of-range mode selects a zero row)
//   * self term    x_bf16 @ bf16(w_self) (f32 sums) + bias (f32)
//   * messages     h_b = x_src_bf16 @ bf16(basis_b) (f32 sums),
//                  msg = (sum_b coeff[rel_q, b] * h_b) * norm_q (a relation
//                  out of range gives coefficient 0), summed per
//                  destination slot in the plan's edge order
//   * y = (self + bias) + messages;  x = bf16(relu(y)) between layers,
//     f32 y without ReLU after the last layer, or bf16(y) (round to nearest
//     even, __float2bfloat16_rn) for a model whose dtype is bfloat16: the
//     reference's out.astype(cfg.dtype) at :470, done in the store, so the
//     bf16 output is the rounding of the f32 one bit for bit.
// The entity table is f32 or bf16 (a bf16 model's own table; its rows are
// bf16 already, so x = bf16(ent[...]) takes them as they are).
//
// Numerics.  The K-deep sums inside the products x @ w_self and x @ basis_b
// run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) in
// the hardware's order.  Every other step keeps the plain version's order
// and rounding points (ops/fused_fwd.py fused_tgt_forward_multi_reference):
// msg starts at coeff_0 h_0 and adds coeff_b h_b for b ascending, each
// product and add rounded once (__fmul_rn / __fadd_rn), then * norm; the
// messages of one destination add up in the plan's edge order; (self +
// bias) + that sum.  So kernel and plain version differ only where a
// product's sum order moves its last bits, and a bf16 rounding between
// layers can turn that into a one-step flip: they are held to
// ops/fused_fwd.py multi_gate (K1's chain_gate on the output, and each
// layer against the plain layer from the kernel's own inputs), not to 0.  No float atomics:
// a repeat launch gives the same bits.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16): at the serving
// shape (B = 256 queries, d = 128, 16 bases, 266 relations) a call needs
// ~0.1-0.6 GFLOP and reads ~0.7-2 MB (the bf16 bases dominate), under a
// few microseconds (chip_smoke.py k3_work; PERF.md has the per-structure
// bounds and times).  What the design does:
//   * one launch per layer, each block owning TQ = 16 queries and a
//     CW = 16-column slice of the layer's output: it multiplies its rows
//     by that slice of w_self and of every basis, so every sum of the
//     basis combination (over b) and of the destination sums stays inside
//     the block, and a layer fills d_pad / 16 x ceil(B / 16) blocks (128
//     at B = 256, d = 128, for the card's 132 SMs).  Layers meet through
//     bf16 activations in a scratch buffer ([2][slot][B][d_pad], the
//     parities alternating, so no layer overwrites rows that blocks of the
//     same layer still read), 0.25 MB a layer at B = 256, L2-resident;
//   * the block's x rows (one per slot it multiplies) sit in shared memory
//     as bf16 for the whole layer; the weight slices stream through it
//     in stages of KT = 64 rows by 16-byte cp.async, double-buffered, in
//     one pipeline over the layer's passes (the self product, then the
//     bases in chunks of up to 8: 128 columns a stage);
//   * each warp takes (source slot, basis) jobs of 16 x 16 outputs, A
//     fragments by ldmatrix, B fragments by ldmatrix.trans from the
//     staged [k][n] tile; at a pass's end the sums go to shared memory
//     (f32), and each thread, owning one (query, column) cell, adds the
//     chunk's bases into its edges' messages in ascending b;
//   * host work per call is the L launches: each structure's descriptor
//     is parsed once into a Plan the caller keeps, and the shared-memory
//     attribute is set only when a plan needs more than the device has
//     been given so far.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps; one (query, column) cell a thread
constexpr int WARPS = THREADS / 32;
constexpr int TQ = 16;        // query rows per block (one m16 tile)
constexpr int CW = 16;        // output columns per block (two n8 tiles)
constexpr int KT = 64;        // weight rows per stage
constexpr int PAD = 8;        // bf16 of padding per shared-memory row
constexpr int MAX_NBC = 8;    // bases per chunk
constexpr int SP = MAX_NBC * CW + PAD;  // stage row pitch (bf16)
constexpr int STAGE = KT * SP;          // bf16 elements of one stage
constexpr int MAXS = 8;       // slots of a structure
constexpr int MAXE = 8;       // edges of a layer
constexpr int MAXJ = 4;       // product jobs per warp and pass
constexpr int MAX_JOBS = MAXJ * WARPS;
static_assert(TQ * CW == THREADS, "one epilogue cell per thread");

// One layer of the plan (ops/fused_fwd.py _descriptor), by value.
struct Layer {
  int l, last;
  int n_a, a_slot[MAXS];  // slots whose rows this layer multiplies
  int n_sp, sp_a[MAXS];   // message sources that are products -> a index
  int n_ss, ss_a[MAXS];   // self terms that are products -> a index
  int n_out, out_slot[MAXS], out_self[MAXS];  // self: index into ss, or
                                              // -1 (layer-0 variable row)
  int n_e, e_sp[MAXE], e_out[MAXE], e_j[MAXE], e_slot[MAXE];
  // per edge, in the plan's order: source as product (index into sp) or
  // -1 (layer-0 variable rows of slot e_slot); destination as index into
  // the out list; edge id j
  int nbc;  // bases per chunk
};

struct Args {
  const void* ent;  // [n_ent][d] f32, or bf16 when ent_bf16
  int ent_bf16;
  long long n_ent;
  int d, dp;
  const int* node_entity;  // [B][n_nodes]
  const int* node_mode;    // [B][n_nodes]
  const int* rel;          // [B][n_edges]
  const float* norm;       // [B][n_edges]
  int B, n_nodes, n_edges;
  const bf16* w_self;  // [L][dp][dp] (k, n)
  const float* bias;   // [L][dp]
  const bf16* vw;      // [L][dp][nb * dp] (k, b * dp + n)
  const float* coeff;  // [L][R][nb]
  int n_rels, nb;
  const bf16* tself0;  // [M][dp]
  const bf16* tvar0;   // [M][nb][dp]
  int n_modes;
  const bf16* x_in;  // [n_nodes][B][dp] (layers >= 1)
  bf16* x_out;       // [n_nodes][B][dp] (all but the last layer)
  void* out;         // [B][d] (the last layer): f32, or bf16 when out_bf16
  int out_bf16;
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
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one block (bytes, 16-aligned pieces): the x rows
// [n_a][TQ][dp + PAD] bf16, two weight stages [KT][SP] bf16, the chunk's
// basis products [n_sp][nbc][TQ][CW] f32 and the self products
// [n_ss][TQ][CW] f32.
__host__ __device__ inline size_t x_bytes(int n_a, int dp) {
  return (size_t)n_a * TQ * (dp + PAD) * sizeof(bf16);
}
__host__ __device__ inline size_t layer_smem(int n_a, int n_sp, int n_ss,
                                             int nbc, int dp) {
  return x_bytes(n_a, dp) + 2 * (size_t)STAGE * sizeof(bf16) +
         ((size_t)n_sp * nbc + n_ss) * TQ * CW * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 2)
fused_multi_layer_kernel(const __grid_constant__ Layer ly,
                         const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = a.dp, xp = dp + PAD;
  bf16* const xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const stage = reinterpret_cast<bf16*>(smem_raw + x_bytes(ly.n_a, dp));
  float* const hs = reinterpret_cast<float*>(stage + 2 * STAGE);
  float* const ss = hs + (size_t)ly.n_sp * ly.nbc * TQ * CW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ, col0 = blockIdx.y * CW;
  const int l = ly.l;
  // this thread's epilogue cell
  const int r = tid / CW, c = tid % CW;
  const int q = q0 + r, col = col0 + c;
  const bool qv = q < a.B;

  // ---- the x rows this layer multiplies, bf16 in shared memory (rows
  // past B and columns past d zero)
  if (l == 0) {
    const int per = TQ * dp;
    for (int i = tid; i < ly.n_a * per; i += THREADS) {
      const int ai = i / per, rem = i % per, rr = rem / dp, cc = rem % dp;
      float v = 0.f;
      if (q0 + rr < a.B && cc < a.d) {
        long long id = a.node_entity[(long long)(q0 + rr) * a.n_nodes +
                                     ly.a_slot[ai]];
        id = id < 0 ? 0 : (id >= a.n_ent ? a.n_ent - 1 : id);
        v = a.ent_bf16
                ? __bfloat162float(static_cast<const bf16*>(a.ent)[id * a.d + cc])
                : __ldg(static_cast<const float*>(a.ent) + id * a.d + cc);
      }
      xs[(ai * TQ + rr) * xp + cc] = __float2bfloat16_rn(v);
    }
  } else {
    const int per = dp / 8;
    for (int i = tid; i < ly.n_a * TQ * per; i += THREADS) {
      const int ai = i / (TQ * per), rem = i % (TQ * per);
      const int rr = rem / per, v = rem % per;
      const bool ok = q0 + rr < a.B;
      cp_async16(xs + (ai * TQ + rr) * xp + v * 8,
                 a.x_in + ((size_t)ly.a_slot[ai] * a.B + (ok ? q0 + rr : 0)) *
                              dp + v * 8,
                 ok);
    }
  }

  // ---- the passes: the self products (if any), then the basis chunks
  // (if any source is a product); dp / KT stages each
  const int tpp = dp / KT;
  const int n_chunks = ly.n_sp > 0 ? (a.nb + ly.nbc - 1) / ly.nbc : 0;
  const int has_self = ly.n_ss > 0;
  const int n_tiles = (has_self + n_chunks) * tpp;
  const size_t wrow = (size_t)a.nb * dp;  // vw row pitch
  auto stage_tile = [&](int t) {
    if (t < n_tiles) {
      const int p = t / tpp, k0 = (t % tpp) * KT;
      bf16* dst = stage + (t & 1) * STAGE;
      if (has_self && p == 0) {
        const bf16* w = a.w_self + ((size_t)l * dp + k0) * dp + col0;
        for (int i = tid; i < KT * 2; i += THREADS)
          cp_async16(dst + (i >> 1) * SP + (i & 1) * 8,
                     w + (size_t)(i >> 1) * dp + (i & 1) * 8);
      } else {
        const int b0 = (p - has_self) * ly.nbc;
        const int nbc = min(ly.nbc, a.nb - b0), per = 2 * nbc;
        const bf16* w = a.vw + ((size_t)l * dp + k0) * wrow +
                        (size_t)b0 * dp + col0;
        for (int i = tid; i < KT * per; i += THREADS) {
          const int rr = i / per, rem = i % per;
          cp_async16(dst + rr * SP + rem * 8,
                     w + (size_t)rr * wrow + (size_t)(rem >> 1) * dp +
                         (rem & 1) * 8);
        }
      }
    }
    cp_async_commit();
  };

  // per-thread message sums of the layer's edges, and their relations
  float msg[MAXE], nr[MAXE];
  int rl[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    msg[e] = 0.f;
    nr[e] = 0.f;
    rl[e] = -1;
    if (e < ly.n_e && qv) {
      const long long off = (long long)q * a.n_edges + ly.e_j[e];
      const int v = a.rel[off];
      rl[e] = (v >= 0 && v < a.n_rels) ? v : -1;
      nr[e] = a.norm[off];
    }
  }
  const float* cl = a.coeff + (size_t)l * a.n_rels * a.nb;

  float acc[MAXJ][2][4];
  stage_tile(0);  // with the x rows' copies: one commit group
  for (int t = 0; t < n_tiles; ++t) {
    const int p = t / tpp, kt = t % tpp;
    const bool self = has_self && p == 0;
    const int b0 = self ? 0 : (p - has_self) * ly.nbc;
    const int nbc = self ? 1 : min(ly.nbc, a.nb - b0);
    const int n_jobs = self ? ly.n_ss : ly.n_sp * nbc;
    if (kt == 0) {
#pragma unroll
      for (int m = 0; m < MAXJ; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][h][i] = 0.f;
    }
    stage_tile(t + 1);
    cp_async_wait<1>();
    __syncthreads();  // stage t (and the x rows) landed

    const bf16* bs = stage + (t & 1) * STAGE;
#pragma unroll
    for (int m = 0; m < MAXJ; ++m) {
      const int j = warp + WARPS * m;
      if (j >= n_jobs) break;
      const int ai = self ? ly.ss_a[j] : ly.sp_a[j / nbc];
      const int bl = self ? 0 : j % nbc;
      const bf16* A = xs + (ai * TQ + (lane & 15)) * xp + kt * KT +
                      (lane >> 4) * 8;
      const bf16* Bm = bs + (lane & 15) * SP + bl * CW + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) {
        uint32_t fa[4], fb[4];
        ldsm_x4(fa, A + ks * 16);
        ldsm_x4_t(fb, Bm + ks * 16 * SP);
        mma16816(acc[m][0], fa, fb[0], fb[1]);
        mma16816(acc[m][1], fa, fb[2], fb[3]);
      }
    }
    const bool pass_end = kt == tpp - 1;
    if (pass_end) {  // the pass's sums to shared memory, f32
      float* dst0 = self ? ss : hs;
      const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int m = 0; m < MAXJ; ++m) {
        const int j = warp + WARPS * m;
        if (j >= n_jobs) break;
        float* dst = dst0 + (size_t)j * TQ * CW;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = h * 8 + 2 * t4;
          dst[gq * CW + cc] = acc[m][h][0];
          dst[gq * CW + cc + 1] = acc[m][h][1];
          dst[(gq + 8) * CW + cc] = acc[m][h][2];
          dst[(gq + 8) * CW + cc + 1] = acc[m][h][3];
        }
      }
    }
    __syncthreads();  // stage t's buffer is free; the pass's sums landed
    if (pass_end && !self) {
      // msg_e += coeff[rel_e, b] * h_b for the chunk's bases, ascending
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        if (e >= ly.n_e) break;
        const int i = ly.e_sp[e];
        if (i < 0) continue;
        const float* h = hs + ((size_t)i * nbc * TQ + r) * CW + c;
        for (int bl = 0; bl < nbc; ++bl) {
          const float ce = rl[e] >= 0 ? __ldg(cl + (size_t)rl[e] * a.nb +
                                              b0 + bl)
                                      : 0.f;
          const float pr = __fmul_rn(ce, h[(size_t)bl * TQ * CW]);
          msg[e] = (b0 == 0 && bl == 0) ? pr : __fadd_rn(msg[e], pr);
        }
      }
    }
  }
  cp_async_wait<0>();

  auto mode_of = [&](int slot) -> int {
    if (!qv) return -1;
    const int m = a.node_mode[(long long)q * a.n_nodes + slot];
    return (m >= 0 && m < a.n_modes) ? m : -1;
  };
  // layer-0 variable sources: h_b = bf16(var @ basis_0[b])[mode]
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (e >= ly.n_e) break;
    if (ly.e_sp[e] >= 0) continue;
    const int md = mode_of(ly.e_slot[e]);
    for (int b = 0; b < a.nb; ++b) {
      const float ce = rl[e] >= 0 ? __ldg(cl + (size_t)rl[e] * a.nb + b) : 0.f;
      const float h = md >= 0 ? __bfloat162float(
                                    a.tvar0[((size_t)md * a.nb + b) * dp + col])
                              : 0.f;
      const float pr = __fmul_rn(ce, h);
      msg[e] = b == 0 ? pr : __fadd_rn(msg[e], pr);
    }
  }

  // ---- y = (self + bias) + the destination's messages, per out slot
  const float bv = __ldg(a.bias + (size_t)l * dp + col);
  for (int o = 0; o < ly.n_out; ++o) {
    const int s = ly.out_slot[o];
    float y;
    if (ly.out_self[o] >= 0) {
      y = ss[((size_t)ly.out_self[o] * TQ + r) * CW + c];
    } else {
      const int md = mode_of(s);
      y = md >= 0 ? __bfloat162float(a.tself0[(size_t)md * dp + col]) : 0.f;
    }
    y = __fadd_rn(y, bv);
    float m = 0.f;
    bool any = false;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e >= ly.n_e) break;
      if (ly.e_out[e] != o) continue;
      const float pm = __fmul_rn(msg[e], nr[e]);
      m = any ? __fadd_rn(m, pm) : pm;
      any = true;
    }
    if (any) y = __fadd_rn(y, m);
    if (!qv) continue;
    if (ly.last) {
      if (col < a.d) {
        const size_t o_at = (size_t)q * a.d + col;
        if (a.out_bf16)
          static_cast<bf16*>(a.out)[o_at] = __float2bfloat16_rn(y);
        else
          static_cast<float*>(a.out)[o_at] = y;
      }
    } else {
      a.x_out[((size_t)s * a.B + q) * dp + col] =
          __float2bfloat16_rn(fmaxf(y, 0.f));
    }
  }
}

// Parse the host descriptor (ops/fused_fwd.py _descriptor):
//   [steps, per layer: n_a, a_slot * n_a, n_sp, sp_a * n_sp, n_ss,
//    ss_a * n_ss, n_out, (slot, self) * n_out, n_e,
//    (sp, out, j, slot) * n_e]
// into Layer records, the chunk width from the product sources.
// Returns the number of layers, or -1 for a descriptor out of range.
int parse(const int* desc, int desc_len, int n_nodes, int n_edges, int nb,
          Layer* out, int max_layers) {
  int p = 0;
  auto next = [&](int lo, int hi, bool& ok) {
    if (p >= desc_len) {
      ok = false;
      return 0;
    }
    const int v = desc[p++];
    if (v < lo || v > hi) ok = false;
    return v;
  };
  bool ok = true;
  const int steps = next(1, max_layers, ok);
  if (!ok) return -1;
  for (int l = 0; l < steps; ++l) {
    Layer& ly = out[l];
    ly.l = l;
    ly.last = l == steps - 1;
    ly.n_a = next(0, MAXS, ok);
    for (int i = 0; ok && i < ly.n_a; ++i)
      ly.a_slot[i] = next(0, n_nodes - 1, ok);
    ly.n_sp = next(0, MAXS, ok);
    for (int i = 0; ok && i < ly.n_sp; ++i)
      ly.sp_a[i] = next(0, ly.n_a - 1, ok);
    ly.n_ss = next(0, MAXS, ok);
    for (int i = 0; ok && i < ly.n_ss; ++i)
      ly.ss_a[i] = next(0, ly.n_a - 1, ok);
    ly.n_out = next(1, MAXS, ok);
    for (int i = 0; ok && i < ly.n_out; ++i) {
      ly.out_slot[i] = next(0, n_nodes - 1, ok);
      ly.out_self[i] = next(-1, ly.n_ss - 1, ok);
    }
    ly.n_e = next(0, MAXE, ok);
    for (int i = 0; ok && i < ly.n_e; ++i) {
      ly.e_sp[i] = next(-1, ly.n_sp - 1, ok);
      ly.e_out[i] = next(0, ly.n_out - 1, ok);
      ly.e_j[i] = next(0, n_edges - 1, ok);
      ly.e_slot[i] = next(0, n_nodes - 1, ok);
    }
    if (!ok || ly.n_ss > MAX_JOBS) return -1;
    // bases per chunk: as many as MAX_NBC, while every job fits a warp
    ly.nbc = ly.n_sp > 0 ? MAX_JOBS / ly.n_sp : MAX_NBC;
    if (ly.nbc > MAX_NBC) ly.nbc = MAX_NBC;
    if (ly.nbc > nb) ly.nbc = nb;
    if (ly.nbc < 1) return -1;
  }
  return p == desc_len ? steps : -1;
}

constexpr int MAX_LAYERS = 8;
constexpr int MAX_DEVICES = 64;

// A descriptor parsed once at one padded width (mpqe_fused_multi_plan);
// the caller keeps it for every launch of its structure.
struct Plan {
  Layer ls[MAX_LAYERS];
  size_t smem[MAX_LAYERS];  // dynamic shared memory of each layer
  size_t max_smem;
  int steps, n_nodes, n_edges, nb, dp;
};

// The dynamic shared memory fused_multi_layer_kernel may use on each
// device so far: the attribute is set only when a plan needs more.
std::atomic<long long> g_smem_allowed[MAX_DEVICES];

cudaError_t allow_smem(size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && g_smem_allowed[dev].load() >= (long long)smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(fused_multi_layer_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) {
    long long seen = g_smem_allowed[dev].load();
    while (seen < (long long)smem &&
           !g_smem_allowed[dev].compare_exchange_weak(seen, (long long)smem)) {
    }
  }
  return err;
}

}  // namespace

// Parse the descriptor of a structure with n_nodes slots and n_edges
// edges, nb bases, at padded width dp (a multiple of 128).  Returns the
// plan (free with mpqe_fused_multi_plan_free), or null for a descriptor
// the kernel cannot take.
extern "C" void* mpqe_fused_multi_plan(const int* desc, int desc_len,
                                       int n_nodes, int n_edges, int nb,
                                       int dp) {
  if (nb <= 0 || dp <= 0 || dp % 128 != 0 || dp / CW > 65535) return nullptr;
  Plan* p = new Plan();
  p->steps = parse(desc, desc_len, n_nodes, n_edges, nb, p->ls, MAX_LAYERS);
  if (p->steps < 0) {
    delete p;
    return nullptr;
  }
  p->n_nodes = n_nodes;
  p->n_edges = n_edges;
  p->nb = nb;
  p->dp = dp;
  p->max_smem = 0;
  for (int l = 0; l < p->steps; ++l) {
    const Layer& ly = p->ls[l];
    p->smem[l] = layer_smem(ly.n_a, ly.n_sp, ly.n_ss, ly.nbc, dp);
    if (p->smem[l] > p->max_smem) p->max_smem = p->smem[l];
  }
  return p;
}

extern "C" void mpqe_fused_multi_plan_free(void* plan) {
  delete static_cast<Plan*>(plan);
}

// Dynamic shared memory a launch of this plan needs (its widest layer).
extern "C" long long mpqe_fused_multi_plan_smem(const void* plan) {
  return (long long)static_cast<const Plan*>(plan)->max_smem;
}

// Blocks in each layer's launch for B queries at padded width dp.
extern "C" long long mpqe_fused_multi_blocks(int B, int dp) {
  return (long long)((B + TQ - 1) / TQ) * (dp / CW);
}

// Dynamic shared memory a block of this kernel may have on `device`.
extern "C" long long mpqe_fused_multi_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (long long)optin;
}

// K3: one launch per layer on `stream`, of the plan from
// mpqe_fused_multi_plan.  scratch [planes][n_nodes][B][dp] bf16 holds the
// activations between layers: layer l writes plane l % planes and the
// next layer reads it, so planes is at least 2 for three or more layers
// (no layer overwrites rows that blocks of the layer before still read)
// and 1 for two; with planes = steps - 1 every layer's activations stay
// there after the call.  A one-layer plan takes no scratch.  ent is f32,
// or bf16 with ent_bf16; out is written in f32, or in bf16 with out_bf16.
// Returns the first cudaError (0 on success); arguments out of range are
// cudaErrorInvalidValue.
extern "C" int mpqe_fused_multi_forward(
    const void* plan, const void* ent, int ent_bf16, long long n_ent, int d,
    const int* node_entity, const int* node_mode, const int* rel,
    const float* norm, int B, const void* w_self, const float* bias,
    const void* vw, const float* coeff, int n_rels, const void* tself0,
    const void* tvar0, int n_modes, void* scratch, int planes, void* out,
    int out_bf16, void* stream) {
  const Plan* p = static_cast<const Plan*>(plan);
  if (p == nullptr) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int dp = p->dp;
  const int need = p->steps > 2 ? 2 : p->steps - 1;
  if (d <= 0 || d > dp || planes < need || (need > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (B + TQ - 1) / TQ;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(p->max_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, dp / CW);
  const size_t plane = (size_t)p->n_nodes * B * dp;
  bf16* buf = static_cast<bf16*>(scratch);
  Args a;
  a.ent = ent;
  a.ent_bf16 = ent_bf16;
  a.n_ent = n_ent;
  a.d = d;
  a.dp = dp;
  a.node_entity = node_entity;
  a.node_mode = node_mode;
  a.rel = rel;
  a.norm = norm;
  a.B = B;
  a.n_nodes = p->n_nodes;
  a.n_edges = p->n_edges;
  a.w_self = static_cast<const bf16*>(w_self);
  a.bias = bias;
  a.vw = static_cast<const bf16*>(vw);
  a.coeff = coeff;
  a.n_rels = n_rels;
  a.nb = p->nb;
  a.tself0 = static_cast<const bf16*>(tself0);
  a.tvar0 = static_cast<const bf16*>(tvar0);
  a.n_modes = n_modes;
  a.out = out;
  a.out_bf16 = out_bf16;
  for (int l = 0; l < p->steps; ++l) {
    a.x_in = l > 0 ? buf + (size_t)((l - 1) % planes) * plane : nullptr;
    a.x_out = p->ls[l].last ? nullptr : buf + (size_t)(l % planes) * plane;
    fused_multi_layer_kernel<<<grid, THREADS, p->smem[l],
                               static_cast<cudaStream_t>(stream)>>>(p->ls[l],
                                                                    a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
