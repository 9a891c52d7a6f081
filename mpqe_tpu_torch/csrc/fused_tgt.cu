// Shared-relation fused TGT forward (K1) and its backward (K2) for Hopper
// (sm_90a).
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
//        g <- (gb W_l^T) * [Y_{l-1} > 0]; at layer 0 the anchor column
//        blocks of gb W_0^T are dA.
// Every f32 sum runs in one fixed order, one rounding per step: products
// over k ascending then + bias; gb W^T over n ascending; dW and db over
// the rows of each fixed row partition ascending (R rows each, chosen
// from B alone), then the partitions' partial sums in partition order.
// The plain versions in ops/fused_fwd.py run the same order, and a
// product of two bf16 values is exact in f32, so fmaf equals their
// multiply-then-add: kernel and plain version agree bit for bit.  No
// float atomics: the result is the same run to run.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor, 67 TFLOP/s
// f32), counting the function's own work (chip_smoke.py chain_work):
// 2 B d^2 FLOP per nonzero d x d block of W_l, and bytes for the bf16
// anchor rows, one mode id per variable slot and row, the nonzero weights
// and the f32 output.  At the flagship width (d = 128) K1 does 40 to 290
// FLOP per byte, under the card's balance point of 295, so bytes bound it
// at every batch (3-chain at B = 131,072: 30 GFLOP, 102 MB, 31 us); K2
// does 2 to 2.7 times K1's operations and is bound by them only for
// 3-chain at B = 131,072 (82 us).  This design is far from
// that on purpose for now: it runs the products on the f32 FMA pipes
// (1/15 of the bf16 tensor rate) so that its sums have a fixed order
// (the tensor cores' sum order inside an MMA is the hardware's, and bf16
// re-rounding between layers amplifies last-bit noise into flips).  What
// it does about traffic: the activations of a row tile stay in shared
// memory for the whole chain, so K1 reads only X_0, the weights and the
// bias and writes only the output; weight tiles of KT rows are staged in
// shared memory with 16-byte cp.async, double-buffered.  Row tiles are
// 4 rows, so that the training batch of 512 gives 128 blocks for the 132
// SMs.
//
// K2's dW is a reduction over rows, i.e. across blocks, which on Hopper
// run in no order.  Three passes, all launched by mpqe_tgt_backward:
//   A  per row tile: recompute, walk back, write dA, and write the
//      activations X_l (l >= 1, bf16) and cotangents g_l (f32) to scratch;
//   B  per (64 rows of W_l, 128 columns, row partition): sum its rows of
//      X_l^T bf16(g_l) (and of g_l for db) into a partial in scratch;
//   C  per element: add the partials in partition order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CW = 128;            // output columns per chunk
constexpr int NP = CW / 2;         // threads per row group (column pairs)
constexpr int RG = THREADS / NP;   // row groups per block
constexpr int RT = 2;              // rows per thread
constexpr int TQ = RG * RT;        // rows per block (the row tile)
constexpr int KT = 32;             // weight rows per shared-memory tile
constexpr int MAXL = 8;            // layers
constexpr int KB = 64;             // rows of dW per block in pass B
constexpr int KPT = KB / RG;       // rows of dW per thread in pass B
constexpr int RED_THREADS = 256;   // pass C

struct Chain {
  int L;
  int k[MAXL], n[MAXL];
  const __nv_bfloat16* w[MAXL];   // W_l [k_l][n_l]
  const __nv_bfloat16* wt[MAXL];  // W_l^T [n_l][k_l] (backward only)
  const float* b[MAXL];           // b_l [n_l]
};

struct Scratch {
  __nv_bfloat16* x[MAXL];  // X_l [B][k_l] for l >= 1
  float* g[MAXL];          // g_l [B][n_l]
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [k0, k1) of a CW-wide column chunk of a bf16 matrix (row k at
// w + k * stride) to dst (row pitch CW), 16 bytes per cp.async; one
// commit group.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* w, int stride,
                                           int k0, int k1) {
  constexpr int PER_ROW = CW / 8;
  const int total = (k1 - k0) * PER_ROW;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / PER_ROW, v = (i % PER_ROW) * 8;
    cp_async16(dst + r * CW + v, w + (size_t)(k0 + r) * stride + v);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

static_assert(RT == 2, "staged_gemm reads one float2 of X per k");

// acc[i][j] += sum_{k < K} x[i][k] * W[k][n + j], k ascending, one
// rounding per step.  x[i][k] at xr[k * TQ + i] (shared memory, k-major);
// W row k at w + k * stride (global, already offset to the column chunk).
// Every thread of the block calls this together.
__device__ __forceinline__ void staged_gemm(float (&acc)[RT][2],
                                            const float* xr,
                                            const __nv_bfloat16* w,
                                            int stride, int K, int n,
                                            __nv_bfloat16* stage) {
  const int tiles = (K + KT - 1) / KT;
  stage_rows(stage, w, stride, 0, min(K, KT));
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * KT, k1 = min(K, k0 + KT);
    if (t + 1 < tiles) {
      stage_rows(stage + ((t + 1) & 1) * KT * CW, w, stride, k1,
                 min(K, k1 + KT));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* st = stage + (t & 1) * KT * CW + n;
    for (int k = k0; k < k1; ++k, st += CW) {
      const float2 xv2 = *reinterpret_cast<const float2*>(xr + k * TQ);
      const float xv[RT] = {xv2.x, xv2.y};
      const float2 wv = ld_bf16x2(st);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        acc[i][0] = fmaf(xv[i], wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv[i], wv.y, acc[i][1]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles later
  }
}

__device__ __forceinline__ void zero(float (&acc)[RT][2]) {
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = 0.f;
}

// X_0 rows [q0, q0 + TQ) -> xs[c * TQ + r] (f32; rows past B are zero).
__device__ __forceinline__ void load_x0(float* xs,
                                        const __nv_bfloat16* __restrict__ x0,
                                        int B, int k0, int q0) {
  for (int i = threadIdx.x; i < TQ * k0; i += THREADS) {
    const int r = i / k0, c = i % k0, q = q0 + r;
    xs[c * TQ + r] = q < B ? __bfloat162float(x0[(size_t)q * k0 + c]) : 0.f;
  }
}

int max_dim(const Chain& ch) {
  int m = 0;
  for (int l = 0; l < ch.L; ++l) m = max(m, max(ch.k[l], ch.n[l]));
  return m;
}

// Dynamic shared memory of one block, in floats before the weight stage.
size_t smem_floats(bool bwd, const Chain& ch) {
  if (!bwd) return 2 * (size_t)max_dim(ch) * TQ;
  size_t f = 2 * (size_t)max_dim(ch);
  for (int l = 0; l < ch.L; ++l) f += ch.k[l];
  for (int l = 0; l + 1 < ch.L; ++l) f += ch.n[l];
  return f * TQ;
}

size_t smem_bytes(bool bwd, const Chain& ch) {
  return smem_floats(bwd, ch) * sizeof(float) +
         2 * (size_t)KT * CW * sizeof(__nv_bfloat16);
}

// K1.  One block per TQ-row tile; shared memory: X_l and X_{l+1}
// (f32 copies of bf16 values, k-major), then the weight stage.  Threads:
// NP threads own one column pair (cc * CW + n, + 1) of every column chunk
// cc, for RT rows each; RG such row groups make the tile.
__global__ void __launch_bounds__(THREADS)
tgt_forward_kernel(Chain ch, const __nv_bfloat16* __restrict__ x0, int B,
                   float* __restrict__ out, int d, int md) {
  extern __shared__ __align__(16) float smem[];
  float* xa = smem;
  float* xb = smem + (size_t)md * TQ;
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * (size_t)md * TQ);
  const int n = 2 * (threadIdx.x % NP);
  const int r0 = (threadIdx.x / NP) * RT;
  const int q0 = blockIdx.x * TQ;

  load_x0(xa, x0, B, ch.k[0], q0);
  __syncthreads();
  for (int l = 0; l < ch.L; ++l) {
    const bool last = l == ch.L - 1;
#pragma unroll 1
    for (int cc = 0; cc < ch.n[l] / CW; ++cc) {
      const int col = cc * CW + n;
      float acc[RT][2];
      zero(acc);
      staged_gemm(acc, xa + r0, ch.w[l] + cc * CW, ch.n[l], ch.k[l], n,
                      stage);
      const float b0 = ch.b[l][col], b1 = ch.b[l][col + 1];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float y0 = __fadd_rn(acc[i][0], b0);
        const float y1 = __fadd_rn(acc[i][1], b1);
        if (last) {
          const int q = q0 + r0 + i;
          if (q < B) {
            if (col < d) out[(size_t)q * d + col] = y0;
            if (col + 1 < d) out[(size_t)q * d + col + 1] = y1;
          }
        } else {
          xb[col * TQ + r0 + i] = bf16_round(fmaxf(y0, 0.f));
          xb[(col + 1) * TQ + r0 + i] = bf16_round(fmaxf(y1, 0.f));
        }
      }
    }
    __syncthreads();  // X_{l+1} complete; every read of X_l done
    float* t = xa;
    xa = xb;
    xb = t;
  }
}

// K2, pass A.  Shared memory: X_0 .. X_{L-1}, Y_0 .. Y_{L-2} (pre-ReLU,
// for the masks), two cotangent buffers (bf16-valued gb, k-major over the
// columns of the layer's output), then the weight stage.
__global__ void __launch_bounds__(THREADS)
tgt_backward_kernel(Chain ch, const __nv_bfloat16* __restrict__ x0, int B,
                    const float* __restrict__ g, int d, int dp, int n_a,
                    float* __restrict__ da, Scratch scr, int md) {
  extern __shared__ __align__(16) float smem[];
  float* X[MAXL];
  float* Y[MAXL];
  size_t off = 0;
  for (int l = 0; l < ch.L; ++l) {
    X[l] = smem + off * TQ;
    off += ch.k[l];
  }
  for (int l = 0; l + 1 < ch.L; ++l) {
    Y[l] = smem + off * TQ;
    off += ch.n[l];
  }
  float* ga = smem + off * TQ;
  float* gb = ga + (size_t)md * TQ;
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(gb + (size_t)md * TQ);
  const int n = 2 * (threadIdx.x % NP);
  const int r0 = (threadIdx.x / NP) * RT;
  const int q0 = blockIdx.x * TQ;
  const int L = ch.L;

  // ---- recompute the chain, keeping X_l and pre-ReLU Y_l
  load_x0(X[0], x0, B, ch.k[0], q0);
  __syncthreads();
  for (int l = 0; l + 1 < L; ++l) {
    const int nl = ch.n[l];
#pragma unroll 1
    for (int cc = 0; cc < nl / CW; ++cc) {
      const int col = cc * CW + n;
      float acc[RT][2];
      zero(acc);
      staged_gemm(acc, X[l] + r0, ch.w[l] + cc * CW, nl, ch.k[l], n,
                      stage);
      const float b0 = ch.b[l][col], b1 = ch.b[l][col + 1];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float y0 = __fadd_rn(acc[i][0], b0);
        const float y1 = __fadd_rn(acc[i][1], b1);
        const int r = r0 + i;
        Y[l][col * TQ + r] = y0;
        Y[l][(col + 1) * TQ + r] = y1;
        const float x_0 = bf16_round(fmaxf(y0, 0.f));
        const float x_1 = bf16_round(fmaxf(y1, 0.f));
        X[l + 1][col * TQ + r] = x_0;
        X[l + 1][(col + 1) * TQ + r] = x_1;
        if (q0 + r < B)
          *reinterpret_cast<__nv_bfloat162*>(
              scr.x[l + 1] + (size_t)(q0 + r) * nl + col) =
              __floats2bfloat162_rn(x_0, x_1);
      }
    }
    __syncthreads();
  }

  // ---- the output cotangent (columns past d are zero)
  {
    const int nl = ch.n[L - 1];
    for (int i = threadIdx.x; i < TQ * nl; i += THREADS) {
      const int r = i / nl, c = i % nl, q = q0 + r;
      const float v = (q < B && c < d) ? g[(size_t)q * d + c] : 0.f;
      ga[c * TQ + r] = bf16_round(v);
      if (q < B) scr.g[L - 1][(size_t)q * nl + c] = v;
    }
  }
  __syncthreads();

  // ---- reverse sweep: dX_l = gb W_l^T, n ascending
  for (int l = L - 1; l >= 0; --l) {
    const int kl = ch.k[l], nl = ch.n[l];
    const int ncols = l > 0 ? kl : n_a * dp;
#pragma unroll 1
    for (int cc = 0; cc < ncols / CW; ++cc) {
      const int col = cc * CW + n;
      float acc[RT][2];
      zero(acc);
      staged_gemm(acc, ga + r0, ch.wt[l] + cc * CW, kl, nl, n, stage);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + i, q = q0 + r;
        if (l > 0) {
          const float g0 = Y[l - 1][col * TQ + r] > 0.f ? acc[i][0] : 0.f;
          const float g1 = Y[l - 1][(col + 1) * TQ + r] > 0.f ? acc[i][1] : 0.f;
          gb[col * TQ + r] = bf16_round(g0);
          gb[(col + 1) * TQ + r] = bf16_round(g1);
          if (q < B)
            *reinterpret_cast<float2*>(scr.g[l - 1] + (size_t)q * kl + col) =
                make_float2(g0, g1);
        } else if (q < B) {
          const int a = col / dp, c = col % dp;
          float* dst = da + ((size_t)q * n_a + a) * d;
          if (c < d) dst[c] = acc[i][0];
          if (c + 1 < d) dst[c + 1] = acc[i][1];
        }
      }
    }
    __syncthreads();
    float* t = ga;
    ga = gb;
    gb = t;
  }
}

// K2, pass B.  Block (KB rows of dW starting at blockIdx.x * KB, CW
// columns starting at blockIdx.y * CW, row partition blockIdx.z): sums
// x[r][k] * bf16(g[r][n]) over the partition's rows in ascending order
// into partial[p][k][n]; the blocks of blockIdx.x == 0 also sum g[r][n]
// into partial[p][k_rows][n] (db).  x rows (64 bytes of bf16 per thread
// and row) are read straight from global memory.
__global__ void __launch_bounds__(THREADS)
dw_partial_kernel(const __nv_bfloat16* __restrict__ x, int k,
                  const float* __restrict__ g, int nn, int B, int R,
                  float* __restrict__ partial, long long T, long long off) {
  const int n = blockIdx.y * CW + 2 * (threadIdx.x % NP);
  const int kb = blockIdx.x * KB + (threadIdx.x / NP) * KPT;
  const int p = blockIdx.z;
  const int r_lo = p * R, r_hi = min(B, r_lo + R);
  const bool do_db = blockIdx.x == 0 && threadIdx.x < NP;
  float acc[KPT][2];
#pragma unroll
  for (int i = 0; i < KPT; ++i) acc[i][0] = acc[i][1] = 0.f;
  float db0 = 0.f, db1 = 0.f;
  for (int r = r_lo; r < r_hi; ++r) {
    const float2 gv = *reinterpret_cast<const float2*>(g + (size_t)r * nn + n);
    const float g0 = bf16_round(gv.x), g1 = bf16_round(gv.y);
    const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)r * k + kb);
#pragma unroll
    for (int v = 0; v < KPT / 8; ++v) {
      const uint4 u = xp[v];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(h[j]);
        const int i = v * 8 + 2 * j;
        acc[i][0] = fmaf(xf.x, g0, acc[i][0]);
        acc[i][1] = fmaf(xf.x, g1, acc[i][1]);
        acc[i + 1][0] = fmaf(xf.y, g0, acc[i + 1][0]);
        acc[i + 1][1] = fmaf(xf.y, g1, acc[i + 1][1]);
      }
    }
    if (do_db) {
      db0 = __fadd_rn(db0, gv.x);
      db1 = __fadd_rn(db1, gv.y);
    }
  }
  float* dst = partial + (size_t)p * T + off;
#pragma unroll
  for (int i = 0; i < KPT; ++i)
    *reinterpret_cast<float2*>(dst + (size_t)(kb + i) * nn + n) =
        make_float2(acc[i][0], acc[i][1]);
  if (do_db)
    *reinterpret_cast<float2*>(dst + (size_t)k * nn + n) =
        make_float2(db0, db1);
}

// K2, pass C: out[i] = sum_p partial[p][i], p ascending.
__global__ void __launch_bounds__(RED_THREADS)
reduce_partials_kernel(const float* __restrict__ partial, int P, long long T,
                       float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= T) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc = __fadd_rn(acc, partial[(size_t)p * T + i]);
  out[i] = acc;
}

bool make_chain(Chain& ch, int L, const int* k, const int* n,
                const void* const* w, const void* const* wt,
                const void* const* b) {
  if (L <= 0 || L > MAXL) return false;
  ch.L = L;
  for (int l = 0; l < L; ++l) {
    if (k[l] <= 0 || n[l] <= 0 || k[l] % CW || n[l] % CW) return false;
    if (l > 0 && k[l] != n[l - 1]) return false;
    ch.k[l] = k[l];
    ch.n[l] = n[l];
    ch.w[l] = static_cast<const __nv_bfloat16*>(w ? w[l] : nullptr);
    ch.wt[l] = static_cast<const __nv_bfloat16*>(wt ? wt[l] : nullptr);
    ch.b[l] = static_cast<const float*>(b ? b[l] : nullptr);
  }
  return true;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Dynamic shared memory one block needs (bwd: 0 = K1, 1 = K2 pass A)
// for a chain of L layers of k x n.
extern "C" long long mpqe_tgt_smem_bytes(int bwd, int L, const int* k,
                                         const int* n) {
  Chain ch;
  if (!make_chain(ch, L, k, n, nullptr, nullptr, nullptr)) return -1;
  return (long long)smem_bytes(bwd != 0, ch);
}

// Dynamic shared memory a block may have on `device`.
extern "C" long long mpqe_tgt_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (long long)optin;
}

// K1.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpqe_tgt_forward(const void* x0, int B, int L, const int* k,
                                const int* n, const void* const* w,
                                const void* const* b, float* out, int d,
                                void* stream) {
  Chain ch;
  if (!make_chain(ch, L, k, n, w, nullptr, b) || d > n[L - 1])
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const size_t smem = smem_bytes(false, ch);
  const dim3 grid((B + TQ - 1) / TQ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x0);
  const cudaError_t err = prepare(tgt_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tgt_forward_kernel<<<grid, THREADS, smem, s>>>(ch, xp, B, out, d,
                                                 max_dim(ch));
  return (int)cudaGetLastError();
}

// K2: passes A, B (one launch per layer) and C, in stream order.
//   da [B][n_a][d]; xg[l] (l >= 1) [B][k_l] bf16 and gg[l] [B][n_l] f32
//   scratch; partial [P][T] and out [T] with, per layer in order, dW_l
//   [k_l][n_l] then db_l [n_l] (T = sum of k_l n_l + n_l); rows of
//   partition p are [p R, min(B, (p + 1) R)).
extern "C" int mpqe_tgt_backward(
    const void* x0, int B, int L, const int* k, const int* n,
    const void* const* w, const void* const* wt, const void* const* b,
    const float* g, int d, int dp, int n_a, float* da, void* const* xg,
    void* const* gg, int R, int P, float* partial, float* out,
    void* stream) {
  Chain ch;
  if (!make_chain(ch, L, k, n, w, wt, b) || d > n[L - 1] ||
      dp <= 0 || dp % CW || n_a * dp > k[0] ||
      R <= 0 || P <= 0 || (long long)P * R < B)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Scratch scr;
  for (int l = 0; l < L; ++l) {
    scr.x[l] = static_cast<__nv_bfloat16*>(xg[l]);
    scr.g[l] = static_cast<float*>(gg[l]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x0);
  const size_t smem = smem_bytes(true, ch);
  const dim3 grid((B + TQ - 1) / TQ);
  cudaError_t err = prepare(tgt_backward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tgt_backward_kernel<<<grid, THREADS, smem, s>>>(ch, xp, B, g, d, dp, n_a,
                                                  da, scr, max_dim(ch));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  long long T = 0;
  for (int l = 0; l < L; ++l) T += (long long)k[l] * n[l] + n[l];
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    const __nv_bfloat16* xl = l == 0 ? xp : scr.x[l];
    const dim3 gridb(k[l] / KB, n[l] / CW, P);
    dw_partial_kernel<<<gridb, THREADS, 0, s>>>(xl, k[l], scr.g[l], n[l], B,
                                                R, partial, T, off);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    off += (long long)k[l] * n[l] + n[l];
  }
  reduce_partials_kernel<<<(unsigned)((T + RED_THREADS - 1) / RED_THREADS),
                           RED_THREADS, 0, s>>>(partial, P, T, out);
  return (int)cudaGetLastError();
}
