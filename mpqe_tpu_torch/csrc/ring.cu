// The layouts and the destination sum of the ring-halo R-GCN aggregation
// (K8) for Hopper (sm_90a).
//
// K8 replaces the Pallas TPU kernel mpqe_tpu/ops/pallas_ring.py
// rgcn_ring_halo_rdma (:159; kernel body _ring_kernel :54, aggregate()
// :87-105).  The TPU kernel runs the whole ring inside one pallas_call per
// chip, with remote DMAs between two VMEM slots and ack tokens.  Here the
// copies run outside the kernels, on a copy stream ordered by CUDA events
// (ops/ring.py), and each hop is two kernels for every part that lives on
// this device.  At hop s, part p holds in slot s % 2 the node block of part
// sb = (p - s) mod P and aggregates the edge bucket [p, sb]:
//   out[dst_e] += norm_e * sum_b coeff[rel_e, b] * (slot[src_e] @ V_b)
//
// The route: per relation, not per edge and basis (16x fewer products at
// 16 bases).  Once per layer call W_r = sum_b coeff[r, b] V_b (b
// ascending, f32, one rounding per product and sum) for every relation r
// the edges use and a zero W for slot n_rels, by K5a's prologue
// (csrc/rgcn_fused.cu mpqe_rgcn_combine).  Per hop:
//   1. the messages m_e = (slot[src_e] @ W_{slot_e}) * norm_e on the tensor
//      cores in split TF32, by K5's messages kernel (mpqe_rgcn_msg_live)
//      over each bucket's edges laid out in chunks of one relation, into
//      an f32 [chunk rows, d_out] scratch.  The layouts are the kernels
//      below, once per layer call around one stable sort of their keys,
//      with no host sync (K5's kernel reads the number of chunks on the
//      device; ops/ring.py ring_route is their plain version); the
//      combine takes only the relations the edges use;
//   2. ring_sum_kernel below: out[i][r] += the messages of row r's edges,
//      in bucket order (the destination order of ops/ring.py ring_layout),
//      one running sum per column started from out's value: the plain
//      version's per-destination order and rounding.  No atomics.
// So only the products differ from the plain version (ring_hop_reference,
// which keeps the TPU kernel's order: per edge and basis, k ascending):
// the kernel is held to ops/ring.py ring_gate (<= 1e-4 of the plain
// version and <= 1e-5 of the f32 oracles), as K5 is, and a repeat gives
// the same bits.
//
// Out-of-range ids (csrc/rgcn_fused.cu and ops/ring.py ring_route):
//   * src outside [0, block): the edge reads a zero row kept after both
//     slots (the TPU's one-hot gather gives a zero row);
//   * rel outside [0, n_rels): slot n_rels, a zero W (the zero rows of the
//     TPU's coeff_p);
//   * dst outside [0, block) (padding: dst == block): the edge is left out
//     of the chunks and of the sums: the plain version adds nothing for it.
// inf and NaN: a source row holding inf or NaN gives NaN messages through
// a zero W, as the plain version's 0 * h does, and inf or NaN in W (from
// the basis or coeff) reaches an edge from a zero row as NaN in both.  An
// inf operand splits into inf and NaN (hi, lo), so a message the plain
// version makes inf comes out NaN here: non-finite stays non-finite, not
// the same value.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32), counted in
// chip_smoke.py k8_work as the least work over three routes; per relation:
// 2 d d_out per real edge (x3 in split TF32) plus the combine, the norm
// and the destination add.  On the reference's general graph (2^20 edges,
// d = 128) the products bound it (~0.21 ms split TF32); the destination
// sum reads each message once (2^20 x 512 B) and the held rows once.
// ring_sum_kernel: a warp per destination row, lanes across its columns
// (16-byte loads where d_out % 4 == 0), four of the row's messages loaded
// ahead of their ordered adds.  Measured (PERF.md §6): ~1.5x K5a alone on
// the general graph; a template batch's call is bound by the wrapper's
// host work, not by these kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// grid.x: groups of WARPS (part, row) pairs, part-major.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ring_sum_kernel(const float* __restrict__ msg, int N,
                const int* __restrict__ drow, const int* __restrict__ offs,
                int e_max, int block, long long n_rows, int first,
                float* __restrict__ out) {
  const long long gw = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (gw >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const long long i = gw / block;
  const int r = (int)(gw - i * block);
  const int* o = offs + i * (block + 1);
  const int lo = o[r], hi = o[r + 1];
  float* orow = out + gw * N;
  if (lo >= hi) {  // no edge: the first hop writes the row's zeros
    if (first)
      for (int c = lane; c < N; c += 32) orow[c] = 0.f;
    return;
  }
  const int* dr = drow + i * e_max;
  constexpr int W = VEC ? 4 : 1;  // columns a lane loads at once
  for (int c = lane * W; c < N; c += 32 * W) {
    float s[W];  // the running sums, from out (0 at the first hop)
#pragma unroll
    for (int u = 0; u < W; ++u) s[u] = first ? 0.f : orow[c + u];
    for (int j = lo; j < hi; j += 4) {
      float v[4][W];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j + q < hi) {
          const float* m = msg + (size_t)__ldg(dr + j + q) * N + c;
          if constexpr (VEC) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(m));
            v[q][0] = t.x;
            v[q][1 % W] = t.y;
            v[q][2 % W] = t.z;
            v[q][3 % W] = t.w;
          } else {
            v[q][0] = __ldg(m);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < hi)
#pragma unroll
          for (int u = 0; u < W; ++u) s[u] = __fadd_rn(s[u], v[q][u]);
    }
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(orow + c) = make_float4(s[0], s[1 % W],
                                                         s[2 % W], s[3 % W]);
    } else {
      orow[c] = s[0];
    }
  }
}


// ------------------------------------------------------------- layouts
// K8's layouts for the L parts on this device, hop-major (bucket (s, i):
// what part i aggregates at hop s, the edges of [p_i, (p_i - s) mod P]),
// once per layer call.  ops/ring.py ring_route is their plain version.
constexpr int LT = 256;  // layout kernels' threads

// keys [2][P][L][E]: 0, the edge's slot (rel in [0, n_rels), else n_rels)
// where its dst lies in [0, block), else n_rels + 1 (left out); 1, its dst
// where in range, else block.  Also zeroes the row after both slots.
__global__ void __launch_bounds__(LT)
ring_keys_kernel(const int* __restrict__ dst, const int* __restrict__ rel,
                 const int* __restrict__ parts, int L, int P, int E,
                 int block, int n_rels, int* __restrict__ keys,
                 float* __restrict__ zero_row, int K) {
  const long long n = (long long)P * L * E;
  for (long long t = (long long)blockIdx.x * LT + threadIdx.x; t < n;
       t += (long long)gridDim.x * LT) {
    const int e = (int)(t % E);
    const int i = (int)((t / E) % L), s = (int)(t / ((long long)E * L));
    const int b = ((parts[i] - s) % P + P) % P;
    const long long at = ((long long)i * P + b) * E + e;
    const int d = dst[at], r = rel[at];
    const bool in = d >= 0 && d < block;
    keys[t] = in ? (r >= 0 && r < n_rels ? r : n_rels) : n_rels + 1;
    keys[n + t] = in ? d : block;
  }
  for (int k = blockIdx.x * LT + threadIdx.x; k < K; k += gridDim.x * LT)
    zero_row[k] = 0.f;
}

// Block-wide exclusive scan of one int a thread (LT threads); returns the
// thread's prefix, *total gets the sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sum[LT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < LT / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < LT / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  const int before = (warp ? warp_sum[warp - 1] : 0) + x - v;
  *total = warp_sum[LT / 32 - 1];
  __syncthreads();
  return before;
}

// From the slot-sorted keys (skey [buckets][E]): each slot's run start and
// end in its bucket (runs[bucket][0][slot], [1][slot], zeroed before).
__global__ void __launch_bounds__(LT)
ring_bounds_kernel(const int* __restrict__ skey, long long n, int E,
                   int n_rels, int* __restrict__ runs) {
  const int n_slots = n_rels + 1;
  for (long long t = (long long)blockIdx.x * LT + threadIdx.x; t < n;
       t += (long long)gridDim.x * LT) {
    const int j = (int)(t % E), r = skey[t];
    if (r >= n_slots) continue;  // left out: sorted last
    int* start = runs + (t / E) * 3 * n_slots;
    if (j == 0 || skey[t - 1] != r) start[r] = j;
    if (j == E - 1 || skey[t + 1] != r) start[n_slots + r] = j + 1;
  }
}

// One block per bucket: each slot's run length (runs[bucket][1][slot],
// from its end), its first chunk (runs[bucket][2][slot], from the
// bucket's start: runs of ceil(len / C) chunks in slot order) and the
// bucket's chunk total (tot[bucket]); marks the relations present
// (present[r] = 1, zeroed before).
__global__ void __launch_bounds__(LT)
ring_runs_kernel(int n_rels, int chunk, int* __restrict__ runs,
                 int* __restrict__ tot, int* __restrict__ present) {
  const int n_slots = n_rels + 1;
  int* start = runs + (long long)blockIdx.x * 3 * n_slots;
  int* len = start + n_slots;
  int* first = len + n_slots;
  // chunks per slot, scanned in slot order: each thread a span of slots
  const int per = (n_slots + LT - 1) / LT, r0 = threadIdx.x * per;
  int mine = 0;
  for (int r = r0; r < min(r0 + per, n_slots); ++r) {
    if (len[r]) len[r] -= start[r];
    mine += (len[r] + chunk - 1) / chunk;
  }
  int total;
  int at = block_scan(mine, &total);
  for (int r = r0; r < min(r0 + per, n_slots); ++r) {
    first[r] = at;
    at += (len[r] + chunk - 1) / chunk;
    if (len[r] && r < n_rels) present[r] = 1;
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

// Over every slot-sorted position of every bucket (s, i) (its chunks
// follow those of parts i' < i of hop s): the message row of each edge
// whose dst lies in the block (edge_row, and src_h: the slot's row of the
// edge's source, or zero_row; norm_h), each live chunk's relation
// (crel_h), each hop's live chunk count (live[s]) and the combine's
// relation list (comb: r where present, else n_rels: runs of the zero
// slot, which the combine skips but at their starts).
__global__ void __launch_bounds__(LT)
ring_rows_kernel(const int* __restrict__ src, const float* __restrict__ norm,
                 const int* __restrict__ parts, int L, int P, int E,
                 int block, int n_rels, int chunk, long long rows_per_hop,
                 int cap, const int* __restrict__ skey,
                 const long long* __restrict__ order,
                 const int* __restrict__ runs, const int* __restrict__ tot,
                 const int* __restrict__ present, int* __restrict__ edge_row,
                 int* __restrict__ src_h, float* __restrict__ norm_h,
                 int* __restrict__ crel_h, int* __restrict__ live,
                 int* __restrict__ comb) {
  const int n_slots = n_rels + 1;
  const long long n = (long long)P * L * E;
  const long long t0 = (long long)blockIdx.x * LT + threadIdx.x;
  const long long stride = (long long)gridDim.x * LT;
  for (long long r = t0; r < n_slots; r += stride)
    comb[r] = r < n_rels && present[r] ? (int)r : n_rels;
  for (long long h = t0; h < P; h += stride) {
    int sum = 0;
    for (int q = 0; q < L; ++q) sum += tot[h * L + q];
    live[h] = sum;
  }
  for (long long t = t0; t < n; t += stride) {
    const int r = skey[t];
    if (r >= n_slots) continue;  // left out
    const int bk = (int)(t / E), j = (int)(t % E), s = bk / L, i = bk % L;
    const int* start = runs + (long long)bk * 3 * n_slots;
    int base = 0;
    for (int q = 0; q < i; ++q) base += tot[s * L + q];
    const int b = ((parts[i] - s) % P + P) % P;
    const long long in = ((long long)i * P + b) * E;  // the bucket's edges
    const int e = (int)order[t], rank = j - start[r];
    const int c = base + start[2 * n_slots + r] + rank / chunk;
    const int row = c * chunk + rank % chunk;
    const int sv = src[in + e];
    src_h[s * rows_per_hop + row] =
        sv >= 0 && sv < block ? ((s & 1) * L + i) * block + sv
                              : 2 * L * block;  // the zero row
    norm_h[s * rows_per_hop + row] = norm[in + e];
    crel_h[(long long)s * cap + c] = r;
    edge_row[(long long)bk * E + e] = row;
  }
}

// Over every dst-sorted position of every bucket: the destination order
// as message rows (drow) and its row offsets (doffs[r], the first
// position whose key is >= r).
__global__ void __launch_bounds__(LT)
ring_dst_kernel(long long n, int E, int block, const int* __restrict__ dkey,
                const long long* __restrict__ dorder,
                const int* __restrict__ edge_row, int* __restrict__ drow,
                int* __restrict__ doffs) {
  for (long long t = (long long)blockIdx.x * LT + threadIdx.x; t < n;
       t += (long long)gridDim.x * LT) {
    const long long bk = t / E;
    const int j = (int)(t % E), k = dkey[t];
    if (k < block) drow[t] = edge_row[bk * E + dorder[t]];
    int* off = doffs + bk * (block + 1);
    const int prev = j ? dkey[t - 1] : -1;
    for (int r = prev + 1; r <= min(k, block); ++r) off[r] = j;
    if (j == E - 1)
      for (int r = k + 1; r <= block; ++r) off[r] = E;
  }
}

}  // namespace

// One hop's destination sum for the n_local parts on this device:
//   msg  [rows][N] f32, the hop's messages;
//   drow [n_local][e_max] int32: part i's bucket edges in destination order
//        (stable in bucket order), each as its message row;
//   offs [n_local][block + 1] int32: row r's edges are
//        drow[i][offs[i][r] .. offs[i][r + 1]];
//   out  [n_local][block][N] f32, added to (first != 0: written, the sums
//        started from 0, as the plain version's zeros).
// One launch; returns cudaGetLastError() after it (0 on success).
extern "C" int mpqe_ring_sum(const float* msg, int N, const int* drow,
                             const int* offs, int e_max, int block,
                             int n_local, int first, float* out,
                             void* stream) {
  if (N <= 0 || e_max <= 0 || block <= 0 || n_local <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)n_local * block;
  const long long blocks = (n_rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(msg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    ring_sum_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        msg, N, drow, offs, e_max, block, n_rows, first, out);
  } else {
    ring_sum_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        msg, N, drow, offs, e_max, block, n_rows, first, out);
  }
  return (int)cudaGetLastError();
}

// K8's layouts for the n_local parts on this device (the kernels above;
// ops/ring.py ring_route is their plain version), in two calls around a
// stable sort.  mpqe_ring_route_keys: from dst, rel [n_local][n_parts]
// [e_max] int32 and parts [n_local], the keys [2][n_parts][n_local][e_max]
// int32 of ring_keys_kernel; zeroes zero_row [K]; one launch.  The caller
// sorts each key row stably (values and int64 positions).
// mpqe_ring_route: from those sorted keys and positions (order), src and
// norm ([n_local][n_parts][e_max], int32 and f32); scratch runs
// [n_parts n_local][3][n_rels + 1], tot [n_parts n_local], present
// [n_rels], edge_row [n_parts n_local][e_max] int32; outputs src_h, norm_h
// [n_parts][rows_per_hop], crel_h [n_parts][cap], live [n_parts], drow
// [n_parts][n_local][e_max], doffs [n_parts][n_local][block + 1] and comb
// [n_rels + 1] (the combine's relation list); two memsets and four
// launches.
// Each returns cudaGetLastError() after its launches.
extern "C" int mpqe_ring_route_keys(const int* dst, const int* rel,
                                    const int* parts, int n_local,
                                    int n_parts, int e_max, int block,
                                    int n_rels, int* keys, float* zero_row,
                                    int K, void* stream) {
  if (n_local <= 0 || n_parts <= 0 || e_max <= 0 || block <= 0 ||
      n_rels <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_parts * n_local * e_max;
  const long long blocks = (n + LT - 1) / LT;
  ring_keys_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), LT, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      dst, rel, parts, n_local, n_parts, e_max, block, n_rels, keys,
      zero_row, K);
  return (int)cudaGetLastError();
}

extern "C" int mpqe_ring_route(const int* src, const float* norm,
                               const int* parts, int n_local, int n_parts,
                               int e_max, int block, int n_rels, int chunk,
                               long long rows_per_hop, int cap,
                               const int* keys, const long long* order,
                               int* runs, int* tot, int* present,
                               int* edge_row, int* src_h, float* norm_h,
                               int* crel_h, int* live, int* drow, int* doffs,
                               int* comb, void* stream) {
  if (n_local <= 0 || n_parts <= 0 || e_max <= 0 || block <= 0 ||
      n_rels <= 0 || chunk <= 0 || cap <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int buckets = n_parts * n_local;
  const long long n = (long long)buckets * e_max;
  const long long want = (n + LT - 1) / LT;
  const unsigned grid = (unsigned)(want < 8192 ? (want > 0 ? want : 1)
                                               : 8192);
  cudaError_t err = cudaMemsetAsync(
      runs, 0, sizeof(int) * (size_t)buckets * 3 * (n_rels + 1), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(present, 0, sizeof(int) * n_rels, st);
  if (err != cudaSuccess) return (int)err;
  ring_bounds_kernel<<<grid, LT, 0, st>>>(keys, n, e_max, n_rels, runs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ring_runs_kernel<<<buckets, LT, 0, st>>>(n_rels, chunk, runs, tot,
                                           present);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ring_rows_kernel<<<grid, LT, 0, st>>>(
      src, norm, parts, n_local, n_parts, e_max, block, n_rels, chunk,
      rows_per_hop, cap, keys, order, runs, tot, present, edge_row, src_h,
      norm_h, crel_h, live, comb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ring_dst_kernel<<<grid, LT, 0, st>>>(n, e_max, block, keys + n, order + n,
                                       edge_row, drow, doffs);
  return (int)cudaGetLastError();
}
