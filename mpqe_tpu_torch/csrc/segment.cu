// Segment sum (K4a) and segment max (K4b) for Hopper (sm_90a), and the
// segment layout both read.
//
// mpqe_segment_sum replaces the Pallas TPU kernel
// mpqe_tpu/ops/pallas_segment.py segment_sum_pallas (:56; kernel body
// _segment_sum_kernel :39); mpqe_segment_max replaces segment_max_pallas
// (:120; kernel body _segment_max_kernel :100).
//
//   K4a:  out[s] = sum of data[e] over the rows e with id_e == s, f32;
//   K4b:  out[s] = max(-1e30, max of data[e] over the same rows), with a
//         NaN in any term giving NaN (jnp.maximum's rule; fmaxf would
//         drop it), so an empty segment keeps -1e30 (the reference's
//         NEG_INF, not -inf).
// Rows whose id is outside [0, S) belong to no segment.  Both read a
// layout (mpqe_segment_layout): `perm`, the row numbers grouped by
// segment and in ascending row order within a segment, and `offs[s]` ..
// `offs[s + 1]`, segment s's range of `perm` (out-of-range rows come
// after segment S - 1, in row order: a stable sort by segment).  The
// layout depends on the ids alone, so a caller that reduces several
// tensors over the same ids (every R-GCN layer of a sparse encode sums
// into the same destinations) builds it once.
//
// The TPU kernel adds a chunk's rows into all segments at once with a
// one-hot matmul, chunks in grid order.  There is no one-hot matmul here:
// each (segment, 128-column tile) has one owner warp that adds its rows
// in ascending row order, one rounding per add (__fadd_rn), starting from
// 0.  So the sums have one fixed order and no atomics, and the plain
// version (a stable sort and one index_add_ per rank within a segment)
// adds in the same order: the two agree bit for bit.  A max is exact, so
// only NaN needs care there.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes, E d 4 of rows and E 4 of
// ids in, S d 4 out (chip_smoke.py k4_work); one add or compare per input
// element is far below the f32 rate.  The owner warp reads each of its
// rows once as 32 lanes x 4 strided columns (128-byte transactions), and
// takes its row numbers 32 at a time with one load and warp shuffles;
// eight rows are loaded before they are added, so the loads overlap.
//
// The layout is a stable sort of the rows by segment, in integers only,
// so it is the same in every run.  S <= 8,192 (the reference's cap): a
// histogram of S + 1 keys (the last for out-of-range rows) fits in shared
// memory, and a key fits 14 bits.  Up to LAYOUT_ROWS rows one block does
// it all (segment_layout_kernel<.., true>): a shared histogram (integer
// atomics: only the counts depend on them) and a block scan give `offs`;
// the rows, packed as (key, row) pairs, are sorted in shared memory by
// two LSD radix passes of 7 bits (one when S < 128).  In a pass each of
// the 32 warps owns a contiguous slice of the pairs and moves it in order,
// 32 at a time, behind its own cursors: a pair's rank among the equal
// digits of its 32 comes from seven warp ballots.  The sorted pairs are
// perm.  Above LAYOUT_ROWS the rows are cut into ranges of LAYOUT_ROWS:
// per-range histograms (segment_layout_count_kernel), a scan down each
// key's column of ranges (segment_layout_scan_kernel), then one block per
// range sorts its rows as above and writes each where its key's rows of
// the earlier ranges end.  Bound: the ids read once, perm and offs
// written once (chip_smoke.py layout_work).  What takes the time is a
// fixed chain of block barriers and scans and the ~E / 1,024 dependent
// shared-memory steps per warp and pass;
// the ids are loaded all at once, so a block waits on memory once, and
// the radix counts are padded so that a warp's cursors lie in distinct
// banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // four warps, one (segment, tile) each
constexpr int WARPS = THREADS / 32;
constexpr int CPL = 4;        // columns per lane
constexpr int TILE = 32 * CPL;  // columns per warp
constexpr int UNROLL = 8;     // rows loaded before they are added
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <bool MAX>
__device__ __forceinline__ float combine(float acc, float v) {
  if (MAX) return (v > acc || isnan(v)) ? v : acc;  // NaN sticks in acc
  return __fadd_rn(acc, v);
}

template <bool MAX>
__global__ void __launch_bounds__(THREADS)
segment_kernel(const float* __restrict__ data, const int* __restrict__ perm,
               const int* __restrict__ offs, int n_seg, int d, int n_tiles,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= (long long)n_seg * n_tiles) return;  // whole warps leave
  const int s = (int)(w / n_tiles);
  const int col0 = (int)(w % n_tiles) * TILE + lane;
  bool ok[CPL];
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    ok[j] = col0 + 32 * j < d;
    acc[j] = MAX ? NEG_INF : 0.f;
  }
  const int lo = offs[s], hi = offs[s + 1];
  for (int r0 = lo; r0 < hi; r0 += 32) {
    const int n = min(32, hi - r0);  // the same in every lane
    const int my_row = lane < n ? perm[r0 + lane] : 0;
    for (int i = 0; i < n; i += UNROLL) {
      float v[UNROLL][CPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long row = __shfl_sync(FULL, my_row, (i + u) & 31);
        const float* p = data + row * d + col0;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          v[u][j] = (i + u < n && ok[j]) ? p[32 * j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u < n) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[j] = combine<MAX>(acc[j], v[u][j]);
        }
      }
    }
  }
  float* o = out + (long long)s * d + col0;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (ok[j]) o[32 * j] = acc[j];
}

template <bool MAX>
int launch(const float* data, const int* perm, const int* offs, int n_seg,
           int d, float* out, void* stream) {
  if (n_seg < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  const int n_tiles = (d + TILE - 1) / TILE;
  const long long warps = (long long)n_seg * n_tiles;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_kernel<MAX><<<(unsigned)blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      data, perm, offs, n_seg, d, n_tiles, out);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// The layout
// ----------------------------------------------------------------------
constexpr int LAYOUT_THREADS = 1024;
constexpr int LAYOUT_WARPS = LAYOUT_THREADS / 32;
constexpr int LAYOUT_ROWS = 8192;   // rows one block lays out
constexpr int ROWS_PER_THREAD = LAYOUT_ROWS / LAYOUT_THREADS;
constexpr int RADIX_BITS = 7;       // two passes cover keys <= 8,192
constexpr int RADIX = 1 << RADIX_BITS;
// the radix counts, digit-major: one pad column, so that the 32 digits a
// warp touches at once lie in distinct banks (with a stride of 32 ints
// they would all lie in the warp's one bank)
constexpr int HIST_STRIDE = LAYOUT_WARPS + 1;
constexpr int HIST_INTS = RADIX * HIST_STRIDE;
constexpr int MAX_SEGMENTS = 8192;  // the reference's cap
constexpr int SCAN_THREADS = 256;

template <typename T>
__device__ __forceinline__ int seg_key(T id, int n_seg) {
  return (id >= 0 && id < (T)n_seg) ? (int)id : n_seg;
}

// The keys of rows row0 + threadIdx.x + j LAYOUT_THREADS (j <
// ROWS_PER_THREAD, n <= LAYOUT_ROWS rows from row0), -1 past the end: all
// loads issued before any is used, so a block waits on memory once.
template <typename T>
__device__ __forceinline__ void load_keys(const T* __restrict__ ids,
                                          int row0, int n, int n_seg,
                                          int (&key)[ROWS_PER_THREAD]) {
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int e = threadIdx.x + j * LAYOUT_THREADS;
    key[j] = e < n ? seg_key(ids[row0 + e], n_seg) : -1;
  }
}

// Exclusive prefix sum of a[0, n) in shared memory, in place, by the whole
// block (blockDim.x a multiple of 32); warp_tot: 32 ints of shared
// scratch.  Every thread calls it; it ends with a barrier.
__device__ void block_exclusive_scan(int* a, int n, int* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nt = blockDim.x;
  const int per = (n + nt - 1) / nt;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int inc = own;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int n_warps = nt >> 5;
    int v = lane < n_warps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane < n_warps) warp_tot[lane] = v;  // inclusive, over warps
  }
  __syncthreads();
  int run = inc - own + (w > 0 ? warp_tot[w - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
}

// Stable sort of the n packed pairs a[i] = key << 16 | row (row < 2^16,
// key < 2^14) by key, in shared memory: LSD radix passes of RADIX_BITS
// (passes: 1 when every key < RADIX, else 2).  A pass: each warp counts
// the digits of its slice of a (LAYOUT_WARPS contiguous slices, in
// order), one scan over (digit, warp) gives each warp's first place per
// digit, and each warp moves its slice into b in order, 32 at a time: a
// pair's rank among the equal digits of its 32 comes from one warp ballot
// per digit bit, and the group's leader moves the warp's own cursor for
// that digit.  Integer work, no race on a place.  hist: RADIX x
// HIST_INTS ints.  Every thread calls it; returns the buffer that holds
// the sorted pairs.
__device__ unsigned* radix_sort_pairs(unsigned* a, unsigned* b, int n,
                                      int passes, int* hist,
                                      int* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int per = (n + LAYOUT_WARPS - 1) / LAYOUT_WARPS;
  const int lo = min(w * per, n), hi = min(lo + per, n);
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 16 + pass * RADIX_BITS;
    for (int i = threadIdx.x; i < HIST_INTS; i += LAYOUT_THREADS) hist[i] = 0;
    __syncthreads();
    for (int i = lo + lane; i < hi; i += 32)
      atomicAdd(&hist[((a[i] >> shift) & (RADIX - 1)) * HIST_STRIDE + w], 1);
    __syncthreads();
    block_exclusive_scan(hist, HIST_INTS, warp_tot);  // pads count 0
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const bool live = i < hi;
      const unsigned v = live ? a[i] : 0u;
      const int d = (int)((v >> shift) & (RADIX - 1));
      // the live lanes with this lane's digit: one ballot per digit bit
      unsigned same = __ballot_sync(FULL, live);
#pragma unroll
      for (int bit = 0; bit < RADIX_BITS; ++bit) {
        const unsigned ones = __ballot_sync(FULL, (d >> bit) & 1);
        same &= ((d >> bit) & 1) ? ones : ~ones;
      }
      const int rank = __popc(same & below);
      int* cur = hist + d * HIST_STRIDE + w;
      const int c = live ? *cur : 0;
      __syncwarp();
      if (live) {
        b[c + rank] = v;
        if (rank == 0) *cur = c + __popc(same);
      }
      __syncwarp();
    }
    __syncthreads();
    unsigned* t = a;
    a = b;
    b = t;
  }
  return a;
}

// ONE_BLOCK: the whole layout of n_rows <= LAYOUT_ROWS rows, in one block:
// the sorted pairs are perm.  Otherwise block b lays out rows
// [b LAYOUT_ROWS, (b + 1) LAYOUT_ROWS): tot[k] is key k's row count,
// counts[b][k] the count of key k in the ranges before b
// (segment_layout_scan_kernel's output), so the i-th of the range's
// sorted rows, of key k, goes to perm[start[k] + counts[b][k] + i -
// (the range's rows of keys below k)]; block 0 writes offs.  Dynamic
// shared memory (layout_smem): the key counts, in the multi-block form
// twice; two buffers of the range's packed pairs; the radix counts.
template <typename T, bool ONE_BLOCK>
__global__ void __launch_bounds__(LAYOUT_THREADS)
segment_layout_kernel(const T* __restrict__ ids, int n_rows, int n_seg,
                      const int* __restrict__ counts,
                      const int* __restrict__ tot, int* __restrict__ perm,
                      int* __restrict__ offs) {
  extern __shared__ int smem[];
  __shared__ int warp_tot[32];
  const int n1 = n_seg + 1;
  int* local = smem;                             // [n1]
  int* place = ONE_BLOCK ? smem : smem + n1;     // [n1]
  unsigned* pa = reinterpret_cast<unsigned*>(place + n1);  // [LAYOUT_ROWS]
  const int row0 = ONE_BLOCK ? 0 : blockIdx.x * LAYOUT_ROWS;
  const int n = ONE_BLOCK ? n_rows : min(LAYOUT_ROWS, n_rows - row0);
  const int cap = ONE_BLOCK ? n_rows : LAYOUT_ROWS;
  unsigned* pb = pa + cap;                       // [LAYOUT_ROWS]
  int* hist = reinterpret_cast<int*>(pb + cap);  // [HIST_INTS]
  int key[ROWS_PER_THREAD];
  load_keys(ids, row0, n, n_seg, key);
  for (int s = threadIdx.x; s < n1; s += LAYOUT_THREADS) {
    local[s] = 0;
    if (!ONE_BLOCK) place[s] = tot[s];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int e = threadIdx.x + j * LAYOUT_THREADS;
    if (key[j] >= 0) {
      pa[e] = ((unsigned)key[j] << 16) | (unsigned)e;
      atomicAdd(&local[key[j]], 1);
    }
  }
  __syncthreads();
  block_exclusive_scan(local, n1, warp_tot);  // the range's key starts
  if (!ONE_BLOCK) block_exclusive_scan(place, n1, warp_tot);
  if (blockIdx.x == 0)  // ONE_BLOCK: place is local
    for (int s = threadIdx.x; s < n1; s += LAYOUT_THREADS) offs[s] = place[s];
  if (!ONE_BLOCK) {
    const int* before = counts + (long long)blockIdx.x * n1;
    for (int s = threadIdx.x; s < n1; s += LAYOUT_THREADS)
      place[s] += before[s] - local[s];
  }
  const unsigned* sorted =
      radix_sort_pairs(pa, pb, n, n_seg < RADIX ? 1 : 2, hist, warp_tot);
  for (int i = threadIdx.x; i < n; i += LAYOUT_THREADS) {
    const unsigned v = sorted[i];
    perm[(ONE_BLOCK ? 0 : place[v >> 16]) + i] = row0 + (int)(v & 0xffffu);
  }
}

// counts[b][k]: the rows of key k in range b (LAYOUT_ROWS rows a range).
template <typename T>
__global__ void __launch_bounds__(LAYOUT_THREADS)
segment_layout_count_kernel(const T* __restrict__ ids, int n_rows,
                            int n_seg, int* __restrict__ counts) {
  extern __shared__ int hist[];
  const int n1 = n_seg + 1;
  const int row0 = blockIdx.x * LAYOUT_ROWS;
  int key[ROWS_PER_THREAD];
  load_keys(ids, row0, min(LAYOUT_ROWS, n_rows - row0), n_seg, key);
  for (int s = threadIdx.x; s < n1; s += blockDim.x) hist[s] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j)
    if (key[j] >= 0) atomicAdd(&hist[key[j]], 1);
  __syncthreads();
  int* out = counts + (long long)blockIdx.x * n1;
  for (int s = threadIdx.x; s < n1; s += blockDim.x) out[s] = hist[s];
}

// Down each key's column: counts[b][k] becomes the rows of key k in the
// ranges before b, tot[k] their total.
__global__ void __launch_bounds__(SCAN_THREADS)
segment_layout_scan_kernel(int* __restrict__ counts, int n_ranges, int n1,
                           int* __restrict__ tot) {
  const int k = blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (k >= n1) return;
  int run = 0;
#pragma unroll 8
  for (int b = 0; b < n_ranges; ++b) {
    int* p = counts + (long long)b * n1 + k;
    const int c = *p;
    *p = run;
    run += c;
  }
  tot[k] = run;
}

template <typename F>
cudaError_t allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

long long ranges_of(int n_rows) {
  return ((long long)n_rows + LAYOUT_ROWS - 1) / LAYOUT_ROWS;
}

// Dynamic shared memory of segment_layout_kernel for n rows: the key
// counts (twice in the multi-block form), two buffers of n packed pairs,
// the radix counts.
size_t layout_smem(int n1, int n, bool one_block) {
  return (size_t)(one_block ? 1 : 2) * n1 * 4 + (size_t)n * 8 +
         (size_t)HIST_INTS * 4;
}

template <typename T>
int launch_layout(const T* ids, int n_rows, int n_seg, int* scratch,
                  int* perm, int* offs, cudaStream_t st) {
  const int n1 = n_seg + 1;
  cudaError_t err;
  if (n_rows <= LAYOUT_ROWS) {
    const size_t smem = layout_smem(n1, n_rows, true);
    if ((err = allow_smem(segment_layout_kernel<T, true>, smem)))
      return (int)err;
    segment_layout_kernel<T, true><<<1, LAYOUT_THREADS, smem, st>>>(
        ids, n_rows, n_seg, nullptr, nullptr, perm, offs);
    return (int)cudaGetLastError();
  }
  const int n_ranges = (int)ranges_of(n_rows);
  int* tot = scratch;
  int* counts = scratch + n1;
  segment_layout_count_kernel<T><<<n_ranges, LAYOUT_THREADS,
                                   (size_t)n1 * 4, st>>>(
      ids, n_rows, n_seg, counts);
  if ((err = cudaGetLastError())) return (int)err;
  segment_layout_scan_kernel<<<(n1 + SCAN_THREADS - 1) / SCAN_THREADS,
                               SCAN_THREADS, 0, st>>>(counts, n_ranges, n1,
                                                      tot);
  if ((err = cudaGetLastError())) return (int)err;
  const size_t smem = layout_smem(n1, LAYOUT_ROWS, false);
  if ((err = allow_smem(segment_layout_kernel<T, false>, smem)))
    return (int)err;
  segment_layout_kernel<T, false><<<n_ranges, LAYOUT_THREADS, smem, st>>>(
      ids, n_rows, n_seg, counts, tot, perm, offs);
  return (int)cudaGetLastError();
}

}  // namespace

// The ints of device scratch mpqe_segment_layout needs for n_rows rows
// and n_seg segments (0 up to LAYOUT_ROWS rows: one block, no scratch).
extern "C" long long mpqe_segment_layout_scratch(int n_rows, int n_seg) {
  if (n_rows <= LAYOUT_ROWS) return 0;
  return (ranges_of(n_rows) + 1) * (long long)(n_seg + 1);
}

// The layout of K4a / K4b.  ids [n_rows], int32 (ids_64 == 0) or int64
// (ids_64 != 0); scratch: mpqe_segment_layout_scratch(n_rows, n_seg)
// ints (may be null when that is 0); perm [n_rows] int32; offs
// [n_seg + 1] int32.  0 <= n_seg <= 8,192.  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int mpqe_segment_layout(const void* ids, int ids_64, int n_rows,
                                   int n_seg, int* scratch, int* perm,
                                   int* offs, void* stream) {
  if (n_rows < 0 || n_seg < 0 || n_seg > MAX_SEGMENTS ||
      (n_rows > LAYOUT_ROWS && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ids_64)
    return launch_layout(static_cast<const long long*>(ids), n_rows, n_seg,
                         scratch, perm, offs, st);
  return launch_layout(static_cast<const int*>(ids), n_rows, n_seg, scratch,
                       perm, offs, st);
}

// K4a.  data [E][d] f32; perm [E] int32 (rows grouped by segment, each
// segment's rows ascending); offs [n_seg + 1] int32; out [n_seg][d] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mpqe_segment_sum(const float* data, const int* perm,
                                const int* offs, int n_seg, int d,
                                float* out, void* stream) {
  return launch<false>(data, perm, offs, n_seg, d, out, stream);
}

// K4b.  The same arguments; empty segments get -1e30.
extern "C" int mpqe_segment_max(const float* data, const int* perm,
                                const int* offs, int n_seg, int d,
                                float* out, void* stream) {
  return launch<true>(data, perm, offs, n_seg, d, out, stream);
}
