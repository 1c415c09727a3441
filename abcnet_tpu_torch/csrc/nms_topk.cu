// Fused 3x3 NMS + threshold + top-K over (B, H, W) heatmap logits, for one
// map or for two maps of one shape (the atom and the bond heatmap of a
// serving batch) in a single launch.
//
// Replaces the Pallas kernel abcnet_tpu/ops/pallas_peaks.py:_nms_topk_kernel
// (wrapper nms_topk). Same contract as there and as the plain version in
// ops/peaks.py (a 3x3 max pool with -inf padding, the mask
// (pooled == x) & (x > threshold), a stable descending sort, the first K):
//   * plateau ties all survive; a value exactly at the threshold drops;
//   * slots are ordered by score descending, ties by flat index ascending;
//   * exhausted slots carry -inf, and take the indices a stable sort gives
//     them: the smallest non-surviving flat indices, ascending.
//
// What bounds it on an H100. Not the bytes: both bf16 maps of a batch of
// 64 are 4 MB, 1.3 us at 3.35 TB/s. An empty kernel of the same launch
// shape takes 5 us between two CUDA events, and the work itself is a chain
// of latencies: a round of global loads, the survivor test, a cluster
// barrier, a merge, the stores. Stamps of clock64() per stage showed what
// that chain is made of on this card: instructions that run once. Every
// launch starts with cold instruction caches on all SMs at the same time:
// a straight run of code then costs many cycles an instruction and a jump
// to a line not yet fetched far more, whatever the instructions do. So the design keeps the path that a trained heatmap
// takes (about 30 survivors a map) short and straight, puts everything
// rare behind calls (__noinline__), makes no constant on the device that
// the host can pass in, and spreads every step over the card:
//   * One launch serves both maps: grid = (cluster * B, maps).
//   * A thread block cluster takes one map, each CTA a band of rows
//     (4 CTAs of 256 threads, 32 rows each at 128x128): 512 CTAs of 41 KB
//     shared memory for a serving batch, all resident on the 132 SMs at
//     once.
//   * No copy of the map in shared memory. A thread loads 8 consecutive
//     cells of its row and of the rows above and below as 16-byte words
//     (the rows next to a band are simply read from global memory: the L1
//     and the L2 hold them), takes the vertical maximum in registers and
//     gets the two columns beside its 8 from the neighbouring lanes by
//     shuffle. bf16 converts to f32 exactly, so comparing in f32 keeps the
//     order and the ties of the input. The test only sets the band's
//     survivor bitmask. A width that is no multiple of 8, or a map that
//     is not 16-byte aligned, takes a scalar route (a cell a thread, nine
//     guarded loads) to the same bitmask.
//   * Survivors become 64-bit keys, high word the score mapped to an
//     unsigned integer that orders descending, low word the flat index:
//     the order is total and never depends on the order of the atomics.
//     A thread takes a 32-cell word of the bitmask, reserves room for its
//     survivors with one atomicAdd and reads their scores again (from the
//     L1, where its CTA just put them).
//   * A band with at most K survivors hands them, unsorted, to the
//     cluster's first CTA through distributed shared memory: an atomicAdd
//     on that CTA's counter says where they go, so the keys of a map stand
//     one after another. A band with more sorts first (a bitonic sort in
//     shared memory) and hands over its best K. The cluster barrier is
//     split: every CTA arrives at kernel entry and waits only before it
//     first touches the first CTA's memory, so the barrier that proves
//     "that CTA runs" costs nothing.
//   * The first CTA gives a key the slot that counting says: the number of
//     keys that order before it, one thread a key and no sort, for up to
//     64 keys a map; more are sorted by the same bitonic sort.
//   * Exhausted slots: fewer than K survivors means that the first 2K
//     cells hold at least K non-survivors, so where band 0 has 2K cells
//     (the serving shapes) its own bitmask is enough. The first CTA lists
//     those cells between its arrival at the cluster barrier and its wait,
//     a warp a word and a lane a cell, placed by popcounts alone; after
//     the barrier a thread a slot copies them out. On a small map (or
//     K > 512) one warp lists them after the barrier instead, from the
//     later bands' bitmasks too, read through distributed shared memory,
//     and the cluster stays until it is done.
//   * A flat map makes every cell a survivor: the key list of a band is
//     sized for that (32 KB for 32x128 cells), so no shape needs the old
//     192 KB layout, and the opt-in for more than 48 KB of dynamic shared
//     memory is asked for once per process and only by shapes that need it
//     (a single band of more than 4,096 cells).
// A score of -0.0 is returned as +0.0 (the two compare equal, and the key
// must order them as equal).
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// return value is the launch's cudaError_t.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448 - 256;  // 227 KB less the static part
constexpr size_t kSmemDefault = 48 * 1024;

typedef unsigned long long u64;

struct Job {
  const void* logit;
  float* scores;
  int* idx;
  int k;
};

struct Params {
  Job job[2];
  int H, W;
  int cluster;   // CTAs per map
  int rows;      // rows per band
  int kc;        // keys a band may hand over: min(largest K, cells per band)
  int kmax;      // the largest K of the launch
  // Made on the host, so that no CTA spends instructions on them:
  int cluster_shift;   // log2(cluster)
  int row_shift;       // log2(W / 8) where W / 8 is a power of two, else -1
  int words;           // 32-cell words of a full band
  int at_merged, at_alive, at_cells;                    // Layout, in bytes
  int vec;       // 1: 16-byte loads are allowed
  float thr;
  long long* stamps;   // timing-only build: 16 words a CTA, else unused
};

// Timing-only build (-DABCNET_NMS_STAMPS, tools/nms_stamps.py): thread 0 of
// every CTA keeps clock64() at eight places of the kernel in registers and
// writes them out as it leaves, with %globaltimer at entry and exit.
#ifdef ABCNET_NMS_STAMPS
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMPS_BEGIN()                                \
  long long stamp_[8] = {0, 0, 0, 0, 0, 0, 0, 0};     \
  const long long entered_ = global_ns()
#define STAMP(n) \
  do { if (threadIdx.x == 0) stamp_[n] = clock64(); } while (0)
#define STAMPS_END()                                                       \
  do {                                                                     \
    if (threadIdx.x == 0 && p.stamps) {                                    \
      long long* out_ =                                                    \
          p.stamps + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 16;   \
      for (int n_ = 0; n_ < 8; ++n_) out_[n_] = stamp_[n_];                \
      out_[8] = entered_;                                                  \
      out_[9] = global_ns();                                               \
    }                                                                      \
  } while (0)
#else
#define STAMPS_BEGIN()
#define STAMP(n)
#define STAMPS_END()
#endif

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Dynamic shared memory of one CTA, offsets in bytes.
struct Layout {
  size_t keys;    // next_pow2(cells per band) keys of this band
  size_t merged;  // next_pow2(cluster * kc) keys, used in the first CTA
  size_t alive;   // survivor bitmask of this band, bit j = local cell j
  size_t cells;   // kmax cells: the first non-survivors, ascending
  size_t total;
};

// 32-cell words that hold the K smallest non-surviving cells for sure.
// Fewer than K survivors leave K non-survivors among the first 2K cells:
// where band 0 has 2K cells, its first 2K cells are enough; on a smaller
// map every band's words are looked at.
__host__ __device__ inline int table_words(int cells, int k, int cluster) {
  const int words = (cells + 31) / 32;
  const int near = (2 * k + 31) / 32;
  return cells < 2 * k ? cluster * words : (near < words ? near : words);
}

__host__ inline Layout layout(int cells, int kc, int kmax, int cluster) {
  const size_t words = (size_t)(cells + 31) / 32;
  Layout l;
  size_t o = 0;
  l.keys = o;
  o += (size_t)next_pow2(cells) * 8;
  l.merged = o;
  o += cluster > 1 ? (size_t)next_pow2(cluster * kc) * 8 : 0;
  l.alive = o;
  o += words * 4;
  l.cells = o;
  o += (size_t)kmax * 4;
  l.total = o;
  return l;
}

// The largest cluster <= want whose bands fit in shared memory.
__host__ inline bool choose(int H, int W, int kmax, int want, int* cluster,
                            int* rows, int* kc, size_t* bytes) {
  int c = 1;
  while (c * 2 <= want && c * 2 <= kMaxCluster && c * 2 <= H) c *= 2;
  for (;; c >>= 1) {
    const int r = (H + c - 1) / c;
    const long long cells = (long long)r * W;
    if (cells <= (1 << 24)) {
      const int k = kmax < cells ? kmax : (int)cells;
      const size_t b = layout((int)cells, k, kmax, c).total;
      if (b <= kSmemLimit) {
        *cluster = c, *rows = r, *kc = k, *bytes = b;
        return true;
      }
    }
    if (c == 1) return false;
  }
}

// The cluster barrier, split. `started` orders nothing in memory: it only
// tells the cluster that this CTA runs, so that its shared memory exists.
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Max over the in-map rows r-1, r, r+1 of column c.
template <typename T>
__device__ __forceinline__ float column_max(const T* map, int H, int W, int r,
                                            int c) {
  float m = load1(map + (size_t)r * W + c);
  if (r > 0) m = fmaxf(m, load1(map + (size_t)(r - 1) * W + c));
  if (r + 1 < H) m = fmaxf(m, load1(map + (size_t)(r + 1) * W + c));
  return m;
}

// Monotone map of a float to an unsigned integer, complemented so that a
// larger score gives a smaller key; -0.0 and +0.0 give one key.
__device__ __forceinline__ uint32_t desc_key(float v) {
  uint32_t u = __float_as_uint(v + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~u;
}
__device__ __forceinline__ float key_score(u64 key) {
  const uint32_t e = ~(uint32_t)(key >> 32);
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e);
}
__device__ __forceinline__ u64 make_key(float v, int cell) {
  return ((u64)desc_key(v) << 32) | (uint32_t)cell;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// One band of one map, as a CTA sees it.
template <typename T>
struct Band {
  const T* map;     // the whole (H, W) map
  int H, W;
  int r0;           // first row of the band
  int rows;         // rows of a full band (the last band may have fewer)
  int cells;        // cells of this band
  int row_shift;    // log2(W / 8), or -1
  float thr;
};

// Survivor test, 8 consecutive cells a thread from 16-byte loads. Sets the
// band's bitmask, a byte per chunk of 8 cells (bit i = cell i of the chunk).
template <typename T>
__device__ __forceinline__ void nms_chunks(const Band<T>& b, uint8_t* alive,
                                           int tid, int lane) {
  const int per_row = b.W >> 3;
  const int chunks = b.cells >> 3;
  // Every warp makes the same number of passes, so all lanes shuffle.
  const int passes = (b.rows * per_row + kThreads - 1) / kThreads;
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    const int q = pass * kThreads + tid;
    const bool active = q < chunks;
    float x[8], vm[8];
    int r = 0, c0 = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = vm[i] = neg_inf();
    if (active) {
      const int lr = b.row_shift >= 0 ? q >> b.row_shift : q / per_row;
      r = b.r0 + lr;
      c0 = (q - lr * per_row) << 3;
      const T* row = b.map + (size_t)r * b.W + c0;
      float t[8];
      load8(row, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) vm[i] = x[i];
      if (r > 0) {
        load8(row - b.W, t);
#pragma unroll
        for (int i = 0; i < 8; ++i) vm[i] = fmaxf(vm[i], t[i]);
      }
      if (r + 1 < b.H) {
        load8(row + b.W, t);
#pragma unroll
        for (int i = 0; i < 8; ++i) vm[i] = fmaxf(vm[i], t[i]);
      }
    }
    // The columns beside the chunk: the neighbouring lane holds them,
    // unless the chunk starts or ends its row (-inf) or the warp.
    float left = __shfl_up_sync(kFull, vm[7], 1);
    float right = __shfl_down_sync(kFull, vm[0], 1);
    if (active) {
      if (c0 == 0) left = neg_inf();
      else if (lane == 0) left = column_max(b.map, b.H, b.W, r, c0 - 1);
      if (c0 + 8 >= b.W) right = neg_inf();
      else if (lane == 31) right = column_max(b.map, b.H, b.W, r, c0 + 8);
      uint32_t mask = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float l = i ? vm[i - 1] : left;
        const float g = i < 7 ? vm[i + 1] : right;
        const float m = fmaxf(fmaxf(l, vm[i]), g);
        if (x[i] == m && x[i] > b.thr) mask |= 1u << i;
      }
      alive[q] = (uint8_t)mask;
    }
  }
}

// The same test a cell a thread, for a width that is no multiple of 8 or a
// map that is not 16-byte aligned. Sets the bitmask a 32-cell word a warp.
template <typename T>
__device__ __noinline__ void nms_cells(const Band<T> b, uint32_t* alive,
                                       int tid, int lane) {
  const int passes = (b.rows * b.W + kThreads - 1) / kThreads;
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    const int i = pass * kThreads + tid;
    bool keep = false;
    if (i < b.cells) {
      const int lr = i / b.W;
      const int r = b.r0 + lr, c = i - lr * b.W;
      const float v = load1(b.map + (size_t)r * b.W + c);
      float m = column_max(b.map, b.H, b.W, r, c);
      if (c > 0) m = fmaxf(m, column_max(b.map, b.H, b.W, r, c - 1));
      if (c + 1 < b.W) m = fmaxf(m, column_max(b.map, b.H, b.W, r, c + 1));
      keep = (v == m) && (v > b.thr);
    }
    const uint32_t ball = __ballot_sync(kFull, keep);
    if (lane == 0 && i < b.cells) alive[i >> 5] = ball;
  }
}

// Up to this many keys a map are put in order by counting, for each key,
// the keys that order before it (they are all different): one thread a key,
// no barrier. The count is a shared-memory load a pair of keys: for the 450
// to 640 keys of a map of random logits it was slower than the bitonic
// sort when tried.
constexpr int kCountMax = 64;

// Bitonic sort of keys[0..n) ascending (score descending, index ascending)
// by the whole CTA; keys has room for next_pow2(n).
__device__ __noinline__ void block_sort(u64* keys, int n, int tid) {
  const int len = next_pow2(n);
#pragma unroll 1
  for (int i = n + tid; i < len; i += kThreads) keys[i] = ~0ull;
  __syncthreads();
#pragma unroll 1
  for (int k = 2; k <= len; k <<= 1) {
#pragma unroll 1
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll 1
      for (int t = tid; t < len / 2; t += kThreads) {   // a pair a thread
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int q = i | j;
        const u64 a = keys[i], b = keys[q];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[q] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The first `k` non-surviving cells of the map, ascending, into `cells`,
// by one warp: a lane takes a 32-cell word of the survivor bitmask (band
// after band, `words` to a band; bands after the first are read through
// distributed shared memory), a prefix sum over the popcounts tells it
// where its cells go, and it writes them out. 32 words a round, until k
// cells are listed.
__device__ __noinline__ void list_dead_cells(
    cg::cluster_group& cluster, uint32_t* alive, int* cells, int k,
    int entries, int words, int band_cells, int n, int lane) {
  int listed = 0;
#pragma unroll 1
  for (int e0 = 0; e0 < entries && listed < k; e0 += 32) {
    const int e = e0 + lane;
    uint32_t dead = 0;
    int cell = 0;
    if (e < entries) {
      const int j = e / words, w = e - j * words;
      const int left = min(band_cells, n - j * band_cells) - w * 32;
      if (left > 0) {
        dead = ~(j ? cluster.map_shared_rank(alive, j)[w] : alive[w]);
        if (left < 32) dead &= (1u << left) - 1u;
      }
      cell = j * band_cells + w * 32;
    }
    const int c = __popc(dead);
    const int incl = warp_inclusive_scan(c, lane);
    int at = listed + incl - c;
#pragma unroll 1
    while (dead && at < k) {
      cells[at++] = cell + __ffs(dead) - 1;
      dead &= dead - 1;
    }
    listed += __shfl_sync(kFull, incl, 31);
  }
}

// The same list where the first `entries` <= 32 words of this band's own
// bitmask hold the k cells: a warp takes a word and a lane a cell, which
// goes where the popcounts of the words before and of the lanes before
// say. No prefix sum, no barrier.
__device__ __forceinline__ void list_few_dead_cells(const uint32_t* alive,
                                                    int* cells, int k,
                                                    int entries,
                                                    int band_cells, int tid) {
  const int lane = tid & 31;
#pragma unroll 1
  for (int w = tid >> 5; w < entries; w += kThreads / 32) {
    uint32_t dead = ~alive[w];
    const int left = band_cells - w * 32;
    if (left < 32) dead &= (1u << left) - 1u;
    int at = __popc(dead & ((1u << lane) - 1u));
#pragma unroll 1
    for (int v = 0; v < w; ++v) at += __popc(~alive[v]);
    if (((dead >> lane) & 1u) && at < k) cells[at] = w * 32 + lane;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nms_topk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count;       // survivors of this band
  __shared__ int gathered;    // in the first CTA: keys handed over so far
  __shared__ int base;        // where this band's keys go among them

  STAMPS_BEGIN();
  STAMP(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  if (tid == 0) count = 0, gathered = 0;
  // Every CTA of the cluster arrives here and waits before it first touches
  // another CTA's shared memory; the first CTA's arrival publishes its
  // gathered = 0.
  if (rank == 0) cluster_arrive(); else cluster_arrive_started();

  const int image = blockIdx.x >> p.cluster_shift;
  const Job job = blockIdx.y ? p.job[1] : p.job[0];
  const int K = job.k;
  const int n = p.H * p.W;
  const int band_cells = p.rows * p.W;            // of a full band
  const int words = p.words;
  u64* keys = reinterpret_cast<u64*>(smem);
  // Where the first CTA gathers the cluster's keys (keys itself if C == 1).
  u64* flat = reinterpret_cast<u64*>(smem + p.at_merged);
  uint32_t* alive = reinterpret_cast<uint32_t*>(smem + p.at_alive);
  int* dead_cells = reinterpret_cast<int*>(smem + p.at_cells);

  const int lane = tid & 31;
  float* out_s = job.scores + (size_t)image * K;
  int* out_i = job.idx + (size_t)image * K;

  Band<T> band;
  band.map = static_cast<const T*>(job.logit) + (size_t)image * n;
  band.H = p.H, band.W = p.W, band.thr = p.thr;
  band.r0 = rank * p.rows;
  band.rows = p.rows;
  band.row_shift = p.row_shift;
  band.cells = max(0, min(p.H - band.r0, p.rows)) * p.W;
  const int cell0 = band.r0 * p.W;                // its first flat index

  // 1. NMS: the band's survivor bitmask.
  if (p.vec) nms_chunks(band, reinterpret_cast<uint8_t*>(alive), tid, lane);
  else nms_cells(band, alive, tid, lane);
  __syncthreads();
  STAMP(1);

  // 2. Survivors become keys, a 32-cell word a thread. The score is read
  // again: its line was loaded a moment ago.
#pragma unroll 1
  for (int w = tid; w * 32 < band.cells; w += kThreads) {
    uint32_t word = alive[w];
    const int left = band.cells - w * 32;
    if (left < 32) word &= (1u << left) - 1u;
    if (word) {
      int slot = atomicAdd(&count, __popc(word));
      do {
        const int cell = cell0 + w * 32 + __ffs(word) - 1;
        keys[slot++] = make_key(load1(band.map + cell), cell);
        word &= word - 1;
      } while (word);
    }
  }
  __syncthreads();
  STAMP(2);

  // 3. A band hands its keys, unsorted, to the cluster's first CTA; one
  // with more than K sorts them first and hands over the best K.
  const int cnt = count;
  const int top = cnt < K ? cnt : K;
  if (cnt > K) block_sort(keys, cnt, tid);
  // Where band 0 holds all the cells the exhausted slots can take (2K
  // cells) in at most 32 words, the first CTA lists them between its
  // arrival at the barrier and its wait, all warps at once; else one warp
  // lists them after the barrier, from the later bands' bitmasks too.
  const bool far_fill = band_cells < 2 * K;
  const int entries = table_words(band_cells, K, C);
  const bool quick = !far_fill && entries <= 32;
  STAMP(3);
  cluster_wait();
  if (C > 1) {
    // A band's keys go where an atomicAdd on the first CTA's counter says.
    if (tid == 0) base = atomicAdd(cluster.map_shared_rank(&gathered, 0), top);
    __syncthreads();
    u64* dst = cluster.map_shared_rank(flat, 0) + base;
#pragma unroll 1
    for (int s = tid; s < top; s += kThreads) dst[s] = keys[s];
    cluster_arrive();
    if (rank == 0 && quick) list_few_dead_cells(alive, dead_cells, K, entries,
                                                band_cells, tid);
    cluster_wait();
    STAMP(4);
    if (rank != 0) {
      STAMPS_END();
      if (far_fill) {             // keep the bitmask readable for CTA 0
        cluster_arrive();
        cluster_wait();
      }
      return;
    }
  } else {
    if (tid == 0) gathered = top;
    if (quick) list_few_dead_cells(alive, dead_cells, K, entries, band_cells,
                                   tid);
  }
  __syncthreads();
  STAMP(5);

  // 4. The slot of a key is the number of keys that order before it: a few
  // keys are counted through, one thread a key; many are sorted.
  const int total = gathered;
  if (total <= kCountMax) {
    if (tid < total) {
      const u64 key = flat[tid];
      int slot = 0;
#pragma unroll 4
      for (int i = 0; i < total; ++i) slot += flat[i] < key;
      if (slot < K) {
        out_s[slot] = key_score(key);
        out_i[slot] = (int)(uint32_t)key;
      }
    }
  } else {
    block_sort(flat, total, tid);
#pragma unroll 1
    for (int s = tid; s < min(total, K); s += kThreads) {
      out_s[s] = key_score(flat[s]);
      out_i[s] = (int)(uint32_t)flat[s];
    }
  }
  STAMP(6);

  // 5. Exhausted slots: the smallest non-surviving indices, ascending.
  if (total < K) {
    if (!quick) {
      if (tid < 32)
        list_dead_cells(cluster, alive, dead_cells, K - total, entries,
                        words, band_cells, n, lane);
      __syncthreads();
    }
#pragma unroll 1
    for (int s = tid; s < K - total; s += kThreads) {
      out_s[total + s] = neg_inf();
      out_i[total + s] = dead_cells[s];
    }
  }
  STAMP(7);
  STAMPS_END();
  if (far_fill && C > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// An empty kernel: launched with the grid, cluster and shared memory of
// the real one, it shows what a launch of that shape costs by itself.
__global__ void __launch_bounds__(kThreads) null_kernel() {}

template <typename K, typename... Args>
cudaError_t launch_clustered(K kernel, int blocks_x, int maps, int cluster,
                             size_t bytes, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks_x, (unsigned)maps, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Dynamic shared memory above 48 KB is an opt-in: asked for once per
// process and kernel, the first time a shape needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* allowed) {
  if (bytes <= kSmemDefault || *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  *allowed = err == cudaSuccess;
  return err;
}

template <typename T>
int launch(Params p, int maps, int B, int want, void* stream) {
  static bool allowed = false;
  size_t bytes;
  const int kmax = maps > 1 && p.job[1].k > p.job[0].k ? p.job[1].k
                                                       : p.job[0].k;
  if (B < 1 || B > (1 << 27) ||
      !choose(p.H, p.W, kmax, want, &p.cluster, &p.rows, &p.kc, &bytes))
    return (int)cudaErrorInvalidValue;
  p.kmax = kmax;
  const Layout l = layout(p.rows * p.W, p.kc, kmax, p.cluster);
  p.at_merged = p.cluster > 1 ? (int)l.merged : (int)l.keys;
  p.at_alive = (int)l.alive, p.at_cells = (int)l.cells;
  p.words = (p.rows * p.W + 31) / 32;
  p.cluster_shift = 0;
  while ((1 << p.cluster_shift) < p.cluster) ++p.cluster_shift;
  p.row_shift = -1;
  for (int sh = 0; sh < 16; ++sh)
    if (p.W == (8 << sh)) p.row_shift = sh;
  p.vec = p.W % 8 == 0;
  for (int j = 0; j < maps; ++j)
    if (reinterpret_cast<uintptr_t>(p.job[j].logit) % 16) p.vec = 0;
  cudaError_t err = allow_smem(nms_topk_kernel<T>, bytes, &allowed);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(nms_topk_kernel<T>, p.cluster * B, maps, p.cluster,
                         bytes, stream, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef ABCNET_NMS_STAMPS
long long* g_stamps = nullptr;
#endif

}  // namespace

#ifdef ABCNET_NMS_STAMPS
// Where the next launches write their stamps: 16 int64 a CTA, grid order.
extern "C" void abcnet_nms_topk_stamps(void* buffer) {
  g_stamps = (long long*)buffer;
}
#endif

// Dynamic shared memory per CTA for (H, W) maps, the largest K `kmax` and a
// wanted cluster size; -1 if no cluster size fits the map.
extern "C" long long abcnet_nms_topk_smem_bytes(int H, int W, int kmax,
                                                int cluster) {
  int c, rows, kc;
  size_t bytes;
  if (!choose(H, W, kmax, cluster, &c, &rows, &kc, &bytes)) return -1;
  return (long long)bytes;
}

// The cluster size a launch would use (<= the wanted one), 0 if none fits.
extern "C" int abcnet_nms_topk_cluster(int H, int W, int kmax, int cluster) {
  int c, rows, kc;
  size_t bytes;
  return choose(H, W, kmax, cluster, &c, &rows, &kc, &bytes) ? c : 0;
}

// maps = 1 or 2 maps of one (B, H, W) shape and type (bf16 != 0: bfloat16,
// else float32), each with its own K and outputs (B, K) f32 and int32.
extern "C" int abcnet_nms_topk(const void* logit_a, int k_a, void* scores_a,
                               void* idx_a, const void* logit_b, int k_b,
                               void* scores_b, void* idx_b, int maps, int B,
                               int H, int W, float thr, int bf16, int cluster,
                               void* stream) {
  Params p = {};
  p.job[0] = Job{logit_a, (float*)scores_a, (int*)idx_a, k_a};
  p.job[1] = Job{logit_b, (float*)scores_b, (int*)idx_b, k_b};
  p.H = H, p.W = W, p.thr = thr;
#ifdef ABCNET_NMS_STAMPS
  p.stamps = g_stamps;
#endif
  if (maps < 1 || maps > 2) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(p, maps, B, cluster, stream)
              : launch<float>(p, maps, B, cluster, stream);
}

// The empty kernel in the launch shape abcnet_nms_topk would use.
extern "C" int abcnet_nms_topk_null(int maps, int B, int H, int W, int kmax,
                                    int cluster, void* stream) {
  static bool allowed = false;
  int c, rows, kc;
  size_t bytes;
  if (!choose(H, W, kmax, cluster, &c, &rows, &kc, &bytes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(null_kernel, bytes, &allowed);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(null_kernel, c * B, maps, c, bytes, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
