// Fused 3x3 NMS + threshold + top-K over (B, H, W) heatmap logits.
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
// The TPU kernel makes K select-and-suppress passes over the whole map
// because a sequential grid and wide vector units favour that. On Hopper
// one CTA takes one map (blocks run in parallel, nothing carries between
// them), and the K passes become one compaction and one sort:
//   1. load the map into shared memory as f32 (bf16 converts exactly, so
//      comparing in f32 keeps the order and the ties of the input);
//   2. each warp tests 32 consecutive cells against their in-bounds
//      neighbours, appends survivors as 64-bit keys to a shared list and
//      records a survivor bitmask word with one ballot;
//   3. a bitonic sort of the keys: the high word is the score mapped to an
//      unsigned integer that orders descending, the low word the flat
//      index, so the order is total and never depends on the order in
//      which atomics appended the keys;
//   4. the first K keys are written; if fewer survived, warp 0 walks the
//      bitmask to give the remaining slots their indices.
//
// Bound: the map is read once (32 KiB per 128x128 bf16 map, 64 KiB in
// f32), about 2 MB for a batch of 64 and 2 us at 3.35 TB/s. A trained
// heatmap has about 30 survivors, so the sort is short; the launch and the
// shared-memory round trips set the time. A flat map makes every cell a
// survivor (16,384 for G = 128); the key list is sized for that worst
// case, 192 KiB of shared memory in all at G = 128, one CTA per SM.
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float load_f32(const float* p, int i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// Monotone map of a float to an unsigned integer, complemented so that a
// larger score gives a smaller key.
__device__ __forceinline__ uint32_t desc_key(float v) {
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~u;
}

__host__ __device__ inline size_t align8(size_t x) {
  return (x + 7) & ~size_t(7);
}

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Shared memory: map (n floats) | keys (next_pow2(n) u64) | alive words.
__host__ inline size_t smem_bytes(int n) {
  const int words = (n + 31) / 32;
  return align8((size_t)n * 4) + (size_t)next_pow2(n) * 8 +
         (size_t)words * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nms_topk_kernel(const T* __restrict__ logit, int H, int W, int K, float thr,
                float* __restrict__ scores, int* __restrict__ idx) {
  extern __shared__ unsigned char smem[];
  const int n = H * W;
  const int words = (n + 31) / 32;
  float* map = reinterpret_cast<float*>(smem);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + align8((size_t)n * 4));
  uint32_t* alive = reinterpret_cast<uint32_t*>(keys + next_pow2(n));
  __shared__ int count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const T* src = logit + (size_t)blockIdx.x * n;
  float* out_s = scores + (size_t)blockIdx.x * K;
  int* out_i = idx + (size_t)blockIdx.x * K;

  for (int i = tid; i < n; i += blockDim.x) map[i] = load_f32(src, i);
  if (tid == 0) count = 0;
  __syncthreads();

  // 2. NMS: warp-uniform loop, so every lane takes part in the ballot.
  for (int base = warp * 32; base < n; base += n_warps * 32) {
    const int i = base + lane;
    bool keep = false;
    float v = 0.f;
    if (i < n) {
      const int r = i / W, c = i - r * W;
      v = map[i];
      float m = v;
#pragma unroll
      for (int dr = -1; dr <= 1; ++dr) {
        const int rr = r + dr;
        if (rr < 0 || rr >= H) continue;
#pragma unroll
        for (int dc = -1; dc <= 1; ++dc) {
          const int cc = c + dc;
          if (cc < 0 || cc >= W) continue;
          m = fmaxf(m, map[rr * W + cc]);
        }
      }
      keep = (v == m) && (v > thr);
    }
    const uint32_t ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) alive[base >> 5] = ball;
    if (keep) {
      const int slot = atomicAdd(&count, 1);
      keys[slot] = ((unsigned long long)desc_key(v) << 32) | (uint32_t)i;
    }
  }
  __syncthreads();

  // 3. Bitonic sort of the survivors, padded to a power of two with keys
  // that sort last.
  const int cnt = count;
  const int len = next_pow2(cnt < 1 ? 1 : cnt);
  for (int i = cnt + tid; i < len; i += blockDim.x) keys[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < len; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          const bool ascending = (i & k) == 0;
          if ((a > b) == ascending) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // 4. Survivor slots.
  const int top = cnt < K ? cnt : K;
  for (int s = tid; s < top; s += blockDim.x) {
    const int cell = (int)(keys[s] & 0xffffffffu);
    out_s[s] = map[cell];
    out_i[s] = cell;
  }
  // Exhausted slots: the smallest non-surviving indices, ascending.
  if (warp == 0 && cnt < K) {
    const int need = K - cnt;
    int found = 0;
    for (int w0 = 0; w0 < words && found < need; w0 += 32) {
      const int w = w0 + lane;
      uint32_t dead = 0;
      if (w < words) {
        dead = ~alive[w];
        const int tail = n - w * 32;
        if (tail < 32) dead &= (1u << tail) - 1u;
      }
      const int c = __popc(dead);
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      int rank = found + incl - c;
      while (dead && rank < need) {
        const int bit = __ffs(dead) - 1;
        dead &= dead - 1;
        out_s[cnt + rank] = -__int_as_float(0x7f800000);
        out_i[cnt + rank] = w * 32 + bit;
        ++rank;
      }
      found += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

template <typename T>
int launch(const void* logit, int B, int H, int W, int K, float thr,
           void* scores, void* idx, void* stream) {
  const size_t bytes = smem_bytes(H * W);
  cudaError_t err = cudaFuncSetAttribute(
      nms_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  nms_topk_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)logit, H, W, K, thr, (float*)scores, (int*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long abcnet_nms_topk_smem_bytes(int H, int W) {
  return (long long)smem_bytes(H * W);
}

extern "C" int abcnet_nms_topk_bf16(const void* logit, int B, int H, int W,
                                    int K, float thr, void* scores,
                                    void* idx, void* stream) {
  return launch<__nv_bfloat16>(logit, B, H, W, K, thr, scores, idx, stream);
}

extern "C" int abcnet_nms_topk_f32(const void* logit, int B, int H, int W,
                                   int K, float thr, void* scores, void* idx,
                                   void* stream) {
  return launch<float>(logit, B, H, W, K, thr, scores, idx, stream);
}
