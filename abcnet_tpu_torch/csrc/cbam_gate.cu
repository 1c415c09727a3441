// CBAM gate in eval mode at one site of models/unet_cbam.py:DoubleConvCBAM:
// out = relu(sa * (ca * y) + res), three kernels launched by one call.
//
// No Pallas kernel stands behind this one. The JAX package gets the gate
// from XLA's fusions of abcnet_tpu/models/unet_cbam.py (ChannelAttention,
// SpatialAttention, CBAM, the residual add and relu). Written as PyTorch
// ops the port ran some fifteen stock kernels a site (mean, amax, the
// shared MLP's linears, relu, add, sigmoid, mul; mean, amax, cat, a cuDNN
// 7x7 conv and its bias add, sigmoid, mul; the residual add, relu), about
// thirteen tensor-sized trips through device memory.
//
// Bound: memory. The channel gate needs every pixel of an image before any
// output exists, so the least a site moves is y read twice, res read once
// and out written once (benchmark/counts_cbam.py:gate_bytes counts these
// four passes). The arithmetic is a few f32 operations an element, and 98
// multiply-adds a pixel for the 7x7 conv over the two-channel map.
//
//   (1) pool: grid (P chunks of an image's pixels, B images), one wave of
//       the blocks the card holds at once where the batch allows (a
//       second, part-filled wave would double the time). A thread owns
//       one 16-byte vector of channels and a stride of its chunk's pixels;
//       the block's rows merge in shared memory into f32 partial sums and
//       maxima a channel, written to scratch `part` [B][P][2][C].
//   (2) mlp: one block an image. Merges the P partials in order into the
//       spatial mean and max, runs the shared MLP (C -> C/16 -> relu -> C)
//       on both, adds them and writes ca = sigmoid(sum) [B][C] as f32.
//   (3) gate: one block a TH x TW tile of one image and its 3-pixel halo.
//       Phase 1 reads y over the tile and the halo, forms x = ca * y and
//       reduces it over C to the channel mean and max in shared memory
//       (zero outside the image: the conv's padding). Phase 2 runs the 7x7
//       conv and the sigmoid over the map for the tile's pixels: sa.
//       Phase 3 reads y and res again and writes relu(sa * ca * y + res).
//       The halo is the neighbouring tiles' pixels, which blocks of nearby
//       index read at about the same time, and phase 3 reads what phase 1
//       just read, so both come mostly from L2 and HBM sees y about once
//       here. (Keeping the tile's ca * y in shared memory for phase 3
//       measured slower at every site: fewer blocks an SM.)
// Loads are 16 bytes a thread along C, neighbouring lanes on neighbouring
// vectors; res is read and out written with the streaming hints, so that
// they do not push the halos out of L2.
//
// Roundings: those of the stock chain, which stores a value of y's type T
// after every op. Each is emulated in registers: the pooled mean (the f32
// sum times fl(1/N), ATen's mean) and max, each MLP layer's output (f32
// sum plus the bias, once), relu, their sum, ca = 1 / (1 + expf(-s));
// ca * y; the channel mean and max; the conv's output, then its bias added
// (ATen adds a cuDNN conv's bias in a pass of its own); sa; sa * x; the
// sum with res; relu. Products of two T values are exact in f32, sums are
// f32 as the chain's, in another order. So the output equals the chain's
// up to summation order. Weights are the f32 masters, rounded to T here as
// the chain's .to(dtype) rounds them.
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// type as an int (1: bf16, 0: f32), the return value cudaGetLastError()
// after the launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kK = 7;        // the spatial gate's kernel side
constexpr int kHalo = kK / 2;
constexpr int kTaps = kK * kK;

// v rounded to T (to nearest even) and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The larger of a and b, NaN if either is (ATen's amax propagates NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float relu_nan(float v) {
  return v > 0.f || v != v ? v : 0.f;
}

// ATen's sigmoid for float and reduced types: 1 / (1 + exp(-v)) in f32.
__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// One 16-byte vector: kVec values of T.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4& w, float* v) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& w, float* v) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(u[k] << 16);
      v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
  // The values are already of T, so the conversion is exact.
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      u[k] = (__float_as_uint(v[2 * k]) >> 16) |
             (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// ---------------------------------------------------------------------------
// (1) pool
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_kernel(const T* __restrict__ y, float* __restrict__ part, int hw,
                int C, int chunk) {
  constexpr int V = Vec<T>::kVec;
  __shared__ float red[2][kThreads * 8];
  const int cv = C / V;
  const int rows = kThreads / cv;
  const int t = threadIdx.x, j = t % cv, r = t / cv;
  const int b = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int begin = p * chunk, end = min(begin + chunk, hw);
  float s[V], m[V], v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = 0.f;
    m[k] = -CUDART_INF_F;
  }
  if (r < rows) {
    const T* base = y + (long long)b * hw * C + j * V;
    for (int q = begin + r; q < end; q += kUnroll * rows) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q + u * rows < end)
          raw[u] = *reinterpret_cast<const uint4*>(
              base + (long long)(q + u * rows) * C);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q + u * rows >= end) break;
        Vec<T>::unpack(raw[u], v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += v[k];
          m[k] = max_nan(m[k], v[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][r * C + j * V + k] = s[k];
      red[1][r * C + j * V + k] = m[k];
    }
  }
  __syncthreads();
  float* out = part + ((long long)b * P + p) * 2 * C;
  for (int c = t; c < C; c += kThreads) {
    float sum = 0.f, mx = -CUDART_INF_F;
    for (int i = 0; i < rows; ++i) {
      sum += red[0][i * C + c];
      mx = max_nan(mx, red[1][i * C + c]);
    }
    out[c] = sum;
    out[C + c] = mx;
  }
}

// ---------------------------------------------------------------------------
// (2) mlp
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_kernel(const float* __restrict__ part, int P, int C, int mid,
               float inv_hw, const float* __restrict__ w0,
               const float* __restrict__ b0, const float* __restrict__ w1,
               const float* __restrict__ b1, float* __restrict__ ca) {
  extern __shared__ float sm[];
  float* v = sm;            // [2][C]: the pooled mean, then the max
  float* h = sm + 2 * C;    // [2][mid]: the hidden layer of each
  const int t = threadIdx.x, b = blockIdx.x;
  const float* pb = part + (long long)b * P * 2 * C;
  for (int c = t; c < C; c += kThreads) {
    float sum = 0.f, mx = -CUDART_INF_F;
    for (int p = 0; p < P; ++p) {
      sum += pb[(long long)p * 2 * C + c];
      mx = max_nan(mx, pb[(long long)p * 2 * C + C + c]);
    }
    v[c] = round_to<T>(sum * inv_hw);
    v[C + c] = mx;
  }
  __syncthreads();
  // Layer 0, a warp a hidden unit: both vectors at once, so each weight
  // is read once.
  const int warp = t / 32, lane = t % 32;
  for (int jj = warp; jj < mid; jj += kThreads / 32) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      const float w = round_to<T>(w0[(long long)jj * C + c]);
      acc0 = fmaf(w, v[c], acc0);
      acc1 = fmaf(w, v[C + c], acc1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
      acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
    }
    if (lane == 0) {
      const float bias = round_to<T>(b0[jj]);
      h[jj] = relu_nan(round_to<T>(acc0 + bias));
      h[mid + jj] = relu_nan(round_to<T>(acc1 + bias));
    }
  }
  __syncthreads();
  // Layer 1, a thread a channel, both vectors at once.
  for (int c = t; c < C; c += kThreads) {
    const float* wr = w1 + (long long)c * mid;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
    for (int jj = 0; jj < mid; ++jj) {
      const float w = round_to<T>(wr[jj]);
      acc0 = fmaf(w, h[jj], acc0);
      acc1 = fmaf(w, h[mid + jj], acc1);
    }
    const float bias = round_to<T>(b1[c]);
    const float o = round_to<T>(round_to<T>(acc0 + bias) +
                                round_to<T>(acc1 + bias));
    ca[(long long)b * C + c] = round_to<T>(sigmoid(o));
  }
}

// ---------------------------------------------------------------------------
// (3) gate
// ---------------------------------------------------------------------------

struct GateArgs {
  int H, W, C, th, tw, tiles_x, tiles_per_image, group;
  float inv_c;
};

// Shared memory of a gate block, f32: ca [C], the conv's 98 weights and
// bias (padded to 100), the mean and max maps [(th+6) * (tw+6)] and sa
// [th * tw].
inline size_t gate_smem_bytes(const GateArgs& a) {
  const size_t ext = (size_t)(a.th + 2 * kHalo) * (a.tw + 2 * kHalo);
  return sizeof(float) * (a.C + 100 + 2 * ext + (size_t)a.th * a.tw);
}

// NV: the vectors of a pixel that one lane of its group takes (cv <=
// group * NV). A thread holds kUnroll * NV raw vectors in flight.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    gate_kernel(const T* __restrict__ y, const T* __restrict__ res,
                T* __restrict__ out, const float* __restrict__ ca,
                const float* __restrict__ wsp, const float* __restrict__ bsp,
                GateArgs a) {
  constexpr int V = Vec<T>::kVec;
  extern __shared__ float sg[];
  const int eh = a.th + 2 * kHalo, ew = a.tw + 2 * kHalo;
  const int ext = eh * ew, own = a.th * a.tw;
  float* ca_s = sg;
  float* wt = ca_s + a.C;
  float* smean = wt + 100;
  float* smax = smean + ext;
  float* sa = smax + ext;

  const int t = threadIdx.x;
  const int b = blockIdx.x / a.tiles_per_image;
  const int ti = blockIdx.x % a.tiles_per_image;
  const int y0 = ti / a.tiles_x * a.th, x0 = ti % a.tiles_x * a.tw;
  const int C = a.C, cv = C / V;
  for (int c = t; c < C; c += kThreads) ca_s[c] = ca[(long long)b * C + c];
  for (int i = t; i <= 2 * kTaps; i += kThreads)
    wt[i] = round_to<T>(i < 2 * kTaps ? wsp[i] : bsp[0]);
  __syncthreads();

  const int group = a.group, lane = t % group, gid = t / group;
  const int groups = kThreads / group;
  const long long img = (long long)b * a.H * a.W;

  // Phase 1: the channel mean and max of x = ca * y over the tile and its
  // halo. Every thread runs the same trip count, so the group's shuffles
  // see all its lanes.
  for (int q0 = 0; q0 < ext; q0 += groups * kUnroll) {
    uint4 raw[kUnroll][NV];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * groups + gid;
      const int gy = y0 - kHalo + q / ew, gx = x0 - kHalo + q % ew;
      in[u] = q < ext && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const T* px = y + (img + (long long)gy * a.W + gx) * C;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int jv = lane + n * group;
        if (in[u] && jv < cv)
          raw[u][n] = *reinterpret_cast<const uint4*>(px + jv * V);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * groups + gid;
      float s = 0.f, m = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int jv = lane + n * group;
        if (!in[u] || jv >= cv) continue;
        float v[V];
        Vec<T>::unpack(raw[u][n], v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float x = round_to<T>(ca_s[jv * V + k] * v[k]);
          s += x;
          m = max_nan(m, x);
        }
      }
      for (int off = group / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (lane == 0 && q < ext) {
        smean[q] = in[u] ? round_to<T>(s * a.inv_c) : 0.f;
        smax[q] = in[u] ? m : 0.f;
      }
    }
  }
  __syncthreads();

  // Phase 2: sa = sigmoid(conv7x7([mean, max]) + bias) at the tile's
  // pixels, the conv's output and the biased output each rounded to T.
  // (Blocking a thread's outputs to reuse map values in registers measured
  // slower: it takes registers that the loads in flight need.)
  for (int p = t; p < own; p += kThreads) {
    const int ty = p / a.tw, tx = p % a.tw;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < kK; ++dy) {
      const float* rm = smean + (ty + dy) * ew + tx;
      const float* rx = smax + (ty + dy) * ew + tx;
#pragma unroll
      for (int dx = 0; dx < kK; ++dx) {
        acc = fmaf(wt[dy * kK + dx], rm[dx], acc);
        acc = fmaf(wt[kTaps + dy * kK + dx], rx[dx], acc);
      }
    }
    const float pre = round_to<T>(round_to<T>(acc) + wt[2 * kTaps]);
    sa[p] = round_to<T>(sigmoid(pre));
  }
  __syncthreads();

  // Phase 3: out = relu(sa * x + res) at the tile's pixels, y read again
  // (the tile was read in phase 1, so mostly from L1 and L2).
  for (int q0 = 0; q0 < own; q0 += groups * kUnroll) {
    uint4 ry[kUnroll][NV], rr[kUnroll][NV];
    long long at[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * groups + gid;
      const int gy = y0 + q / a.tw, gx = x0 + q % a.tw;
      in[u] = q < own && gy < a.H && gx < a.W;
      at[u] = (img + (long long)gy * a.W + gx) * C;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int jv = lane + n * group;
        if (in[u] && jv < cv) {
          ry[u][n] = *reinterpret_cast<const uint4*>(y + at[u] + jv * V);
          rr[u][n] = __ldcs(reinterpret_cast<const uint4*>(res + at[u] +
                                                           jv * V));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float g = sa[min(q0 + u * groups + gid, own - 1)];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int jv = lane + n * group;
        if (!in[u] || jv >= cv) continue;
        float x[V], r[V];
        Vec<T>::unpack(ry[u][n], x);
        Vec<T>::unpack(rr[u][n], r);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float cx = round_to<T>(ca_s[jv * V + k] * x[k]);
          x[k] = relu_nan(round_to<T>(round_to<T>(g * cx) + r[k]));
        }
        __stcs(reinterpret_cast<uint4*>(out + at[u] + jv * V),
               Vec<T>::pack(x));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename T, int NV>
int gate_launch(const void* y, const void* res, void* out, const float* ca,
                const float* wsp, const float* bsp, const GateArgs& a,
                int tiles, cudaStream_t s) {
  auto kernel = gate_kernel<T, NV>;
  const size_t smem = gate_smem_bytes(a);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<tiles, kThreads, smem, s>>>((const T*)y, (const T*)res, (T*)out,
                                       ca, wsp, bsp, a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* y, const void* res, void* out, int B, int H, int W,
        int C, const float* w0, const float* b0, const float* w1,
        const float* b1, int mid, const float* wsp, const float* bsp,
        float* part, int P, int chunk, float* ca, int th, int tw, int group,
        int nv, float inv_hw, float inv_c, cudaStream_t s) {
  const int hw = H * W;
  pool_kernel<T><<<dim3(P, B), kThreads, 0, s>>>((const T*)y, part, hw, C,
                                                  chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_kernel<T><<<B, kThreads, sizeof(float) * (2 * C + 2 * mid), s>>>(
      part, P, C, mid, inv_hw, w0, b0, w1, b1, ca);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  GateArgs a;
  a.H = H;
  a.W = W;
  a.C = C;
  a.th = th;
  a.tw = tw;
  a.tiles_x = (W + tw - 1) / tw;
  a.tiles_per_image = a.tiles_x * ((H + th - 1) / th);
  a.group = group;
  a.inv_c = inv_c;
  const int tiles = B * a.tiles_per_image;
  switch (nv) {
    case 1: return gate_launch<T, 1>(y, res, out, ca, wsp, bsp, a, tiles, s);
    case 2: return gate_launch<T, 2>(y, res, out, ca, wsp, bsp, a, tiles, s);
    case 4: return gate_launch<T, 4>(y, res, out, ca, wsp, bsp, a, tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out = relu(sa * (ca * y) + res) for channels_last y, res and out of B x C
// x H x W values of one type (bf16 = 1: bf16, 0: f32), C a multiple of the
// 16-byte vector, every pointer 16-byte aligned (ops/cbam_gate.py checks
// all of it). w0 [mid][C], b0 [mid], w1 [C][mid], b1 [C]: the shared MLP's
// f32 weights; wsp [2][7][7], bsp [1]: the spatial conv's. part: scratch of
// B * P * 2 * C floats (P chunks of `chunk` pixels an image), ca: of B * C.
// The gate's blocks take th x tw tiles and give each pixel `group` lanes (a
// power of two <= 32) of nv (1, 2 or 4) vectors each. inv_hw and inv_c:
// ATen's factors of the spatial and the channel mean.
extern "C" int abcnet_cbam_gate_eval(
    const void* y, const void* res, void* out, int bf16, int B, int H, int W,
    int C, const void* w0, const void* b0, const void* w1, const void* b1,
    int mid, const void* wsp, const void* bsp, void* part, int P, int chunk,
    void* ca, int th, int tw, int group, int nv, float inv_hw, float inv_c,
    void* stream) {
  auto fn = bf16 ? run<__nv_bfloat16> : run<float>;
  return fn(y, res, out, B, H, W, C, (const float*)w0, (const float*)b0,
            (const float*)w1, (const float*)b1, mid, (const float*)wsp,
            (const float*)bsp, (float*)part, P, chunk, (float*)ca, th, tw,
            group, nv, inv_hw, inv_c, (cudaStream_t)stream);
}

// The pooling kernel's blocks that the current device holds at once, all
// SMs together (bf16 = 1: the bf16 kernel, 0: the f32 one): the wrapper
// splits an image into at most this many over the batch. A negative value
// is a CUDA error.
extern "C" int abcnet_cbam_gate_pool_resident(int bf16) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm, pool_kernel<__nv_bfloat16>, kThreads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm, pool_kernel<float>, kThreads, 0);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}
