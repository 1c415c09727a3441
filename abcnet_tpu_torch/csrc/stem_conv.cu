// The CBAM U-Net's stem sites in eval mode: a 5x5 conv with padding 2 to 32
// channels, then the eval BatchNorm and the activation, as one call a site:
//
//   y = act(bn_eval(round_bf16(round_bf16(conv_f32(x, w)) + conv_bias)))
//
// in bf16, channels_last (NHWC), one call for models/unet_cbam.py's sites
// inc1.0 (1 -> 32 channels), inc1.1, inc2.0 and inc2.1 (32 -> 32) at 512².
//
// No Pallas kernel stands behind this one: the JAX package gets the conv
// from XLA and fuses the bias, BatchNorm and activation after it
// (abcnet_tpu/models/unet_cbam.py, abcnet_tpu/models/unet.py:40-48). The
// port ran cuDNN's conv (an sm80 mma.sync implicit GEMM for these shapes)
// and then bn_act.cu's eval kernel (e), which reads and writes the conv's
// output once more.
//
// Bound (batch 64, 512², bf16; input read once, output written once): a
// 32 -> 32 site is 859.0 GFLOP against 2.147 GB, 400 FLOP a byte, just
// above the card's ridge (989 TFLOP/s over 3.35 TB/s, 295): 0.869 ms of
// tensor-core time. The 1 -> 32 site is 26.8 GFLOP against 1.107 GB:
// 0.331 ms of bytes.
//
// wide_kernel (32 input channels): the implicit GEMM on wgmma.
//   * M = 64 output pixels of one row, N = 32 output channels, K = 25 taps
//     x 32 input channels, as m64n32k16 wgmma with A from registers. (N is
//     fixed by the channels. Alone on an H100, that instruction runs at
//     about 80% of the bf16 peak from registers and 66% with A in shared
//     memory, against about 99% from N = 64 up.)
//   * The weights, 25 taps x 32 x 32 bf16 (51,200 bytes), live in shared
//     memory for the whole kernel in wgmma's K-major layout without
//     swizzle (8 x 16-byte core matrices), loaded once a block. Output
//     channels are stored in a permuted column order (swap_fields) so that
//     a lane's accumulators hold 8 consecutive channels of a pixel: the
//     epilogue stores 16 bytes a lane, a warp 512 contiguous bytes.
//   * A persistent block a SM runs kWG = 3 independent warpgroups (three
//     instruction streams keep the tensor cores fed while one of them
//     loads, waits or stores). Each takes segments (64 columns x
//     kSegmentRows = 32 rows of one image) from a counter in device memory
//     and walks a segment kStepRows = 4 output rows a step. Its input rows sit in a ring of 12
//     halo rows (68 pixels x 64 bytes each, stored as four 8-channel planes
//     so that 8 neighbouring pixels are 128 contiguous bytes); a step loads
//     the 4 rows the next step adds by cp.async (zero-filled outside the
//     image: the conv's padding) while it computes, so an input row crosses
//     to the SM once a segment.
//   * A step loads each A fragment (one halo row, one column shift dx, 16
//     channels) once by ldmatrix, at row addresses shifted by dx (the
//     im2col costs nothing), and issues it against the up to five output
//     rows it feeds (dy = 0..4), each its own accumulator: 8 rows x 10
//     fragments a step for 200 wgmma. Fragments go 5 at a time into one of
//     two register buffers, one wgmma fence and one commit group each
//     (fewer fences measured faster; 10 at a time runs out of registers
//     and ptxas serializes the wgmma).
//   * The epilogue runs from the accumulators: the conv's sum rounded to
//     bf16 (the conv's output), plus the bias rounded to bf16 (ATen's
//     add_ of a cuDNN conv's bias), then bn_act.cu's eval arithmetic:
//     scale = gamma * rsqrt(var + eps), shift = fma(-(mean * gamma),
//     rsqrt(var + eps), beta), fma(x, scale, shift), the activation, bf16.
// narrow_kernel (1 input channel): K is only 25, so the tensor cores do
// little and the site is bound by its output bytes. One block a 32 x 128
// tile of one image; its halo (36 x 132 values) in shared memory; each
// warp runs 4 of its rows as m16n8k16 mma.sync with the 25 taps as K
// (padded to 32 with zero weights) and the weights held in registers, then
// the same epilogue.
//
// Roundings: those of the chain (cuDNN's conv in bf16 with f32
// accumulation, then kernel (e)), except the order in which the f32
// accumulator sums the conv's products.
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// return value cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 32;                     // output channels; wide input
constexpr int kK = 5;                      // kernel side
constexpr int kPad = 2;
constexpr int kTaps = kK * kK;
constexpr int kTileW = 64;                 // a step's pixels of a row: M
constexpr int kHaloW = kTileW + kK - 1;    // 68
constexpr int kChunks = kHaloW * 4;        // 16-byte chunks of a halo row
constexpr int kPlaneBytes = kHaloW * 16;   // one 8-channel plane of a row
constexpr int kRowBytes = 4 * kPlaneBytes; // 4352
constexpr int kTapBytes = kC * kC * 2;     // B of one tap: 2048
constexpr int kWeightBytes = kTaps * kTapBytes;  // 51,200
// The wide kernel's shape (the best of those measured on an H100): a
// segment is kSegmentRows output rows (all of a shorter image, rounded up
// to whole steps); a step computes kStepRows of them from a ring of
// kRingRows input rows; a block runs kWG warpgroups; an input row's 10 A
// fragments go kFragsAFence at a time into one of kABuffers register
// buffers.
constexpr int kSegmentRows = 32;
constexpr int kStepRows = 4;
constexpr int kRingRows = 2 * kStepRows + 4;
constexpr int kWG = 3;
constexpr int kFragsAFence = 5;
constexpr int kABuffers = 2;
constexpr int kWideSmem = kWeightBytes + kWG * kRingRows * kRowBytes;
enum Act { kNone = 0, kRelu = 1 };

// The column of wgmma's N (and of mma.sync's) that holds channel c, and
// the channel column n holds (the map is its own inverse): c = 8t + 2j + e
// sits at n = 8j + 2t + e, so that lane t's accumulators of a pixel, at
// columns 8j + 2t + e, hold channels 8t .. 8t + 7.
__host__ __device__ constexpr int swap_fields(int c) {
  return 8 * ((c & 7) >> 1) + 2 * (c >> 3) + (c & 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int ACT>
__device__ __forceinline__ float act_fwd(float p) {
  if constexpr (ACT == kRelu) return p <= 0.f ? 0.f : p;   // NaN passes
  return p;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The eval BatchNorm's terms of a lane's 8 channels.
struct Epi {
  float cb[8], scale[8], shift[8];
};

__device__ __forceinline__ void load_epi(Epi& e, int c0,
                                         const bf16* __restrict__ cb,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         float eps) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = c0 + k;
    const float invstd = rsqrtf(__fadd_rn(var[c], eps));
    e.cb[k] = __bfloat162float(cb[c]);
    e.scale[k] = __fmul_rn(gamma[c], invstd);
    e.shift[k] = __fmaf_rn(-__fmul_rn(mean[c], gamma[c]), invstd, beta[c]);
  }
}

// The 8 conv sums of a pixel's channels 8t .. 8t + 7 through the
// epilogue, stored as 16 bytes at dst.
template <int ACT>
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8],
                                       const Epi& e) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * k + h;
      const float x = round_bf16(__fadd_rn(round_bf16(v[c]), e.cb[c]));
      o[h] = act_fwd<ACT>(__fmaf_rn(x, e.scale[c], e.shift[c]));
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(o[0], o[1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` over the 128 threads of one warpgroup.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// wgmma fences and waits.
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor without swizzle: start address, the
// byte distance between core matrices along K (leading) and along M or N
// (stride), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32);
}

// d (64 x 32 f32, the warpgroup's fragment) += a (64 x 16 bf16 in
// registers) * B (16 x 32 bf16 in shared memory); scale_d = 0 overwrites.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// ---------------------------------------------------------------------------
// wide_kernel: 32 -> 32 channels on wgmma
// ---------------------------------------------------------------------------

// Input rows u0 .. u0 + count - 1 of a segment (row u is image row y0 - 2 +
// u) into ring slot u % NR, pixel p of a row at plane g, byte p * 16.
template <int NR>
__device__ __forceinline__ void load_rows(uint32_t ring,
                                          const bf16* __restrict__ x, int n,
                                          int H, int W, int y0, int x0,
                                          int u0, int count, int lane128) {
  for (int i = lane128; i < count * kChunks; i += 128) {
    const int rr = i / kChunks;
    const int rem = i - rr * kChunks;
    const int p = rem >> 2, g = rem & 3;
    const int u = u0 + rr;
    const int yin = y0 - kPad + u, xin = x0 - kPad + p;
    const bool ok = (unsigned)yin < (unsigned)H && (unsigned)xin < (unsigned)W;
    const bf16* src =
        ok ? x + ((((size_t)n * H + yin) * W + xin) * kC + g * 8) : x;
    cp_async16(ring + (u % NR) * kRowBytes + g * kPlaneBytes + p * 16, src,
               ok);
  }
}

// One step: acc[r] = the conv sums of output rows r = 0..R-1 of the step
// (input rows u = r .. r + 4 of the ring from slot s0 on), for this
// warpgroup's 64 pixels. An input row's 10 A fragments (dx = 0..4 x two
// 16-channel halves) go F at a time into one of NBG register buffers, one
// wgmma fence and one commit group a buffer.
__device__ __forceinline__ void mma_step(float (&acc)[kStepRows][16],
                                         uint32_t ring, int s0,
                                         uint32_t lane_off, uint64_t desc0) {
  constexpr int R = kStepRows, NR = kRingRows, F = kFragsAFence,
                NBG = kABuffers;
  constexpr int kFrags = 2 * kK;
  static_assert(kFrags % F == 0, "F must divide an input row's fragments");
  uint32_t a[NBG][F][4];
#pragma unroll
  for (int r = 0; r < R; ++r) fence_acc(acc[r]);
#pragma unroll
  for (int u = 0; u < R + 4; ++u) {
    int slot = s0 + u;
    if (slot >= NR) slot -= NR;
    const uint32_t row = ring + slot * kRowBytes + lane_off;
#pragma unroll
    for (int f0 = 0; f0 < kFrags; f0 += F) {
      const int s = (u * kFrags + f0) / F;
      const int b = s % NBG;
      if (s >= NBG) wgmma_wait<NBG - 1>();
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int dx = (f0 + f) >> 1, kc = (f0 + f) & 1;
        ldmatrix_x4(a[b][f], row + kc * 2 * kPlaneBytes + dx * 16);
      }
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int dx = (f0 + f) >> 1, kc = (f0 + f) & 1;
#pragma unroll
        for (int dy = 0; dy < kK; ++dy) {
          const int r = u - dy;
          if (r >= 0 && r < R)
            wgmma_m64n32k16(
                acc[r], a[b][f],
                desc0 + (((dy * kK + dx) * kTapBytes + kc * 1024) >> 4),
                (dy | dx | kc) != 0);
        }
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < R; ++r) fence_acc(acc[r]);
}

template <int ACT>
__global__ void __launch_bounds__(kWG * 128, 1)
    wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ cb, const float* __restrict__ mean,
                const float* __restrict__ var,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, float eps,
                bf16* __restrict__ y, int N, int H, int W, int S,
                int* __restrict__ next) {
  constexpr int R = kStepRows, NR = kRingRows, WG = kWG;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int seg_of[WG];
  // cb, scale, shift of each channel: read by the epilogue, so that they
  // hold no registers during the MMAs (in registers the kernel spills)
  __shared__ __align__(16) float epi_tab[3][kC];
  const int tid = threadIdx.x;
  const int wg = tid >> 7, lane128 = tid & 127;
  const int warp = lane128 >> 5, lane = tid & 31;

  // The weights as B: tap t, 8-channel group k / 8 of the input, column
  // n of the output; core matrices of 8 columns x 8 inputs (16 bytes a
  // column), 128 bytes apart along N and 512 along K.
  for (int i = tid; i < kTaps * kC * kC; i += WG * 128) {
    const int tap = i % kTaps, ci = (i / kTaps) % kC, co = i / (kTaps * kC);
    *reinterpret_cast<bf16*>(smem + tap * kTapBytes + (ci >> 3) * 512 +
                             swap_fields(co) * 16 + (ci & 7) * 2) = w[i];
  }
  if (tid < kC) {
    const float invstd = rsqrtf(__fadd_rn(var[tid], eps));
    epi_tab[0][tid] = __bfloat162float(cb[tid]);
    epi_tab[1][tid] = __fmul_rn(gamma[tid], invstd);
    epi_tab[2][tid] =
        __fmaf_rn(-__fmul_rn(mean[tid], gamma[tid]), invstd, beta[tid]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t ring = smem_u32(smem + kWeightBytes + wg * NR * kRowBytes);
  const uint32_t lane_off =
      (lane >> 4) * kPlaneBytes + (warp * 16 + (lane & 15)) * 16;
  const uint64_t desc0 = make_desc(smem_u32(smem), 512, 128);
  const int ncx = (W + kTileW - 1) / kTileW;
  const int nsy = (H + S - 1) / S;
  const int nseg = N * nsy * ncx;
  float acc[kStepRows][16];

  for (;;) {
    if (lane128 == 0) seg_of[wg] = atomicAdd(next, 1);
    wg_sync(1 + wg);
    const int seg = seg_of[wg];
    if (seg >= nseg) break;
    const int cx = seg % ncx, rest = seg / ncx;
    const int n = rest / nsy, y0 = (rest % nsy) * S, x0 = cx * kTileW;
    const int steps = (min(S, H - y0) + R - 1) / R;
    load_rows<NR>(ring, x, n, H, W, y0, x0, 0, R + 4, lane128);
    cp_async_commit();
    for (int q = 0; q < steps; ++q) {
      if (q + 1 < steps) {
        load_rows<NR>(ring, x, n, H, W, y0, x0, q * R + R + 4, R, lane128);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      wg_sync(1 + wg);
      mma_step(acc, ring, (q * R) % NR, lane_off, desc0);
      // every lane's reads of the ring are done before the next step's
      // loads reuse the slots of this step's first R rows
      wg_sync(1 + wg);
      Epi epi;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        epi.cb[k] = epi_tab[0][8 * (lane & 3) + k];
        epi.scale[k] = epi_tab[1][8 * (lane & 3) + k];
        epi.shift[k] = epi_tab[2][8 * (lane & 3) + k];
      }
      const int xx0 = x0 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int yy = y0 + q * R + r;
        if (yy >= H) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = xx0 + 8 * h;
          if (xx >= W) continue;
          const float v[8] = {acc[r][2 * h], acc[r][2 * h + 1],
                              acc[r][4 + 2 * h], acc[r][5 + 2 * h],
                              acc[r][8 + 2 * h], acc[r][9 + 2 * h],
                              acc[r][12 + 2 * h], acc[r][13 + 2 * h]};
          store8<ACT>(y + (((size_t)n * H + yy) * W + xx) * kC +
                          8 * (lane & 3),
                      v, epi);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// narrow_kernel: 1 -> 32 channels on mma.sync
// ---------------------------------------------------------------------------

constexpr int kNarrowRows = 32;            // a block: 8 warps, 4 rows each
constexpr int kNarrowW = 128;
constexpr int kNarrowHS = kNarrowW + kK - 1;

template <int ACT>
__global__ void __launch_bounds__(256)
    narrow_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const bf16* __restrict__ cb, const float* __restrict__ mean,
                  const float* __restrict__ var,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, float eps,
                  bf16* __restrict__ y, int N, int H, int W) {
  constexpr int kHR = kNarrowRows + kK - 1;
  __shared__ bf16 halo[kHR * kNarrowHS + 1];   // the last one is 0
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntx = (W + kNarrowW - 1) / kNarrowW;
  const int nty = (H + kNarrowRows - 1) / kNarrowRows;
  int b = blockIdx.x;
  const int tx = b % ntx;
  b /= ntx;
  const int y0 = (b % nty) * kNarrowRows, n = b / nty;
  const int x0 = tx * kNarrowW;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i <= kHR * kNarrowHS; i += 256) {
    const int r = i / kNarrowHS, c = i - r * kNarrowHS;
    const int yin = y0 - kPad + r, xin = x0 - kPad + c;
    const bool ok = i < kHR * kNarrowHS && (unsigned)yin < (unsigned)H &&
                    (unsigned)xin < (unsigned)W;
    halo[i] = ok ? x[((size_t)n * H + yin) * W + xin] : zero;
  }
  // B fragments: K = the 25 taps (16 a chunk, zero past 25), N column
  // 8j + g = channel swap_fields(8j + g).
  uint32_t bw[2][4][2];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = swap_fields(8 * j + g);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * kc + 2 * t + 8 * h;
        bw[kc][j][h] = pack2(k < kTaps ? w[co * kTaps + k] : zero,
                             k + 1 < kTaps ? w[co * kTaps + k + 1] : zero);
      }
    }
  // a lane's taps: 2t, 2t + 1, 2t + 8, 2t + 9 of each chunk, as offsets
  // into the halo (-1: past the 25th, read as 0)
  int off[2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * kc + 2 * t + (e & 1) + 8 * (e >> 1);
      off[kc][e] = k < kTaps ? (k / kK) * kNarrowHS + k % kK : -1;
    }
  Epi epi;
  load_epi(epi, 8 * t, cb, mean, var, gamma, beta, eps);
  __syncthreads();
  const bf16* zp = halo + kHR * kNarrowHS;
#pragma unroll 1
  for (int row = warp; row < kNarrowRows; row += 8) {
    const int yy = y0 + row;
    if (yy >= H) return;
#pragma unroll 1
    for (int xs = 0; xs < kNarrowW && x0 + xs < W; xs += 16) {
      const bf16* hb = halo + row * kNarrowHS + xs;
      uint32_t a[2][4];
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
#pragma unroll
        for (int h = 0; h < 2; ++h)       // h: taps 2t.. or 2t + 8..
#pragma unroll
          for (int m = 0; m < 2; ++m) {   // m: pixel g or g + 8
            const int o0 = off[kc][2 * h], o1 = off[kc][2 * h + 1];
            const bf16* p = hb + g + 8 * m;
            a[kc][2 * h + m] =
                pack2(o0 < 0 ? *zp : p[o0], o1 < 0 ? *zp : p[o1]);
          }
      float c[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) c[j][k] = 0.f;
        mma_m16n8k16(c[j], a[0], bw[0][j]);
        mma_m16n8k16(c[j], a[1], bw[1][j]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int xx = x0 + xs + g + 8 * m;
        if (xx >= W) continue;
        const float v[8] = {c[0][2 * m], c[0][2 * m + 1], c[1][2 * m],
                            c[1][2 * m + 1], c[2][2 * m], c[2][2 * m + 1],
                            c[3][2 * m], c[3][2 * m + 1]};
        store8<ACT>(y + (((size_t)n * H + yy) * W + xx) * kC + 8 * t, v,
                    epi);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct Args {
  const bf16 *x, *w, *cb;
  const float *mean, *var, *gamma, *beta;
  float eps;
  bf16* y;
  int N, H, W;
  int* next;
  cudaStream_t s;
};

int launch_narrow(const Args& a, int act) {
  const long long blocks = (long long)a.N *
                           ((a.H + kNarrowRows - 1) / kNarrowRows) *
                           ((a.W + kNarrowW - 1) / kNarrowW);
  const auto kernel =
      act == kRelu ? narrow_kernel<kRelu> : narrow_kernel<kNone>;
  kernel<<<(unsigned)blocks, 256, 0, a.s>>>(a.x, a.w, a.cb, a.mean, a.var,
                                            a.gamma, a.beta, a.eps, a.y, a.N,
                                            a.H, a.W);
  return (int)cudaGetLastError();
}

int launch_wide(const Args& a, int act) {
  const auto kernel = act == kRelu ? wide_kernel<kRelu> : wide_kernel<kNone>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.next, 0, sizeof(int), a.s);
  if (err != cudaSuccess) return (int)err;
  const int steps = (a.H + kStepRows - 1) / kStepRows;
  const int S = kStepRows * (steps < kSegmentRows / kStepRows
                                 ? steps
                                 : kSegmentRows / kStepRows);
  const long long nseg = (long long)a.N * ((a.H + S - 1) / S) *
                         ((a.W + kTileW - 1) / kTileW);
  const long long blocks =
      nseg < (long long)sms * kWG ? (nseg + kWG - 1) / kWG : sms;
  kernel<<<(unsigned)blocks, kWG * 128, kWideSmem, a.s>>>(
      a.x, a.w, a.cb, a.mean, a.var, a.gamma, a.beta, a.eps, a.y, a.N, a.H,
      a.W, S, a.next);
  return (int)cudaGetLastError();
}

}  // namespace

// y = act(bn_eval(round(round(conv5x5(x, w)) + conv_bias))): x (N, H, W,
// c_in) bf16 with c_in 1 or 32, w (32, c_in, 5, 5) bf16, conv_bias 32
// bf16, mean, var, gamma, beta 32 f32 each, y (N, H, W, 32) bf16; act 0
// none, 1 relu. next: one int of device memory, the wide kernel's segment
// counter (set to 0 on the stream first).
extern "C" int abcnet_stem_conv_eval(const void* x, const void* w,
                                     const void* conv_bias, const void* mean,
                                     const void* var, const void* gamma,
                                     const void* beta, float eps, void* y,
                                     int N, int H, int W, int c_in, int act,
                                     void* next, void* stream) {
  if ((act != kNone && act != kRelu) || (c_in != 1 && c_in != kC))
    return (int)cudaErrorInvalidValue;
  const Args a{(const bf16*)x,     (const bf16*)w,    (const bf16*)conv_bias,
               (const float*)mean, (const float*)var, (const float*)gamma,
               (const float*)beta, eps,               (bf16*)y,
               N,                  H,                 W,
               (int*)next,        (cudaStream_t)stream};
  return c_in == 1 ? launch_narrow(a, act) : launch_wide(a, act);
}
