// int8 3x3 convolution of the serving backbone: quantize -> s8 x s8 -> s32
// -> dequantize, bias, activation, cast, in one pass.
//
// No Pallas kernel stands behind it. In the JAX package one conv site of
// the int8 backbone (abcnet_tpu/infer/quant.py:forward_quant, :195-217) is
// one XLA convolution, conv_general_dilated(..., preferred_element_type=
// int32), with the quantize before it and the dequantize after it fused by
// XLA. Stock PyTorch has no int8 convolution on CUDA, so the port ran an
// im2col, cuBLASLt's int8 GEMM and five elementwise passes around it
// (ops/conv_s8.py:conv3x3_s8_plain). This kernel is that chain as one
// implicit GEMM: M = the output pixels, N = the output channels, K = 9 taps
// x C_in.
//
// What it computes, for SAME padding and stride 1, NHWC in and out, one
// activation scale s a site and per-output-channel f32 vectors coef (the
// site's s times the weight scales) and bias:
//   xq  = clamp(rint(float(x) * inv), -127, 127)        int8, inv = 1/s
//   acc = sum over the 3x3 taps and C_in of xq * w      int32, exact
//   out = act(float(acc) * coef[o] + bias[o])           in out's type
// with the chain's roundings on the card: `x.float() / s` for a Python
// scalar s is ATen's div_true_kernel_cuda, which multiplies by a
// reciprocal the host computed, f32(1 / s) from the double s (measured on
// the card: for s = 0.0371 it is not 1.0f / f32(s); the wrapper passes the
// same reciprocal); the quantize rounds half to even in one saturating
// conversion (__float2int_rn) and clamps in integers, which for every
// finite input is the chain's rint, clamp and cast; every multiply and add
// is rounded on its own (__fmul_rn, __fadd_rn: the chain runs them as
// separate kernels, so no FMA); relu is clamp_min's max(y, 0) with NaN
// passed, leaky_relu ATen's y > 0 ? y : y * 0.01f; the cast rounds to
// nearest even.
//
// Bound: at batch 64 the 28 sites take 3.58 ms at the card's peaks (the
// larger of the bytes of x and out over 3.35 TB/s and of 2*M*N*K over the
// 1,979 int8 TOPS, site by site); the 512^2 and 256^2 sites are bound by
// their bytes, those from down4 to up2.0 by their operations.
//
// Design (simple first; wgmma and TMA are later work):
//   * A block of 256 threads (8 warps) computes a tile of TH output rows x
//     16 output columns of one image and BN output channels, the warps
//     split WM x WN, each warp MI rows (one m16 tile of 16 pixels each) x
//     NI n8 tiles.
//   * The K loop walks the input channels 32 at a time (one k-step of
//     mma.m16n8k32). For each chunk the block stages its input tile with
//     its one-pixel halo in shared memory, quantizing every bf16 (or f32)
//     value once as it stores it as int8 (zero padding is the int8 0, the
//     channels past C_in are 0), and the chunk's weights of all nine taps
//     for its BN channels, in the K-major layout pack_weights made
//     ((C_in/32, 9, C_out, 32) int8). Then each warp runs the nine taps:
//     a tap's A rows are the 16 pixels of an output row shifted by the
//     tap, read straight out of the halo tile, so no im2col is formed.
//   * The products run on the int8 tensor cores (mma.sync.aligned.
//     m16n8k32.row.col.s32.s8.s8.s32), accumulating in int32 registers;
//     ldmatrix brings their fragments out of shared memory, four 8x8 b16
//     matrices an instruction (an A fragment of 16 pixels x 32 channels,
//     or the B fragments of two n8 tiles).
//   * Shared memory rows are 32 bytes (one pixel's or one channel's 32
//     int8 values); their 16-byte halves are swapped where bit 2 of the
//     row index is set, so the eight rows an ldmatrix phase reads fall in
//     distinct banks.
//   * A block's loads and its products do not overlap; the blocks
//     resident beside it on the SM hide them (__launch_bounds__ asks for
//     three of the 16-channel shape, two of the others, which spill a
//     little to fit and are faster so than one).
//   * The tile shapes, by C_out (dispatch): 32 rows x 16 channels up to
//     16, 32 x 32 up to 32, 16 x 64 up to 64, else 8 rows x 128 channels
//     (one channel tile for the 128-channel sites, so each input tile is
//     quantized once). Each was the fastest of the shapes tried at the 28
//     sites of a batch of 64 on the card.
//   * The epilogue converts each accumulator (__int2float_rn: |acc|
//     reaches 4608 * 127^2, past 2^24), applies coef, bias, the activation
//     and the cast, and writes NHWC, two channels a store.
//   * Offsets into x and out are 64-bit (64 x 512^2 x 16 elements is
//     2^28, and the f32 head outputs double the bytes).
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 16;            // output columns a block: one m16 tile
constexpr int kHaloW = kTileW + 2;
constexpr int kChunk = 32;            // input channels a k-step
constexpr int kTaps = 9;

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

// Byte offset of byte c of 32-byte row p, the 16-byte halves swapped where
// bit 2 of p is set: eight consecutive rows read at one half hit the eight
// distinct 16-byte groups of the banks.
__device__ __forceinline__ int swz(int p, int c) {
  return p * kChunk + (c ^ (((p >> 2) & 1) << 4));
}

__device__ __forceinline__ uint32_t q8(float v, float inv) {
  const int i = __float2int_rn(__fmul_rn(v, inv));
  return (uint32_t)(min(max(i, -127), 127) & 0xFF);
}

__device__ __forceinline__ uint32_t pack4(const float* f, float inv) {
  return q8(f[0], inv) | (q8(f[1], inv) << 8) | (q8(f[2], inv) << 16) |
         (q8(f[3], inv) << 24);
}

template <typename T>
struct In;

template <>
struct In<__nv_bfloat16> {
  // Eight consecutive values from one 16-byte load; a bf16 widens to f32
  // by its bits, exactly.
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float* f) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct In<float> {
  static __device__ __forceinline__ void load8(const float* p, float* f) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    f[0] = __uint_as_float(a.x); f[1] = __uint_as_float(a.y);
    f[2] = __uint_as_float(a.z); f[3] = __uint_as_float(a.w);
    f[4] = __uint_as_float(b.x); f[5] = __uint_as_float(b.y);
    f[6] = __uint_as_float(b.z); f[7] = __uint_as_float(b.w);
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldg(p);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float epilogue(int acc, float coef, float bias,
                                          int act) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), coef), bias);
  if (act == kRelu) y = isnan(y) ? y : fmaxf(y, 0.f);
  else if (act == kLeakyRelu) y = y > 0.f ? y : __fmul_rn(y, 0.01f);
  return y;
}

struct Params {
  const void* x;
  const int8_t* w;
  const float* coef;
  const float* bias;
  void* out;
  int h, w_, cin, cout;
  int tiles_x, tiles_y, n_tiles;
  float inv;
  int act, out_bf16, vec;
};

template <typename TIn, int WM, int WN, int MI, int NI, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
conv3x3_s8_kernel(const Params prm) {
  static_assert(WM * WN * 32 == kThreads, "8 warps a block");
  constexpr int TH = WM * MI;                 // output rows a block
  constexpr int BN = WN * NI * 8;             // output channels a block
  constexpr int PIX = (TH + 2) * kHaloW;      // input pixels with the halo
  __shared__ __align__(16) int8_t xs[PIX * kChunk];
  __shared__ __align__(16) int8_t ws[kTaps * BN * kChunk];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const int H = prm.h, W = prm.w_, Cin = prm.cin, Cout = prm.cout;

  long long id = blockIdx.x;
  const int nt = (int)(id % prm.n_tiles);
  id /= prm.n_tiles;
  const int tx = (int)(id % prm.tiles_x);
  id /= prm.tiles_x;
  const int ty = (int)(id % prm.tiles_y);
  const long long b = id / prm.tiles_y;
  const int y0 = ty * TH, x0 = tx * kTileW, n0 = nt * BN;
  const TIn* xb = static_cast<const TIn*>(prm.x) + b * H * W * Cin;

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][ni][k] = 0;

  const int chunks = (Cin + kChunk - 1) / kChunk;
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();                  // the last chunk's reads are done
    // The input tile: 8 channels an item, quantized once, 8 bytes stored.
    for (int i = tid; i < PIX * 4; i += kThreads) {
      const int p = i >> 2, grp = i & 3;
      const int gy = y0 - 1 + p / kHaloW, gx = x0 - 1 + p % kHaloW;
      const int c0 = ch * kChunk + grp * 8;
      uint2 v = make_uint2(0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 < Cin) {
        const TIn* src = xb + ((long long)gy * W + gx) * Cin + c0;
        float f[8];
        if (prm.vec) {
          In<TIn>::load8(src, f);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            f[j] = c0 + j < Cin ? In<TIn>::load1(src + j) : 0.f;
        }
        v.x = pack4(f, prm.inv);
        v.y = pack4(f + 4, prm.inv);
      }
      *reinterpret_cast<uint2*>(xs + swz(p, grp * 8)) = v;
    }
    // The chunk's weights of the nine taps, 16 bytes an item.
    const int8_t* wc = prm.w + (long long)ch * kTaps * Cout * kChunk;
    for (int i = tid; i < kTaps * BN * 2; i += kThreads) {
      const int tap = i / (BN * 2), r = i % (BN * 2);
      const int n = r >> 1, half = r & 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < Cout)
        v = __ldg(reinterpret_cast<const uint4*>(
            wc + ((long long)tap * Cout + n0 + n) * kChunk + half * 16));
      *reinterpret_cast<uint4*>(ws + tap * BN * kChunk + swz(n, half * 16)) =
          v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int8_t* wt = ws + tap * BN * kChunk;
      uint32_t bf[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        const int m = lane >> 3;
        const int n = (warp_n * NI + ni + (m >> 1)) * 8 + (lane & 7);
        uint32_t r[4];
        ldmatrix_x4(r, wt + swz(n, (m & 1) * 16));
        bf[ni][0] = r[0];
        bf[ni][1] = r[1];
        bf[ni + 1][0] = r[2];
        bf[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int m = lane >> 3;
        const int p =
            (warp_m * MI + mi + dy) * kHaloW + (m & 1) * 8 + (lane & 7) + dx;
        uint32_t a[4];
        ldmatrix_x4(a, xs + swz(p, (m >> 1) * 16));
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a, bf[ni]);
      }
    }
  }

  // Epilogue: accumulator k of an m16n8 tile is pixel g + 8 * (k >> 1),
  // channel 2t + (k & 1).
  const bool pair = (Cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int oy = y0 + warp_m * MI + mi;
    if (oy >= H) continue;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = n0 + (warp_n * NI + ni) * 8 + 2 * t;
      if (n >= Cout) continue;
      const bool two = n + 1 < Cout;
      const float c0 = __ldg(prm.coef + n), b0 = __ldg(prm.bias + n);
      const float c1 = two ? __ldg(prm.coef + n + 1) : 0.f;
      const float b1 = two ? __ldg(prm.bias + n + 1) : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ox = x0 + g + 8 * hf;
        if (ox >= W) continue;
        const long long off = ((b * H + oy) * (long long)W + ox) * Cout + n;
        const float v0 = epilogue(acc[mi][ni][2 * hf], c0, b0, prm.act);
        const float v1 =
            two ? epilogue(acc[mi][ni][2 * hf + 1], c1, b1, prm.act) : 0.f;
        if (prm.out_bf16) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(prm.out) + off;
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16_rn(v0);
            if (two) o[1] = __float2bfloat16_rn(v1);
          }
        } else {
          float* o = static_cast<float*>(prm.out) + off;
          if (pair) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (two) o[1] = v1;
          }
        }
      }
    }
  }
}

// One tile shape a band of output widths: BN = WN * NI * 8 channels and
// TH = WM * MI rows of 16 pixels a block, at least MINB blocks an SM.
template <typename TIn, int WM, int WN, int MI, int NI, int MINB>
int launch(Params prm, int batch, cudaStream_t stream) {
  constexpr int TH = WM * MI, BN = WN * NI * 8;
  prm.tiles_x = (prm.w_ + kTileW - 1) / kTileW;
  prm.tiles_y = (prm.h + TH - 1) / TH;
  prm.n_tiles = (prm.cout + BN - 1) / BN;
  const long long blocks =
      (long long)batch * prm.tiles_y * prm.tiles_x * prm.n_tiles;
  if (blocks <= 0 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  conv3x3_s8_kernel<TIn, WM, WN, MI, NI, MINB>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename TIn>
int dispatch(const Params& prm, int batch, cudaStream_t stream) {
  if (prm.cout <= 16) return launch<TIn, 8, 1, 4, 2, 3>(prm, batch, stream);
  if (prm.cout <= 32) return launch<TIn, 8, 1, 4, 4, 2>(prm, batch, stream);
  if (prm.cout <= 64) return launch<TIn, 8, 1, 2, 8, 2>(prm, batch, stream);
  return launch<TIn, 2, 4, 4, 4, 2>(prm, batch, stream);
}

}  // namespace

// x: (batch, h, w, cin) NHWC, bf16 (in_bf16) or f32; w: pack_weights'
// (ceil(cin/32), 9, cout, 32) int8; coef, bias: (cout,) f32; out: (batch, h,
// w, cout) NHWC, bf16 (out_bf16) or f32. inv: the f32 reciprocal of the
// site's scale. act: 0 none, 1 relu, 2 leaky_relu (0.01). vec: 1 where cin is
// a multiple of 8 and x is 16-byte aligned (16- or 32-byte loads).
extern "C" int abcnet_conv3x3_s8(const void* x, const void* w,
                                 const void* coef, const void* bias,
                                 void* out, int batch, int h, int w_, int cin,
                                 int cout, float inv, int act, int in_bf16,
                                 int out_bf16, int vec, void* stream) {
  Params prm;
  prm.x = x;
  prm.w = static_cast<const int8_t*>(w);
  prm.coef = static_cast<const float*>(coef);
  prm.bias = static_cast<const float*>(bias);
  prm.out = out;
  prm.h = h;
  prm.w_ = w_;
  prm.cin = cin;
  prm.cout = cout;
  prm.inv = inv;
  prm.act = act;
  prm.out_bf16 = out_bf16;
  prm.vec = vec;
  prm.tiles_x = prm.tiles_y = prm.n_tiles = 0;
  if (batch <= 0 || h <= 0 || w_ <= 0 || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? dispatch<__nv_bfloat16>(prm, batch, s)
                 : dispatch<float>(prm, batch, s);
}
