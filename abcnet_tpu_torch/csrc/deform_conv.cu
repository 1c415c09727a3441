// Modulated deformable 3x3 columns (DCNv2, eval mode): for each output
// pixel p, tap k = 3i + j and input channel c,
//
//   cols[p, k, c] = sigmoid(m_k(p)) * bilinear(x_c, y, x)
//   y = (h - 1 + i) + dy_k(p),   x = (w - 1 + j) + dx_k(p)
//
// where dy_k, dx_k, m_k are channels 2k, 2k + 1 and 18 + k of the offset /
// mask conv's output (DCN's `conv_offset_mask`: offset = cat(o1, o2) is
// its first 18 channels in order). A sample outside -1 < y < H, -1 < x < W
// is 0; inside, each of the four corners that falls off the map counts 0
// (DCNv2's dmcn_im2col_bilinear). The contraction over the 9 C columns of
// a pixel is one GEMM after this kernel (ops/deform_conv.py), then the
// bias, eval BatchNorm and activation (ops/bn_act.py:bn_act_eval): DCNv2's
// own im2col structure.
//
// No Pallas kernel stands behind it: the JAX package has no deformable
// conv. It was added for the DLA-34 + DCN configuration
// (models/dla_dcn.py), whose 16 aggregation sites sample their input at
// data-dependent fractional positions, which no stock op computes.
//
// Bound: memory. The input is NHWC bf16, so one tap's four corners are
// four contiguous runs of C values; a thread takes 8 channels (16 bytes)
// of one (pixel, tap), neighbouring threads the neighbouring channels, so
// every corner load and the column store are 16-byte vectors coalesced
// across the C / 8 threads of a tap. The kernel reads each input pixel up
// to 36 times (9 taps, 4 corners; mostly from L1/L2) and writes 9 C bf16
// columns a pixel, which the GEMM reads once more: the columns, not the
// input, set its time. A gather-and-contract kernel that never writes
// them is the later design.
//
// Rounding: every coordinate, weight and product in f32, each operation
// rounded on its own (__fadd_rn / __fmul_rn / __fdiv_rn, so the compiler
// contracts nothing into an FMA), in the order of the plain op
// ops/deform_conv.py:modulated_columns_plain:
//   w1 = hy * hx, w2 = hy * lx, w3 = ly * hx, w4 = ly * lx,
//   s = ((w1 v1 + w2 v2) + w3 v3) + w4 v4,   col = s * sigmoid(m),
// sigmoid(m) = 1 / (1 + exp(-m)) as ATen's CUDA sigmoid, then one
// round-to-nearest-even to bf16. The offsets are the bf16 conv outputs
// widened to f32 and added to the integer grid position in f32.
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;
constexpr int kOffsetMask = 27;   // 18 offsets, 9 mask logits
constexpr int kVec = 8;           // bf16 values in a 16-byte vector

__device__ __forceinline__ void widen(const uint4 q, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One thread: 8 channels of one (pixel, tap). x (N, H, W, C) and om
// (N, H, W, 27) bf16 channels-last; cols (N H W, 9, C) bf16.
__global__ void columns_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ om,
                               __nv_bfloat16* __restrict__ cols, int H,
                               int W, int C, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cv = C / kVec;
  const int v = (int)(t % cv);
  const long long pk = t / cv;
  const int k = (int)(pk % kTaps);
  const long long p = pk / kTaps;
  const long long hw = (long long)H * W;
  const long long b = p / hw;
  const int r = (int)(p % hw);
  const int h = r / W, w = r % W;

  const __nv_bfloat16* o = om + p * kOffsetMask;
  const float dy = __bfloat162float(o[2 * k]);
  const float dx = __bfloat162float(o[2 * k + 1]);
  const float m = __bfloat162float(o[18 + k]);
  const float mask = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-m)));

  const float ys = __fadd_rn((float)(h - 1 + k / 3), dy);
  const float xs = __fadd_rn((float)(w - 1 + k % 3), dx);

  float out[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = 0.0f;
  if (ys > -1.0f && ys < (float)H && xs > -1.0f && xs < (float)W) {
    const float y0f = floorf(ys), x0f = floorf(xs);
    const int y0 = (int)y0f, x0 = (int)x0f;
    const float ly = __fsub_rn(ys, y0f), lx = __fsub_rn(xs, x0f);
    const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
    const float wt[4] = {__fmul_rn(hy, hx), __fmul_rn(hy, lx),
                         __fmul_rn(ly, hx), __fmul_rn(ly, lx)};
    const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
    const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
    float s[kVec];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float val[kVec];
      if (cy[q] >= 0 && cy[q] < H && cx[q] >= 0 && cx[q] < W) {
        const long long at =
            ((b * H + cy[q]) * W + cx[q]) * (long long)C + v * kVec;
        widen(*reinterpret_cast<const uint4*>(x + at), val);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) val[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float prod = __fmul_rn(wt[q], val[i]);
        s[i] = q == 0 ? prod : __fadd_rn(s[i], prod);
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = __fmul_rn(s[i], mask);
  }
  uint4 packed;
  __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ph[i] = __floats2bfloat162_rn(out[2 * i], out[2 * i + 1]);
  *reinterpret_cast<uint4*>(cols + (p * kTaps + k) * (long long)C +
                            v * kVec) = packed;
}

}  // namespace

// x (N, H, W, C) and om (N, H, W, 27) bf16, channels-last and 16-byte
// aligned, C a multiple of 8; cols (N H W, 9 C) bf16.
extern "C" int abcnet_deform_columns(const void* x, const void* om,
                                     void* cols, int N, int H, int W, int C,
                                     void* stream) {
  const long long total = (long long)N * H * W * kTaps * (C / kVec);
  const long long blocks = (total + kThreads - 1) / kThreads;
  columns_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)om,
      (__nv_bfloat16*)cols, H, W, C, total);
  return (int)cudaGetLastError();
}
