// Fused training input: bit unpack + per-image salt/pepper noise.
//
// Replaces the Pallas kernel abcnet_tpu/ops/pallas_input.py:_kernel_noise
// (launched by fused_unpack_noise(train=True)). Per pixel it computes
//
//     mask = max(ink, u1 < salt_b) * (u2 >= pepper_b)
//
// with ink the unpacked bit, (salt_b, pepper_b) the rates of image b and
// u1, u2 two uniforms in [0, 1) made from 32 random bits each as
// (r >> 8) * 2^-24. The TPU kernel takes its bits from the chip's
// stateful PRNG seeded seed + b and expands bytes through a one-hot
// matmul; neither exists or is needed here. On Hopper each thread owns
// one packed byte, as in unpack.cu: shifts give the eight ink bits, and
// the 16 random words come from a counter-based Philox4x32-10 written
// out below, keyed by the 64-bit seed and countered by
//
//     (byte index within the image, image index, draw 0..3, 0)
//
// Draws 0 and 1 give u1 of pixels 0-3 and 4-7 of the byte, draws 2 and 3
// give u2. Nothing is carried between threads or launches, so the same
// (bits, rates, seed) always gives the same mask, whatever the grid, and
// the plain PyTorch version (ops/noise.py:unpack_noise_plain) reproduces
// the stream bit for bit with integer tensor arithmetic.
//
// Bound: at batch 64 the kernel reads 2.1 MB of bits and writes 33.6 MB
// of bf16 (10.6 us at the H100's 3.35 TB/s). The Philox arithmetic is the
// larger term: 4 calls x 10 rounds x (2 mul.lo, 2 mul.hi, 4 xor, 2 add)
// per thread, about 400 integer operations per byte of input against the
// 17 bytes moved for it. The design keeps that work in registers (no
// state in memory, loops fully unrolled) and keeps the store one 16-byte
// write per thread (two for f32), so a warp still writes 512 contiguous
// bytes.
//
// The seed is read from device memory, so a caller that draws it with a
// CUDA generator never has to bring it to the host.
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kMul0 = 0xD2511F53u;
constexpr uint32_t kMul1 = 0xCD9E8D57u;
constexpr uint32_t kWeyl0 = 0x9E3779B9u;
constexpr uint32_t kWeyl1 = 0xBB67AE85u;

// Philox4x32 with ten rounds (Salmon et al., SC'11): each round multiplies
// two counter words by fixed constants, swaps the high and low halves
// across the words and mixes the key in; the key advances by a Weyl
// constant between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kMul0, c.x), lo0 = kMul0 * c.x;
    const uint32_t hi1 = __umulhi(kMul1, c.z), lo1 = kMul1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kWeyl0;
    k1 += kWeyl1;
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t r) {
  return __uint2float_rn(r >> 8) * (1.0f / 16777216.0f);   // exact
}

template <bool kBf16>
__global__ void unpack_noise_kernel(const uint8_t* __restrict__ bits,
                                    const float* __restrict__ rates,
                                    const long long* __restrict__ seed,
                                    uint4* __restrict__ out, long long n,
                                    unsigned per_image) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t image = (uint32_t)(i / per_image);
  const uint32_t idx = (uint32_t)(i - (long long)image * per_image);
  const unsigned long long s = (unsigned long long)__ldg(seed);
  const uint32_t k0 = (uint32_t)s, k1 = (uint32_t)(s >> 32);
  const float salt = __ldg(rates + 2 * image);
  const float pepper = __ldg(rates + 2 * image + 1);
  const uint32_t byte = bits[i];

  uint32_t r[16];
#pragma unroll
  for (uint32_t draw = 0; draw < 4; ++draw) {
    const uint4 v = philox4x32_10(make_uint4(idx, image, draw, 0u), k0, k1);
    r[4 * draw] = v.x;
    r[4 * draw + 1] = v.y;
    r[4 * draw + 2] = v.z;
    r[4 * draw + 3] = v.w;
  }
  uint32_t keep[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t ink = (byte >> (7 - p)) & 1u;
    const uint32_t add = uniform24(r[p]) < salt ? 1u : 0u;
    const uint32_t stay = uniform24(r[8 + p]) >= pepper ? 1u : 0u;
    keep[p] = (ink | add) & stay;
  }
  // 1.0 is 0x3F80 in bf16 and 0x3F800000 in f32; 0.0 is all zero bits.
  if (kBf16) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (keep[2 * k] * 0x3F80u) | ((keep[2 * k + 1] * 0x3F80u) << 16);
    out[i] = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    out[2 * i] = make_uint4(keep[0] * 0x3F800000u, keep[1] * 0x3F800000u,
                            keep[2] * 0x3F800000u, keep[3] * 0x3F800000u);
    out[2 * i + 1] = make_uint4(keep[4] * 0x3F800000u, keep[5] * 0x3F800000u,
                                keep[6] * 0x3F800000u, keep[7] * 0x3F800000u);
  }
}

template <bool kBf16>
int launch(const void* bits, const void* rates, const void* seed, void* out,
           long long n_bytes, int per_image, void* stream) {
  const unsigned blocks = (unsigned)((n_bytes + kThreads - 1) / kThreads);
  unpack_noise_kernel<kBf16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const float*)rates, (const long long*)seed,
      (uint4*)out, n_bytes, (unsigned)per_image);
  return (int)cudaGetLastError();
}

}  // namespace

// bits: n_bytes packed bytes, per_image of them per image; rates: two f32
// (salt, pepper) per image; seed: one int64 in device memory.
extern "C" int abcnet_unpack_noise_bf16(const void* bits, const void* rates,
                                        const void* seed, void* out,
                                        long long n_bytes, int per_image,
                                        void* stream) {
  return launch<true>(bits, rates, seed, out, n_bytes, per_image, stream);
}

extern "C" int abcnet_unpack_noise_f32(const void* bits, const void* rates,
                                       const void* seed, void* out,
                                       long long n_bytes, int per_image,
                                       void* stream) {
  return launch<false>(bits, rates, seed, out, n_bytes, per_image, stream);
}
