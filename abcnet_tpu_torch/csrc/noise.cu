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
// larger term, and all of it is 32-bit integer work, which an SM of
// compute capability 9.0 executes at 64 lanes a clock, half its f32 rate.
// The least this function needs per packed byte: a round is two wide
// multiplies (32 x 32 -> 64 bits, one instruction for the high and the low
// word) and two three-input xors, 4 instructions, and rounds 3-10 of the
// four draws cost that in full (32 x 4). The four draws differ in one
// counter word only, so their round 1 is one multiply (by the byte index,
// shared; the draw number times a constant is a constant) and four xors,
// and their round 2 four multiplies and seven xors. The 18 round-key
// additions are shared by the four calls; a pixel needs two compares and
// two logic operations, and a pixel's share of the pack is one more:
// 128 + 5 + 11 + 18 + 8 x 4 + 8 = 202 integer instructions, 25.3 us for
// the 2,097,152 bytes of a batch of 64 at 132 SMs x 64 lanes x 1.98 GHz.
//
// The design keeps that work in registers and takes everything else out of
// the per-pixel tail:
//   * u < s with u = m * 2^-24 and integer m = r >> 8 is m < T(s) with
//     T(s) = ceil(s * 2^24) clamped to [0, 2^24] (s * 2^24 is exact in
//     f32), and that is r < (T << 8) on the random word itself. A thread
//     makes its two thresholds once; a pixel then costs two unsigned
//     compares, no shift, no conversion to float, no float multiply.
//     T = 2^24 does not fit the shifted form and is folded into the byte:
//     a salt rate >= 1 inks every pixel (byte = 0xFF), a pepper rate >= 1
//     erases every pixel (byte = 0, no salt). A NaN rate keeps what the
//     float compares did: u < NaN and u >= NaN are both false, so a NaN
//     salt rate adds nothing and a NaN pepper rate erases the image.
//     ops/noise.py:rate_thresholds is the same arithmetic on tensors and
//     is held to the float compares on the CPU.
//   * each product is written as one 64-bit multiply, and the round keys
//     are made once per thread, not once per call;
//   * loops are fully unrolled, no state lives in memory, and the store
//     stays one 16-byte write per thread (two for f32), so a warp writes
//     512 contiguous bytes.
//   * grid = (images, blocks of an image), so that no thread divides to
//     find its image.
// What the compiler makes of it (cuobjdump -sass of the sm_90a build, CUDA
// 12 toolkit; chip_smoke.py prints the counts in its environment line): 280
// instructions a thread for bf16, of them 69 wide multiplies (65
// IMAD.WIDE.U32 and 4 on the uniform datapath: the four draws share most
// of rounds 1 and 2, so 69 stand for 4 x 10 x 2 products), 79 LOP3 (every
// three-input xor is one), the 18 round-key additions as UIADD3 on the
// uniform datapath, 17 ISETP and 18 SEL for the 16 compares and the
// pack, 2 FMUL, 2 FRND and 2 F2I for the two thresholds, and no shift of
// a random word, no conversion and no float multiply a pixel: the 69 and
// the 18 are just what the count above allows. 28 registers, no spills.
// A probe kernel of nothing but Philox rounds (int32_probe_kernel below)
// runs its multiplies, xors and additions at 96% of 132 SMs x 64 lanes
// x 1.98 GHz on an H100 at 700 W, so that rate is the yardstick.
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
// across the words and mixes the round's key in; the key advances by a
// Weyl constant between rounds (k0[], k1[] hold the ten keys).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const uint32_t* k0,
                                               const uint32_t* k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned long long p0 = (unsigned long long)kMul0 * c.x;
    const unsigned long long p1 = (unsigned long long)kMul1 * c.z;
    c = make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ k0[round], (uint32_t)p1,
                   (uint32_t)(p0 >> 32) ^ c.w ^ k1[round], (uint32_t)p0);
  }
  return c;
}

constexpr uint32_t kOne24 = 1u << 24;

// T(rate) = ceil(rate * 2^24) clamped to [0, 2^24]: m < T is u < rate and
// m >= T is u >= rate for u = m * 2^-24. A NaN salt rate gives 0 (never
// below), a NaN pepper rate 2^24 (never at or above).
// (fmaxf and fminf return their other argument for a NaN.)
__device__ __forceinline__ uint32_t salt_threshold(float rate) {
  const float x = ceilf(rate * 16777216.0f);
  return (uint32_t)fminf(fmaxf(x, 0.0f), 16777216.0f);
}
__device__ __forceinline__ uint32_t pepper_threshold(float rate) {
  const float x = ceilf(rate * 16777216.0f);
  return (uint32_t)fmaxf(fminf(x, 16777216.0f), 0.0f);
}

template <bool kBf16>
__global__ void unpack_noise_kernel(const uint8_t* __restrict__ bits,
                                    const float* __restrict__ rates,
                                    const long long* __restrict__ seed,
                                    uint4* __restrict__ out,
                                    unsigned per_image) {
  // grid = (images, blocks per image): no division to find the image.
  const uint32_t image = blockIdx.x;
  const uint32_t idx = blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= per_image) return;
  const size_t i = (size_t)image * per_image + idx;
  const unsigned long long s = (unsigned long long)__ldg(seed);
  uint32_t k0[10], k1[10];
  k0[0] = (uint32_t)s, k1[0] = (uint32_t)(s >> 32);
#pragma unroll
  for (int round = 1; round < 10; ++round) {
    k0[round] = k0[round - 1] + kWeyl0;
    k1[round] = k1[round - 1] + kWeyl1;
  }
  // Thresholds on the 32-bit random words; 2^24 << 8 wraps to 0 and is
  // folded into the byte instead.
  const uint32_t t_salt = salt_threshold(__ldg(rates + 2 * image));
  const uint32_t t_pepper = pepper_threshold(__ldg(rates + 2 * image + 1));
  uint32_t salt_below = t_salt << 8, stay_from = t_pepper << 8;
  uint32_t byte = bits[i];
  if (t_salt == kOne24) byte = 0xFFu;
  if (t_pepper == kOne24) byte = 0u, salt_below = 0u;

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
    const uint32_t add = r[p] < salt_below ? 1u : 0u;
    const uint32_t stay = r[8 + p] >= stay_from ? 1u : 0u;
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

// Probe of the SM's rate for the instruction mix of a Philox round: every
// thread runs `rounds` rounds on four independent counters (8 wide
// multiplies, 8 three-input xors and 2 key additions per round, nothing
// else in the loop) and writes one word so that the work stays.
constexpr int kProbeOpsPerRound = 18;

__global__ void int32_probe_kernel(uint32_t* __restrict__ out, int rounds) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint4 c[4];
#pragma unroll
  for (uint32_t d = 0; d < 4; ++d) c[d] = make_uint4(t, d, t ^ d, 1u);
  uint32_t k0 = t, k1 = ~t;
  for (int round = 0; round < rounds; ++round) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const unsigned long long p0 = (unsigned long long)kMul0 * c[d].x;
      const unsigned long long p1 = (unsigned long long)kMul1 * c[d].z;
      c[d] = make_uint4((uint32_t)(p1 >> 32) ^ c[d].y ^ k0, (uint32_t)p1,
                        (uint32_t)(p0 >> 32) ^ c[d].w ^ k1, (uint32_t)p0);
    }
    k0 += kWeyl0;
    k1 += kWeyl1;
  }
  uint32_t acc = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) acc ^= c[d].x ^ c[d].y ^ c[d].z ^ c[d].w;
  out[t] = acc;
}

template <bool kBf16>
int launch(const void* bits, const void* rates, const void* seed, void* out,
           long long n_bytes, int per_image, void* stream) {
  const long long images = per_image > 0 ? n_bytes / per_image : 0;
  const long long per_y = ((long long)per_image + kThreads - 1) / kThreads;
  if (images < 1 || images > 2147483647LL || per_y > 65535 ||
      images * per_image != n_bytes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)images, (unsigned)per_y, 1);
  unpack_noise_kernel<kBf16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const float*)rates, (const long long*)seed,
      (uint4*)out, (unsigned)per_image);
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

// Runs the probe on blocks x 256 threads (out: that many uint32) and returns
// the integer instructions it runs per thread, or -1 if the launch failed.
extern "C" long long abcnet_int32_probe(void* out, int blocks, int rounds,
                                        void* stream) {
  int32_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, rounds);
  if (cudaGetLastError() != cudaSuccess) return -1;
  return (long long)rounds * kProbeOpsPerRound;
}

extern "C" int abcnet_unpack_noise_f32(const void* bits, const void* rates,
                                       const void* seed, void* out,
                                       long long n_bytes, int per_image,
                                       void* stream) {
  return launch<false>(bits, rates, seed, out, n_bytes, per_image, stream);
}
