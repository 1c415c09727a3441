// Bit unpack: MSB-first 1-bit-packed rows -> {0, 1} ink mask.
//
// Replaces the Pallas kernel abcnet_tpu/ops/pallas_input.py:_kernel_unpack
// (launched by fused_unpack_noise(train=False)), which expands each byte
// through a one-hot matmul because the TPU lowers that more readily than
// a lane-level bit shuffle. On Hopper the expansion is plain integer work:
// each thread reads one packed byte and writes its eight mask values with
// one 16-byte store (bf16) or two (f32), so a warp writes 512 or 1024
// contiguous bytes.
//
// Bound: memory. Per image the kernel reads 512*64 = 32 KiB and writes
// 512*512 values (512 KiB in bf16); at batch 64 that is about 35.7 MB, or
// about 10.6 us at the H100's 3.35 TB/s. The arithmetic (a shift and a
// select per output) is negligible, so the design only has to keep every
// load and store coalesced and wide.
//
// The layout is flat: byte i of the input becomes outputs 8i..8i+7, bit
// 7 first. A (B, H, W/8) input therefore yields the (B, H, W) mask, which
// is also the NCHW (B, 1, H, W) input the stem convolution reads, written
// directly in the model's compute dtype: no cast or copy follows.
//
// C interface (bound with ctypes): pointers and the stream as void*, the
// return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// bf16 1.0 is 0x3F80 and f32 1.0 is 0x3F800000; 0.0 is all zero bits in
// both, so the mask is built from bit patterns without any conversion.
__global__ void unpack_bf16_kernel(const uint8_t* __restrict__ bits,
                                   uint4* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t b = bits[i];
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // Output 2k is the lower half-word (little endian): bit 7 - 2k.
    const uint32_t lo = (b >> (7 - 2 * k)) & 1u;
    const uint32_t hi = (b >> (6 - 2 * k)) & 1u;
    w[k] = (lo * 0x3F80u) | ((hi * 0x3F80u) << 16);
  }
  out[i] = make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void unpack_f32_kernel(const uint8_t* __restrict__ bits,
                                  uint4* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t b = bits[i];
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = ((b >> (7 - j)) & 1u) * 0x3F800000u;
  out[2 * i] = make_uint4(w[0], w[1], w[2], w[3]);
  out[2 * i + 1] = make_uint4(w[4], w[5], w[6], w[7]);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int abcnet_unpack_bits_bf16(const void* bits, void* out,
                                       long long n_bytes, void* stream) {
  unpack_bf16_kernel<<<blocks_for(n_bytes), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (uint4*)out, n_bytes);
  return (int)cudaGetLastError();
}

extern "C" int abcnet_unpack_bits_f32(const void* bits, void* out,
                                      long long n_bytes, void* stream) {
  unpack_f32_kernel<<<blocks_for(n_bytes), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (uint4*)out, n_bytes);
  return (int)cudaGetLastError();
}
