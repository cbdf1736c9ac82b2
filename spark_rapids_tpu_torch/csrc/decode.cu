// Phase-0 bit unpack of the fused Parquet decode, for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/decode.py::unpack_bits
// (its pallas_call in _unpack_pallas).  It computes, for a buffer of ncap
// w-bit values packed LSB-first (Parquet's bit-packed hybrid runs, every
// region of one width concatenated by io/parquet_fused.py):
//
//     out[32g + j] = bits [(32g + j) * w, (32g + j + 1) * w) of the buffer
//
// as unsigned 32-bit values, written into an int32 array as bit patterns.
// Group g of 32 values spans exactly the w little-endian 32-bit words
// [g*w, g*w + w): value j starts in word a = (j*w) >> 5 at bit s = (j*w) & 31
// and spills into word a + 1 when s + w > 32.
//
// What bounds it: memory traffic.  It reads ncap*w/8 bytes and writes
// 4*ncap; the arithmetic is a few shifts per value.  The design: one warp
// owns one group of 32 values.  Lane l < w loads word l of the group (one
// coalesced 4*w-byte read per warp, no gathers), and lane j takes words a and
// a + 1 from their owners with __shfl_sync, then writes its value (one
// coalesced 128-byte store per warp).  The TPU kernel's value blocks and its
// byte -> word reshape are not carried over: the card reads the words
// directly.
//
// Any w in 1..32 and any ncap with ncap*w a multiple of 8 is taken.  A group
// that runs past the buffer (ncap not a multiple of 32, or a byte count not a
// multiple of 4) reads zeros there and writes only values below ncap.  w = 32
// never shifts by 32: its mask is all ones and no value spills.
//
// Interface: plain C, loaded with ctypes.  The launch goes to the caller's
// stream, nothing synchronises, the caller allocates out, and the entry point
// returns cudaGetLastError().  bytes must be 4-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ b,
                                              long long nbytes,
                                              long long word) {
  const long long off = word * 4;
  if (off + 4 <= nbytes) return *reinterpret_cast<const uint32_t*>(b + off);
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    if (off + k < nbytes) v |= static_cast<uint32_t>(b[off + k]) << (8 * k);
  return v;
}

__global__ void unpack_kernel(const uint8_t* __restrict__ bytes,
                              long long nbytes, int w, long long ncap,
                              int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const long long groups = (ncap + 31) >> 5;
  const uint32_t mask = w == 32 ? FULL : ((1u << w) - 1u);
  const int bit = lane * w;
  const int a = bit >> 5;
  const int s = bit & 31;
  const bool spill = s + w > 32;  // implies s > 0, so 32 - s < 32
  for (long long g = warp; g < groups; g += n_warps) {
    const uint32_t mine = lane < w ? load_word(bytes, nbytes, g * w + lane)
                                   : 0u;
    const uint32_t lo = __shfl_sync(FULL, mine, a);
    const uint32_t hi = __shfl_sync(FULL, mine, (a + 1) & 31);
    uint32_t v = lo >> s;
    if (spill) v |= hi << (32 - s);
    const long long j = g * 32 + lane;
    if (j < ncap) out[j] = static_cast<int32_t>(v & mask);
  }
}

}  // namespace

extern "C" {

int decode_unpack_bits(const void* bytes, long long nbytes, int w,
                       long long ncap, void* out, int device, void* stream) {
  if (ncap <= 0) return 0;
  if (w < 1 || w > 32) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (ncap + 31) / 32;
  const long long want = (groups * 32 + THREADS - 1) / THREADS;
  const unsigned blocks =
      static_cast<unsigned>(want < (1LL << 20) ? want : (1LL << 20));
  unpack_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), nbytes, w, ncap,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
