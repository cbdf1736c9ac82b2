// The two Parquet stream kernels, for Hopper (sm_90a): the phase-0 bit
// unpack of the fused decode, and the run expansion of the per-column decode.
//
// unpack_bits.  Replaces the TPU kernel spark_rapids_tpu/kernels/decode.py::unpack_bits
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
// expand.  Replaces the TPU kernel spark_rapids_tpu/kernels/decode.py::
// expand_stream (its pallas_call in _expand_pallas).  One hybrid RLE /
// bit-packed stream of cap values arrives as two step functions over the
// elements, built outside the kernel by a delta scatter and a cumsum
// (kernels/decode.py::step_functions): a[i] = dense index - i inside a
// bit-packed run, c[i] = value * 2 + 1 inside an RLE run, 0 otherwise.  It
// computes
//
//     out[i] = (c[i] & 1) ? c[i] >> 1 : dense[clip(a[i] + i, 0, dlen - 1)]
//
// with dense the stream's bit-packed values, unpacked by unpack_bits, and
// writes the low 32 bits of each value into an int32 array.  The steps are
// int32 or int64 (the host widens them for wide RLE payloads: at w = 32 an
// RLE value of 2^32 - 5 needs 33 bits); a + i wraps in the step type and
// c >> 1 is an arithmetic shift, as in the reference's jnp arithmetic.
//
// What bounds it: memory traffic.  Per element it reads a and c and writes
// 4 bytes; the dense gather is one read per element, and since the dense
// index rises with i along a bit-packed run, neighbouring threads read
// neighbouring words.  The design: one thread per element in a grid-stride
// loop, no shared memory.  The TPU kernel's sweep of every element block
// over VMEM-sized dense tiles (_expand_body, tiling.plan) is not carried
// over: the card gathers from device memory directly, for any dlen.
//
// Interface: plain C, loaded with ctypes.  The launches go to the caller's
// stream, nothing synchronises, the caller allocates out, and each entry
// point returns cudaGetLastError().  bytes must be 4-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

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

// a + i in the step type, wrapping as the reference's int32 add does
template <typename T>
__device__ __forceinline__ long long step_index(T a, long long i) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<long long>(
      static_cast<T>(static_cast<U>(a) + static_cast<U>(i)));
}

template <typename T>
__global__ void expand_kernel(const int32_t* __restrict__ dense,
                              long long dlen, const T* __restrict__ a,
                              const T* __restrict__ c, long long cap,
                              int32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += stride) {
    const T ci = c[i];
    int32_t v;
    if (ci & 1) {
      v = static_cast<int32_t>(static_cast<uint32_t>(ci >> 1));
    } else {
      long long idx = step_index<T>(a[i], i);
      idx = idx < 0 ? 0 : (idx >= dlen ? dlen - 1 : idx);
      v = dense[idx];
    }
    out[i] = v;
  }
}

unsigned grid_for(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(want < (1LL << 20) ? want : (1LL << 20));
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

// step_bytes: 4 for int32 steps, 8 for int64.
int decode_expand(const void* dense, long long dlen, const void* a,
                  const void* c, int step_bytes, long long cap, void* out,
                  int device, void* stream) {
  if (cap <= 0) return 0;
  if (dlen <= 0 || (step_bytes != 4 && step_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* d = static_cast<const int32_t*>(dense);
  int32_t* o = static_cast<int32_t*>(out);
  if (step_bytes == 4) {
    expand_kernel<int32_t><<<grid_for(cap), THREADS, 0, s>>>(
        d, dlen, static_cast<const int32_t*>(a),
        static_cast<const int32_t*>(c), cap, o);
  } else {
    expand_kernel<int64_t><<<grid_for(cap), THREADS, 0, s>>>(
        d, dlen, static_cast<const int64_t*>(a),
        static_cast<const int64_t*>(c), cap, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
