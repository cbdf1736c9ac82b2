// Predicated dictionary gathers of the fused Parquet decode, for Hopper
// (sm_90a).
//
// Replaces the two TPU kernels of spark_rapids_tpu/kernels/filter_decode.py:
//
//   decode_pallas      out[i] = keep[i] ? dbuf[clip(codes[i], 0, dlen-1)] : 0
//   decode_str_pallas  out[r, c] = keep[r] && c < lw[r]
//                                  ? dbuf[clip(byte_base[r] + c, 0, dlen-1)]
//                                  : 0            (uint8 [cap, width])
//
// The fused scan (io/parquet_fused.py, phase 5) keeps dictionary columns
// that the pushed filter does not read as codes until the filter's mask is
// known, then gathers only the rows that survive it.
//
// What bounds them: memory traffic, and most of it is data dependent.
// decode reads cap keep bytes and, per kept row, 4 B of code and one
// element, and writes cap elements; decode_str reads keep, byte base and
// length per row plus the kept bytes, and writes cap*width bytes.
//
// The design: one thread per output element (per row for decode, per
// (row, byte) cell for decode_str), in a grid-stride loop.  A row whose keep
// is false writes zeros and reads neither its code nor the dictionary: the
// TPU kernel skips whole blocks whose rows all failed the filter, and here
// the skip is per row (a warp whose rows are all dropped issues no
// dictionary load at all).  Writes are coalesced along the output; the
// dictionary reads are gathers, served mostly from L2 for the dictionaries
// of q6 (18,000 x 8 B).  The TPU kernels' 2-D (element block x dictionary
// tile) grid is not carried over: the card gathers from device memory
// directly, so any dictionary size and any string width is taken.  Staging
// the dictionary in shared memory is later work.
//
// decode copies bits: it is templated on the element size (4 or 8 bytes),
// so int32/float32 and int64/float64 dictionaries share one instantiation.
// Byte offsets in decode_str are computed in 64 bits.
//
// Interface: plain C, loaded with ctypes.  Launches go to the caller's
// stream, nothing synchronises, the caller allocates out, and each entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1LL << 20;

__device__ __forceinline__ long long clip(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <typename T>
__global__ void decode_kernel(const T* __restrict__ dbuf, long long dlen,
                              const int32_t* __restrict__ codes,
                              const uint8_t* __restrict__ keep,
                              long long cap, T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += stride) {
    T v = 0;
    if (keep[i]) v = dbuf[clip(codes[i], dlen - 1)];
    out[i] = v;
  }
}

__global__ void decode_str_kernel(const uint8_t* __restrict__ dbuf,
                                  long long dlen,
                                  const int32_t* __restrict__ byte_base,
                                  const int32_t* __restrict__ lw,
                                  const uint8_t* __restrict__ keep,
                                  long long cap, int width,
                                  uint8_t* __restrict__ out) {
  const long long cells = cap * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < cells; t += stride) {
    const long long r = t / width;
    const int c = static_cast<int>(t - r * width);
    uint8_t v = 0;
    if (keep[r] && c < lw[r])
      v = dbuf[clip(static_cast<long long>(byte_base[r]) + c, dlen - 1)];
    out[t] = v;
  }
}

unsigned n_blocks(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// elem_size: 4 or 8 (bytes per dictionary element)
int filter_decode(int elem_size, const void* dbuf, long long dlen,
                  const int32_t* codes, const uint8_t* keep, long long cap,
                  void* out, int device, void* stream) {
  if (cap <= 0) return 0;
  if (dlen <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) {
    decode_kernel<uint32_t><<<n_blocks(cap), THREADS, 0, s>>>(
        static_cast<const uint32_t*>(dbuf), dlen, codes, keep, cap,
        static_cast<uint32_t*>(out));
  } else if (elem_size == 8) {
    decode_kernel<uint64_t><<<n_blocks(cap), THREADS, 0, s>>>(
        static_cast<const uint64_t*>(dbuf), dlen, codes, keep, cap,
        static_cast<uint64_t*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int filter_decode_str(const uint8_t* dbuf, long long dlen,
                      const int32_t* byte_base, const int32_t* lw,
                      const uint8_t* keep, long long cap, int width,
                      uint8_t* out, int device, void* stream) {
  if (cap <= 0 || width <= 0) return 0;
  if (dlen <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  decode_str_kernel<<<n_blocks(cap * width), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      dbuf, dlen, byte_base, lw, keep, cap, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
