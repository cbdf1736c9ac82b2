// The two Parquet stream kernels, for Hopper (sm_90a): the phase-0 bit
// unpack of the fused decode, and the whole run expansion of the
// per-column decode.
//
// unpack_bits.  Replaces the TPU kernel spark_rapids_tpu/kernels/decode.py::
// unpack_bits (its pallas_call in _unpack_pallas).  It computes, for a
// buffer of ncap w-bit values packed LSB-first (Parquet's bit-packed hybrid
// runs, every region of one width concatenated by io/parquet_fused.py):
//
//     out[j] = bits [j * w, (j + 1) * w) of the buffer
//
// as unsigned 32-bit values, written into an int32 array as bit patterns.
// Value j starts in little-endian word a = (j*w) >> 5 at bit s = (j*w) & 31
// and spills into word a + 1 when s + w > 32.
//
// What bounds it: memory traffic.  It reads ncap*w/8 bytes and writes
// 4*ncap; the arithmetic is a few shifts per value.  What held the first
// version back was latency: one warp per group of 32 values, where only
// lanes < w loaded one word each, kept 4*w bytes in flight per warp.  The
// design: a block owns UNPACK_VALS consecutive values (UNPACK_VALS*w/8
// bytes, at most 16 KiB).  Every thread first issues all of its 16-byte
// loads of that chunk into registers, then stores them to shared memory,
// so the whole chunk is in flight at once (w/2 KB per block, up to 8
// blocks per SM).  After one barrier each thread extracts 4 consecutive
// values from shared memory and writes them with one 16-byte store; a
// warp's stores cover 512 consecutive bytes.  The TPU kernel's byte ->
// word reshape is not carried over.
//
// Any w in 1..32 and any ncap with ncap*w a multiple of 8 is taken.  A chunk
// that runs past the buffer (ncap not a multiple of UNPACK_VALS, a byte
// count not a multiple of 16) reads zeros there and writes only values
// below ncap.  An input not 16-byte aligned is loaded word by word, an
// output not 16-byte aligned (a slice of a larger array) stored value by
// value.  w = 32 never shifts by 32: its mask is all ones and no value
// spills.
//
// expand.  Replaces the TPU kernel spark_rapids_tpu/kernels/decode.py::
// expand_stream: its pallas_call in _expand_pallas, with the unpack
// (_unpack_pallas) and the delta scatter + cumsum of _expand_impl that feed
// it.  One hybrid RLE / bit-packed stream of cap values arrives as a run
// table of absolute rows (start, A, C), sorted by start, made on the host
// (kernels/decode.py::run_table), and the stream's packed bits.  With
// A(i), C(i) the row of the last start <= i (0, 0 before the first row),
// it computes
//
//     out[i] = (C(i) & 1) ? low32(C(i) >> 1)
//                         : value(clip(A(i) + i, 0, dlen - 1))
//
// where value(d) is bits [d*w, (d+1)*w) of the packed buffer (0 when
// w = 0).  A is the dense index minus the element inside a bit-packed run,
// C the RLE value * 2 + 1 inside an RLE run.  The rows are int32 or int64
// (the host widens them for wide RLE payloads); A + i wraps in the row
// type and C >> 1 is an arithmetic shift, as in the reference's jnp
// arithmetic.  Padding rows (start 2^30) lie past every element; rows with
// one start (zero-count runs) resolve to the last of them.
//
// What bounds it: memory traffic, 4 bytes written per element; the table
// and the packed bits are read once.  The three-phase version it replaces
// materialised two [cap] step functions and the dense array (8-16 B per
// element) in 14 launches per stream.  At the PERFILE reader's 2^20-value
// streams the bytes take ~1.3 us, so what bounds the kernel is its chain of
// dependent memory round trips.  The design: one launch; a block owns
// EXPAND_TILE = EXPAND_VALS * EXPAND_THREADS consecutive elements.  It
// finds the rows that cover its tile by a k-ary search: each round every
// thread reads one evenly spaced start, and the block counts, with
// __syncthreads_count, those at or below the tile's first and last
// element, until the rows between the two fit one load per thread (no
// round for a table of up to EXPAND_THREADS rows, one for up to 2^16).
// Those rows are staged in shared memory in one more round trip; a tile
// that covers more rows (runs of under 4 elements on average) searches the
// table in global memory instead, it does not fall back.  Each thread then
// takes EXPAND_VALS consecutive elements (a binary search in the staged
// rows for the first, then the next row's start is watched), issues the
// packed loads of all of them at once (neighbouring threads read
// neighbouring words) and writes them with 16-byte stores.  No [cap] step
// function and no dense array exists.  Larger blocks (512 or 1024
// threads) and 8 elements per thread measured no faster.
//
// Interface: plain C, loaded with ctypes.  The launches go to the caller's
// stream, nothing synchronises, the caller allocates out, and each entry
// point returns cudaGetLastError().  Packed buffers must be 4-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int UNPACK_VALS = 4096;                 // values per block
constexpr int UNPACK_QUADS = UNPACK_VALS / 4 / THREADS;
constexpr int UNPACK_MAX_VECS = UNPACK_VALS * 32 / 8 / 16 / THREADS;
constexpr int EXPAND_THREADS = 256;
constexpr int EXPAND_VALS = 4;                    // elements per thread
constexpr int EXPAND_TILE = EXPAND_VALS * EXPAND_THREADS;

__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ b,
                                              long long nbytes,
                                              long long word) {
  const long long off = word * 4;
  if (off + 4 <= nbytes)
    return __ldg(reinterpret_cast<const uint32_t*>(b + off));
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    if (off + k < nbytes) v |= static_cast<uint32_t>(b[off + k]) << (8 * k);
  return v;
}

__device__ __forceinline__ uint32_t low_mask(int w) {
  return w == 32 ? 0xffffffffu : ((1u << w) - 1u);
}

// bits [bit, bit + w) of little-endian words (w in 1..32)
__device__ __forceinline__ uint32_t extract(const uint32_t* words, int bit,
                                            int w, uint32_t mask) {
  const int a = bit >> 5;
  const int s = bit & 31;
  uint32_t v = words[a] >> s;
  if (s + w > 32) v |= words[a + 1] << (32 - s);  // s > 0 here
  return v & mask;
}

// v[0..3] into out[e..e+3], the values below n
__device__ __forceinline__ void store4(int32_t* __restrict__ out,
                                       long long e, long long n,
                                       const int32_t* v, bool vec) {
  if (vec && e + 4 <= n) {
    *reinterpret_cast<int4*>(out + e) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e + k < n) out[e + k] = v[k];
  }
}

__global__ void __launch_bounds__(THREADS)
unpack_kernel(const uint8_t* __restrict__ bytes, long long nbytes, int w,
              long long ncap, int32_t* __restrict__ out, int vec_in,
              int vec_out) {
  extern __shared__ uint4 chunk4[];
  uint32_t* words = reinterpret_cast<uint32_t*>(chunk4);
  const long long v0 = static_cast<long long>(blockIdx.x) * UNPACK_VALS;
  const long long b0 = v0 / 8 * w;          // a multiple of 16
  const int chunk = UNPACK_VALS / 8 * w;    // bytes
  const long long left = nbytes - b0;
  const int have = left < chunk ? static_cast<int>(left) : chunk;
  const uint8_t* src = bytes + b0;
  const int nvec = chunk / 16;
  if (vec_in) {
    // every load of the chunk in flight before any store to shared memory
    uint4 r[UNPACK_MAX_VECS];
#pragma unroll
    for (int k = 0; k < UNPACK_MAX_VECS; ++k) {
      const int q = threadIdx.x + k * THREADS;
      if (q < nvec) {
        if (q * 16 + 16 <= have) {
          r[k] = __ldg(reinterpret_cast<const uint4*>(src) + q);
        } else {
          uint32_t t[4];
          for (int m = 0; m < 4; ++m) t[m] = load_word(src, have, q * 4 + m);
          r[k] = make_uint4(t[0], t[1], t[2], t[3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < UNPACK_MAX_VECS; ++k) {
      const int q = threadIdx.x + k * THREADS;
      if (q < nvec) chunk4[q] = r[k];
    }
  } else {
    for (int q = threadIdx.x; q < chunk / 4; q += THREADS)
      words[q] = load_word(src, have, q);
  }
  __syncthreads();
  const uint32_t mask = low_mask(w);
#pragma unroll
  for (int k = 0; k < UNPACK_QUADS; ++k) {
    const int q = threadIdx.x + k * THREADS;
    const long long e = v0 + 4 * q;
    if (e >= ncap) break;
    int32_t v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      v[m] = static_cast<int32_t>(extract(words, (4 * q + m) * w, w, mask));
    store4(out, e, ncap, v, vec_out);
  }
}

// a + i in the row type, wrapping as the reference's int32 add does
template <typename T>
__device__ __forceinline__ long long step_index(T a, long long i) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<long long>(
      static_cast<T>(static_cast<U>(a) + static_cast<U>(i)));
}

// First row in [lo, hi) whose start is > x (rows of 3: start, A, C;
// starts sorted); hi when there is none.
template <typename T>
__device__ __forceinline__ int upper_row(const T* rows, int lo, int hi,
                                         long long x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(rows[3 * mid]) <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Narrows, by the block, the ranges that hold upper_row(x0) and
// upper_row(x1) over the whole table until the rows between them fit one
// load per thread (or both are exact): each round every thread reads one
// of EXPAND_THREADS evenly spaced starts of each range and the block
// counts those <= the key, which narrows each range EXPAND_THREADS-fold.
// On return upper_row(x0) is in [lo0, hi0] and upper_row(x1) in
// [lo1, hi1], the same in every thread.
template <typename T>
__device__ void block_narrow(const T* __restrict__ rows, long long x0,
                             long long x1, int& lo0, int& hi0, int& lo1,
                             int& hi1) {
  while ((lo0 < hi0 || lo1 < hi1) &&
         hi1 - max(lo0 - 1, 0) > EXPAND_THREADS) {
    const int st0 = (hi0 - lo0 + EXPAND_THREADS - 1) / EXPAND_THREADS;
    const int st1 = (hi1 - lo1 + EXPAND_THREADS - 1) / EXPAND_THREADS;
    const int p0 = lo0 + threadIdx.x * st0;
    const int p1 = lo1 + threadIdx.x * st1;
    const bool in0 = p0 < hi0 && static_cast<long long>(rows[3 * p0]) <= x0;
    const bool in1 = p1 < hi1 && static_cast<long long>(rows[3 * p1]) <= x1;
    const int c0 = __syncthreads_count(in0);
    const int c1 = __syncthreads_count(in1);
    // the answer lies after the last counted position, up to the next one
    if (lo0 < hi0) {
      if (c0 == 0) {
        hi0 = lo0;
      } else {
        const int nlo = lo0 + (c0 - 1) * st0 + 1;
        hi0 = min(lo0 + c0 * st0, hi0);
        lo0 = nlo;
      }
    }
    if (lo1 < hi1) {
      if (c1 == 0) {
        hi1 = lo1;
      } else {
        const int nlo = lo1 + (c1 - 1) * st1 + 1;
        hi1 = min(lo1 + c1 * st1, hi1);
        lo1 = nlo;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(EXPAND_THREADS)
expand_kernel(const T* __restrict__ table, int nrows,
              const uint8_t* __restrict__ packed, long long nbytes, int w,
              long long dlen, long long cap, int32_t* __restrict__ out) {
  __shared__ T staged[3 * EXPAND_THREADS];
  const long long t0 = static_cast<long long>(blockIdx.x) * EXPAND_TILE;
  const long long t1 = min(t0 + EXPAND_TILE, cap) - 1;   // last element
  // rows [first, first + hi) of the table cover the tile: the row that
  // holds its first element (none before the table's first start, and
  // then that element reads A = C = 0) up to the one that holds its last
  int lo0 = 0, hi0 = nrows, lo1 = 0, hi1 = nrows;
  block_narrow(table, t0, t1, lo0, hi0, lo1, hi1);
  const int first = max(lo0 - 1, 0);
  const int hi = hi1 - first;
  const T* rows = table + 3 * static_cast<long long>(first);
  if (hi <= EXPAND_THREADS) {              // one load per thread and column
    for (int j = threadIdx.x; j < 3 * hi; j += EXPAND_THREADS)
      staged[j] = rows[j];
    rows = staged;
  }                                        // else search in place
  __syncthreads();
  // the thread's elements: their rows, then every packed load at once
  const long long e = t0 + EXPAND_VALS * threadIdx.x;
  if (e > t1) return;
  // the row in force (A = C = 0 before the first) and the next row's start
  constexpr long long NONE = 1LL << 62;
  int j = upper_row(rows, 0, hi, e) - 1;
  T a = 0, c = 0;
  if (j >= 0) {
    a = rows[3 * j + 1];
    c = rows[3 * j + 2];
  }
  long long next = j + 1 < hi ? static_cast<long long>(rows[3 * (j + 1)])
                              : NONE;
  int32_t v[EXPAND_VALS];
  long long word[EXPAND_VALS];
  int sh[EXPAND_VALS];
  bool gather[EXPAND_VALS];
#pragma unroll
  for (int k = 0; k < EXPAND_VALS; ++k) {
    const long long i = e + k;
    if (i >= next) {                       // a later row holds i
      do {
        ++j;
      } while (j + 1 < hi && static_cast<long long>(rows[3 * (j + 1)]) <= i);
      a = rows[3 * j + 1];
      c = rows[3 * j + 2];
      next = j + 1 < hi ? static_cast<long long>(rows[3 * (j + 1)]) : NONE;
    }
    gather[k] = !(c & 1) && w != 0;
    v[k] = (c & 1) ? static_cast<int32_t>(static_cast<uint32_t>(c >> 1)) : 0;
    long long d = step_index<T>(a, i);
    d = d < 0 ? 0 : (d >= dlen ? dlen - 1 : d);
    const long long bit = d * w;
    word[k] = bit >> 5;
    sh[k] = static_cast<int>(bit & 31);
  }
  uint32_t lo[EXPAND_VALS], up[EXPAND_VALS];
#pragma unroll
  for (int k = 0; k < EXPAND_VALS; ++k) {
    lo[k] = gather[k] ? load_word(packed, nbytes, word[k]) : 0u;
    up[k] = gather[k] && sh[k] + w > 32
                ? load_word(packed, nbytes, word[k] + 1) : 0u;
  }
  const uint32_t mask = w ? low_mask(w) : 0u;
#pragma unroll
  for (int k = 0; k < EXPAND_VALS; ++k) {
    if (gather[k]) {
      uint32_t x = lo[k] >> sh[k];
      if (sh[k] + w > 32) x |= up[k] << (32 - sh[k]);   // sh > 0 here
      v[k] = static_cast<int32_t>(x & mask);
    }
  }
#pragma unroll
  for (int g = 0; g < EXPAND_VALS; g += 4)
    store4(out, e + g, cap, v + g, true);
}

}  // namespace

extern "C" {

// out may be any 4-byte-aligned int32 array of ncap values (a slice).
int decode_unpack_bits(const void* bytes, long long nbytes, int w,
                       long long ncap, void* out, int device, void* stream) {
  if (ncap <= 0) return 0;
  if (w < 1 || w > 32) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (ncap + UNPACK_VALS - 1) / UNPACK_VALS;
  const int vec_in = reinterpret_cast<uintptr_t>(bytes) % 16 == 0;
  const int vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  unpack_kernel<<<static_cast<unsigned>(blocks), THREADS,
                  UNPACK_VALS / 8 * w, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), nbytes, w, ncap,
      static_cast<int32_t*>(out), vec_in, vec_out);
  return (int)cudaGetLastError();
}

// table: nrows rows of (start, A, C), row_bytes 4 (int32) or 8 (int64);
// out: cap int32 values, 16-byte aligned.
int decode_expand(const void* table, int row_bytes, long long nrows,
                  const void* packed, long long nbytes, int w, long long dlen,
                  long long cap, void* out, int device, void* stream) {
  if (cap <= 0) return 0;
  if ((row_bytes != 4 && row_bytes != 8) || w < 0 || w > 32 || dlen <= 0 ||
      nrows < 0 || nrows > (1LL << 28) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((cap + EXPAND_TILE - 1) / EXPAND_TILE);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  int32_t* o = static_cast<int32_t*>(out);
  if (row_bytes == 4) {
    expand_kernel<int32_t><<<blocks, EXPAND_THREADS, 0, s>>>(
        static_cast<const int32_t*>(table), static_cast<int>(nrows), p,
        nbytes, w, dlen, cap, o);
  } else {
    expand_kernel<int64_t><<<blocks, EXPAND_THREADS, 0, s>>>(
        static_cast<const int64_t*>(table), static_cast<int>(nrows), p,
        nbytes, w, dlen, cap, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
