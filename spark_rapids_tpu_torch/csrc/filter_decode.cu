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
// known, then gathers only the rows that survive it (q6: ~12.5%).
//
// What bounds them on this card.  decode: bytes, then latency.  It must
// read cap keep bytes, the codes of kept rows, each dictionary entry at
// most once, and write cap elements (at cap 2^22, int32: 4.2 + 2.1 + 2.1 +
// 16.8 MB, 7.5 us at 3.35 TB/s).  But a code costs its 32-byte sector: at
// 12.5% random keep about two thirds of the code sectors hold a kept row,
// which puts the floor at ~32 MB (9.6 us; int64 ~49 MB, 14.6 us), and each
// launch and its events cost ~4 us besides.  decode_str: bytes.  At the
// q6s shape (cap 2^22, width 16) the 67 MB it writes take 20 us alone;
// keep and, per kept row, the sectors of lw and byte_base (two thirds of
// them at 12.5% random keep) add ~26 MB: a floor of ~93 MB, 28 us.
//
// What held the first versions back.  decode ran one row per thread: a
// 1-byte keep load, then a dependent code load, then a dependent gather,
// so each thread had one chain of three round trips in flight and int32
// took as long as int64.  decode_str ran one thread per output byte: a
// 64-bit division, fresh loads of keep, lw and byte_base and a 1-byte
// store for every byte (2^26 threads at q6s).
//
// decode.  A lane owns groups of consecutive rows whose outputs fill one
// 16-byte store: 4 rows of 4-byte elements (keep as one 4-byte word, the
// codes as one int4), 2 rows of 8-byte elements (a 2-byte keep word, an
// int2 of codes).  Lanes of a warp take neighbouring groups, so every load
// and store instruction of the warp covers 128 or 64 (keep), 512 or 256
// (codes) and 512 (out) contiguous bytes.  Groups of 4 rows of 8-byte
// elements (two 16-byte stores per lane, each instruction striding over
// 1 KB) measured 0.032 against 0.022 ms at cap 2^22.  Each lane takes
// DECODE_ROWS = 16 rows (4 or 8 groups) per iteration and issues all
// their keep loads, then all their code loads, before any gather, so up
// to 16 gathers are in flight per thread.  A group with no kept row loads
// no codes and no dictionary entry and stores zeros.  The clip is the
// reference's, clip(code, 0, dlen-1).  A keep or codes view that is not
// aligned for the vector load (keep[3:], codes[1:]) is read row by row
// with the same layout; the rows past the last whole group are read and
// written row by row.  The kernel is templated on the element size (4 or
// 8 bytes), so int32/float32 and int64/float64 dictionaries share one
// instance: it copies bits.
//
// The grid, both kernels: blocks of 256 threads covering the work in one
// pass (the grid-stride loops only matter past 2^31 blocks).  A grid
// capped from the SM count, 8 or 4 blocks per SM each looping over the
// rest, measured up to 7% and 11% slower at the q6 shapes
// (filter_decode_variants.py): a resident wave's warps run the same load,
// wait and store phases in step, and the blocks of a one-pass grid start
// and end at staggered times.
//
// decode_str.  A thread owns one aligned 16-byte window of the flat
// [cap*width] output and writes it with one 16-byte store; a window of
// dropped rows reads nothing but keep and stores zeros.  The window's first
// row costs one division (32-bit while cap*width < 2^31, as at every q6
// shape); a window that spans rows walks them (at most two from width 16
// on, sixteen at width 1), loading each row's keep, lw and byte_base once.
// Where a row's live bytes lie in 16-byte blocks wholly inside the
// dictionary buffer, they come from one or two aligned 16-byte loads,
// aligned to the window by funnel shifts; else (a span that crosses either
// end, or an unaligned buffer's first and last block) each byte is read
// with the reference's clip: below 0 reads dbuf[0], past the end
// dbuf[dlen-1].  When width % 16 == 0 and the output is aligned (q6s:
// width 16), a window lies in one row and needs no walk; that kernel takes
// STR_WINDOWS windows per thread, warp-striped, with all their loads
// issued before the stores (the walking kernel measured 15% slower at
// q6s).  An output that does not start on
// 16 bytes, or a byte count that is not a multiple of 16, is covered by
// partial windows at either end, stored byte by byte.
//
// The dictionaries stay in device memory and L2; they are not staged in
// shared memory.  The q6s string dictionary buffer (18,000 x 16 B, padded
// to 4 MiB) is larger than a block's 227 KB of shared memory, and copying
// a 144 KB int dictionary into every block would move more bytes between
// L2 and shared memory than the ~0.5 M kept gathers it replaces, which L2
// (50 MB) serves.  Outputs are stored with the streaming hint (__stcs), so
// they do not evict the dictionary from L2.  The TPU kernels' 2-D (element
// block x dictionary tile) grid is not carried over: any dictionary size
// and any width is taken.
//
// Interface: plain C, loaded with ctypes.  Launches go to the caller's
// stream, nothing synchronises, the caller allocates out (decode's 16-byte
// aligned), and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DECODE_ROWS = 16;   // decode: rows per lane per iteration
constexpr int STR_WINDOWS = 4;    // decode_str, one row per window: windows
                                  // per lane per iteration

// blocks of THREADS threads for n items, items_per_block each: the whole
// work in one pass (the kernels' grid-stride loops only matter past 2^31
// blocks)
unsigned blocks(long long n, long long items_per_block) {
  const long long want = (n + items_per_block - 1) / items_per_block;
  const long long most = INT32_MAX;
  return static_cast<unsigned>(want < 1 ? 1 : (want < most ? want : most));
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// a group: the R = 16 / sizeof(T) consecutive rows of one lane, whose
// outputs are 16 bytes

// keep bytes of rows Rg..Rg+R-1 as one word (byte j: row Rg+j), 0 past cap
template <int R, bool VEC>
__device__ __forceinline__ uint32_t load_keep(const uint8_t* __restrict__ keep,
                                              long long g, long long cap) {
  const long long r = g * R;
  if (r >= cap) return 0;
  if (VEC && r + R <= cap) {
    if constexpr (R == 4)
      return __ldg(reinterpret_cast<const uint32_t*>(keep + r));
    else
      return __ldg(reinterpret_cast<const unsigned short*>(keep + r));
  }
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (r + j < cap && __ldg(keep + r + j)) w |= 1u << (8 * j);
  return w;
}

// codes of the kept rows of group g (the others are not read when the
// group is read row by row)
template <int R, bool VEC>
__device__ __forceinline__ void load_codes(const int32_t* __restrict__ codes,
                                           long long g, long long cap,
                                           uint32_t kw, int32_t* c) {
  const long long r = g * R;
  if (VEC && r + R <= cap) {
    if constexpr (R == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(codes + r));
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
      const int2 v = __ldg(reinterpret_cast<const int2*>(codes + r));
      c[0] = v.x; c[1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    c[j] = ((kw >> (8 * j)) & 0xff) ? __ldg(codes + r + j) : 0;
}

template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ dbuf, int32_t hi,
                                    uint32_t kw, int j, int32_t code) {
  if (!((kw >> (8 * j)) & 0xff)) return 0;
  return __ldg(dbuf + (code < 0 ? 0 : (code > hi ? hi : code)));
}

template <typename T, int R>
__device__ __forceinline__ void store_group(T* __restrict__ out, long long g,
                                            long long cap, const T* v) {
  const long long r = g * R;
  if (r >= cap) return;
  if (r + R <= cap) {
    if constexpr (sizeof(T) == 4) {
      __stcs(reinterpret_cast<uint4*>(out + r),
             make_uint4(v[0], v[1], v[2], v[3]));
    } else {
      __stcs(reinterpret_cast<ulonglong2*>(out + r),
             make_ulonglong2(v[0], v[1]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (r + j < cap) out[r + j] = v[j];
  }
}

// T: uint32_t or unsigned long long; hi = min(dlen - 1, INT32_MAX)
template <typename T, int R, bool KEEP_VEC, bool CODES_VEC>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ dbuf, int32_t hi,
              const int32_t* __restrict__ codes,
              const uint8_t* __restrict__ keep, long long cap,
              T* __restrict__ out) {
  constexpr int DECODE_STEPS = DECODE_ROWS / R;   // groups per lane
  const long long ngroups = (cap + R - 1) / R;
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * WARPS * 32 *
                         DECODE_STEPS;
  for (long long base = (static_cast<long long>(blockIdx.x) * WARPS +
                         threadIdx.x / 32) * 32 * DECODE_STEPS;
       base < ngroups; base += step) {
    uint32_t kw[DECODE_STEPS];
#pragma unroll
    for (int u = 0; u < DECODE_STEPS; ++u)
      kw[u] = load_keep<R, KEEP_VEC>(keep, base + u * 32 + lane, cap);
    int32_t c[DECODE_STEPS][R];
#pragma unroll
    for (int u = 0; u < DECODE_STEPS; ++u) {
      if (kw[u]) {
        load_codes<R, CODES_VEC>(codes, base + u * 32 + lane, cap, kw[u],
                                 c[u]);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) c[u][j] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < DECODE_STEPS; ++u) {
      T v[R];
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = gather(dbuf, hi, kw[u], j, c[u][j]);
      store_group<T, R>(out, base + u * 32 + lane, cap, v);
    }
  }
}

template <typename T, int R, bool KEEP_VEC, bool CODES_VEC>
void launch_decode_as(const void* dbuf, int32_t hi, const int32_t* codes,
                      const uint8_t* keep, long long cap, void* out,
                      cudaStream_t s) {
  decode_kernel<T, R, KEEP_VEC, CODES_VEC>
      <<<blocks(cap, THREADS * DECODE_ROWS), THREADS, 0, s>>>(
          static_cast<const T*>(dbuf), hi, codes, keep, cap,
          static_cast<T*>(out));
}

template <typename T>
void launch_decode(const void* dbuf, int32_t hi, const int32_t* codes,
                   const uint8_t* keep, long long cap, void* out,
                   cudaStream_t s) {
  constexpr int R = 16 / sizeof(T);
  const bool kv = reinterpret_cast<uintptr_t>(keep) % R == 0;
  const bool cv = reinterpret_cast<uintptr_t>(codes) % (4 * R) == 0;
  if (kv && cv)
    launch_decode_as<T, R, true, true>(dbuf, hi, codes, keep, cap, out, s);
  else if (kv)
    launch_decode_as<T, R, true, false>(dbuf, hi, codes, keep, cap, out, s);
  else if (cv)
    launch_decode_as<T, R, false, true>(dbuf, hi, codes, keep, cap, out, s);
  else
    launch_decode_as<T, R, false, false>(dbuf, hi, codes, keep, cap, out,
                                         s);
}

// ---------------------------------------------------------------------------
// decode_str
// ---------------------------------------------------------------------------

// the bytes of word j below byte n of a 16-byte value
__device__ __forceinline__ uint32_t prefix_mask(int n, int j) {
  const int k = n - 4 * j;
  return k <= 0 ? 0u : (k >= 4 ? 0xffffffffu : (1u << (8 * k)) - 1u);
}

// the 16 bytes from address a, from the aligned 16-byte block holding a
// and, when the first n bytes run past it, the next one
__device__ __forceinline__ void load16(uintptr_t a, int n, uint32_t* v) {
  const uint4* p = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int o = static_cast<int>(a & 15);
  const uint4 lo = __ldg(p);
  const uint4 hi = o + n > 16 ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
  uint32_t w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w;
  uint32_t w4 = hi.x, w5 = hi.y, w6 = hi.z, w7 = hi.w;
  if (o & 8) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7; }
  if (o & 4) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; }
  const int s = 8 * (o & 3);
  v[0] = __funnelshift_r(w0, w1, s);
  v[1] = __funnelshift_r(w1, w2, s);
  v[2] = __funnelshift_r(w2, w3, s);
  v[3] = __funnelshift_r(w3, w4, s);
}

// v moved up by b bytes (0..15) within 16, zeros shifted in
__device__ __forceinline__ void shl_bytes(uint32_t* v, int b) {
  uint32_t x0 = v[0], x1 = v[1], x2 = v[2], x3 = v[3];
  if (b & 8) { x3 = x1; x2 = x0; x1 = 0; x0 = 0; }
  if (b & 4) { x3 = x2; x2 = x1; x1 = x0; x0 = 0; }
  const int s = 8 * (b & 3);
  v[0] = __funnelshift_l(0u, x0, s);
  v[1] = __funnelshift_l(x0, x1, s);
  v[2] = __funnelshift_l(x1, x2, s);
  v[3] = __funnelshift_l(x2, x3, s);
}

// ORs into window bytes [b, b + seg) of acc a kept row's columns
// [c, c + seg): dbuf[clip(bb + col)] where col < min(lw, width), else 0
__device__ __forceinline__ void row_bytes(const uint8_t* __restrict__ dbuf,
                                          long long dlen, int32_t bb,
                                          int32_t lw, int width, int c, int b,
                                          int seg, uint32_t* acc) {
  const int live = max(min(lw, width), 0) - c;
  const int n = min(max(live, 0), seg);
  if (n == 0) return;
  const long long s = static_cast<long long>(bb) + c;
  const uintptr_t base = reinterpret_cast<uintptr_t>(dbuf);
  if (s >= 0) {
    const uintptr_t a = base + static_cast<uintptr_t>(s);
    const uintptr_t a0 = a & ~uintptr_t(15);
    const uintptr_t need = (a - a0) + n > 16 ? 32 : 16;
    if (a0 >= base && a0 + need <= base + static_cast<uintptr_t>(dlen)) {
      uint32_t v[4];
      load16(a, n, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] &= prefix_mask(n, j);
      shl_bytes(v, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] |= v[j];
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i >= b && i < b + n) {
      long long idx = s + (i - b);
      idx = idx < 0 ? 0 : (idx >= dlen ? dlen - 1 : idx);
      acc[i >> 2] |= static_cast<uint32_t>(__ldg(dbuf + idx)) << (8 * (i & 3));
    }
  }
}

// width % 16 == 0, out 16-byte aligned: window k lies in row k / (width/16)
template <typename I>
__global__ void __launch_bounds__(THREADS)
decode_str_rows_kernel(const uint8_t* __restrict__ dbuf, long long dlen,
                       const int32_t* __restrict__ byte_base,
                       const int32_t* __restrict__ lw,
                       const uint8_t* __restrict__ keep, int width, I nwin,
                       uint8_t* __restrict__ out) {
  const I per_row = static_cast<I>(width >> 4);
  const int lane = threadIdx.x & 31;
  const I step = static_cast<I>(gridDim.x) * WARPS * 32 * STR_WINDOWS;
  for (I base = (static_cast<I>(blockIdx.x) * WARPS + threadIdx.x / 32) *
                32 * STR_WINDOWS;
       base < nwin; base += step) {
    I row[STR_WINDOWS];
    bool kept[STR_WINDOWS];
#pragma unroll
    for (int u = 0; u < STR_WINDOWS; ++u) {
      const I k = base + u * 32 + lane;
      row[u] = per_row == 1 ? k : k / per_row;
      kept[u] = k < nwin && __ldg(keep + row[u]);
    }
    int32_t len[STR_WINDOWS], bb[STR_WINDOWS];
#pragma unroll
    for (int u = 0; u < STR_WINDOWS; ++u) {
      len[u] = kept[u] ? __ldg(lw + row[u]) : 0;
      bb[u] = kept[u] ? __ldg(byte_base + row[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < STR_WINDOWS; ++u) {
      const I k = base + u * 32 + lane;
      if (k >= nwin) continue;
      uint32_t acc[4] = {0, 0, 0, 0};
      if (kept[u])
        row_bytes(dbuf, dlen, bb[u], len[u], width,
                  16 * static_cast<int>(k - row[u] * per_row), 0, 16, acc);
      __stcs(reinterpret_cast<uint4*>(out) + k,
             make_uint4(acc[0], acc[1], acc[2], acc[3]));
    }
  }
}

// any width and output alignment: window k holds output bytes
// [16k - lead, 16k - lead + 16) clipped to [0, total), and walks its rows
template <typename I>
__global__ void __launch_bounds__(THREADS)
decode_str_walk_kernel(const uint8_t* __restrict__ dbuf, long long dlen,
                       const int32_t* __restrict__ byte_base,
                       const int32_t* __restrict__ lw,
                       const uint8_t* __restrict__ keep, int width, I total,
                       int lead, I nwin, uint8_t* __restrict__ out) {
  const I stride = static_cast<I>(gridDim.x) * THREADS;
  for (I k = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x; k < nwin;
       k += stride) {
    const int first = k == 0 ? lead : 0;
    const I left = total + lead - 16 * k;          // > 0
    const int bend = left < 16 ? static_cast<int>(left) : 16;
    const I t = 16 * k + first - lead;
    I r = t / static_cast<I>(width);
    int c = static_cast<int>(t - r * static_cast<I>(width));
    uint32_t acc[4] = {0, 0, 0, 0};
    for (int b = first; b < bend; ++r, c = 0) {
      const int seg = min(bend - b, width - c);
      if (__ldg(keep + r))
        row_bytes(dbuf, dlen, __ldg(byte_base + r), __ldg(lw + r), width, c,
                  b, seg, acc);
      b += seg;
    }
    uint8_t* dst = out + (static_cast<long long>(16 * k) - lead);
    if (first == 0 && bend == 16) {
      __stcs(reinterpret_cast<uint4*>(dst),
             make_uint4(acc[0], acc[1], acc[2], acc[3]));
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i >= first && i < bend)
          dst[i] = static_cast<uint8_t>(acc[i >> 2] >> (8 * (i & 3)));
    }
  }
}

template <typename I>
void launch_decode_str(const uint8_t* dbuf, long long dlen,
                       const int32_t* byte_base, const int32_t* lw,
                       const uint8_t* keep, long long total, int width,
                       int lead, uint8_t* out, cudaStream_t s) {
  const long long nwin = (total + lead + 15) / 16;
  if (width % 16 == 0 && lead == 0) {
    decode_str_rows_kernel<I>
        <<<blocks(nwin, THREADS * STR_WINDOWS), THREADS, 0, s>>>(
            dbuf, dlen, byte_base, lw, keep, width, static_cast<I>(nwin),
            out);
  } else {
    decode_str_walk_kernel<I><<<blocks(nwin, THREADS), THREADS, 0, s>>>(
        dbuf, dlen, byte_base, lw, keep, width, static_cast<I>(total), lead,
        static_cast<I>(nwin), out);
  }
}

}  // namespace

extern "C" {

// elem_size: 4 or 8 (bytes per dictionary element); out 16-byte aligned
int filter_decode(int elem_size, const void* dbuf, long long dlen,
                  const int32_t* codes, const uint8_t* keep, long long cap,
                  void* out, int device, void* stream) {
  if (cap <= 0) return 0;
  if (dlen <= 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // int32 codes never exceed INT32_MAX: a longer dictionary clips there
  const int32_t hi = static_cast<int32_t>(
      dlen - 1 < INT32_MAX ? dlen - 1 : INT32_MAX);
  if (elem_size == 4)
    launch_decode<uint32_t>(dbuf, hi, codes, keep, cap, out, s);
  else if (elem_size == 8)
    launch_decode<unsigned long long>(dbuf, hi, codes, keep, cap, out, s);
  else
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = cap * width;
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(out) & 15);
  if (total + 32 < (1LL << 31))
    launch_decode_str<unsigned>(dbuf, dlen, byte_base, lw, keep, total, width,
                                lead, out, s);
  else
    launch_decode_str<unsigned long long>(dbuf, dlen, byte_base, lw, keep,
                                          total, width, lead, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
