// Segmented inclusive scan with a fused gather, for Hopper (sm_90a): one
// launch per call, a single pass with a deterministic decoupled look-back.
//
// Replaces the TPU kernel spark_rapids_tpu/kernels/segreduce.py: both of its
// entry points, seg_scan_sorted (_seg_kernel) and gather_seg_scan
// (_seg_gather_kernel), reach one pallas_call in _run.  It computes
//
//     y[k] = op-scan of cast(x[order[k]])  (or of cast(x[k]) when order is
//            null), restarting wherever flags[k] is set,
//
// for op in {add, min, max}; the caller supplies the op's identity, which
// only pads the last tile.  The sorted-key aggregate (exec/tpu_aggregate.py)
// then reads y at each group's last row.
//
// What bounds it: per element it reads 4 B of order, 1 B of flags and one
// gathered value of sizeof(TIn), and writes sizeof(TOut), with one op of
// arithmetic, so the bytes bound it.  At the capacities the aggregate's
// updates use (2^18 and 2^20 rows: 0.7-5.5 MB, 0.2-1.7 us at 3.35 TB/s) the
// launch and the latency of one tile's dependent loads (order, then the
// gather) cost more than the bytes; at the merge's 2^24 rows the bytes
// dominate.  So the design makes one launch and one pass, keeps every load
// coalesced and many in flight, and moves each byte once.
//
//   * One launch.  Each block takes its tile number from a device-wide
//     counter, not from blockIdx, so it only waits on tiles that have
//     already started: forward progress without assuming co-residency.
//   * A tile is 8 warps x 32 lanes x ITEMS rows (ITEMS = 16 for outputs of
//     up to 4 bytes, 8 for 8-byte outputs).  A warp owns 32 x ITEMS
//     consecutive elements as ITEMS rows of 32; lane l holds element l of
//     each row.  So every load, gather and store of a warp touches 32
//     consecutive elements, and a sorted gather reads whole sectors.
//     (ITEMS consecutive elements per thread, loaded as 16-byte vectors,
//     make each warp's gather and store touch 4x the sectors: measured
//     slower than the old three-phase kernel at 2^24 rows, PERF.md.)  All
//     of a thread's loads are issued before any is used.
//   * The scan needs no shared-memory exchange, hence no bank conflicts:
//     each row is scanned across lanes by shuffles, restarting at the row's
//     last flag at or before the lane (one ballot of the row's flags); the
//     rows and then the warps are folded in order.
//   * Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
//     Scan with Decoupled Look-back", 2016).  A tile that holds a flag (and
//     tile 0) publishes its inclusive prefix at once: its aggregate is that
//     prefix.  Any other tile publishes its aggregate, looks back, then
//     publishes its inclusive prefix.  Warp 0 reads 128 predecessors per
//     round trip; the nearest published prefix ends the look-back: one step
//     when every tile holds a group start (q6's short groups), a few when a
//     segment spans hundreds of tiles (q6's sorted-last padding rows).
//   * Deterministic float sums.  A tile's inclusive prefix is the left fold
//     P_j = P_{j-1} op a_j, restarting at a tile with a flag.  The look-back
//     folds the aggregates after the prefix it found forward, one by one,
//     from that prefix, so whichever prefix it finds the result is the same
//     left fold, bit for bit.  The in-tile tree is fixed.  So every call
//     returns the same bits; integers, min and max are exact anyway.
//   * Memory ordering without fences: every 64-bit word of the look-back
//     state carries a 32-bit tag (the call's epoch and the kind, aggregate
//     or prefix) beside 32 bits of value, and is written and read whole
//     (relaxed atomics at device scope).  A value is valid when all its
//     words carry the expected tag, so no store needs to be ordered before
//     another, and no acquire load invalidates the SM's L1.
//   * No reset per call.  Tags carry the call's epoch (the wrapper keeps one
//     state buffer per device and stream and counts its calls), so a word of
//     an earlier call reads as empty; the block that takes the last tile
//     puts the counter back to 0.  A call costs no memset and no second
//     launch, at any capacity.
//
// Float sums use another reduction tree than the reference's
// jax.lax.associative_scan, so they agree to rounding, not bit for bit.
// Integers (wrapping) and min/max agree exactly; min and max propagate NaN;
// uint64 compares unsigned.
//
// Interface: plain C, loaded with ctypes.  The launch goes to the caller's
// stream and nothing synchronises; the caller allocates y and the state
// (segreduce_state_bytes) and passes the call's epoch.  The entry point
// returns cudaGetLastError().

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// predecessors warp 0 reads per look-back round trip: LB_K per lane
constexpr int LB_K = 4;
constexpr int LB_SPAN = 32 * LB_K;
// a look-back that waits this many rounds has lost a predecessor: trap
// (a launch error) rather than hang the card
constexpr long long SPIN_LIMIT = 1LL << 26;

template <typename TOut>
__host__ __device__ constexpr int items_of() {
  return sizeof(TOut) <= 4 ? 16 : 8;
}

enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };

// dtype codes shared with kernels/segreduce.py
enum {
  DT_BOOL = 0, DT_INT8 = 1, DT_INT16 = 2, DT_INT32 = 3, DT_INT64 = 4,
  DT_UINT8 = 5, DT_UINT64 = 6, DT_FLOAT32 = 7, DT_FLOAT64 = 8
};

// the kind of a published value (the low two bits of a word's tag, the
// call's epoch above them); EMPTY: nothing of this call yet
enum : uint32_t { ST_EMPTY = 0, ST_AGG = 1, ST_PREFIX = 2 };

using ull = unsigned long long;
using dev_u64 = cuda::atomic_ref<ull, cuda::thread_scope_device>;

// the state buffer: the tile counter (16 B), then per tile 4 words of 8 B:
// its prefix and its aggregate, each in one word (outputs of up to 4 bytes)
// or two (8-byte outputs: low, then high 32 bits)
struct State {
  uint32_t* counter;
  ull* words;
};

template <typename TOut>
__device__ __forceinline__ constexpr int words_of() {
  return sizeof(TOut) <= 4 ? 1 : 2;
}

template <typename T>
__device__ __forceinline__ ull to_bits(T v) {
  ull u = 0;
  memcpy(&u, &v, sizeof(T));
  return u;
}

template <typename T>
__device__ __forceinline__ T from_bits(ull u) {
  T v;
  memcpy(&v, &u, sizeof(T));
  return v;
}

template <typename TOut>
__device__ __forceinline__ void publish(const State& s, long long t,
                                        uint32_t epoch, uint32_t kind,
                                        TOut v) {
  constexpr int W = words_of<TOut>();
  ull* w = s.words + 4 * t + (kind == ST_PREFIX ? 0 : 2);
  const ull tag = (ull)((epoch << 2) | kind) << 32;
  const ull bits = to_bits(v);
#pragma unroll
  for (int i = 0; i < W; ++i)
    dev_u64(w[i]).store(tag | ((bits >> (32 * i)) & 0xffffffffull),
                        cuda::memory_order_relaxed);
}

// tile t's kind: its prefix if published, else its aggregate if published,
// else ST_EMPTY; v receives the value
template <typename TOut>
__device__ __forceinline__ uint32_t read_tile(const State& s, long long t,
                                              uint32_t epoch, TOut& v) {
  constexpr int W = words_of<TOut>();
  ull* w = s.words + 4 * t;
  ull p[W], a[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    p[i] = dev_u64(w[i]).load(cuda::memory_order_relaxed);
    a[i] = dev_u64(w[2 + i]).load(cuda::memory_order_relaxed);
  }
  const ull tp = (ull)((epoch << 2) | ST_PREFIX);
  const ull ta = (ull)((epoch << 2) | ST_AGG);
  bool pv = true, av = true;
  ull pb = 0, ab = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    pv &= (p[i] >> 32) == tp;
    av &= (a[i] >> 32) == ta;
    pb |= (p[i] & 0xffffffffull) << (32 * i);
    ab |= (a[i] & 0xffffffffull) << (32 * i);
  }
  if (pv) {
    v = from_bits<TOut>(pb);
    return ST_PREFIX;
  }
  if (av) {
    v = from_bits<TOut>(ab);
    return ST_AGG;
  }
  return ST_EMPTY;
}

// tile t's aggregate, known to be published (its prefix may be too)
template <typename TOut>
__device__ __forceinline__ TOut aggregate_of(const State& s, long long t) {
  constexpr int W = words_of<TOut>();
  ull* w = s.words + 4 * t + 2;
  ull b = 0;
#pragma unroll
  for (int i = 0; i < W; ++i)
    b |= (dev_u64(w[i]).load(cuda::memory_order_relaxed) & 0xffffffffull)
         << (32 * i);
  return from_bits<TOut>(b);
}

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  if constexpr (std::is_floating_point<T>::value) return v != v;
  return false;
}

// jnp.add (wrapping for integers) / jnp.minimum / jnp.maximum: min and max
// propagate NaN
template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  if constexpr (OP == OP_ADD) {
    if constexpr (std::is_integral<T>::value) {
      using U = std::make_unsigned_t<T>;
      return static_cast<T>(static_cast<U>(static_cast<U>(a) +
                                           static_cast<U>(b)));
    } else {
      return a + b;
    }
  } else {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    if constexpr (OP == OP_MIN) return b < a ? b : a;
    return a < b ? b : a;
  }
}

// 1- and 2-byte integers travel widened
template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  if constexpr (sizeof(T) < 4)
    return static_cast<T>(__shfl_up_sync(FULL, static_cast<int>(v), d));
  else
    return __shfl_up_sync(FULL, v, d);
}

template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int src) {
  if constexpr (sizeof(T) < 4)
    return static_cast<T>(__shfl_sync(FULL, static_cast<int>(v), src));
  else
    return __shfl_sync(FULL, v, src);
}

// jnp.take never faults: wrap a negative index, clamp the rest
__device__ __forceinline__ long long source_of(int32_t o, long long n_src) {
  long long s = o;
  if (s < 0) s += n_src;
  return s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
}

// acc op each value of v[k] on lanes (oldest first) whose distance
// k*32 + lane from the newest tile is below `below`; uniform in the warp
template <typename TOut, int OP>
__device__ __forceinline__ TOut fold_span(TOut acc, const TOut (&v)[LB_K],
                                          int below) {
#pragma unroll
  for (int k = LB_K - 1; k >= 0; --k) {
    if (k * 32 >= below) continue;
#pragma unroll
    for (int i = 31; i >= 0; --i) {
      const TOut vi = shfl_idx(v[k], i);
      if (k * 32 + i < below) acc = apply<TOut, OP>(acc, vi);
    }
  }
  return acc;
}

// Warp 0 of tile `tile` (> 0): the inclusive prefix of tile - 1.  Reads
// predecessors LB_SPAN at a time (a span: tile base - d for distance
// d = k*32 + lane) until it finds the nearest published prefix with every
// nearer tile's aggregate published, then folds those aggregates forward
// from that prefix, oldest first.  Every lane returns the same value.
template <typename TOut, int OP>
__device__ __forceinline__ TOut look_back(const State& s, long long tile,
                                          uint32_t epoch, int lane,
                                          TOut ident) {
  long long base = tile - 1;
  TOut v[LB_K];
  int near = -1;  // distance of the nearest prefix in the last span read
  long long spins = 0;
  for (;;) {
    for (;;) {
      uint32_t st[LB_K];
#pragma unroll
      for (int k = 0; k < LB_K; ++k) {
        const long long t = base - (k * 32 + lane);
        v[k] = ident;
        // a lane before tile 0 counts as published, never as the prefix
        st[k] = t >= 0 ? read_tile(s, t, epoch, v[k]) : ST_AGG;
      }
      unsigned blocked = 0;
      near = -1;
#pragma unroll
      for (int k = 0; k < LB_K; ++k) {
        const unsigned pre = __ballot_sync(FULL, st[k] == ST_PREFIX);
        const unsigned empty = __ballot_sync(FULL, st[k] == ST_EMPTY);
        if (near < 0) {
          // the tiles nearer than the nearest prefix must all be published
          blocked |= pre ? empty & ((pre & (0u - pre)) - 1u) : empty;
          if (pre) near = k * 32 + __ffs(pre) - 1;
        }
      }
      if (!blocked) break;
      if (++spins > SPIN_LIMIT) __trap();
    }
    if (near >= 0) break;
    base -= LB_SPAN;
  }
  TOut acc = ident;
#pragma unroll
  for (int k = 0; k < LB_K; ++k)
    if (near / 32 == k) acc = shfl_idx(v[k], near % 32);
  acc = fold_span<TOut, OP>(acc, v, near);
  // spans read before the last one, oldest first: their aggregates, read
  // again (a published value never changes within a call; a tile may have
  // published its prefix since, which must not be folded in)
  for (long long b = base + LB_SPAN; b < tile; b += LB_SPAN) {
#pragma unroll
    for (int k = 0; k < LB_K; ++k)
      v[k] = aggregate_of<TOut>(s, b - (k * 32 + lane));
    acc = fold_span<TOut, OP>(acc, v, LB_SPAN);
  }
  return acc;
}

template <typename TIn, typename TOut, int OP>
__global__ void __launch_bounds__(THREADS)
seg_scan_onepass(const TIn* __restrict__ x, long long n_src,
                 const int32_t* __restrict__ order,
                 const uint8_t* __restrict__ flags, TOut* __restrict__ y,
                 long long n, TOut ident, State s, uint32_t epoch,
                 long long n_tiles) {
  constexpr int ITEMS = items_of<TOut>();
  constexpr int SPAN = 32 * ITEMS;  // elements per warp
  constexpr int TILE = WARPS * SPAN;
  __shared__ TOut warp_v[WARPS];
  __shared__ int warp_f[WARPS];
  __shared__ long long s_tile;
  __shared__ TOut s_carry;
  __shared__ int s_has_carry;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    const long long t = atomicAdd(s.counter, 1u);
    if (t == n_tiles - 1) atomicExch(s.counter, 0u);  // the last tile taken
    s_tile = t;
  }
  __syncthreads();
  const long long tile = s_tile;
  // row i of this warp: elements w0 + i*32 + lane
  const long long w0 = tile * TILE + (long long)warp * SPAN + lane;

  // every load is issued before any is used; rows past n are (no flag,
  // identity) and never stored
  TOut v[ITEMS];
  unsigned fm[ITEMS];  // per row: the ballot of its flags
  {
    uint8_t f[ITEMS];
    TIn g[ITEMS];
    if (tile * TILE + (long long)(warp + 1) * SPAN <= n) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) f[i] = flags[w0 + i * 32];
      if (order != nullptr) {
        int32_t o[ITEMS];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) o[i] = order[w0 + i * 32];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) g[i] = x[source_of(o[i], n_src)];
      } else {
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) g[i] = x[w0 + i * 32];
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) v[i] = static_cast<TOut>(g[i]);
    } else {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const long long k = w0 + i * 32;
        f[i] = 0;
        v[i] = ident;
        if (k < n) {
          f[i] = flags[k];
          v[i] = static_cast<TOut>(
              x[order != nullptr ? source_of(order[k], n_src) : k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) fm[i] = __ballot_sync(FULL, f[i] != 0);
  }

  // each row: inclusive scan across lanes from the row's last flag at or
  // before the lane (lo), by shuffles
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int last = 31 - __clz(fm[i] & upto);  // -1: no flag
    const int lo = last > 0 ? last : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const TOut o = shfl_up(v[i], d);
      if (lane - d >= lo) v[i] = apply<TOut, OP>(o, v[i]);
    }
  }
  // the warp aggregate: the rows folded in order
  {
    int wf = fm[0] != 0;
    TOut wv = shfl_idx(v[0], 31);
#pragma unroll
    for (int i = 1; i < ITEMS; ++i) {
      const TOut r = shfl_idx(v[i], 31);
      wv = fm[i] ? r : apply<TOut, OP>(wv, r);
      wf |= fm[i] != 0;
    }
    if (lane == 0) {
      warp_v[warp] = wv;
      warp_f[warp] = wf;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // the tile aggregate, folded over the warps in order
    int af = warp_f[0];
    TOut av = warp_v[0];
    for (int w = 1; w < WARPS; ++w) {
      av = warp_f[w] ? warp_v[w] : apply<TOut, OP>(av, warp_v[w]);
      af |= warp_f[w];
    }
    if (lane == 0)
      publish(s, tile, epoch, (tile == 0 || af) ? ST_PREFIX : ST_AGG, av);
    // rows before the tile's first flag need P_{tile-1}
    const bool carry = tile > 0 && !(fm[0] & 1u);
    if (carry) {
      const TOut c = look_back<TOut, OP>(s, tile, epoch, lane, ident);
      if (lane == 0) {
        if (!af) publish(s, tile, epoch, ST_PREFIX, apply<TOut, OP>(c, av));
        s_carry = c;
      }
    }
    if (lane == 0) s_has_carry = carry;
  }
  __syncthreads();

  // the prefix entering this warp: the carry, then the earlier warps
  bool has = s_has_carry;
  TOut p = has ? s_carry : ident;
  for (int w = 0; w < warp; ++w) {
    p = (has && !warp_f[w]) ? apply<TOut, OP>(p, warp_v[w]) : warp_v[w];
    has = true;
  }
  // then row by row: a lane with no flag at or before it in its row takes
  // the prefix of the rows before
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const TOut r = shfl_idx(v[i], 31);
    if (has && !(fm[i] & upto)) v[i] = apply<TOut, OP>(p, v[i]);
    p = (has && !fm[i]) ? apply<TOut, OP>(p, r) : r;
    has = true;
  }

#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (w0 + i * 32 < n) y[w0 + i * 32] = v[i];
}

template <typename TIn, typename TOut, int OP>
int run(const void* x, long long n_src, const int32_t* order,
        const uint8_t* flags, void* y, long long n, ull ident_bits,
        void* state, long long state_tiles, uint32_t epoch,
        cudaStream_t stream) {
  constexpr int TILE = THREADS * items_of<TOut>();
  const long long nb = (n + TILE - 1) / TILE;
  if (nb > state_tiles || epoch == 0 || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  TOut ident;
  memcpy(&ident, &ident_bits, sizeof(TOut));
  char* b = static_cast<char*>(state);
  const State s{reinterpret_cast<uint32_t*>(b),
                reinterpret_cast<ull*>(b + 16)};
  seg_scan_onepass<TIn, TOut, OP><<<(unsigned)nb, THREADS, 0, stream>>>(
      static_cast<const TIn*>(x), n_src, order, flags,
      static_cast<TOut*>(y), n, ident, s, epoch, nb);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int run_op(int op, const void* x, long long n_src, const int32_t* order,
           const uint8_t* flags, void* y, long long n, ull ident_bits,
           void* state, long long state_tiles, uint32_t epoch,
           cudaStream_t s) {
  switch (op) {
    case OP_ADD:
      return run<TIn, TOut, OP_ADD>(x, n_src, order, flags, y, n,
                                    ident_bits, state, state_tiles, epoch, s);
    case OP_MIN:
      return run<TIn, TOut, OP_MIN>(x, n_src, order, flags, y, n,
                                    ident_bits, state, state_tiles, epoch, s);
    case OP_MAX:
      return run<TIn, TOut, OP_MAX>(x, n_src, order, flags, y, n,
                                    ident_bits, state, state_tiles, epoch, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// elements per tile for an output of out_size bytes
int segreduce_tile(int out_size) {
  return THREADS * (out_size <= 4 ? 16 : 8);
}

long long segreduce_state_bytes(long long tiles) { return 16 + 32 * tiles; }

// in_code/out_code: the DT_* codes above; order may be null (sorted path);
// state holds state_tiles tiles, epoch is in [1, 2^30) and new for each call
// on this state
int segreduce_scan(int in_code, int out_code, int op, const void* x,
                   long long n_src, const int32_t* order,
                   const uint8_t* flags, void* y, long long n,
                   unsigned long long ident_bits, void* state,
                   long long state_tiles, unsigned epoch, int device,
                   void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEG_CASE(IC, OC, TI, TO)                                           \
  if (in_code == IC && out_code == OC)                                     \
    return run_op<TI, TO>(op, x, n_src, order, flags, y, n, ident_bits,    \
                          state, state_tiles, epoch, s);
  SEG_CASE(DT_INT8, DT_INT8, int8_t, int8_t)
  SEG_CASE(DT_INT16, DT_INT16, int16_t, int16_t)
  SEG_CASE(DT_INT32, DT_INT32, int32_t, int32_t)
  SEG_CASE(DT_INT64, DT_INT64, int64_t, int64_t)
  SEG_CASE(DT_UINT64, DT_UINT64, uint64_t, uint64_t)
  SEG_CASE(DT_FLOAT32, DT_FLOAT32, float, float)
  SEG_CASE(DT_FLOAT64, DT_FLOAT64, double, double)
  SEG_CASE(DT_BOOL, DT_INT32, uint8_t, int32_t)
  SEG_CASE(DT_INT8, DT_INT64, int8_t, int64_t)
  SEG_CASE(DT_INT16, DT_INT64, int16_t, int64_t)
  SEG_CASE(DT_INT32, DT_INT64, int32_t, int64_t)
  SEG_CASE(DT_UINT8, DT_UINT64, uint8_t, uint64_t)
  SEG_CASE(DT_FLOAT32, DT_FLOAT64, float, double)
#undef SEG_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
