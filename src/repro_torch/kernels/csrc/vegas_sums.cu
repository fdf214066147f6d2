// VEGAS sample reductions for Hopper (sm_90a): per-cube and per-bin sums in
// a fixed order.
//
// Replaces the three jax.ops.segment_sum of `shard_accumulate` in
// src/repro/mc/engine.py:196-202 (plain XLA there, not a Pallas kernel).
// For every problem p and sample shard s of an iteration it writes
//   s1[p, s, k]    = sum of w            over the shard's samples in cube k,
//   s2[p, s, k]    = sum of w * w        over the same samples,
//   g[p, s, i, b]  = sum of w * w        over the shard's samples whose
//                    axis-i coordinate y falls in importance-grid bin b.
// PyTorch's index_add_ / scatter_add_ add with atomics on the card, so
// their float sums change from run to run.  Here every sum has one fixed
// order, a function of the shard's values alone: the same bits on every
// run and at every rank count (a rank launches for its own shards), and the
// bits of the plain version (vegas_sums.py), whose index_add_ adds in
// sample order on the CPU.
//
// The order: a shard is cut into chunks of kChunk samples (the last one
// shorter).  Within a chunk each sum runs left to right in sample order,
// from +0; the chunk partials of a sum are then added left to right,
// starting from +0.  A shard of at most kChunk samples is therefore summed
// strictly in sample order, as the reference's segment_sum does.
//
// Layout: w (P, n) and y (d, P, n) hold the n = n_shards * Ns samples of
// the caller's shards in global index order (shard shard0 first); cum
// (P, M) is each problem's cumulative per-cube counts over the whole
// iteration.  The samples of cube k are the global indices
// [cum[k-1], cum[k]): one contiguous run, so a chunk meets a contiguous
// range of cubes, each in one contiguous piece (at most kChunk of them).
//
// What bounds it on the H100: bytes, at best.  It reads w and y once
// (8 (d + 1) bytes per sample in float64; y is 15/16 of them at d = 15)
// and writes a few MB.  Its shared-memory traffic comes next: the sort's
// scatter and the sums' gathers are random accesses, which meet bank
// conflicts and share the load/store pipe with the loads of y.  Design,
// two launches:
//   1. vegas_sums_chunks, one block per (problem, shard, chunk).  The block
//      stages the chunk's w * w in shared memory under the first loads of
//      y; after that one barrier each warp works alone on axes warp,
//      warp + 8, ..., so the loads of some warps overlap the sorting and
//      adding of others.  Per axis:
//      - its row of y is read with 16-byte streaming loads (kBatch in
//        flight per lane); each sample's bin goes to the warp's shared
//        memory (2 bytes) and is counted, with an integer shared atomic
//        (exact in any order), in a (bin, run) table: run r is the 32
//        consecutive samples [32 r, 32 r + 32), and lane r owns it below;
//      - the chunk's sample indices are sorted by bin, stably, by a
//        counting sort: lane l reads the rows of bins l and l + 32, and the
//        table's exclusive scan in (bin, run) order (each bin's start
//        rounded up to even) turns each cell into its run's first slot in
//        its bin; then each lane walks its run in sample order and places
//        each sample at its bin's next slot of its run.  Every step is one
//        lane's own work: no lane waits for another;
//      - lane l adds the w * w of the runs of bins l and l + 32 of the
//        sorted order, which is sample order, from +0, side by side, two
//        indices a read.  This is d * len adds per chunk, where a scan per
//        (axis, bin) would do d * nb * len.
//      Up to kDigits bins a bin is one 6-bit digit.  Above, the bins are
//      sorted in stable 6-bit digit passes, least significant first (up to
//      three for 65535 bins), and the lane at the head of each run of
//      equal bins adds the run; the row's other bins are zeroed first.
//      The per-sample arrays are rotated within each 32-entry row (swz) and
//      the table's columns by row, so that lanes walking their runs, and
//      lanes scanning their rows, meet distinct banks.
//      The last warp then finds the chunk's cube range (a 16-ary search of
//      cum by each half warp) and adds each cube piece in order.
//      Chunk partials go to scratch (P, S, C, kChunk) and (P, S, C, d, nb).
//   2. vegas_sums_combine, one thread per output adds its chunk partials in
//      chunk order; the bin outputs, whose chains are C long, come first in
//      the grid and load kAhead partials ahead of their adds.
// The library is built with -fmad=false, so w * w and the adds round as
// the plain version's.  The bin of y is static_cast<long long>(y * nb)
// clipped to [0, nb), as the plain version's; a NaN falls in bin 0 on the
// card and on the CPU (|y * nb| >= 2^63 would not: the card saturates).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 1024;  // samples per chunk: the sums' fixed grouping
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // 16-byte loads of y in flight per lane
constexpr int kDigitBits = 6;  // a digit is 64 bins: two per lane
constexpr int kDigits = 1 << kDigitBits;
constexpr int kCombineThreads = 64;
constexpr int kAhead = 32;  // chunk partials a bin output loads ahead of its adds
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  long long P, n_shards, Ns, shard0, M, C;
  int d, nb;
  const void* w;
  const void* y;
  const long long* cum;
  void* part1;  // (P, S, C, kChunk): per-piece sums of w
  void* part2;  // (P, S, C, kChunk): per-piece sums of w * w
  long long* kfirst;  // (P, S, C): the cube of each chunk's first sample
  void* partg;  // (P, S, C, d, nb): per-chunk bin sums
  void* s1;
  void* s2;
  void* g;
  int vec;  // 1: w and y rows are 16-byte aligned and Ns a multiple of 16 bytes
};

// 16-byte vectors of T
template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<float> {
  using type = float4;
};

// Shared memory of a chunk block: w * w; per warp the bins, the sorted
// order (the many-bin path: two orders, the passes alternate; the one-pass
// order holds a spare slot after each odd-sized bin) and the (digit, run)
// table.
template <typename T>
__host__ __device__ constexpr int smem_bytes(bool many) {
  return kChunk * sizeof(T) +
         kWarps * 2 * (kChunk + (many ? 2 : 1) * (kChunk + kDigits) + kDigits * 32);
}

// Where entry j of a per-sample array lives: rotated within its row of 32
// by two entries per pair of rows, so that 32 lanes reading entry t of
// runs 32 l + t meet 32 banks, as do lanes storing pairs 2 l, 2 l + 1.
__device__ __forceinline__ int swz(int j) { return (j & ~31) | ((j + ((j >> 6) << 1)) & 31); }

// Where (digit b, lane c) of the table lives: columns rotated by row, so
// that lanes scanning rows l (or l + 32) meet 32 banks.
__device__ __forceinline__ int cell(int b, int c) { return b * 32 + (c ^ (b & 30)); }

__device__ __forceinline__ unsigned short bin_of(double yv, double scale, int nb) {
  long long b = static_cast<long long>(yv * scale);  // truncation toward zero
  b = b < 0 ? 0 : (b > nb - 1 ? nb - 1 : b);
  return static_cast<unsigned short>(b);
}
__device__ __forceinline__ unsigned short bin_of(float yv, float scale, int nb) {
  long long b = static_cast<long long>(yv * scale);
  b = b < 0 ? 0 : (b > nb - 1 ? nb - 1 : b);
  return static_cast<unsigned short>(b);
}

// The first k in [0, M) with cum[k] > idx (M if none), by the 16 lanes of
// one half warp (`g` its lane in the half, `mask` its lanes): each step
// probes 16 evenly spaced entries and keeps the interval between the last
// probe <= idx and the first one above it.
__device__ long long cube_of16(const long long* cum, long long M, long long idx, int g,
                               unsigned mask) {
  long long lo = 0, hi = M;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 15) / 16;
    const long long q = lo + (g + 1) * step - 1;
    const bool below = q < hi && cum[q] <= idx;
    const int f = __popc(__ballot_sync(mask, below));  // the probes <= idx: a prefix
    const long long top = lo + (f + 1) * step - 1;
    lo += f * step;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// By one warp, from the (digit, run) table: lane l's n0 and n1 are the
// sample counts of digits l and l + 32, r0 and r1 their first slots (the
// exclusive prefix sums of the counts in digit order, each count rounded
// up to even if `even`, so that every digit starts on a 32-bit word); the
// table's cells become each run's first slot in its digit.  Lane l reads
// its two rows once: runs 2m and 2m + 1 share a 32-bit word (the row's
// rotation moves pairs whole).
__device__ __forceinline__ void warp_slots(unsigned short* tab, int lane, bool even, int& n0,
                                           int& n1, int& r0, int& r1) {
  __syncwarp();
  unsigned* const row0 = reinterpret_cast<unsigned*>(tab) + lane * 16;
  unsigned* const row1 = row0 + 32 * 16;
  const int rot = (lane & 30) >> 1;  // the same for rows l and l + 32
  unsigned v0[16], v1[16], s0 = 0, s1 = 0;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    v0[m] = row0[m ^ rot];
    v1[m] = row1[m ^ rot];
    s0 += v0[m];  // the halves cannot carry: at most 512 each
    s1 += v1[m];
  }
  n0 = static_cast<int>((s0 & 0xffffu) + (s0 >> 16));
  n1 = static_cast<int>((s1 & 0xffffu) + (s1 >> 16));
  const int p0 = even ? (n0 + 1) & ~1 : n0, p1 = even ? (n1 + 1) & ~1 : n1;
  int i0 = p0, i1 = p1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t0 = __shfl_up_sync(kFull, i0, o), t1 = __shfl_up_sync(kFull, i1, o);
    if (lane >= o) {
      i0 += t0;
      i1 += t1;
    }
  }
  r0 = i0 - p0;
  r1 = __shfl_sync(kFull, i0, 31) + i1 - p1;
  unsigned b0 = r0, b1 = r1;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    row0[m ^ rot] = b0 | ((b0 + (v0[m] & 0xffffu)) << 16);
    row1[m ^ rot] = b1 | ((b1 + (v1[m] & 0xffffu)) << 16);
    b0 += (v0[m] & 0xffffu) + (v0[m] >> 16);
    b1 += (v1[m] & 0xffffu) + (v1[m] >> 16);
  }
  __syncwarp();
}

// Adds one to (digit b, run r) of the table from any lane: the 32-bit
// atomic on the pair of 16-bit cells that holds it (a cell counts at most
// 32 samples, so it never carries into its neighbour).
__device__ __forceinline__ void tab_add(unsigned short* tab, int b, int r) {
  const int at = cell(b, r);
  atomicAdd(reinterpret_cast<unsigned*>(tab) + (at >> 1), 1u << ((at & 1) << 4));
}

// By one warp: a stable scatter of the len entries of `order` (sample
// order if null) by the digit (key >> shift) & 63 of their samples into
// out (at swz(slot) if `swz_out`, for a later pass), from the table of
// first slots.  Lane l owns run l: entries [32 l, 32 l + 32).
__device__ void warp_scatter(const unsigned short* key, const unsigned short* order,
                             unsigned short* out, unsigned short* tab, int len, int shift,
                             bool swz_out, int lane) {
  const int k0 = lane * 32;
  const int k1 = k0 + 32 < len ? k0 + 32 : len;
  auto place = [&](int j, unsigned b) {
    const int at = cell((b >> shift) & (kDigits - 1), lane);
    const int slot = tab[at];
    tab[at] = static_cast<unsigned short>(slot + 1);
    out[swz_out ? swz(slot) : slot] = static_cast<unsigned short>(j);
  };
  if (order) {
    for (int k = k0; k < k1; ++k) {
      const int j = order[swz(k)];
      place(j, key[swz(j)]);
    }
  } else {  // sample order: two bins a read (a pair stays adjacent under swz)
    for (int k = k0; k < k1; k += 2) {
      const unsigned pair = *reinterpret_cast<const unsigned*>(key + swz(k));
      place(k, pair & 0xffffu);
      if (k + 1 < k1) place(k + 1, pair >> 16);
    }
  }
  __syncwarp();
}

// By one warp: the table of a later pass, counted from `order` (the
// previous pass's, at swz): lane l counts its own run into its column.
__device__ void warp_count(const unsigned short* key, const unsigned short* order,
                           unsigned short* tab, int len, int shift, int lane) {
  const int k0 = lane * 32;
  const int k1 = k0 + 32 < len ? k0 + 32 : len;
  for (int b = 0; b < kDigits; ++b) tab[cell(b, lane)] = 0;
  for (int k = k0; k < k1; ++k) ++tab[cell((key[swz(order[swz(k)])] >> shift) & (kDigits - 1), lane)];
}

template <typename T, bool kMany>
__global__ void __launch_bounds__(kThreads, 3) vegas_sums_chunks(Args a) {
  using V = typename Vec16<T>::type;
  constexpr int kVec = sizeof(V) / sizeof(T);
  constexpr int kOrders = kMany ? 2 : 1;
  constexpr int kWarpShorts = kChunk + kOrders * (kChunk + kDigits) + kDigits * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* const w2_s = reinterpret_cast<T*>(smem);
  unsigned short* const key = reinterpret_cast<unsigned short*>(w2_s + kChunk) + warp * kWarpShorts;
  unsigned short* const ord = key + kChunk;
  unsigned short* const tab = ord + kOrders * (kChunk + kDigits);

  const long long c = blockIdx.x % a.C;
  const long long ps = blockIdx.x / a.C;  // p * n_shards + s
  const long long s = ps % a.n_shards;
  const long long p = ps / a.n_shards;
  const long long n = a.n_shards * a.Ns;
  const long long j0 = s * a.Ns + c * kChunk;  // local index of the chunk's first sample
  const int len = static_cast<int>(a.Ns - c * kChunk < kChunk ? a.Ns - c * kChunk : kChunk);
  const long long g0 = a.shard0 * a.Ns + j0;  // its global index
  const T* w = static_cast<const T*>(a.w) + p * n + j0;
  const T* y = static_cast<const T*>(a.y) + p * n + j0;  // axis i at y + i * P * n
  const int nb = a.nb;
  const T scale = static_cast<T>(nb);
  T* partg = static_cast<T*>(a.partg) + blockIdx.x * static_cast<long long>(a.d) * nb;
  int bin_bits = 0;  // bits of the largest bin
  while ((nb - 1) >> bin_bits) ++bin_bits;
  const int passes = kMany ? (bin_bits + kDigitBits - 1) / kDigitBits : 1;

  // w * w, for every warp: staged while the first loads of y are in flight
  auto stage_w2 = [&] {
    if (a.vec) {
      constexpr int kPer = kChunk / kVec / kThreads;
      V v[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int q = tid + u * kThreads;
        if (q * kVec < len) v[u] = __ldg(reinterpret_cast<const V*>(w) + q);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int q = tid + u * kThreads;
        if (q * kVec < len) {
          const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
          for (int k = 0; k < kVec; ++k) w2_s[q * kVec + k] = e[k] * e[k];
        }
      }
    } else {
      for (int j = tid; j < len; j += kThreads) w2_s[j] = w[j] * w[j];
    }
  };

  // The bins of axis i into key, and the first pass's (digit, run) table;
  // `between` runs once, after the first batch of loads is issued.
  auto bins = [&](int i, auto&& between) {
    const T* row = y + i * a.P * n;
    for (int q = lane; q < kDigits * 32 / 8; q += 32) reinterpret_cast<uint4*>(tab)[q] = uint4{0, 0, 0, 0};
    __syncwarp();
    bool first = true;
    if (a.vec) {
      const int nv = len / kVec;
      const V* rv = reinterpret_cast<const V*>(row);
      for (int q0 = lane; first || q0 < nv; q0 += 32 * kBatch) {
        V v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (q0 + 32 * u < nv) v[u] = __ldcs(rv + q0 + 32 * u);
        }
        if (first) {
          between();
          first = false;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = q0 + 32 * u;
          if (q < nv) {
            const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
            for (int k = 0; k < kVec; k += 2) {  // a pair stays adjacent under swz
              const int j = q * kVec + k;
              const unsigned b0 = bin_of(e[k], scale, nb), b1 = bin_of(e[k + 1], scale, nb);
              *reinterpret_cast<unsigned*>(key + swz(j)) = b0 | (b1 << 16);
              tab_add(tab, b0 & (kDigits - 1), j >> 5);
              tab_add(tab, b1 & (kDigits - 1), (j + 1) >> 5);
            }
          }
        }
      }
    } else {
      for (int q0 = lane; first || q0 < len; q0 += 32 * kBatch) {
        T v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (q0 + 32 * u < len) v[u] = row[q0 + 32 * u];
        }
        if (first) {
          between();
          first = false;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = q0 + 32 * u;
          if (j < len) {
            const unsigned b = bin_of(v[u], scale, nb);
            key[swz(j)] = static_cast<unsigned short>(b);
            tab_add(tab, b & (kDigits - 1), j >> 5);
          }
        }
      }
    }
  };

  // The stable counting sort of axis i's samples by bin, digit by digit,
  // then each bin's run of the sorted order added from +0.
  auto sort_and_add = [&](int i) {
    const unsigned short* order = nullptr;  // sample order
    unsigned short* out = ord;
    int n0 = 0, n1 = 0, r0 = 0, r1 = 0;
    for (int pass = 0; pass < passes; ++pass) {
      if (pass) warp_count(key, order, tab, len, pass * kDigitBits, lane);
      warp_slots(tab, lane, !kMany, n0, n1, r0, r1);
      warp_scatter(key, order, out, tab, len, pass * kDigitBits, pass + 1 < passes, lane);
      order = out;
      out = out == ord ? ord + kChunk + kDigits : ord;
    }
    T* prow = partg + i * nb;
    if (!kMany) {  // bins lane and lane + 32: n0 samples from slot r0, n1 from r1
      // (both even), side by side, two samples a read
      const unsigned* pairs = reinterpret_cast<const unsigned*>(order);
      T acc0 = T(0), acc1 = T(0);
      const int most = n0 > n1 ? n0 : n1;
      for (int t = 0; t < most; t += 2) {
        if (t < n0) {
          const unsigned pair = pairs[(r0 + t) >> 1];
          acc0 = acc0 + w2_s[pair & 0xffffu];
          if (t + 1 < n0) acc0 = acc0 + w2_s[pair >> 16];
        }
        if (t < n1) {
          const unsigned pair = pairs[(r1 + t) >> 1];
          acc1 = acc1 + w2_s[pair & 0xffffu];
          if (t + 1 < n1) acc1 = acc1 + w2_s[pair >> 16];
        }
      }
      if (lane < nb) prow[lane] = acc0;
      if (lane + 32 < nb) prow[lane + 32] = acc1;
    } else {  // the run of each head; bins with no sample stay +0
      unsigned short* sk = out;  // the free order buffer: the sorted bins
      for (int k = lane; k < len; k += 32) sk[k] = key[swz(order[k])];
      for (int b = lane; b < nb; b += 32) prow[b] = T(0);
      __syncwarp();
      for (int k = lane; k < len; k += 32) {
        const unsigned short b = sk[k];
        if (k == 0 || sk[k - 1] != b) {
          T acc = T(0);
          int e = k;
          do {
            acc = acc + w2_s[order[e]];
            ++e;
          } while (e < len && sk[e] == b);
          prow[b] = acc;
        }
      }
    }
    __syncwarp();  // the next axis reuses this warp's arrays
  };

  // each warp alone on axes warp, warp + kWarps, ...; one barrier, for w * w
  if (warp < a.d) {
    bins(warp, stage_w2);
  } else {
    stage_w2();
  }
  __syncthreads();
  for (int i = warp; i < a.d; i += kWarps) {
    if (i != warp) bins(i, [] {});
    sort_and_add(i);
  }

  // --- cube pieces, by the last warp: cubes kf..kl meet this chunk --------
  if (warp != kWarps - 1) return;
  const long long* cum = a.cum + p * a.M;
  const int half = lane >> 4;  // lanes 0-15: the first sample's cube; 16-31: the last's
  const long long k_half = cube_of16(cum, a.M, g0 + (half ? len - 1 : 0), lane & 15,
                                     half ? 0xffff0000u : 0x0000ffffu);
  const long long kf = __shfl_sync(kFull, k_half, 0);
  const long long kl = __shfl_sync(kFull, k_half, 16);
  if (lane == 0) a.kfirst[blockIdx.x] = kf;
  const int pieces = static_cast<int>(kl - kf + 1);
  T* part1 = static_cast<T*>(a.part1) + blockIdx.x * static_cast<long long>(kChunk);
  T* part2 = static_cast<T*>(a.part2) + blockIdx.x * static_cast<long long>(kChunk);
  for (int t = lane; t < pieces; t += 32) {
    const long long k = kf + t;
    const long long start = k ? cum[k - 1] : 0;
    const int lo = static_cast<int>(start > g0 ? start - g0 : 0);
    const int hi = static_cast<int>(cum[k] < g0 + len ? cum[k] - g0 : len);
    T acc1 = T(0), acc2 = T(0);
    for (int j = lo; j < hi; ++j) {
      acc1 = acc1 + w[j];
      acc2 = acc2 + w2_s[j];
    }
    part1[t] = acc1;
    part2[t] = acc2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) vegas_sums_combine(Args a) {
  const long long t = static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  const long long dnb = static_cast<long long>(a.d) * a.nb;
  const long long n_bin = a.P * a.n_shards * dnb;
  if (t < n_bin) {  // g[p, s, i, b]: its C chunk partials, in chunk order
    const long long q = t % dnb;  // i * nb + b
    const long long ps = t / dnb;
    const T* src = static_cast<const T*>(a.partg) + ps * a.C * dnb + q;
    const long long full = a.C / kAhead * kAhead;
    T acc = T(0);
    T cur[kAhead];
    if (full) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) cur[u] = __ldg(src + u * dnb);
    }
    for (long long c = 0; c < full; c += kAhead) {
      const bool more = c + kAhead < full;
      T nxt[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) nxt[u] = more ? __ldg(src + (c + kAhead + u) * dnb) : T(0);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) acc = acc + cur[u];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
    }
    for (long long c = full; c < a.C; ++c) acc = acc + __ldg(src + c * dnb);
    static_cast<T*>(a.g)[t] = acc;
    return;
  }
  const long long u = t - n_bin;
  if (u >= a.P * a.n_shards * a.M) return;
  // s1, s2[p, s, k]: the pieces of cube k in the shard's chunks, in order
  const long long k = u % a.M;
  const long long ps = u / a.M;
  const long long s = ps % a.n_shards;
  const long long p = ps / a.n_shards;
  const long long* cum = a.cum + p * a.M;
  const long long base = (a.shard0 + s) * a.Ns;
  const long long start = k ? cum[k - 1] : 0;
  const long long lo = start > base ? start : base;
  const long long hi = cum[k] < base + a.Ns ? cum[k] : base + a.Ns;
  T acc1 = T(0), acc2 = T(0);
  if (lo < hi) {
    for (long long c = (lo - base) / kChunk; c <= (hi - 1 - base) / kChunk; ++c) {
      const long long row = ps * a.C + c;
      const long long at = row * kChunk + (k - a.kfirst[row]);
      acc1 = acc1 + static_cast<const T*>(a.part1)[at];
      acc2 = acc2 + static_cast<const T*>(a.part2)[at];
    }
  }
  static_cast<T*>(a.s1)[u] = acc1;
  static_cast<T*>(a.s2)[u] = acc2;
}

template <typename T>
const void* chunk_kernel(bool many) {
  return many ? reinterpret_cast<const void*>(vegas_sums_chunks<T, true>)
              : reinterpret_cast<const void*>(vegas_sums_chunks<T, false>);
}

// Lets the chunk kernel take its dynamic shared memory (over 48 KB).
template <typename T>
cudaError_t allow_smem(int device, bool many) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chunk_kernel<T>(many), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T>(many));
}

template <typename T>
int launch(int device, Args a, cudaStream_t stream) {
  if (a.P < 1 || a.n_shards < 1 || a.Ns < 1 || a.M < 1 || a.d < 1 || a.nb < 1 || a.nb > 65535 ||
      a.shard0 < 0 || a.C != (a.Ns + kChunk - 1) / kChunk)
    return cudaErrorInvalidValue;
  const long long chunks = a.P * a.n_shards * a.C;
  const long long outputs = a.P * a.n_shards * (a.M + static_cast<long long>(a.d) * a.nb);
  const long long blocks = (outputs + kCombineThreads - 1) / kCombineThreads;
  if (chunks > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  a.vec = reinterpret_cast<std::uintptr_t>(a.w) % 16 == 0 &&
          reinterpret_cast<std::uintptr_t>(a.y) % 16 == 0 && a.Ns % kVec == 0;
  const bool many = a.nb > kDigits;
  cudaError_t err = allow_smem<T>(device, many);
  if (err != cudaSuccess) return err;
  if (many)
    vegas_sums_chunks<T, true><<<static_cast<unsigned>(chunks), kThreads, smem_bytes<T>(true), stream>>>(a);
  else
    vegas_sums_chunks<T, false><<<static_cast<unsigned>(chunks), kThreads, smem_bytes<T>(false), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vegas_sums_combine<T><<<static_cast<unsigned>(blocks), kCombineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int entry(int device, long long P, long long n_shards, long long Ns, long long shard0, long long M,
          int d, int nb, const void* w, const void* y, const void* cum, void* part1, void* part2,
          void* kfirst, void* partg, void* s1, void* s2, void* g, void* stream) {
  const Args a{P,     n_shards, Ns,     shard0, M,     (Ns + kChunk - 1) / kChunk,
               d,     nb,       w,      y,      static_cast<const long long*>(cum),
               part1, part2,    static_cast<long long*>(kfirst), partg, s1, s2, g, 0};
  return launch<T>(device, a, static_cast<cudaStream_t>(stream));
}

template <typename T>
int plan(int device, int nb, int* out) {
  if (nb < 1 || nb > 65535) return cudaErrorInvalidValue;
  const bool many = nb > kDigits;
  cudaError_t err = allow_smem<T>(device, many);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chunk_kernel<T>(many), kThreads,
                                                      smem_bytes<T>(many));
  if (err != cudaSuccess) return err;
  out[0] = many;
  out[1] = smem_bytes<T>(many);
  out[2] = blocks;
  return cudaSuccess;
}

}  // namespace

// C entry points, bound with ctypes (kernels/vegas_sums.py).  Pointers are
// device addresses of contiguous tensors: w (P, n), y (d, P, n), cum (P, M)
// int64, the scratch part1 and part2 (P, n_shards, C, kChunk), kfirst
// (P, n_shards, C) int64 and partg (P, n_shards, C, d, nb), the outputs s1
// and s2 (P, n_shards, M) and g (P, n_shards, d, nb), with n = n_shards *
// Ns and C = ceil(Ns / kChunk).  The return value is a cudaError_t: 0 once
// both launches have been queued on `stream`.
extern "C" int vegas_sums_chunk() { return kChunk; }

extern "C" int vegas_sums_f64(int device, long long P, long long n_shards, long long Ns,
                              long long shard0, long long M, int d, int nb, const void* w,
                              const void* y, const void* cum, void* part1, void* part2,
                              void* kfirst, void* partg, void* s1, void* s2, void* g,
                              void* stream) {
  return entry<double>(device, P, n_shards, Ns, shard0, M, d, nb, w, y, cum, part1, part2, kfirst,
                       partg, s1, s2, g, stream);
}

extern "C" int vegas_sums_f32(int device, long long P, long long n_shards, long long Ns,
                              long long shard0, long long M, int d, int nb, const void* w,
                              const void* y, const void* cum, void* part1, void* part2,
                              void* kfirst, void* partg, void* s1, void* s2, void* g,
                              void* stream) {
  return entry<float>(device, P, n_shards, Ns, shard0, M, d, nb, w, y, cum, part1, part2, kfirst,
                      partg, s1, s2, g, stream);
}

// The chunk launch at nb bins: out[0] 1 for the many-bin path (digit
// passes), out[1] dynamic shared bytes per block, out[2] resident blocks
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int vegas_sums_plan(int device, int is_f64, int nb, int* out) {
  return is_f64 ? plan<double>(device, nb, out) : plan<float>(device, nb, out);
}
