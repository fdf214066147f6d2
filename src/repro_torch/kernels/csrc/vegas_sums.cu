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
// shorter).  Within a chunk each sum runs left to right in sample order;
// the chunk partials of a sum are then added left to right, starting from
// zero.  A shard of at most kChunk samples is therefore summed strictly in
// sample order, as the reference's segment_sum does.
//
// Layout: w (P, n) and y (d, P, n) hold the n = n_shards * Ns samples of
// the caller's shards in global index order (shard shard0 first); cum
// (P, M) is each problem's cumulative per-cube counts over the whole
// iteration.  The samples of cube k are the global indices
// [cum[k-1], cum[k]): one contiguous run, so a chunk meets a contiguous
// range of cubes, each in one contiguous piece.
//
// What bounds it on the H100: bytes.  It reads w and y once (8 (d + 1)
// bytes per sample) and writes a few MB.  Design, two launches:
//   1. one block per (problem, shard, chunk): the chunk's w and w * w go to
//      shared memory (coalesced loads), then
//      - one thread per cube piece sums its piece from shared memory;
//      - the block computes the chunk's bins for up to kGroup axes at a
//        time into shared memory (coalesced loads of y), and one thread
//        per (axis, bin) scans the chunk's bins and adds its matches; the
//        32 threads of a warp are 32 bins of one axis, so each reads the
//        same shared entry (a broadcast).
//      Chunk partials go to scratch (P, S, C, kChunk) and (P, S, C, d, nb).
//   2. one thread per output adds its chunk partials in chunk order.
// The library is built with -fmad=false, so w * w and the adds round as
// the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;  // samples per chunk: the sums' fixed grouping
constexpr int kThreads = 256;
constexpr int kGroup = 4;  // axes whose bins a block holds at once

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
};

// the cube of global sample idx: the first k with cum[k] > idx
__device__ long long cube_of(const long long* cum, long long M, long long idx) {
  long long lo = 0, hi = M;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (cum[mid] > idx)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_sums(Args a) {
  __shared__ T w_s[kChunk];
  __shared__ T w2_s[kChunk];
  __shared__ unsigned short bin_s[kGroup * kChunk];
  __shared__ long long k_range[2];
  const int tid = threadIdx.x;
  const long long c = blockIdx.x % a.C;
  const long long ps = blockIdx.x / a.C;  // p * n_shards + s
  const long long s = ps % a.n_shards;
  const long long p = ps / a.n_shards;
  const long long n = a.n_shards * a.Ns;
  const long long j0 = s * a.Ns + c * kChunk;  // local index of the chunk's first sample
  const int len = static_cast<int>(a.Ns - c * kChunk < kChunk ? a.Ns - c * kChunk : kChunk);
  const long long g0 = a.shard0 * a.Ns + j0;  // its global index
  const T* w = static_cast<const T*>(a.w) + p * n + j0;
  for (int j = tid; j < len; j += kThreads) {
    const T v = w[j];
    w_s[j] = v;
    w2_s[j] = v * v;
  }
  const long long* cum = a.cum + p * a.M;
  if (tid == 0) {
    k_range[0] = cube_of(cum, a.M, g0);
    k_range[1] = cube_of(cum, a.M, g0 + len - 1);
    a.kfirst[blockIdx.x] = k_range[0];
  }
  __syncthreads();

  // --- cube pieces: cubes kf..kl meet this chunk, each in one run ---------
  const long long kf = k_range[0];
  const int pieces = static_cast<int>(k_range[1] - kf + 1);
  T* part1 = static_cast<T*>(a.part1) + blockIdx.x * static_cast<long long>(kChunk);
  T* part2 = static_cast<T*>(a.part2) + blockIdx.x * static_cast<long long>(kChunk);
  for (int t = tid; t < pieces; t += kThreads) {
    const long long k = kf + t;
    const long long start = k ? cum[k - 1] : 0;
    const int lo = static_cast<int>(start > g0 ? start - g0 : 0);
    const int hi = static_cast<int>(cum[k] < g0 + len ? cum[k] - g0 : len);
    T acc1 = T(0), acc2 = T(0);
    for (int j = lo; j < hi; ++j) {
      acc1 = acc1 + w_s[j];
      acc2 = acc2 + w2_s[j];
    }
    part1[t] = acc1;
    part2[t] = acc2;
  }

  // --- bins: kGroup axes at a time ------------------------------------------
  const int group = a.nb >= kThreads ? 1 : (kThreads / a.nb < kGroup ? kThreads / a.nb : kGroup);
  const T scale = static_cast<T>(a.nb);
  T* partg = static_cast<T*>(a.partg) + blockIdx.x * static_cast<long long>(a.d) * a.nb;
  for (int i0 = 0; i0 < a.d; i0 += group) {
    const int gi = a.d - i0 < group ? a.d - i0 : group;
    for (int q = tid; q < gi * len; q += kThreads) {
      const int ii = q / len, j = q % len;
      const T yv = static_cast<const T*>(a.y)[((i0 + ii) * a.P + p) * n + j0 + j];
      // bin_index: truncation toward zero, clipped to [0, nb)
      long long b = static_cast<long long>(yv * scale);
      b = b < 0 ? 0 : (b > a.nb - 1 ? a.nb - 1 : b);
      bin_s[ii * kChunk + j] = static_cast<unsigned short>(b);
    }
    __syncthreads();
    for (int q = tid; q < gi * a.nb; q += kThreads) {
      const int ii = q / a.nb;
      const unsigned short b = static_cast<unsigned short>(q % a.nb);
      const unsigned short* bins = bin_s + ii * kChunk;
      T acc = T(0);
      for (int j = 0; j < len; ++j) {
        if (bins[j] == b) acc = acc + w2_s[j];
      }
      partg[(i0 + ii) * a.nb + b] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) combine(Args a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_cube = a.P * a.n_shards * a.M;
  if (t < n_cube) {
    const long long k = t % a.M;
    const long long ps = t / a.M;
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
    static_cast<T*>(a.s1)[t] = acc1;
    static_cast<T*>(a.s2)[t] = acc2;
    return;
  }
  const long long u = t - n_cube;
  const long long dnb = static_cast<long long>(a.d) * a.nb;
  if (u >= a.P * a.n_shards * dnb) return;
  const long long q = u % dnb;  // i * nb + b
  const long long ps = u / dnb;
  const T* src = static_cast<const T*>(a.partg) + ps * a.C * dnb + q;
  T acc = T(0);
  for (long long c = 0; c < a.C; ++c) acc = acc + src[c * dnb];
  static_cast<T*>(a.g)[u] = acc;
}

template <typename T>
int launch(int device, const Args& a, cudaStream_t stream) {
  if (a.P < 1 || a.n_shards < 1 || a.Ns < 1 || a.M < 1 || a.d < 1 || a.nb < 1 || a.nb > 65535 ||
      a.shard0 < 0 || a.C != (a.Ns + kChunk - 1) / kChunk)
    return cudaErrorInvalidValue;
  const long long chunks = a.P * a.n_shards * a.C;
  const long long outputs = a.P * a.n_shards * (a.M + static_cast<long long>(a.d) * a.nb);
  const long long blocks = (outputs + kThreads - 1) / kThreads;
  if (chunks > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  chunk_sums<T><<<static_cast<unsigned>(chunks), kThreads, 0, stream>>>(a);
  combine<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int entry(int device, long long P, long long n_shards, long long Ns, long long shard0, long long M,
          int d, int nb, const void* w, const void* y, const void* cum, void* part1, void* part2,
          void* kfirst, void* partg, void* s1, void* s2, void* g, void* stream) {
  const Args a{P,  n_shards, Ns, shard0, M,
               (Ns + kChunk - 1) / kChunk, d, nb, w, y, static_cast<const long long*>(cum),
               part1, part2, static_cast<long long*>(kfirst), partg, s1, s2, g};
  return launch<T>(device, a, static_cast<cudaStream_t>(stream));
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
