// One rank's cyclic redistribution round for Hopper (sm_90a): two launches,
// pack and splice, on the rank's current stream.
//
// Replaces the round that the JAX package compiles into its distributed
// step (`redistribute`, src/repro/core/redistribution.py:145-229: a psum,
// two ppermutes of stats, one of the payload, and the splice, all inside
// one XLA program; no Pallas kernel).  pack is its lines 163-199 (stats,
// counts, payload), splice its lines 201-217 (retire and splice).  In
// PyTorch the same round is ~40 small operations a rank (the plain version,
// kernels/ref.py); here it is two launches and two allocations, whatever
// moves.
//
// Inputs of a round on rank r of n, ring distance `shift`:
//   counts (n,) int64   every rank's live count after the split (gathered
//                       once and copied to this rank's device);
//   cap, limit, C       message cap, fill limit, store capacity; P =
//                       min(cap, C) rows are packed and spliced every round.
// The plan, from counts alone (the arithmetic of redistribution.py::
// round_counts and of the reference, src/repro/core/redistribution.py:
// 183-191): fair share [total // n, ceil(total / n)]; per rank the stats
// [n_rows, free, surplus, deficit] = max(0, [x, limit - x, x - fair_hi,
// fair_lo - x]); this rank sends min(cap, surplus, receiver's free,
// receiver's deficit) to r + shift and receives min(cap, donor's surplus,
// free, deficit) from r - shift; base = counts[r] - n_send.
//
//   pack:   plan[0..2] = (n_send, n_recv, base); payload (P, 2d) row j =
//           [centers, halfw] of store row (base + j) mod C where j < n_send,
//           else +0.
//   splice: after the payload has moved along the ring (donor r - shift's
//           block is `incoming`), for j < P and dest = (base + j) mod C:
//           with kept = min(n_recv, C - base), a row j < kept is received:
//           its centres and half-widths come from `incoming`, est, err and
//           axis become 0; active and fresh become (old & !(j < n_send)) |
//           (j < kept).  plan[3] = base + kept, the count after the round.
//
// The P destinations are distinct (P <= C), so every write is to its own
// element and the result is deterministic: the plain version's bits, since
// nothing is computed in floating point (rows are copied, or set to +0).
// Integer divisions and remainders round as PyTorch's `//` and `%` do
// (towards minus infinity), so even a negative count gives the plain
// version's plan.
//
// What bounds it: launch latency.  A round moves at most P rows of 2d
// words (cap 512, d = 8: 64 KiB) and P flag bytes; that is ~20 ns of HBM
// time against a few microseconds to launch.  Design: every thread
// recomputes nothing it can share: thread 0 of each block computes the
// plan (a loop over n counts) into shared memory; then one thread per
// (row, column) element copies, with one more column per row for the
// row's flags and scalars in the splice.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Plan {
  long long n_send, n_recv, base;
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  return a - floor_div(a, b) * b;
}

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long lmax0(long long a) { return a > 0 ? a : 0; }

// [n_rows, free, surplus, deficit], each clamped at 0
struct Stats {
  long long rows, free, surplus, deficit;
};

__device__ Stats stats_of(long long x, long long limit, long long fair_lo, long long fair_hi) {
  return Stats{lmax0(x), lmax0(limit - x), lmax0(x - fair_hi), lmax0(fair_lo - x)};
}

__device__ Plan plan_of(const long long* counts, int n, int r, int shift, long long cap,
                        long long limit) {
  long long total = 0;
  for (int i = 0; i < n; ++i) total += counts[i];
  const long long fair_lo = floor_div(total, n);
  const long long fair_hi = -floor_div(-total, n);
  const long long x = counts[r];
  const Stats own = stats_of(x, limit, fair_lo, fair_hi);
  const Stats down = stats_of(counts[floor_mod(r + shift, n)], limit, fair_lo, fair_hi);
  const Stats up = stats_of(counts[floor_mod(r - shift, n)], limit, fair_lo, fair_hi);
  const long long n_send = lmin(lmin(own.surplus, lmin(down.free, down.deficit)), cap);
  const long long n_recv = lmin(lmin(up.surplus, lmin(own.free, own.deficit)), cap);
  return Plan{n_send, n_recv, x - n_send};
}

struct PackArgs {
  const long long* counts;
  int n, r, shift, d;
  long long cap, limit, C, P;
  const void* centers;  // (C, d)
  const void* halfw;    // (C, d)
  long long* plan;      // (4,)
  void* payload;        // (P, 2d)
};

template <typename T>
__global__ void __launch_bounds__(kThreads) redistribute_pack(PackArgs a) {
  __shared__ Plan plan;
  if (threadIdx.x == 0) {
    plan = plan_of(a.counts, a.n, a.r, a.shift, a.cap, a.limit);
    if (blockIdx.x == 0) {
      a.plan[0] = plan.n_send;
      a.plan[1] = plan.n_recv;
      a.plan[2] = plan.base;
    }
  }
  __syncthreads();
  const int w = 2 * a.d;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= a.P * w) return;
  const long long j = e / w;
  const int c = static_cast<int>(e - j * w);
  T v = T(0);
  if (j < plan.n_send) {
    const long long src = floor_mod(plan.base + j, a.C);
    v = c < a.d ? static_cast<const T*>(a.centers)[src * a.d + c]
                : static_cast<const T*>(a.halfw)[src * a.d + c - a.d];
  }
  static_cast<T*>(a.payload)[e] = v;
}

struct SpliceArgs {
  int d;
  long long C, P;
  long long* plan;       // (4,): reads [0..2], writes [3]
  const void* incoming;  // (P, 2d)
  void* centers;         // (C, d)
  void* halfw;           // (C, d)
  void* est;             // (C,)
  void* err;             // (C,)
  int* axis;             // (C,)
  unsigned char* active; // (C,) bool
  unsigned char* fresh;  // (C,) bool
};

template <typename T>
__global__ void __launch_bounds__(kThreads) redistribute_splice(SpliceArgs a) {
  __shared__ long long n_send, base, kept;
  if (threadIdx.x == 0) {
    n_send = a.plan[0];
    base = a.plan[2];
    kept = lmin(a.plan[1], a.C - base);
  }
  __syncthreads();
  // one column per coordinate word, then one for the row's flags
  const int w = 2 * a.d + 1;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e == 0) a.plan[3] = base + kept;
  if (e >= a.P * w) return;
  const long long j = e / w;
  const int c = static_cast<int>(e - j * w);
  const bool recv = j < kept;
  const long long dest = floor_mod(base + j, a.C);
  if (c < 2 * a.d) {
    if (recv) {
      const T v = static_cast<const T*>(a.incoming)[j * (2 * a.d) + c];
      if (c < a.d)
        static_cast<T*>(a.centers)[dest * a.d + c] = v;
      else
        static_cast<T*>(a.halfw)[dest * a.d + c - a.d] = v;
    }
    return;
  }
  const bool sent = j < n_send;
  if (recv) {
    static_cast<T*>(a.est)[dest] = T(0);
    static_cast<T*>(a.err)[dest] = T(0);
    a.axis[dest] = 0;
  }
  a.active[dest] = (a.active[dest] && !sent) || recv;
  a.fresh[dest] = (a.fresh[dest] && !sent) || recv;
}

unsigned grid(long long elements) {
  return static_cast<unsigned>((elements + kThreads - 1) / kThreads);
}

bool bad_shape(int n, int r, int d, long long cap, long long C, long long width) {
  return n < 1 || r < 0 || r >= n || d < 1 || cap < 1 || C < 1 ||
         (C < cap ? C : cap) * width > 0x7fffffffLL * kThreads;
}

template <typename T>
int pack(const void* counts, int n, int r, int shift, long long cap, long long limit,
         long long C, int d, const void* centers, const void* halfw, void* plan, void* payload,
         void* stream) {
  if (bad_shape(n, r, d, cap, C, 2LL * d)) return cudaErrorInvalidValue;
  const long long P = C < cap ? C : cap;
  const PackArgs a{static_cast<const long long*>(counts), n, r, shift, d, cap, limit, C, P,
                   centers, halfw, static_cast<long long*>(plan), payload};
  redistribute_pack<T><<<grid(P * 2 * d), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename T>
int splice(long long cap, long long C, int d, void* plan, const void* incoming, void* centers,
           void* halfw, void* est, void* err, void* axis, void* active, void* fresh,
           void* stream) {
  if (bad_shape(1, 0, d, cap, C, 2LL * d + 1)) return cudaErrorInvalidValue;
  const long long P = C < cap ? C : cap;
  const SpliceArgs a{d,      C,   P,   static_cast<long long*>(plan), incoming, centers, halfw,
                     est,    err, static_cast<int*>(axis), static_cast<unsigned char*>(active),
                     static_cast<unsigned char*>(fresh)};
  redistribute_splice<T>
      <<<grid(P * (2 * d + 1)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes (kernels/redistribute_round.py).
// Pointers are device addresses of contiguous tensors on one device:
// counts (n,) int64; centers and halfw (C, d), est and err (C,) of the
// working type; axis (C,) int32; active and fresh (C,) bool; plan (4,)
// int64; payload and incoming (min(cap, C), 2d) of the working type.  The
// return value is a cudaError_t: 0 once the launch has been queued on
// `stream`.
extern "C" int redistribute_pack_f64(const void* counts, int n, int r, int shift, long long cap,
                                     long long limit, long long C, int d, const void* centers,
                                     const void* halfw, void* plan, void* payload, void* stream) {
  return pack<double>(counts, n, r, shift, cap, limit, C, d, centers, halfw, plan, payload,
                      stream);
}

extern "C" int redistribute_pack_f32(const void* counts, int n, int r, int shift, long long cap,
                                     long long limit, long long C, int d, const void* centers,
                                     const void* halfw, void* plan, void* payload, void* stream) {
  return pack<float>(counts, n, r, shift, cap, limit, C, d, centers, halfw, plan, payload,
                     stream);
}

extern "C" int redistribute_splice_f64(long long cap, long long C, int d, void* plan,
                                       const void* incoming, void* centers, void* halfw,
                                       void* est, void* err, void* axis, void* active,
                                       void* fresh, void* stream) {
  return splice<double>(cap, C, d, plan, incoming, centers, halfw, est, err, axis, active, fresh,
                        stream);
}

extern "C" int redistribute_splice_f32(long long cap, long long C, int d, void* plan,
                                       const void* incoming, void* centers, void* halfw,
                                       void* est, void* err, void* axis, void* active,
                                       void* fresh, void* stream) {
  return splice<float>(cap, C, d, plan, incoming, centers, halfw, est, err, axis, active, fresh,
                       stream);
}
