// The cyclic redistribution round for Hopper (sm_90a): one launch of
// `redistribute_round` per device a round, over every rank on that device,
// and, only where a donor's receiver lives on another device, one launch of
// `redistribute_pack` on the donor's device before it.
//
// Replaces the round that the JAX package compiles into its distributed
// step (`redistribute`, src/repro/core/redistribution.py:145-229: a psum,
// two ppermutes of stats, one of the payload, and the splice, all inside
// one XLA program; no Pallas kernel).  The plan is its lines 163-191, the
// payload 192-199, the retire and splice 201-217.
//
// Inputs of a round at ring distance `shift` over n ranks:
//   counts        every rank's live count after the split: n pointers to
//                 int64 on the launching device (a rank's own count, or an
//                 element of a gathered copy for a rank on another device);
//   cap, limit, C message cap, fill limit, store capacity; P = min(cap, C)
//                 rows are visited a rank every round, whatever moves.
// The plan of rank r, from counts alone (redistribution.py::round_counts,
// the reference's lines 163-191): fair share [total // n, ceil(total / n)];
// stats [n_rows, free, surplus, deficit] = max(0, [x, limit - x, x -
// fair_hi, fair_lo - x]); r sends n_send = min(cap, surplus, receiver's
// free, receiver's deficit) to r + shift, and receives n_recv = min(cap,
// donor's surplus, free, deficit) from its donor u = r - shift, which is
// exactly what u sends; base = x - n_send.
//
//   redistribute_round, for each rank r of the launch and j < P, with
//     dest = (base + j) mod C and kept = min(n_recv, C - base):
//       j < kept: row dest's centres and half-widths are the donor's row
//         (x_u - n_recv + j) mod C, read from the donor's store where it
//         lives on this device, else row j of a staged (P, 2d) block;
//         est, err and axis become 0;
//       active and fresh become (old & !(j < n_send)) | (j < kept);
//       out[r] = (base + kept, n_send): the count after the round and the
//         rows sent.
//   redistribute_pack, for each donor u given: block row j = [centres,
//     half-widths] of row (base_u + j) mod C for j < n_send_u, else +0.
//
// No barrier between ranks: a rank never both sends and receives in one
// round (n_send > 0 needs x > fair_hi, n_recv > 0 needs x < fair_lo), so a
// donor's coordinates are only read in a round (its own blocks clear the
// flags of the rows it sends, not their coordinates) and a receiver's only
// written.  A rank's P destinations are distinct (P <= C) and only its own
// blocks write them, so every write is to its own element and the result
// is deterministic: the plain version's bits (kernels/ref.py::round_ref,
// round_pack_ref), since nothing is computed in floating point.  Integer
// divisions and remainders round as PyTorch's `//` and `%` do (towards
// minus infinity), so even a negative count gives the plain version's plan.
//
// What bounds it: launch latency.  A round moves at most P rows of 2d
// words a receiver (cap 512, d = 8: 64 KiB) and P flag bytes a rank; that
// is ~20 ns of HBM time against a few microseconds to launch.  Design: the
// whole round is one launch a device, blockIdx.y picking the rank; the
// threads t < n load the counts into shared memory at once, thread 0 plans
// the block's rank there, then the block walks its rank's P (2d + 1)
// elements (one per coordinate word, one more per row for the flags and
// scalars) in a grid-stride loop.  The arguments are one struct passed by
// value (every field 8 bytes), filled on the host from a flat int64 buffer
// whose layout `redistribute_round_layout` reports, so that a launch costs
// one ctypes call whatever the number of ranks.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;   // ranks of the ring (count pointers a launch carries)
constexpr int kMaxLocal = 32;   // ranks one launch serves
constexpr int kMaxBlocks = 64;  // blocks a rank along x; the rest by the grid-stride loop

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

struct Plan {
  long long n_send, n_recv, base, donor_base;
};

// Rank r's plan from the n counts in shared memory.
__device__ Plan plan_of(const long long* cnt, long long n, long long r, long long shift,
                        long long cap, long long limit) {
  long long total = 0;
  for (long long i = 0; i < n; ++i) total += cnt[i];
  const long long fair_lo = floor_div(total, n);
  const long long fair_hi = -floor_div(-total, n);
  const long long x = cnt[r];
  const long long x_up = cnt[floor_mod(r - shift, n)];
  const Stats own = stats_of(x, limit, fair_lo, fair_hi);
  const Stats down = stats_of(cnt[floor_mod(r + shift, n)], limit, fair_lo, fair_hi);
  const Stats up = stats_of(x_up, limit, fair_lo, fair_hi);
  const long long n_send = lmin(lmin(own.surplus, lmin(down.free, down.deficit)), cap);
  const long long n_recv = lmin(lmin(up.surplus, lmin(own.free, own.deficit)), cap);
  // the donor sends n_recv rows, the tail of its x_up
  return Plan{n_send, n_recv, x - n_send, x_up - n_recv};
}

struct Header {
  long long n, shift, cap, limit, C, d, n_local;
  const long long* counts[kMaxRanks];
};

// One rank of a round launch.
struct RankSlot {
  void* centers;  // (C, d)
  void* halfw;    // (C, d)
  void* est;      // (C,)
  void* err;      // (C,)
  int* axis;      // (C,)
  unsigned char* active;  // (C,) bool
  unsigned char* fresh;   // (C,) bool
  // the receive's source: the donor's centers and halfw (C, d), or a staged
  // (P, 2d) block and the same block d words on
  const void* src_centers;
  const void* src_halfw;
  long long staged;  // 0: the donor's store, read at row (x_u - n_recv + j) mod C; 1: block row j
  long long rank;
};

struct RoundArgs {
  Header h;
  long long* out;  // (n_local, 2): the count after the round, the rows sent
  RankSlot slot[kMaxLocal];
};

// One donor of a pack launch.
struct PackSlot {
  const void* centers;  // (C, d)
  const void* halfw;    // (C, d)
  void* block;          // (P, 2d)
  long long rank;
};

struct PackArgs {
  Header h;
  PackSlot slot[kMaxLocal];
};

static_assert(sizeof(RankSlot) == 11 * 8 && sizeof(PackSlot) == 4 * 8, "8-byte fields");
static_assert(sizeof(RoundArgs) <= 4096 && sizeof(PackArgs) <= 4096, "kernel parameter space");

// The kernels read their arguments field by field and never take the
// address of one, so that the structs stay in the parameter space.

template <typename T>
__global__ void __launch_bounds__(kThreads) redistribute_round(RoundArgs a) {
  __shared__ long long cnt[kMaxRanks];
  __shared__ Plan plan;
  const int y = blockIdx.y;
  for (int i = threadIdx.x; i < a.h.n; i += blockDim.x) cnt[i] = *a.h.counts[i];
  __syncthreads();
  if (threadIdx.x == 0) plan = plan_of(cnt, a.h.n, a.slot[y].rank, a.h.shift, a.h.cap, a.h.limit);
  __syncthreads();
  const long long C = a.h.C;
  const long long d = a.h.d;
  const long long P = lmin(a.h.cap, C);
  const long long kept = lmin(plan.n_recv, C - plan.base);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.out[2 * y] = plan.base + kept;
    a.out[2 * y + 1] = plan.n_send;
  }
  T* centers = static_cast<T*>(a.slot[y].centers);
  T* halfw = static_cast<T*>(a.slot[y].halfw);
  const T* src_centers = static_cast<const T*>(a.slot[y].src_centers);
  const T* src_halfw = static_cast<const T*>(a.slot[y].src_halfw);
  const bool staged = a.slot[y].staged != 0;
  // one column per coordinate word, then one for the row's flags
  const long long w = 2 * d + 1;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < P * w;
       e += step) {
    const long long j = e / w;
    const long long c = e - j * w;
    const bool recv = j < kept;
    const long long dest = floor_mod(plan.base + j, C);
    if (c < 2 * d) {
      if (recv) {
        const bool lo = c < d;
        const long long col = lo ? c : c - d;
        // a block row is 2d words, so block row j starts at word (2j) d
        const long long row = staged ? 2 * j : floor_mod(plan.donor_base + j, C);
        const T v = (lo ? src_centers : src_halfw)[row * d + col];
        (lo ? centers : halfw)[dest * d + col] = v;
      }
      continue;
    }
    const bool sent = j < plan.n_send;
    if (recv) {
      static_cast<T*>(a.slot[y].est)[dest] = T(0);
      static_cast<T*>(a.slot[y].err)[dest] = T(0);
      a.slot[y].axis[dest] = 0;
    }
    unsigned char* active = a.slot[y].active;
    unsigned char* fresh = a.slot[y].fresh;
    active[dest] = (active[dest] && !sent) || recv;
    fresh[dest] = (fresh[dest] && !sent) || recv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) redistribute_pack(PackArgs a) {
  __shared__ long long cnt[kMaxRanks];
  __shared__ Plan plan;
  const int y = blockIdx.y;
  for (int i = threadIdx.x; i < a.h.n; i += blockDim.x) cnt[i] = *a.h.counts[i];
  __syncthreads();
  if (threadIdx.x == 0) plan = plan_of(cnt, a.h.n, a.slot[y].rank, a.h.shift, a.h.cap, a.h.limit);
  __syncthreads();
  const long long C = a.h.C;
  const long long d = a.h.d;
  const long long P = lmin(a.h.cap, C);
  const T* centers = static_cast<const T*>(a.slot[y].centers);
  const T* halfw = static_cast<const T*>(a.slot[y].halfw);
  T* block = static_cast<T*>(a.slot[y].block);
  const long long w = 2 * d;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < P * w;
       e += step) {
    const long long j = e / w;
    const long long c = e - j * w;
    T v = T(0);
    if (j < plan.n_send) {
      const long long src = floor_mod(plan.base + j, C);
      v = c < d ? centers[src * d + c] : halfw[src * d + c - d];
    }
    block[e] = v;
  }
}

// An empty kernel: the launch floor that a launch-bound kernel is read
// against (gm_perf.py::time_round).  Not part of the round.
__global__ void launch_floor() {}

bool bad_header(const Header& h) {
  if (h.n < 1 || h.n > kMaxRanks || h.n_local < 1 || h.n_local > kMaxLocal || h.d < 1 ||
      h.cap < 1 || h.C < 1)
    return true;
  for (long long i = 0; i < h.n; ++i)
    if (h.counts[i] == nullptr) return true;
  return false;
}

dim3 grid_for(const Header& h, long long width) {
  const long long P = h.C < h.cap ? h.C : h.cap;
  const long long blocks = (P * width + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
              static_cast<unsigned>(h.n_local));
}

// Run `launch` with `device` current, and give back the launch's error.
template <typename F>
int on_device(int device, F launch) {
  int prev = 0;
  cudaError_t rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return rc;
  if (prev != device && (rc = cudaSetDevice(device)) != cudaSuccess) return rc;
  launch();
  rc = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (rc == cudaSuccess) rc = back;
  }
  return rc;
}

template <typename T>
int launch_round(const void* args, int device, void* stream) {
  RoundArgs a;
  std::memcpy(&a, args, sizeof a);
  if (bad_header(a.h) || a.out == nullptr) return cudaErrorInvalidValue;
  for (long long s = 0; s < a.h.n_local; ++s)
    if (a.slot[s].rank < 0 || a.slot[s].rank >= a.h.n) return cudaErrorInvalidValue;
  const dim3 grid = grid_for(a.h, 2 * a.h.d + 1);
  return on_device(device, [&] {
    redistribute_round<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  });
}

template <typename T>
int launch_pack(const void* args, int device, void* stream) {
  PackArgs a;
  std::memcpy(&a, args, sizeof a);
  if (bad_header(a.h)) return cudaErrorInvalidValue;
  for (long long s = 0; s < a.h.n_local; ++s)
    if (a.slot[s].rank < 0 || a.slot[s].rank >= a.h.n) return cudaErrorInvalidValue;
  const dim3 grid = grid_for(a.h, 2 * a.h.d);
  return on_device(device, [&] {
    redistribute_pack<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  });
}

}  // namespace

// C entry points, bound with ctypes (kernels/redistribute_round.py).
// `args` is a host pointer to the flat int64 words of RoundArgs or
// PackArgs (every field 8 bytes, in declaration order); its pointers are
// device addresses of contiguous tensors on `device`: counts int64
// scalars; centers and halfw (C, d), est and err (C,) of the working type;
// axis (C,) int32; active and fresh (C,) bool; out (n_local, 2) int64;
// blocks (min(cap, C), 2d) of the working type.  The return value is a
// cudaError_t: 0 once the launch has been queued on `stream`.

// [max ranks, max ranks a launch, words of RoundArgs, words of PackArgs]
extern "C" void redistribute_round_layout(long long* out) {
  out[0] = kMaxRanks;
  out[1] = kMaxLocal;
  out[2] = sizeof(RoundArgs) / 8;
  out[3] = sizeof(PackArgs) / 8;
}

extern "C" int redistribute_round_f64(const void* args, int device, void* stream) {
  return launch_round<double>(args, device, stream);
}

extern "C" int redistribute_round_f32(const void* args, int device, void* stream) {
  return launch_round<float>(args, device, stream);
}

extern "C" int redistribute_pack_f64(const void* args, int device, void* stream) {
  return launch_pack<double>(args, device, stream);
}

extern "C" int redistribute_pack_f32(const void* args, int device, void* stream) {
  return launch_pack<float>(args, device, stream);
}

extern "C" int redistribute_launch_floor(int device, void* stream) {
  return on_device(device,
                   [&] { launch_floor<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(); });
}
