// Fused Genz-Malik rule evaluation for Hopper (sm_90a): dispatcher and C
// entry points.  The kernel itself is gm_kernel.cuh, the integrands
// integrands.cuh.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `genz_malik_eval_soa` in src/repro/kernels/genz_malik_eval.py:44.  For
// each region (one column of the (d, B) SoA centre / half-width arrays) it
//   1. visits the 1 + 4d + 2d(d-1) + 2^d Genz-Malik nodes in registers,
//   2. evaluates the integrand, a device functor chosen by kernel id, at
//      each node,
//   3. writes i7, i5, i3, each scaled by prod(h), and the per-axis fourth
//      differences |f2+ + f2- - 2 f0 - (1/7)(f3+ + f3- - 2 f0)| as (d, B).
//
// What bounds it on the H100: FP64 arithmetic.  It reads 2*d*B words (plus
// theta) and writes (3 + d)*B, while its work grows as n_nodes(d) ~ 2^d per
// region; at d = 5 that is ~25 FP64 operations per node against 8 bytes of
// traffic per node.  Per node the work is the integrand's finish, in most
// integrands an exp, which the CUDA math library computes in ~20 FP64
// instructions, so exp dominates.
//
// Design, one thread per region (regions along blockIdx.x * blockDim.x +
// threadIdx.x; every load and store coalesced; the ragged block masked):
//   - The dimension is a template parameter D (1..16), dispatched by a host
//     switch, so the per-axis arrays are [D] and every loop over axes is
//     fully unrolled: no runtime axis index, no `k < d` guard.
//   - Every integrand is finish(fold_k term_k(x_k)) (integrands.cuh), and
//     along axis k the nodes take only the coordinates c, c +- lambda2 h,
//     c +- lambda3 h, c +- lambda4 h and c +- lambda5 h.  So the kernel
//     computes each term once per coordinate (tables C, P, M: the centre,
//     then +- lambda4 h for the pair group, then +- lambda5 h for the
//     corners; the lambda2/lambda3 terms inside the axis loop), and a node
//     costs D - 1 folds and one finish.  Folds shared by several nodes (the
//     centre's terms before the first moved axis) are folded once.
//   - The tables live in registers.  -Xptxas -v shows no spills for
//     float64 at D <= 9; above, ptxas spills up to 1.8 KB per thread, yet
//     tables in shared memory were no faster on the H100 (PERF.md).
//   - A broadcast theta (lane stride 0, the main path) is staged in shared
//     memory once per block; a per-lane theta is read by each thread only
//     when it builds its tables, never per node.  The batch service passes
//     one theta column per slot (lanes_per_col = the slot's window), so one
//     launch covers every live slot without an (n_theta, lanes) copy.
//   - __launch_bounds__(512, 1) at every D, so every block size the wrapper
//     accepts launches; the wrapper's default comes from a block sweep
//     (PERF.md).
//   - Each (T, D) is its own translation unit (gm_instance.cu), so the 320
//     kernels (10 integrands x 2 types x 16 dimensions) build in parallel.
//
// Rounding: the sums run in the order of the plain version
// (repro_torch/core/genz_malik.py): axis groups by ascending axis, + before
// -, lambda2 then lambda3; pairs a < b in the order (+,+), (+,-), (-,+),
// (-,-); corners m = 0 .. 2^d - 1 with bit q of m set meaning axis q is
// negative; then the weighted sums.  Node coordinates are c + (lambda * h)
// and c - (lambda * h), and a node's terms fold left to right from axis 0,
// as the plain integrands reduce.  The library is built with -fmad=false so
// that no multiply-add is fused, and float64 results agree with the plain
// version to the last bits (f6's test x <= cut falls on the same side).

#include "gm_launch.h"

namespace {

template <typename T>
int dispatch(int device, int d, const gm::Args& a) {
  if (d < 1 || d > GM_MAX_D || a.B < 1 || a.block < 1 || a.block > gm::kMaxBlock ||
      (a.B + a.block - 1) / a.block > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define GM_DIM(D) \
  case D:         \
    return gm::launch<T, D>(a);
  switch (d) {
    GM_DIM(1)
    GM_DIM(2)
    GM_DIM(3)
    GM_DIM(4)
    GM_DIM(5)
    GM_DIM(6)
    GM_DIM(7)
    GM_DIM(8)
    GM_DIM(9)
    GM_DIM(10)
    GM_DIM(11)
    GM_DIM(12)
    GM_DIM(13)
    GM_DIM(14)
    GM_DIM(15)
    GM_DIM(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef GM_DIM
}

template <typename T>
int entry(int device, int kernel_id, int d, long long B, int block, const void* c,
          const void* h, const void* theta, long long th_rs, long long th_ls,
          long long lanes_per_col, void* i7, void* i5, void* i3, void* diffs,
          const double* consts, void* stream) {
  if (lanes_per_col < 0) return cudaErrorInvalidValue;
  const gm::Args a{kernel_id, B,  block, c,     h,      theta, th_rs, th_ls, lanes_per_col,
                   i7,        i5, i3,    diffs, consts, static_cast<cudaStream_t>(stream)};
  return dispatch<T>(device, d, a);
}

}  // namespace

// C entry points, bound with ctypes (kernels/genz_malik_eval.py).  Pointers
// are device addresses of contiguous tensors.  Theta row r of lane i is at
// theta + r * th_rs + i * th_ls, or, with lanes_per_col > 0, at
// theta + r * th_rs + (i / lanes_per_col) * th_ls.  `consts` is a host
// array of the 16 rule constants; `stream` is the caller's CUDA stream.
// The return value is a cudaError_t: 0 once the launch has been queued.
extern "C" int gm_eval_f64(int device, int kernel_id, int d, long long B, int block,
                           const void* c, const void* h, const void* theta, long long th_rs,
                           long long th_ls, long long lanes_per_col, void* i7, void* i5,
                           void* i3, void* diffs, const double* consts, void* stream) {
  return entry<double>(device, kernel_id, d, B, block, c, h, theta, th_rs, th_ls, lanes_per_col,
                       i7, i5, i3, diffs, consts, stream);
}

extern "C" int gm_eval_f32(int device, int kernel_id, int d, long long B, int block,
                           const void* c, const void* h, const void* theta, long long th_rs,
                           long long th_ls, long long lanes_per_col, void* i7, void* i5,
                           void* i3, void* diffs, const double* consts, void* stream) {
  return entry<float>(device, kernel_id, d, B, block, c, h, theta, th_rs, th_ls, lanes_per_col,
                      i7, i5, i3, diffs, consts, stream);
}
