// Fused Genz-Malik rule evaluation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `genz_malik_eval_soa` in src/repro/kernels/genz_malik_eval.py.  For each
// region (one column of the (d, B) SoA centre / half-width arrays) it
//   1. generates the 1 + 4d + 2d(d-1) + 2^d Genz-Malik nodes in registers,
//   2. evaluates the integrand, a device functor chosen by kernel id
//      (integrands.cuh), at each node,
//   3. writes i7, i5, i3, each scaled by prod(h), and the per-axis fourth
//      differences |f2+ + f2- - 2 f0 - (1/7)(f3+ + f3- - 2 f0)| as (d, B).
//
// Traffic: it reads 2*d*B words (plus one broadcast theta row set) and
// writes (3 + d)*B words.  Work: n_nodes(d) * (d + the integrand's
// operations) per region, which grows as 2^d while the traffic grows as d,
// so the kernel is bound by arithmetic on the FP64 units: 34 TFLOP/s
// outside the tensor cores on an H100 SXM (NVIDIA data sheet), against
// 3.35 TB/s of HBM.
//
// Design: one thread per region, regions along
// blockIdx.x * blockDim.x + threadIdx.x.  Thread i reads c[k*B + i] and
// writes out[k*B + i], so neighbouring threads touch neighbouring words and
// every load and store is coalesced.  The centre, half-widths and current
// node live in register arrays of GM_MAX_D entries; loops over axes are
// unrolled with a `k < d` guard, and a runtime axis is written through an
// unrolled select so that the arrays are never indexed dynamically (which
// would put them in local memory).  Only node generation and the integrand
// run per node; nothing but the 3 + d results leaves the thread.  The
// ragged last block is masked.  Speed work (warp specialisation, staging
// node groups through shared memory, float32 paths) is left to later work.
//
// Rounding: the sums run in the order of the plain version
// (repro_torch/core/genz_malik.py): axis groups by ascending axis, + before
// -, lambda2 then lambda3; pairs i < j in the order (+,+), (+,-), (-,+),
// (-,-); corners k = 0 .. 2^d - 1 with bit i of k set meaning axis i is
// negative; then the weighted sums.  Node coordinates are c + (lambda * h)
// and c - (lambda * h).  The library is built with -fmad=false so that no
// multiply-add is fused, and float64 results agree with the plain version
// to the last bits (f6's test x <= cut falls on the same side).

#include <cuda_runtime.h>

#include "integrands.cuh"

namespace {

constexpr int kMaxBlock = 512;

// Rule constants in the working type, rounded from the float64 values the
// host passes (core/genz_malik.py's gm_weights and LAMBDA*).
template <typename T>
struct GMConst {
  T lam2, lam3, lam4, lam5, ratio;
  T w1, w2, w3, w4, w5;
  T e1, e2, e3, e4;
  T t1, t3;
};

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[GM_MAX_D], int i) {
  T v = a[0];
#pragma unroll
  for (int q = 1; q < GM_MAX_D; ++q)
    if (q == i) v = a[q];
  return v;
}

template <typename T>
__device__ __forceinline__ void put(T (&a)[GM_MAX_D], int i, T v) {
#pragma unroll
  for (int q = 0; q < GM_MAX_D; ++q)
    if (q == i) a[q] = v;
}

template <typename T, typename F>
__global__ void __launch_bounds__(kMaxBlock)
gm_eval_kernel(const T* __restrict__ c, const T* __restrict__ h,
               const T* __restrict__ theta, long long th_row_stride,
               long long th_lane_stride, T* __restrict__ i7,
               T* __restrict__ i5, T* __restrict__ i3,
               T* __restrict__ diffs, int d, long long B, GMConst<T> k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;

  T cc[GM_MAX_D], hh[GM_MAX_D], x[GM_MAX_D];
#pragma unroll
  for (int a = 0; a < GM_MAX_D; ++a) {
    cc[a] = (a < d) ? c[a * B + i] : T(0);
    hh[a] = (a < d) ? h[a * B + i] : T(0);
    x[a] = cc[a];
  }
  const Theta<T> th{theta == nullptr ? nullptr : theta + i * th_lane_stride,
                    th_row_stride};

  const T f0 = F::eval(x, d, th);
  const T two_f0 = T(2) * f0;

  // groups 1 and 2: +-lambda2, +-lambda3 on one axis; fourth differences
  T sum2 = T(0), sum3 = T(0);
  for (int a = 0; a < d; ++a) {
    const T ca = pick(cc, a);
    const T ha = pick(hh, a);
    const T d2 = k.lam2 * ha;
    const T d3 = k.lam3 * ha;
    put(x, a, ca + d2);
    const T f2p = F::eval(x, d, th);
    put(x, a, ca - d2);
    const T f2m = F::eval(x, d, th);
    put(x, a, ca + d3);
    const T f3p = F::eval(x, d, th);
    put(x, a, ca - d3);
    const T f3m = F::eval(x, d, th);
    put(x, a, ca);
    sum2 = sum2 + f2p;
    sum2 = sum2 + f2m;
    sum3 = sum3 + f3p;
    sum3 = sum3 + f3m;
    diffs[a * B + i] = fabs(f2p + f2m - two_f0 - k.ratio * (f3p + f3m - two_f0));
  }

  // group 3: (+-lambda4, +-lambda4) on each pair of axes a < b
  T sum4 = T(0);
  for (int a = 0; a < d; ++a) {
    const T ca = pick(cc, a);
    const T da = k.lam4 * pick(hh, a);
    for (int b = a + 1; b < d; ++b) {
      const T cb = pick(cc, b);
      const T db = k.lam4 * pick(hh, b);
      put(x, a, ca + da);
      put(x, b, cb + db);
      sum4 = sum4 + F::eval(x, d, th);
      put(x, b, cb - db);
      sum4 = sum4 + F::eval(x, d, th);
      put(x, a, ca - da);
      put(x, b, cb + db);
      sum4 = sum4 + F::eval(x, d, th);
      put(x, b, cb - db);
      sum4 = sum4 + F::eval(x, d, th);
      put(x, b, cb);
    }
    put(x, a, ca);
  }

  // group 4: the 2^d corners at +-lambda5, signs from the bits of m
  T step[GM_MAX_D];
#pragma unroll
  for (int a = 0; a < GM_MAX_D; ++a) step[a] = k.lam5 * hh[a];
  T sum5 = T(0);
  const long long n_corners = 1LL << d;
  for (long long m = 0; m < n_corners; ++m) {
#pragma unroll
    for (int a = 0; a < GM_MAX_D; ++a)
      if (a < d) x[a] = ((m >> a) & 1) ? cc[a] - step[a] : cc[a] + step[a];
    sum5 = sum5 + F::eval(x, d, th);
  }

  T scale = hh[0];
#pragma unroll
  for (int a = 1; a < GM_MAX_D; ++a)
    if (a < d) scale = scale * hh[a];

  i7[i] = scale * (k.w1 * f0 + k.w2 * sum2 + k.w3 * sum3 + k.w4 * sum4 + k.w5 * sum5);
  i5[i] = scale * (k.e1 * f0 + k.e2 * sum2 + k.e3 * sum3 + k.e4 * sum4);
  i3[i] = scale * (k.t1 * f0 + k.t3 * sum3);
}

template <typename T>
GMConst<T> make_consts(const double* v) {
  GMConst<T> k;
  T* out[] = {&k.lam2, &k.lam3, &k.lam4, &k.lam5, &k.ratio, &k.w1,
              &k.w2,   &k.w3,   &k.w4,   &k.w5,   &k.e1,    &k.e2,
              &k.e3,   &k.e4,   &k.t1,   &k.t3};
  for (int q = 0; q < 16; ++q) *out[q] = T(v[q]);
  return k;
}

template <typename T, typename F>
cudaError_t launch(int d, long long B, int block, const void* c, const void* h,
                   const void* theta, long long th_rs, long long th_ls,
                   void* i7, void* i5, void* i3, void* diffs,
                   const double* consts, cudaStream_t stream) {
  const long long grid = (B + block - 1) / block;
  gm_eval_kernel<T, F><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(h),
      static_cast<const T*>(theta), th_rs, th_ls, static_cast<T*>(i7),
      static_cast<T*>(i5), static_cast<T*>(i3), static_cast<T*>(diffs), d, B,
      make_consts<T>(consts));
  return cudaGetLastError();
}

template <typename T>
int dispatch(int device, int kernel_id, int d, long long B, int block,
             const void* c, const void* h, const void* theta, long long th_rs,
             long long th_ls, void* i7, void* i5, void* i3, void* diffs,
             const double* consts, void* stream) {
  if (d < 1 || d > GM_MAX_D || B < 1 || block < 1 || block > kMaxBlock ||
      (B + block - 1) / block > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GM_CASE(F)                                                             \
  case F::kId:                                                                 \
    return launch<T, F>(d, B, block, c, h, theta, th_rs, th_ls, i7, i5, i3,    \
                        diffs, consts, s);
  switch (kernel_id) {
    GM_CASE(F1)
    GM_CASE(F2)
    GM_CASE(F3)
    GM_CASE(F4)
    GM_CASE(F5)
    GM_CASE(F6)
    GM_CASE(F7)
    GM_CASE(GenzGaussian)
    GM_CASE(GenzProductPeak)
    GM_CASE(Monomial)
    default:
      return cudaErrorInvalidValue;
  }
#undef GM_CASE
}

}  // namespace

// C entry points, bound with ctypes (kernels/genz_malik_eval.py).  Pointers
// are device addresses of contiguous tensors; `consts` is a host array of
// the 16 rule constants; `stream` is the caller's CUDA stream.  The return
// value is a cudaError_t: 0 once the launch has been queued.
extern "C" int gm_eval_f64(int device, int kernel_id, int d, long long B,
                           int block, const void* c, const void* h,
                           const void* theta, long long th_rs, long long th_ls,
                           void* i7, void* i5, void* i3, void* diffs,
                           const double* consts, void* stream) {
  return dispatch<double>(device, kernel_id, d, B, block, c, h, theta, th_rs,
                          th_ls, i7, i5, i3, diffs, consts, stream);
}

extern "C" int gm_eval_f32(int device, int kernel_id, int d, long long B,
                           int block, const void* c, const void* h,
                           const void* theta, long long th_rs, long long th_ls,
                           void* i7, void* i5, void* i3, void* diffs,
                           const double* consts, void* stream) {
  return dispatch<float>(device, kernel_id, d, B, block, c, h, theta, th_rs,
                         th_ls, i7, i5, i3, diffs, consts, stream);
}
