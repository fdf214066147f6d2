// The fused GM kernel, templated on the working type T, the dimension D and
// the integrand F.  The design note is at the top of genz_malik_eval.cu;
// the rounding rules are restated where each sum is taken.
#pragma once

#include <cuda_runtime.h>

#include "gm_launch.h"
#include "integrands.cuh"

namespace gm {

// Corner axes unrolled inside the corner loop: their table entries are
// picked at compile time, the others once per 2^kLowAxes corners (2 and 3
// were no faster on the H100, PERF.md).
constexpr int kLowAxes = 4;

// Rule constants in the working type, rounded from the float64 values the
// host passes (core/genz_malik.py's gm_weights and LAMBDA*).
template <typename T>
struct Consts {
  T lam2, lam3, lam4, lam5, ratio;
  T w1, w2, w3, w4, w5;
  T e1, e2, e3, e4;
  T t1, t3;
};

// A read of an input word that the compiler may not merge with an earlier
// read of the same word: each phase re-reads c and h (they are cached)
// rather than keeping 2D words live in registers across the whole kernel.
__device__ __forceinline__ double load_fresh(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_fresh(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// At least one block of kMaxBlock threads per SM: that caps the kernel at
// 128 registers and tells ptxas not to spill for a higher occupancy
// (without the 1, ptxas chose 64 registers and spilled at D = 4 and 5 in
// float64).
template <typename T, int D, typename F>
__global__ void __launch_bounds__(kMaxBlock, 1)
gm_eval_kernel(const T* __restrict__ c, const T* __restrict__ h,
               const T* __restrict__ theta, long long th_rs, long long th_ls,
               long long lanes_per_col, T* __restrict__ i7, T* __restrict__ i5,
               T* __restrict__ i3, T* __restrict__ diffs, long long B, Consts<T> k) {
  constexpr int kThetaRows = F::kThetaPerAxis * D;
  constexpr int L = D < kLowAxes ? D : kLowAxes;
  constexpr int H = D - L;

  // A broadcast theta (lane stride 0, the main path) is staged once per
  // block; a per-lane theta is read from global memory by term().  With
  // lanes_per_col > 0, lane i reads column i / lanes_per_col (the batch
  // service: one column per slot, each slot's window a run of lanes); a
  // block may straddle two slots, so the column is the lane's own.
  __shared__ T stage[kThetaRows > 0 ? kThetaRows : 1];
  const bool broadcast = kThetaRows > 0 && th_ls == 0;
  if (broadcast) {
    for (int r = threadIdx.x; r < kThetaRows; r += blockDim.x) stage[r] = theta[r * th_rs];
    __syncthreads();
  }

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long col = lanes_per_col > 0 ? i / lanes_per_col : i;
  const Theta<T> th{broadcast ? stage : nullptr,
                    kThetaRows > 0 ? theta + col * th_ls : nullptr, th_rs};
  const T* cl = c + i;  // axis q of this lane's centre at cl[q * B]
  const T* hl = h + i;

  // Term tables, in registers (every index is a compile-time constant once
  // the axis loops are unrolled).  C: the centre's terms; P, M: the terms
  // at c + s and c - s, with s = lambda4 h for the pair group, then
  // lambda5 h for the corners.
  T C[D], P[D], M[D];

  T scale = load_fresh(hl);
#pragma unroll
  for (int q = 1; q < D; ++q) scale = scale * load_fresh(hl + q * B);

  // group 0: the centre
#pragma unroll
  for (int q = 0; q < D; ++q) C[q] = F::template term<T, D>(q, load_fresh(cl + q * B), th);
  T acc0 = C[0];
#pragma unroll
  for (int q = 1; q < D; ++q) acc0 = F::fold(acc0, C[q]);
  const T f0 = F::template finish<T, D>(acc0);
  const T two_f0 = T(2) * f0;

  // groups 1 and 2: +-lambda2, +-lambda3 on axis a, by ascending axis, +
  // before -; a node folds the centre's terms before a (shared prefix), its
  // own term, then the centre's terms after a.
  T sum2 = T(0), sum3 = T(0);
  T pre = T(0);  // fold of C[0..a)
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const T ca = load_fresh(cl + a * B);
    const T ha = load_fresh(hl + a * B);
    const T d2 = k.lam2 * ha;
    const T d3 = k.lam3 * ha;
    T n2p = F::template term<T, D>(a, ca + d2, th);
    T n2m = F::template term<T, D>(a, ca - d2, th);
    T n3p = F::template term<T, D>(a, ca + d3, th);
    T n3m = F::template term<T, D>(a, ca - d3, th);
    if (a > 0) {
      n2p = F::fold(pre, n2p);
      n2m = F::fold(pre, n2m);
      n3p = F::fold(pre, n3p);
      n3m = F::fold(pre, n3m);
    }
#pragma unroll
    for (int q = 0; q < D; ++q)
      if (q > a) {
        const T cq = C[q];
        n2p = F::fold(n2p, cq);
        n2m = F::fold(n2m, cq);
        n3p = F::fold(n3p, cq);
        n3m = F::fold(n3m, cq);
      }
    const T f2p = F::template finish<T, D>(n2p);
    const T f2m = F::template finish<T, D>(n2m);
    const T f3p = F::template finish<T, D>(n3p);
    const T f3m = F::template finish<T, D>(n3m);
    sum2 = sum2 + f2p;
    sum2 = sum2 + f2m;
    sum3 = sum3 + f3p;
    sum3 = sum3 + f3m;
    diffs[a * B + i] = fabs(f2p + f2m - two_f0 - k.ratio * (f3p + f3m - two_f0));
    pre = a == 0 ? C[0] : F::fold(pre, C[a]);
  }

  // group 3: (+-lambda4, +-lambda4) on each pair of axes a < b, pairs in
  // order, signs (+,+), (+,-), (-,+), (-,-).  a is unrolled; b is a runtime
  // loop whose axis test is one select per later axis.
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const T cq = load_fresh(cl + q * B);
    const T sq = k.lam4 * load_fresh(hl + q * B);
    P[q] = F::template term<T, D>(q, cq + sq, th);
    M[q] = F::template term<T, D>(q, cq - sq, th);
  }
  T sum4 = T(0);
  pre = T(0);
#pragma unroll
  for (int a = 0; a < D - 1; ++a) {
    const T pa = a == 0 ? P[0] : F::fold(pre, P[a]);
    const T ma = a == 0 ? M[0] : F::fold(pre, M[a]);
#pragma unroll 1
    for (int b = a + 1; b < D; ++b) {
      T npp = pa, npm = pa, nmp = ma, nmm = ma;
#pragma unroll
      for (int q = 0; q < D; ++q)
        if (q > a) {
          const T cq = C[q];
          const bool at_b = q == b;
          const T pq = at_b ? P[q] : cq;
          const T mq = at_b ? M[q] : cq;
          npp = F::fold(npp, pq);
          npm = F::fold(npm, mq);
          nmp = F::fold(nmp, pq);
          nmm = F::fold(nmm, mq);
        }
      sum4 = sum4 + F::template finish<T, D>(npp);
      sum4 = sum4 + F::template finish<T, D>(npm);
      sum4 = sum4 + F::template finish<T, D>(nmp);
      sum4 = sum4 + F::template finish<T, D>(nmm);
    }
    pre = a == 0 ? C[0] : F::fold(pre, C[a]);
  }

  // group 4: the 2^D corners at +-lambda5, m = 0 .. 2^D - 1, bit q of m
  // set meaning axis q negative.  m = mh * 2^L + ml: the L low axes are
  // unrolled (their terms picked at compile time), the high axes' terms are
  // picked once per mh.
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const T cq = load_fresh(cl + q * B);
    const T sq = k.lam5 * load_fresh(hl + q * B);
    P[q] = F::template term<T, D>(q, cq + sq, th);
    M[q] = F::template term<T, D>(q, cq - sq, th);
  }
  T lo_p[L], lo_m[L];
#pragma unroll
  for (int q = 0; q < L; ++q) {
    lo_p[q] = P[q];
    lo_m[q] = M[q];
  }
  T sum5 = T(0);
#pragma unroll 1
  for (int mh = 0; mh < (1 << H); ++mh) {
    T hi[H > 0 ? H : 1];
#pragma unroll
    for (int q = L; q < D; ++q) hi[q - L] = ((mh >> (q - L)) & 1) ? M[q] : P[q];
#pragma unroll
    for (int ml = 0; ml < (1 << L); ++ml) {
      T acc = (ml & 1) ? lo_m[0] : lo_p[0];
#pragma unroll
      for (int q = 1; q < D; ++q) {
        if (q < L)
          acc = F::fold(acc, ((ml >> q) & 1) ? lo_m[q] : lo_p[q]);
        else
          acc = F::fold(acc, hi[q >= L ? q - L : 0]);
      }
      sum5 = sum5 + F::template finish<T, D>(acc);
    }
  }

  i7[i] = scale * (k.w1 * f0 + k.w2 * sum2 + k.w3 * sum3 + k.w4 * sum4 + k.w5 * sum5);
  i5[i] = scale * (k.e1 * f0 + k.e2 * sum2 + k.e3 * sum3 + k.e4 * sum4);
  i3[i] = scale * (k.t1 * f0 + k.t3 * sum3);
}

template <typename T>
Consts<T> make_consts(const double* v) {
  Consts<T> k;
  T* out[] = {&k.lam2, &k.lam3, &k.lam4, &k.lam5, &k.ratio, &k.w1,
              &k.w2,   &k.w3,   &k.w4,   &k.w5,   &k.e1,    &k.e2,
              &k.e3,   &k.e4,   &k.t1,   &k.t3};
  for (int q = 0; q < 16; ++q) *out[q] = T(v[q]);
  return k;
}

template <typename T, int D, typename F>
cudaError_t launch_integrand(const Args& a) {
  const long long grid = (a.B + a.block - 1) / a.block;
  gm_eval_kernel<T, D, F><<<static_cast<unsigned>(grid), a.block, 0, a.stream>>>(
      static_cast<const T*>(a.c), static_cast<const T*>(a.h), static_cast<const T*>(a.theta),
      a.th_rs, a.th_ls, a.lanes_per_col, static_cast<T*>(a.i7), static_cast<T*>(a.i5),
      static_cast<T*>(a.i3), static_cast<T*>(a.diffs), a.B, make_consts<T>(a.consts));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
#define GM_CASE(F) \
  case F::kId:     \
    return launch_integrand<T, D, F>(a);
  switch (a.kernel_id) {
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

}  // namespace gm
