// Device integrands of the GM kernel, one functor per registry entry.
//
// Every integrand of the registry has the form finish(fold_k term_k(x_k)):
// a per-axis term, folded over the axes left to right from axis 0 with +
// or *, then one scalar function of the folded value.  Each functor gives
// those three pieces as static members:
//
//   term<T, D>(k, x_k, theta)  the factor of axis k at coordinate x_k,
//   fold(acc, t)               acc + t or acc * t,
//   finish<T, D>(acc)          the value of the integrand.
//
// The kernel computes each term once per distinct coordinate of a region
// (gm_kernel.cuh) and only folds and finishes per node.  The
// pieces mirror the plain torch functions of the same name in
// repro_torch/core/integrands.py operation for operation: the first term is
// the fold's starting value (f1's is x_0 itself, not 1 * x_0, and no sum
// starts from 0), constants are rounded to the working type T, and s**11 is
// the square-and-multiply chain.  The library is compiled with -fmad=false,
// so no multiply-add pair is contracted into an FMA and every operation
// rounds as in PyTorch.  kernels/ref.py::genz_malik_eval_soa_tables_ref is
// the same decomposition in torch, checked bit for bit against the plain
// version on the CPU.
//
// The kernel id of each functor is the `kernel_id` of its registry entry;
// kThetaPerAxis is the number of theta rows it reads per axis.
#pragma once

#include <math.h>

// Theta rows of one lane: row r is stage[r] when the block has staged one
// broadcast theta in shared memory, else lane[r * row_stride] in global
// memory (a per-lane theta).  Only term() reads it, so a lane reads each row
// a fixed number of times per region, whatever its number of nodes.
template <typename T>
struct Theta {
  const T* stage;
  const T* lane;
  long long row_stride;
  __device__ __forceinline__ T operator[](int r) const {
    return stage != nullptr ? stage[r] : __ldg(lane + r * row_stride);
  }
};

// Accurate math for each working type (no __expf-style intrinsics).
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_cos(double x) { return cos(x); }
__device__ __forceinline__ float dev_cos(float x) { return cosf(x); }
__device__ __forceinline__ double dev_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float dev_pow(float x, float y) { return powf(x, y); }

struct SumFold {
  template <typename T>
  __device__ __forceinline__ static T fold(T acc, T t) { return acc + t; }
};

struct ProdFold {
  template <typename T>
  __device__ __forceinline__ static T fold(T acc, T t) { return acc * t; }
};

// f1: cos(sum_k (k+1) x_k)
struct F1 : SumFold {
  static constexpr int kId = 0, kThetaPerAxis = 0;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int k, T x, const Theta<T>&) {
    return k == 0 ? x : T(k + 1) * x;
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T s) { return dev_cos(s); }
};

// f2: prod_k 1 / (50^-2 + (x_k - 1/2)^2)
struct F2 : ProdFold {
  static constexpr int kId = 1, kThetaPerAxis = 0;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int, T x, const Theta<T>&) {
    const T t = x - T(0.5);
    return T(1) / (T(0.0004) + t * t);
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T p) { return p; }
};

// f3: (1 + sum_k (k+1) x_k)^-(d+1), a float pow
struct F3 : SumFold {
  static constexpr int kId = 2, kThetaPerAxis = 0;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int k, T x, const Theta<T>&) {
    return k == 0 ? x : T(k + 1) * x;
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T s) { return dev_pow(T(1) + s, T(-(D + 1.0))); }
};

// f4: exp(-625 sum_k (x_k - 1/2)^2)
struct F4 : SumFold {
  static constexpr int kId = 3, kThetaPerAxis = 0;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int, T x, const Theta<T>&) {
    const T t = x - T(0.5);
    return t * t;
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T s) { return dev_exp(T(-625.0) * s); }
};

// f5: exp(-10 sum_k |x_k - 1/2|)
struct F5 : SumFold {
  static constexpr int kId = 4, kThetaPerAxis = 0;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int, T x, const Theta<T>&) { return fabs(x - T(0.5)); }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T s) { return dev_exp(T(-10.0) * s); }
};

// f6: exp(sum_k (k+5) x_k) inside the box x_k <= (k+4)/10, else 0.
// The inside/outside flag rides in the term: a coordinate outside the box
// gives NaN, which the sum carries to finish(), where it means 0.  An
// inside term is finite or -inf (x <= cut), so an inside sum is never NaN,
// and the folded sum of an inside node is the plain version's sum.
struct F6 : SumFold {
  static constexpr int kId = 5, kThetaPerAxis = 0;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int k, T x, const Theta<T>&) {
    const T i = T(k + 1);
    return x <= (T(3) + i) / T(10) ? (i + T(4)) * x : T(NAN);
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T s) { return s == s ? dev_exp(s) : T(0); }
};

// f7: (sum_k x_k^2)^11, as s3 * s8 with s3 = s * s^2, s8 = (s^2)^2^2
struct F7 : SumFold {
  static constexpr int kId = 6, kThetaPerAxis = 0;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int, T x, const Theta<T>&) { return x * x; }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T s) {
    const T s2 = s * s;
    const T s3 = s * s2;
    const T s4 = s2 * s2;
    const T s8 = s4 * s4;
    return s3 * s8;
  }
};

// genz_gaussian: exp(-sum_k (a_k (x_k - u_k))^2); theta rows a[0..d), u[d..2d)
struct GenzGaussian : SumFold {
  static constexpr int kId = 7, kThetaPerAxis = 2;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int k, T x, const Theta<T>& th) {
    const T t = th[k] * (x - th[D + k]);
    return t * t;
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T s) { return dev_exp(-s); }
};

// genz_product_peak: prod_k 1 / (1/(a_k a_k) + (x_k - u_k)^2)
struct GenzProductPeak : ProdFold {
  static constexpr int kId = 8, kThetaPerAxis = 2;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int k, T x, const Theta<T>& th) {
    const T a = th[k];
    const T t = x - th[D + k];
    return T(1) / (T(1) / (a * a) + t * t);
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T p) { return p; }
};

// monomial: prod_k x_k^p_k, a float pow; theta rows p[0..d)
struct Monomial : ProdFold {
  static constexpr int kId = 9, kThetaPerAxis = 1;
  template <typename T, int D>
  __device__ __forceinline__ static T term(int k, T x, const Theta<T>& th) {
    return dev_pow(x, th[k]);
  }
  template <typename T, int D>
  __device__ __forceinline__ static T finish(T p) { return p; }
};
