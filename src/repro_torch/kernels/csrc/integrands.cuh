// Device integrands of the GM kernel, one functor per registry entry.
//
// Each functor mirrors the plain torch function of the same name in
// repro_torch/core/integrands.py operation for operation: sums and
// products over the axes run left to right from axis 0, constants are
// rounded to the working type T, and s**11 is the square-and-multiply
// chain.  The file is compiled with -fmad=false, so no multiply-add pair
// is contracted into an FMA and each operation rounds as in PyTorch.
//
// The kernel id of each functor is the `kernel_id` of its registry entry.
#pragma once

#include <math.h>

#define GM_MAX_D 16

// Theta rows of one lane: row r of the (n_theta, B) operand at p[r * row_stride].
template <typename T>
struct Theta {
  const T* p;
  long long row_stride;
  __device__ __forceinline__ T operator[](int r) const { return __ldg(p + r * row_stride); }
};

// Accurate math for each working type (no __expf-style intrinsics).
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_cos(double x) { return cos(x); }
__device__ __forceinline__ float dev_cos(float x) { return cosf(x); }
__device__ __forceinline__ double dev_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float dev_pow(float x, float y) { return powf(x, y); }

// f1: cos(sum_k (k+1) x_k)
struct F1 {
  static constexpr int kId = 0;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>&) {
    T s = x[0];
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) s = s + T(k + 1) * x[k];
    return dev_cos(s);
  }
};

// f2: prod_k 1 / (50^-2 + (x_k - 1/2)^2)
struct F2 {
  static constexpr int kId = 1;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>&) {
    T t = x[0] - T(0.5);
    T p = T(1) / (T(0.0004) + t * t);
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) {
        t = x[k] - T(0.5);
        p = p * (T(1) / (T(0.0004) + t * t));
      }
    return p;
  }
};

// f3: (1 + sum_k (k+1) x_k)^-(d+1), a float pow
struct F3 {
  static constexpr int kId = 2;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>&) {
    T s = x[0];
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) s = s + T(k + 1) * x[k];
    return dev_pow(T(1) + s, T(-(d + 1.0)));
  }
};

// f4: exp(-625 sum_k (x_k - 1/2)^2)
struct F4 {
  static constexpr int kId = 3;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>&) {
    T t = x[0] - T(0.5);
    T s = t * t;
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) {
        t = x[k] - T(0.5);
        s = s + t * t;
      }
    return dev_exp(T(-625.0) * s);
  }
};

// f5: exp(-10 sum_k |x_k - 1/2|)
struct F5 {
  static constexpr int kId = 4;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>&) {
    T s = fabs(x[0] - T(0.5));
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) s = s + fabs(x[k] - T(0.5));
    return dev_exp(T(-10.0) * s);
  }
};

// f6: exp(sum_k (k+5) x_k) inside the box x_k <= (k+4)/10, else 0
struct F6 {
  static constexpr int kId = 5;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>&) {
    bool inside = true;
    T s = T(0);
#pragma unroll
    for (int k = 0; k < GM_MAX_D; ++k)
      if (k < d) {
        const T i = T(k + 1);
        inside = inside && (x[k] <= (T(3) + i) / T(10));
        const T term = (i + T(4)) * x[k];
        s = (k == 0) ? term : s + term;
      }
    return inside ? dev_exp(s) : T(0);
  }
};

// f7: (sum_k x_k^2)^11, as s3 * s8 with s3 = s * s^2, s8 = (s^2)^2^2
struct F7 {
  static constexpr int kId = 6;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>&) {
    T s = x[0] * x[0];
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) s = s + x[k] * x[k];
    const T s2 = s * s;
    const T s3 = s * s2;
    const T s4 = s2 * s2;
    const T s8 = s4 * s4;
    return s3 * s8;
  }
};

// genz_gaussian: exp(-sum_k (a_k (x_k - u_k))^2); theta rows a[0..d), u[d..2d)
struct GenzGaussian {
  static constexpr int kId = 7;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>& th) {
    T t = th[0] * (x[0] - th[d]);
    T s = t * t;
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) {
        t = th[k] * (x[k] - th[d + k]);
        s = s + t * t;
      }
    return dev_exp(-s);
  }
};

// genz_product_peak: prod_k 1 / (1/(a_k a_k) + (x_k - u_k)^2)
struct GenzProductPeak {
  static constexpr int kId = 8;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>& th) {
    T a = th[0];
    T t = x[0] - th[d];
    T p = T(1) / (T(1) / (a * a) + t * t);
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) {
        a = th[k];
        t = x[k] - th[d + k];
        p = p * (T(1) / (T(1) / (a * a) + t * t));
      }
    return p;
  }
};

// monomial: prod_k x_k^p_k, a float pow; theta rows p[0..d)
struct Monomial {
  static constexpr int kId = 9;
  template <typename T>
  __device__ __forceinline__ static T eval(const T (&x)[GM_MAX_D], int d, const Theta<T>& th) {
    T p = dev_pow(x[0], th[0]);
#pragma unroll
    for (int k = 1; k < GM_MAX_D; ++k)
      if (k < d) p = p * dev_pow(x[k], th[k]);
    return p;
  }
};
