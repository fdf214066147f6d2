// Launch interface between the dispatcher (genz_malik_eval.cu) and the
// translation units that instantiate the GM kernel (gm_instance.cu, one per
// working type and dimension; kernels/build.py compiles them in parallel).
#pragma once

#include <cuda_runtime.h>

#define GM_MAX_D 16

namespace gm {

// Every block size the wrapper accepts (powers of two up to this) launches
// at every D: the kernel is compiled with __launch_bounds__(kMaxBlock, 1).
constexpr int kMaxBlock = 512;

struct Args {
  int kernel_id;
  long long B;
  int block;
  const void* c;
  const void* h;
  const void* theta;  // may be null
  long long th_rs, th_ls;
  long long lanes_per_col;  // 0: lane i reads theta + i * th_ls; else column i / lanes_per_col
  void* i7;
  void* i5;
  void* i3;
  void* diffs;
  const double* consts;  // host array of the 16 rule constants
  cudaStream_t stream;
};

// Launches the kernel of integrand a.kernel_id at dimension D.  Defined in
// gm_kernel.cuh and instantiated for one (T, D) per gm_instance.cu build.
template <typename T, int D>
cudaError_t launch(const Args& a);

}  // namespace gm
