// One (working type, dimension) of the GM kernel: the ten integrands'
// kernels at T = GM_T, D = GM_D.  kernels/build.py compiles this file once
// per pair (-DGM_T=double -DGM_D=5, ...), all at once, and links the objects
// with the dispatcher into one library.
#include "gm_kernel.cuh"

#if !defined(GM_T) || !defined(GM_D)
#error "compile with -DGM_T=<double|float> -DGM_D=<1..16>"
#endif

template cudaError_t gm::launch<GM_T, GM_D>(const gm::Args&);
