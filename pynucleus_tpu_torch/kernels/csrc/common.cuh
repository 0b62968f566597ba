// Shared device helpers of the port's CUDA kernels (sm_90a, float64).
#pragma once

#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

#define FULL_MASK 0xffffffffu

// gamma(r2) = C * r2^e for the constant-order fractional kernel and its
// boundary kernel; exactly 0 at r2 == 0 (coincident points of the singular
// rules), as pynucleus_tpu/nl/assembly.py:_radial_eval.
__device__ __forceinline__ double radial(double r2, double C, double e) {
    return r2 > 0.0 ? C * pow(r2, e) : 0.0;
}

__device__ __forceinline__ double warpSum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

// Largest dimension and simplex vertex count the kernels take (triangles
// in 2D; tetrahedra would need 4).
constexpr int MAXDIM = 3;
constexpr int MAXNV = 3;
