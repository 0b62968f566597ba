// K1 panel_scatter (panel_scatter.cuh): the float32 instances of its
// SLOTS, CROSS and DIAG targets into float64 data with the profiles other
// than the power one, in a source of their own so that nvcc compiles them
// beside the others (launchF32Smooth, reached from the entry points of
// panel_scatter_f32.cu by the profile code).  Float32 local entries, with
// the indicator of a finite horizon, summed in float64, as the JAX
// package's host accumulators sum the float32 program's matrices: they
// replace pynucleus_tpu/nl/assembly.py:91 _bucket_contrib of the
// gaussian, exponential, log-inverse-distance and polynomial kernels of a
// finite horizon into CSRAccumulator (:1033, getSparse), BCAccumulator
// (:1011, getDenseCross) and _DiagAccumulator (:926, getDiagonal), and of
// the boundary forms of the gaussian and exponential kernels (the
// zero-exterior rows of an infinite horizon's getDiagonal, nPSI 2 and 3)
// into _DiagAccumulator.

#include "panel_scatter.cuh"

template <>
int launchF32Smooth<SLOTS, double>(double* out, const F32Launch& a,
                                   cudaStream_t stream) {
    F32_FINITE_SWITCH(a.pf.code,
                      return launchF32At<SLOTS, PC, double>(out, a, stream))
    return 0;
}

template <>
int launchF32Smooth<CROSS, double>(double* out, const F32Launch& a,
                                   cudaStream_t stream) {
    F32_FINITE_SWITCH(a.pf.code,
                      return launchF32At<CROSS, PC, double>(out, a, stream))
    return 0;
}

template <>
int launchF32Smooth<DIAG, double>(double* out, const F32Launch& a,
                                  cudaStream_t stream) {
    switch (a.pf.code) {
        F32_FINITE_CASES(return launchF32At<DIAG, PC, double>(out, a, stream))
        default:
            F32_BOUNDARY_SWITCH(a.pf.code,
                                return launchF32At<DIAG, PC, double, true>(
                                    out, a, stream))
    }
    return 0;
}
