// K1 panel_scatter (panel_scatter.cuh): the float32 instances of its DENSE
// target into a float32 A with the profiles other than the power one, in a
// source of their own so that nvcc compiles them beside the others
// (launchF32Smooth<DENSE, float>, reached from panel_scatter_f32 in
// panel_scatter_f32.cu by the profile code).  They replace, with
// params={'dtype': float32}, pynucleus_tpu/nl/assembly.py:91
// _bucket_contrib (+ _device_scatter_rows, _bucket_natural_scatter_scan,
// _bucket_rows_scatter_scan) of the gaussian and exponential kernels of an
// infinite horizon with their boundary forms (the zero-exterior rows, nPSI
// 2 and 3), of the log-inverse-distance kernel, and of the gaussian,
// exponential, log-inverse-distance and polynomial kernels of a finite
// horizon with the indicator (getDense, the float32 DenseAccumulator).

#include "panel_scatter.cuh"

template <>
int launchF32Smooth<DENSE, float>(float* out, const F32Launch& a,
                                  cudaStream_t stream) {
    switch (a.pf.code) {
        F32_FINITE_CASES(return launchF32At<DENSE, PC, float>(out, a, stream))
        PROFILE_CASE(PROFILE_GAUSSIAN_B1,
                     return launchF32At<DENSE, PC, float, true>(out, a,
                                                                stream))
        PROFILE_CASE(PROFILE_GAUSSIAN_B2,
                     return launchF32At<DENSE, PC, float, true>(out, a,
                                                                stream))
        PROFILE_CASE(PROFILE_EXPONENTIAL_B1,
                     return launchF32At<DENSE, PC, float, true>(out, a,
                                                                stream))
        PROFILE_CASE(PROFILE_EXPONENTIAL_B2,
                     return launchF32At<DENSE, PC, float, true>(out, a,
                                                                stream))
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return 0;
}
