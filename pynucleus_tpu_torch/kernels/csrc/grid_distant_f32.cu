// K2 grid_distant (grid_distant.cuh): the C entry point of its float32
// instances, in a source of their own so that nvcc compiles them beside
// the float64 ones.  They replace, with params={'dtype': float32},
// pynucleus_tpu/nl/assembly.py:131 _grid_distant_pass of the kernels the
// JAX package's _gridEligible takes: the power profile (the fractional
// kernel, tempered or with the smooth two-point weight, and the monomial
// one), the gaussian, exponential, log-inverse-distance and polynomial
// profiles (common.cuh radialValueF).  A, X, vols, PhiXw, PhiX, PsiYw, w
// are float32, each value and each sum a float, as _grid_distant_pass with
// float32 arrays, but the row sums in the scratch R (float64, cast once);
// the profile's constants are rounded to float32 on the host.

#include "grid_distant.cuh"

// R [C, Q] float64 is caller-provided scratch, zeroed by the caller.
EXPORT int grid_distant_f32(float* A, long long N, const float* X, int Q,
                            int dim, const float* ccf, const float* vols,
                            const long long* dofs, int dpe, long long C,
                            const float* PhiXw, const float* PhiX,
                            const float* PsiYw, const float* w, float t_lo,
                            float t_hi, int pcode, double Cg, double e,
                            double a, double C1, double C2, double tl,
                            int wcode, double wl, double* R,
                            cudaStream_t stream) {
    if (C <= 0) return 0;
    if (dim > MAXDIM) return static_cast<int>(cudaErrorInvalidValue);
    const Profile pf = PROFILE_OF(Cg);
#define CASE(QQ, DD)                                                       \
    if (Q == QQ && dpe == DD)                                              \
        return launchGrid<QQ, DD, PC, float>(A, N, X, dim, ccf, vols,      \
                                             dofs, C, PhiXw, PhiX, PsiYw,  \
                                             w, t_lo, t_hi, pf, R, stream);
#define CASES                                                              \
    CASE(3, 3) CASE(6, 3) CASE(12, 3) CASE(16, 3)                          \
    CASE(2, 2) CASE(3, 2) CASE(4, 2) CASE(5, 2)                            \
    return static_cast<int>(cudaErrorInvalidValue);
    switch (pcode) {
        PROFILE_CASE(PROFILE_POWER, CASES)
        F32_FINITE_CASES(CASES)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef CASES
#undef CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
