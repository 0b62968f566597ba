// K2 grid_distant (grid_distant.cuh): the C entry point of its float64
// instances.

#include "grid_distant.cuh"

// R [C, Q] is caller-provided scratch, zeroed by the caller.
EXPORT int grid_distant(double* A, long long N, const double* X, int Q,
                        int dim, const float* ccf, const double* vols,
                        const long long* dofs, int dpe, long long C,
                        const double* PhiXw, const double* PhiX,
                        const double* PsiYw, const double* w, float t_lo,
                        float t_hi, int pcode, double Cg, double e,
                        double a, double C1, double C2,
                        double tl, int wcode, double wl, double* R,
                        cudaStream_t stream) {
    if (C <= 0) return 0;
    if (dim > MAXDIM) return static_cast<int>(cudaErrorInvalidValue);
#define CASE(QQ, DD)                                                       \
    if (Q == QQ && dpe == DD)                                              \
        return launchGrid<QQ, DD, PC, double>(                            \
            A, N, X, dim, ccf, vols, dofs, C, PhiXw, PhiX, PsiYw, w, t_lo,  \
            t_hi, PROFILE_OF(Cg), R, stream);
    // 2D P1 (dpe 3): compact triangle rules of orders 2, 4, 6, 8; 1D P1
    // (dpe 2): Gauss rules of orders 2, 4, 6, 8
    PROFILE_SWITCH(pcode, CASE(3, 3) CASE(6, 3) CASE(12, 3) CASE(16, 3)
                   CASE(2, 2) CASE(3, 2) CASE(4, 2) CASE(5, 2)
                   return static_cast<int>(cudaErrorInvalidValue))
#undef CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
