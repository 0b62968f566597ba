// K1 panel_scatter (panel_scatter.cuh): the C entry points of its dense
// and diagonal targets.

#include "panel_scatter.cuh"

EXPORT const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A: dense [N, N]; with pcode PROFILE_GREENS_2D the float64 view of a
// complex128 A (and of a complex128 d [N] in panel_scatter_diag).  The
// order a whole Order (ORDER_PARAMS); an order of position (the codes from
// ORDER_INNER_OUTER on) goes to its own instances.  emask: bit I*nPSI+J
// keeps local entry (I, J) of every pair (-1: all).
EXPORT int panel_scatter(double* A, long long N, const double* vertices,
                         int dim, const long long* vi1, int nv1,
                         const long long* vi2, int nv2,
                         const long long* dofRows, int nPSI,
                         const double* volsym, const double* normals,
                         long long P, const double* bary_x,
                         const double* bary_y, const double* w,
                         const double* PSIP, int Q, int pcode, double C,
                         double e, double a,
                         double C1, double C2,
                         double tl, int wcode, double wl, int inter, double h2,
                         double t00, double t01, double t10, double t11,
                         ORDER_PARAMS, const double* yShift,
                         long long emask, cudaStream_t stream) {
    if (ocode >= ORDER_INNER_OUTER)
        // an order of position: its instances (panel_scatter_order.cu)
        return launchPanelPosition(
            A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym,
            normals, P, bary_x, bary_y, w, PSIP, Q, PROFILE_OF(C),
            Inter{inter, h2, t00, t01, t10, t11}, ORDER_OF, yShift, emask,
            stream);
    return launchPanel<DENSE>(A, N, vertices, dim, vi1, nv1, vi2, nv2,
                              dofRows, nullptr, nPSI, volsym, normals, P,
                              nullptr, nullptr, nullptr, nullptr,
                              TreeTables{}, bary_x, bary_y, w, PSIP, Q,
                              PROFILE_OF(C),
                              Inter{inter, h2, t00, t01, t10, t11}, ORDER_OF,
                              yShift, emask, stream);
}

EXPORT int panel_scatter_diag(double* d, long long N,
                              const double* vertices, int dim,
                              const long long* vi1, int nv1,
                              const long long* vi2, int nv2,
                              const long long* dofRows, int nPSI,
                              const double* volsym, const double* normals,
                              long long P, const double* bary_x,
                              const double* bary_y, const double* w,
                              const double* PSIP, int Q, int pcode, double C,
                              double e, double a, double C1, double C2,
                              double tl, int wcode, double wl,
                              int inter, double h2, double t00, double t01,
                              double t10, double t11, cudaStream_t stream) {
    return launchPanel<DIAG>(d, N, vertices, dim, vi1, nv1, vi2, nv2,
                             dofRows, nullptr, nPSI, volsym, normals, P,
                             nullptr, nullptr, nullptr, nullptr,
                             TreeTables{}, bary_x, bary_y, w, PSIP, Q,
                             PROFILE_OF(C),
                             Inter{inter, h2, t00, t01, t10, t11}, Order{},
                             nullptr, -1LL, stream);
}
