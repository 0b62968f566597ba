// K1 panel_scatter (panel_scatter.cuh): the C entry point of its A_BC
// target.

#include "panel_scatter.cuh"

EXPORT int panel_scatter_cross(double* A, long long NB,
                               const double* vertices, int dim,
                               const long long* vi1, int nv1,
                               const long long* vi2, int nv2,
                               const long long* dofRows, int nPSI,
                               const double* volsym, const double* normals,
                               long long P, const double* bary_x,
                               const double* bary_y, const double* w,
                               const double* PSIP, int Q, int pcode, double C,
                               double e, double a,
                               double C1, double C2,
                               double tl, int wcode, double wl,
                               int inter, double h2,
                               double t00, double t01, double t10,
                               double t11,
                               cudaStream_t stream) {
    return launchPanel<CROSS>(A, NB, vertices, dim, vi1, nv1, vi2, nv2,
                              dofRows, nullptr, nPSI, volsym, normals, P,
                              nullptr, nullptr, nullptr, nullptr,
                              TreeTables{}, bary_x, bary_y, w, PSIP, Q,
                              PROFILE_OF(C),
                              Inter{inter, h2, t00, t01, t10, t11},
                              Order{}, nullptr, -1LL, stream);
}
