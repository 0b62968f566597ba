// K1 panel_scatter (panel_scatter.cuh): the C entry points of its CSR
// targets.  The order a whole Order (ORDER_PARAMS); an order of position
// has no instance of these targets (cudaErrorInvalidValue).

#include "panel_scatter.cuh"

EXPORT int panel_scatter_slots(double* data, long long nnz,
                               const double* vertices, int dim,
                               const long long* vi1, int nv1,
                               const long long* vi2, int nv2,
                               const int* slots, int nPSI,
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
                               ORDER_PARAMS, const double* yShift,
                               cudaStream_t stream) {
    return launchPanel<SLOTS>(data, nnz, vertices, dim, vi1, nv1, vi2, nv2,
                              nullptr, slots, nPSI, volsym, normals, P,
                              nullptr, nullptr, nullptr, nullptr,
                              TreeTables{}, bary_x, bary_y, w, PSIP, Q,
                              PROFILE_OF(C),
                              Inter{inter, h2, t00, t01, t10, t11},
                              ORDER_OF,
                              yShift, -1LL, stream);
}

EXPORT int panel_scatter_tree(double* data, long long nnz,
                              const double* vertices, int dim,
                              const long long* vi1, int nv1,
                              const long long* vi2, int nv2,
                              const long long* dofRows, int nPSI,
                              const double* volsym, const double* normals,
                              long long P, const int* I, const int* J,
                              const int* offF, const int* offB,
                              const int* dofNode, const int* treePos,
                              const int* indptrT, const int* tStart,
                              const double* bary_x, const double* bary_y,
                              const double* w, const double* PSIP, int Q,
                              int pcode, double C, double e, double a,
                              double C1, double C2,
                              double tl, int wcode, double wl,
                              ORDER_PARAMS, const double* yShift,
                              cudaStream_t stream) {
    return launchPanel<TREE>(data, nnz, vertices, dim, vi1, nv1, vi2, nv2,
                             dofRows, nullptr, nPSI, volsym, normals, P, I,
                             J, offF, offB,
                             TreeTables{dofNode, treePos, indptrT, tStart},
                             bary_x, bary_y, w, PSIP, Q,
                             PROFILE_OF(C), Inter{},
                             ORDER_OF,
                             yShift, -1LL, stream);
}
