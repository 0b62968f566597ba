// K1 panel_scatter (panel_scatter.cuh): the C entry points of its CSR
// targets.  The order a whole Order (ORDER_PARAMS); both targets reach the
// instances of the orders of H2_ORDER_SWITCH (panel_scatter_order_h2.cu)
// by the code (the others return cudaErrorInvalidValue), the tree target
// with a singular rule's log tables lnEta, cw1, cw2 [Q] (or null) for the
// component order.

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
    if (ocode >= ORDER_INNER_OUTER)
        return launchPanelH2Position(
            data, nnz, vertices, dim, vi1, nv1, vi2, nv2, nullptr, slots,
            nPSI, volsym, normals, P, nullptr, nullptr, nullptr, nullptr,
            TreeTables{}, bary_x, bary_y, w, PSIP, Q, PROFILE_OF(C),
            ORDER_OF, yShift, stream);
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
                              const double* lnEta, const double* cw1,
                              const double* cw2, cudaStream_t stream) {
    if (ocode >= ORDER_INNER_OUTER)
        return launchPanelH2Position(
            data, nnz, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nullptr,
            nPSI, volsym, normals, P, I, J, offF, offB,
            TreeTables{dofNode, treePos, indptrT, tStart}, bary_x, bary_y,
            w, PSIP, Q, PROFILE_OF(C), ORDER_WITH_LOGS(lnEta, cw1, cw2),
            yShift, stream);
    if (lnEta != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launchPanel<TREE>(data, nnz, vertices, dim, vi1, nv1, vi2, nv2,
                             dofRows, nullptr, nPSI, volsym, normals, P, I,
                             J, offF, offB,
                             TreeTables{dofNode, treePos, indptrT, tStart},
                             bary_x, bary_y, w, PSIP, Q,
                             PROFILE_OF(C), Inter{},
                             ORDER_OF,
                             yShift, -1LL, stream);
}
