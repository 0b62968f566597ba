// K19 panel_scatter_nonsym (panel_scatter_nonsym.cuh): the C entry points
// of its dense and slot targets.

#include "panel_scatter_nonsym.cuh"

// The indicator (inter, h2, t00 ... t11) and the whole order
// (ORDER_PARAMS) as K1's, then the variable horizon (Horizon's fields) and
// a singular rule's log tables lnEta, cw1, cw2 [Q] (or null: the component
// order adds them).  An order of position or the component order goes to
// its own instances: of the dense target (panel_scatter_nonsym_order.cu)
// and, for those of H2_ORDER_SWITCH, of the slot target
// (panel_scatter_nonsym_order_h2.cu; the others return
// cudaErrorInvalidValue).
#define NONSYM_TAIL_PARAMS                                                 \
    int pcode, double C, double e, double a, double C1, double C2,            \
        double tl, int wcode, double wl,                                      \
        int inter, double h2, double t00, double t01, double t10,         \
        double t11, ORDER_PARAMS, int hon, double hc0, double hc1,        \
        double hlo, double hhi, double ha, double he, double hd,          \
        double hgamma, double hpiD2, double hexpo, int hnormalized,       \
        const double *lnEta, const double *cw1, const double *cw2,        \
        cudaStream_t stream
#define NONSYM_TAIL_ARGS                                                   \
    PROFILE_OF(C), Inter{inter, h2, t00, t01, t10, t11}, \
        ORDER_WITH_LOGS(lnEta, cw1, cw2),                                  \
        Horizon{hon, hc0, hc1, hlo, hhi, ha, he, hd, hgamma, hpiD2,       \
                hexpo, hnormalized},                                       \
        stream

EXPORT int panel_scatter_nonsym(
    double* A, long long N, const double* vertices, int dim,
    const long long* vi1, int nv1, const long long* vi2, int nv2,
    const long long* dofRows, int nPSI, const double* volsym, long long P,
    const double* bary_x, const double* bary_y, const double* w,
    const double* PHIxPSI, const double* PHIyPSI, int Q,
    NONSYM_TAIL_PARAMS) {
    if (ocode >= ORDER_INNER_OUTER)
        return launchNonsymPosition(
            A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym,
            P, bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, NONSYM_TAIL_ARGS);
    if (lnEta != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launchNonsym<NS_DENSE>(
        A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nullptr, nPSI,
        volsym, P, bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, NONSYM_TAIL_ARGS);
}

EXPORT int panel_scatter_nonsym_slots(
    double* data, long long nnz, const double* vertices, int dim,
    const long long* vi1, int nv1, const long long* vi2, int nv2,
    const int* slots, int nPSI, const double* volsym, long long P,
    const double* bary_x, const double* bary_y, const double* w,
    const double* PHIxPSI, const double* PHIyPSI, int Q,
    NONSYM_TAIL_PARAMS) {
    if (ocode >= ORDER_INNER_OUTER)
        return launchNonsymSlotsPosition(
            data, nnz, vertices, dim, vi1, nv1, vi2, nv2, slots, nPSI,
            volsym, P, bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q,
            NONSYM_TAIL_ARGS);
    if (lnEta != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launchNonsym<NS_SLOTS>(
        data, nnz, vertices, dim, vi1, nv1, vi2, nv2, nullptr, slots, nPSI,
        volsym, P, bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, NONSYM_TAIL_ARGS);
}
