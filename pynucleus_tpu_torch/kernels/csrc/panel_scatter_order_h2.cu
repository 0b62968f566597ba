// K1 panel_scatter (panel_scatter.cuh): the instances of its CSR targets
// (SLOTS and TREE) with the orders of H2_ORDER_SWITCH (common.cuh:
// innerOuter, islands, layers and fe, and the component order with a
// singular rule's log tables), on the interval (nPSI 2 and 4), in a source
// of their own so that nvcc compiles them beside the others; the CSR entry
// points (panel_scatter_csr.cu) reach them by the order's code.  Replaces
// pynucleus_tpu/nl/assembly.py:_bucket_contrib into the H2 near field for
// those orders: the singular panels of a symmetric order at their masked
// slots (_runPairBuckets with maskLookup), its distant near pairs at tree
// slots (_runNearDistantTree's host path, :3987-4020) and every order's
// union surfaces with useYShift (and useLogCorr for a component kernel,
// _runUnionSurface).  Bound on the card as K1's other targets: a variable
// order's kernel per node (two lgamma, an exp and two pow; the component
// order a pow and a log) and the nPSI^2 FMAs.

#include "panel_scatter.cuh"

int launchPanelH2Position(double* data, long long nnz,
                          const double* vertices, int dim,
                          const long long* vi1, int nv1,
                          const long long* vi2, int nv2,
                          const long long* dofRows, const int* slots,
                          int nPSI, const double* volsym,
                          const double* normals, long long P, const int* I,
                          const int* J, const int* offF, const int* offB,
                          TreeTables tt, const double* bary_x,
                          const double* bary_y, const double* w,
                          const double* PSIP, int Q, Profile pf, Order od,
                          const double* yShift, cudaStream_t stream) {
    if (slots != nullptr)
        return launchPanel<SLOTS, true>(
            data, nnz, vertices, dim, vi1, nv1, vi2, nv2, nullptr, slots,
            nPSI, volsym, normals, P, nullptr, nullptr, nullptr, nullptr,
            TreeTables{}, bary_x, bary_y, w, PSIP, Q, pf, Inter{}, od,
            yShift, -1LL, stream);
    return launchPanel<TREE, true>(
        data, nnz, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nullptr,
        nPSI, volsym, normals, P, I, J, offF, offB, tt, bary_x, bary_y, w,
        PSIP, Q, pf, Inter{}, od, yShift, -1LL, stream);
}
