// K19 panel_scatter_nonsym (panel_scatter_nonsym.cuh): the instances of
// its slot target with the orders of H2_ORDER_SWITCH (common.cuh:
// innerOuter, islands, layers and fe, and the component order with a
// singular rule's log tables), on the interval (nPSI 2 and 4), in a source
// of their own so that nvcc compiles them beside the others; the slot
// entry point (panel_scatter_nonsym.cu) reaches them by the order's code.
// Replaces pynucleus_tpu/nl/assembly.py:_bucket_contrib_nonsym (with
// useLogCorr for a component kernel) into the H2 near field's tree CSR
// through the per-pair entry masks (_runPairBuckets with maskLookup,
// _runNearDistantLegacy) for those orders.  Bound on the card as K19's
// other instances: two kernel evaluations per node and the 2 nPSI^2 FMAs.

#include "panel_scatter_nonsym.cuh"

int launchNonsymSlotsPosition(double* data, long long nnz,
                              const double* vertices, int dim,
                              const long long* vi1, int nv1,
                              const long long* vi2, int nv2,
                              const int* slots, int nPSI,
                              const double* volsym, long long P,
                              const double* bary_x, const double* bary_y,
                              const double* w, const double* PHIxPSI,
                              const double* PHIyPSI, int Q, Profile pf,
                              Inter in, Order od, Horizon hz,
                              cudaStream_t stream) {
    return launchNonsym<NS_SLOTS, true>(
        data, nnz, vertices, dim, vi1, nv1, vi2, nv2, nullptr, slots, nPSI,
        volsym, P, bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, pf, in, od, hz,
        stream);
}
