// K1 panel_scatter (panel_scatter.cuh): the instances of its dense target
// with the orders of position (common.cuh orderAt: innerOuter, islands,
// layers, smoothedLeftRight, linearLeftRight, smoothedInnerOuter and fe)
// and the component order (common.cuh componentTerm), in a source of their
// own so that nvcc compiles them beside the others; the dense entry point
// (panel_scatter.cu) reaches them by the order's code.  Replaces
// pynucleus_tpu/nl/assembly.py:_bucket_contrib + the dense scatter with
// FractionalKernel.evalXY of those orders, and with
// _ComponentFractionalKernel.evalXY and useLogCorr (:68
// _log_extra_scalar).

#include "panel_scatter.cuh"

int launchPanelPosition(double* A, long long N, const double* vertices,
                        int dim, const long long* vi1, int nv1,
                        const long long* vi2, int nv2,
                        const long long* dofRows, int nPSI,
                        const double* volsym, const double* normals,
                        long long P, const double* bary_x,
                        const double* bary_y, const double* w,
                        const double* PSIP, int Q, Profile pf, Inter in,
                        Order od, const double* yShift, long long emask,
                        cudaStream_t stream) {
    return launchPanel<DENSE, true>(
        A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nullptr, nPSI,
        volsym, normals, P, nullptr, nullptr, nullptr, nullptr, TreeTables{},
        bary_x, bary_y, w, PSIP, Q, pf, in, od, yShift, emask, stream);
}
