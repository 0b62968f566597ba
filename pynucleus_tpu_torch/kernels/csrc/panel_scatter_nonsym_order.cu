// K19 panel_scatter_nonsym (panel_scatter_nonsym.cuh): the instances of
// its dense target with the orders of position (common.cuh orderAt:
// innerOuter, islands and layers with sio != soi, smoothedLeftRight,
// linearLeftRight, smoothedInnerOuter and fe) and the component order
// (common.cuh componentTerm), in a source of their own so that nvcc
// compiles them beside the others; the dense entry point
// (panel_scatter_nonsym.cu) reaches them by the order's code.  Replaces
// pynucleus_tpu/nl/assembly.py:_bucket_contrib_nonsym + the dense scatter
// with FractionalKernel.evalXY of those orders, and with
// _ComponentFractionalKernel.evalXY and useLogCorr (:68
// _log_extra_scalar).

#include "panel_scatter_nonsym.cuh"

int launchNonsymPosition(double* A, long long N, const double* vertices,
                         int dim, const long long* vi1, int nv1,
                         const long long* vi2, int nv2,
                         const long long* dofRows, int nPSI,
                         const double* volsym, long long P,
                         const double* bary_x, const double* bary_y,
                         const double* w, const double* PHIxPSI,
                         const double* PHIyPSI, int Q, Profile pf, Inter in,
                         Order od, Horizon hz, cudaStream_t stream) {
    return launchNonsym<NS_DENSE, true>(
        A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nullptr, nPSI,
        volsym, P, bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, pf, in, od, hz,
        stream);
}
