// K26 cheb_smooth: one step of the Chebyshev smoother of the multigrid
// cycle, in place on x and d [n] (float64), one thread per dof:
//   mode 0 (zero)   d = (Dinv b) / theta;  x = d         (first step, x = 0)
//   mode 1 (first)  d = (Dinv (b - Ax)) / theta;  x += d
//   mode 2 (step)   d = c1 d + c2 (Dinv (b - Ax));  x += d
// with Ax = A x from the level operator's apply and the host's float64
// coefficients theta, c1 = rho_{k+1} rho_k and c2 = 2 rho_{k+1} / delta.
//
// Replaces the vector arithmetic of pynucleus_tpu/multilevel/gmg.py:170
// _chebSmooth (lines 181-189), in its order of operations: a division by
// theta (not a product with 1/theta) and c1's and c2's grouping.  The
// source is compiled with -fmad=false, so each product and sum rounds on
// its own, as in the plain version.  Bound on the card: bytes (step: b,
// Ax, Dinv, d and x read, d and x written, 56 B per dof).
//
// Design.  An elementwise pass in CUDA rather than Triton: a Chebyshev
// V-cycle makes six of these launches per level, and the port's Triton
// passes (K10) cost tens of microseconds to launch from Python.  The
// loads and stores are coalesced; no reduction, so the result does not
// depend on the launch.

#include "common.cuh"

__global__ void __launch_bounds__(256)
cheb_smooth_kernel(double* __restrict__ x, double* __restrict__ d,
                   const double* __restrict__ b,
                   const double* __restrict__ Ax,
                   const double* __restrict__ Dinv, int n, int mode,
                   double theta, double c1, double c2) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (mode == 0) {
        const double t = (Dinv[i] * b[i]) / theta;
        d[i] = t;
        x[i] = t;
    } else if (mode == 1) {
        const double t = (Dinv[i] * (b[i] - Ax[i])) / theta;
        d[i] = t;
        x[i] += t;
    } else {
        const double t = c1 * d[i] + c2 * (Dinv[i] * (b[i] - Ax[i]));
        d[i] = t;
        x[i] += t;
    }
}

EXPORT int cheb_smooth(double* x, double* d, const double* b,
                       const double* Ax, const double* Dinv, int n, int mode,
                       double theta, double c1, double c2,
                       cudaStream_t stream) {
    if (n <= 0) return 0;
    if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = ((long long)n + threads - 1) / threads;
    cheb_smooth_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        x, d, b, Ax, Dinv, n, mode, theta, c1, c2);
    return static_cast<int>(cudaGetLastError());
}
