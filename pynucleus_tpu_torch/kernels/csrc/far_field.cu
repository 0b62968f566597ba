// K7 far_field: kernel blocks of the H2 far field on Chebyshev grids.
//
// Replaces pynucleus_tpu/nl/assembly.py:_farFieldBlocks:
//   K[p, a, b] = gamma(gi[p, a], gj[p, b]),  gi, gj [P, M, dim]
// with gamma the kernel's radial profile or its variable fractional order
// (kernel.jaxEval -> evalXY; common.cuh kernelXY), the same as K1's (getH2
// scales the result by -2).  One thread per entry; the M <= 64 grid points of a pair
// stay in L1/L2.  Bound on the card: the float64 pow per entry (compute);
// the output, 8 B per entry, is the only large traffic (343 MB at 17,852
// pairs of M = 49).

#include "common.cuh"

template <int PC, int OC>
__global__ void __launch_bounds__(256)
far_field_kernel(double* __restrict__ K, const double* __restrict__ gi,
                 const double* __restrict__ gj, long long total, int M,
                 int dim, Profile pf, Order od) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const long long MM = (long long)M * M;
    const long long p = idx / MM;
    const int a = static_cast<int>((idx / M) % M);
    const int b = static_cast<int>(idx % M);
    const double* x = gi + (p * M + a) * dim;
    const double* y = gj + (p * M + b) * dim;
    double r2 = 0.0;
    for (int d = 0; d < dim; ++d) {
        const double dd = x[d] - y[d];
        r2 += dd * dd;
    }
    K[idx] = kernelXY<PC, OC>(r2, x, y, pf, od);
}

EXPORT int far_field(double* K, const double* gi, const double* gj,
                     long long P, int M, int dim, int pcode, double C,
                     double e, double a, double C1, double C2,
                     double tl, int wcode, double wl, ORDER_PARAMS,
                     cudaStream_t stream) {
    const long long total = P * M * M;
    if (total <= 0) return 0;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const Order od = ORDER_OF;
    KERNEL_SWITCH(pcode, ocode,
                  far_field_kernel<PC, OC><<<(unsigned)blocks, threads, 0,
                                             stream>>>(
                      K, gi, gj, total, M, dim,
                      PROFILE_OF(C), od))
    return static_cast<int>(cudaGetLastError());
}
