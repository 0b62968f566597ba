// K24 interp_matvec: the apply of an interpolated operator family,
//   y[n] = sum_m w[m] sum_k A[m, n, k] x[k],
// for the stacked dense node operators A [M+1, N, N] of one Chebyshev
// interval and their Lagrange weights w [M+1] (float64, row-major).
//
// Replaces the einsum('m,mnk,k->n') of
// pynucleus_tpu/nl/operator_interpolation.py:262-281
// (multiIntervalInterpolationOperator.matvec on a dense stack).  Bound on
// the card: one read of the stack, (M+1) N^2 8 bytes (bytes).
//
// Design.  One block per row n walks the M+1 rows m N^2 + n N in turn;
// its threads read neighbouring addresses of a row, four loads in flight
// each, and keep one register sum per row m, which they add into their
// total scaled by w[m] (read once per row, the same address for all
// threads).  x (N values, 64 KB at N = 8,191) is read by every block and
// comes from L2.  The block reduces the totals with warp shuffles, then
// across its warps in shared memory, and writes y[n] once: no atomics, so
// the result does not depend on the launch.

#include "common.cuh"

constexpr int IM_THREADS = 256;

__global__ void __launch_bounds__(IM_THREADS)
interp_matvec_kernel(double* __restrict__ y, const double* __restrict__ w,
                     const double* __restrict__ A,
                     const double* __restrict__ x, int M1, long long N) {
    __shared__ double sh[IM_THREADS / 32];
    const int t = threadIdx.x;
    const long long n = blockIdx.x;
    double acc = 0.0;
    for (int m = 0; m < M1; ++m) {
        const double* row = A + ((long long)m * N + n) * N;
        double part = 0.0;
#pragma unroll 4
        for (long long k = t; k < N; k += IM_THREADS)
            part += __ldg(row + k) * __ldg(x + k);
        acc += __ldg(w + m) * part;
    }
    acc = warpSum(acc);
    if ((t & 31) == 0) sh[t >> 5] = acc;
    __syncthreads();
    if (t == 0) {
        double s = 0.0;
        for (int i = 0; i < IM_THREADS / 32; ++i) s += sh[i];
        y[n] = s;
    }
}

EXPORT int interp_matvec(double* y, const double* w, const double* A,
                         const double* x, int M1, long long N,
                         cudaStream_t stream) {
    if (N <= 0) return 0;
    if (M1 < 1 || N > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    interp_matvec_kernel<<<(unsigned)N, IM_THREADS, 0, stream>>>(y, w, A, x,
                                                                 M1, N);
    return static_cast<int>(cudaGetLastError());
}
