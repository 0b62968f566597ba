// K27 sss_spmv: the apply of a symmetric sparse skyline operator,
//   y = diag x + L x + L^T x,
// for the strictly lower triangle L given by its entries data [nnz]
// (float64) at (rowids, indices) (int32), in any order.
//
// Replaces pynucleus_tpu/base/linear_operators.py:434
// SSS_LinearOperator.matvec: diag * x, then segment_sum(data x[indices],
// rowids) and segment_sum(data x[rowids], indices) added in that order.
// Bound on the card: bytes (L's data, its row and column ids and both
// orders read once, the offsets, diag and x read once, y written once).
//
// Design.  A gather with one thread per row and no atomics, as K16 and
// K25: the host sorts L's entries stably by row (order1, offsets1 [n+1])
// and by column (order2, offsets2) once, when the operator is made; the
// second order turns the L^T product into a gather over row i's entries
// of L^T.  Each thread sums its two lists in ascending entry order in two
// accumulators, the order of the JAX package's segment sums, and writes
// (diag x + s1) + s2.  Compiled with -fmad=false: each product rounds on
// its own, as the plain version's.  The reads of data and of x are
// gathers through the orders, not coalesced.

#include "common.cuh"

__global__ void __launch_bounds__(256)
sss_spmv_kernel(double* __restrict__ y, const double* __restrict__ diag,
                const double* __restrict__ data,
                const int* __restrict__ indices,
                const int* __restrict__ rowids,
                const int* __restrict__ order1,
                const int* __restrict__ offsets1,
                const int* __restrict__ order2,
                const int* __restrict__ offsets2,
                const double* __restrict__ x, int n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    double s1 = 0.0;
    for (int e = offsets1[i], end = offsets1[i + 1]; e < end; ++e) {
        const int o = order1[e];
        s1 += data[o] * x[indices[o]];
    }
    double s2 = 0.0;
    for (int e = offsets2[i], end = offsets2[i + 1]; e < end; ++e) {
        const int o = order2[e];
        s2 += data[o] * x[rowids[o]];
    }
    y[i] = (diag[i] * x[i] + s1) + s2;
}

EXPORT int sss_spmv(double* y, const double* diag, const double* data,
                    const int* indices, const int* rowids, const int* order1,
                    const int* offsets1, const int* order2,
                    const int* offsets2, const double* x, int n,
                    cudaStream_t stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    const long long blocks = ((long long)n + threads - 1) / threads;
    sss_spmv_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        y, diag, data, indices, rowids, order1, offsets1, order2, offsets2,
        x, n);
    return static_cast<int>(cudaGetLastError());
}
