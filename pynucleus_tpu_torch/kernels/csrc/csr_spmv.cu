// K9 csr_spmv: y = A x (or y += A x) for a CSR matrix A, float64 values,
// int32 row pointers and column indices.
//
// Replaces pynucleus_tpu/base/linear_operators.py:310 CSR_LinearOperator
// .matvec (gather data * x[indices], segment sum over rows) and, run on
// the CSR of the transpose, :314 rmatvec.  In the multigrid V-cycle it
// applies the prolongation P (accumulate: x += P xc) and the restriction
// P^T (defect = P^T res).
//
// One warp per row: the lanes stride over the row's entries, a shuffle
// reduction sums them, lane 0 writes.  No atomics, so the sum of a row is
// the same in every run.  A P1 prolongation row holds 1-2 entries and a
// row of P^T up to about 7, so most lanes idle: a simple first design.
// Bound on the card: memory (12 B per entry, 16-24 B per row, and the
// gathered x), far below the float64 rate.

#include "common.cuh"

__global__ void __launch_bounds__(256)
csr_spmv_kernel(double* __restrict__ y, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const double* __restrict__ data,
                const double* __restrict__ x, int nRows, int accumulate) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * (blockDim.x >> 5)
                          + (threadIdx.x >> 5);
    if (row >= nRows) return;  // uniform across the warp
    const int start = indptr[row], end = indptr[row + 1];
    double s = 0.0;
    for (int k = start + lane; k < end; k += 32) s += data[k] * x[indices[k]];
    s = warpSum(s);
    if (lane == 0) y[row] = accumulate ? y[row] + s : s;
}

EXPORT int csr_spmv(double* y, const int* indptr, const int* indices,
                    const double* data, const double* x, int nRows,
                    int accumulate, cudaStream_t stream) {
    if (nRows <= 0) return 0;
    const int threads = 256;
    const long long blocks = ((long long)nRows * 32 + threads - 1) / threads;
    csr_spmv_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        y, indptr, indices, data, x, nRows, accumulate);
    return static_cast<int>(cudaGetLastError());
}
