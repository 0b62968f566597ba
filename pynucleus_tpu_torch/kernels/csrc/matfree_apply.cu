// K25 matfree_apply: the matrix-free apply of a finite element operator
// from its local matrices A [C, dpe, dpe] (float64) and the cells' dofs
// [C, dpe] (int32, -1 for a dropped boundary dof):
//   apply     y[i] = sum_{(c, a): dofs[c, a] = i} sum_b A[c, a, b] x[dofs[c, b]]
//   diagonal  y[i] = sum_{(c, a): dofs[c, a] = i} A[c, a, a]
// (a dropped dof's x is 0).
//
// Replaces pynucleus_tpu/fem/assembly.py:321-328 matrixFreeOperator's mv
// (the gather of x, einsum('cij,cj->ci'), the segment sum into the dofs)
// and its diagonal (:333-339).  Bound on the card: bytes (the local
// matrices, the dofs, the order and the offsets read once, x gathered
// once, y written once).
//
// Design.  A gather, not atomics, as K16 csr_scatter: the host sorts the
// kept local rows (c, a) by their dof once, stably, so each dof's rows
// stay in flat order, and gives each dof its range of that order through
// offsets [N+1].  One thread per dof walks its rows, forms each row's
// product with the gathered x in b order and adds it in that order, which
// is the order of the JAX package's segment sum: the result does not
// depend on the launch.  The reads of A and of x are gathers, so
// neighbouring threads do not read neighbouring addresses.

#include "common.cuh"

__global__ void __launch_bounds__(256)
matfree_apply_kernel(double* __restrict__ y, const double* __restrict__ A,
                     const int* __restrict__ dofs,
                     const int* __restrict__ order,
                     const int* __restrict__ offsets,
                     const double* __restrict__ x, int N, int dpe,
                     int diagonal) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const int end = offsets[i + 1];
    double s = 0.0;
    for (int e = offsets[i]; e < end; ++e) {
        const long long ca = order[e];           // c dpe + a
        const double* row = A + ca * dpe;        // A[c, a, :]
        if (diagonal) {
            s += row[ca % dpe];
            continue;
        }
        const int* cd = dofs + (ca / dpe) * dpe;  // dofs[c, :]
        double t = 0.0;
        for (int b = 0; b < dpe; ++b) {
            const int j = cd[b];
            if (j >= 0) t += row[b] * x[j];
        }
        s += t;
    }
    y[i] = s;
}

EXPORT int matfree_apply(double* y, const double* A, const int* dofs,
                         const int* order, const int* offsets,
                         const double* x, int N, int dpe, int diagonal,
                         cudaStream_t stream) {
    if (N <= 0) return 0;
    if (dpe < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = ((long long)N + threads - 1) / threads;
    matfree_apply_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        y, A, dofs, order, offsets, x, N, dpe, diagonal);
    return static_cast<int>(cudaGetLastError());
}
