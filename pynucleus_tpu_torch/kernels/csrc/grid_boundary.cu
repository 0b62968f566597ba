// K3 grid_boundary: the zero-exterior (Gauss-theorem) surface term.
//
// Replaces pynucleus_tpu/nl/assembly.py:_grid_boundary_blocks and the dense
// scatter _scatter_cell_blocks.  For each cell c and each of its Q1 nodes
//   R[c,q] = vol[c] sum_{s not excluded} sum_r gamma_b(|x-y|^2)
//                   (* n_s.(y-x)/|y-x|) svolw2[s,r],  x = X[c,q], y = Ysurf[s,r]
//   A[dof(c,a), dof(c,b)] += sum_q PhiXw[a,q] PhiX[b,q] R[c,q]
// The excluded surface cells of c (touching pairs and the order > 4
// corrections, both assembled by K1) arrive as sorted per-cell CSR lists
// exclPtr [C+1] / exclIdx.  gamma_b is the boundary kernel's radial<PC>,
// with a tempered kernel's tempering (its boundary kernel keeps lambda and
// has no two-point weight, as in the JAX package).
//
// Design: one block per cell, threads striding over the S*Q2 surface
// nodes, the Q1 partial sums reduced over the block (warp shuffles, then
// shared memory), the dpe x dpe block formed by one thread and added with
// atomics (cells share dofs).  Bound on the card: C*Q1*S*Q2 float64 pow
// (compute); it reads only O(C + S) data.

#include "common.cuh"

constexpr int BOUNDARY_THREADS = 128;

template <int Q1, int DPE, int PC>
__global__ void __launch_bounds__(BOUNDARY_THREADS)
grid_boundary_kernel(double* __restrict__ A, long long N,
                     const double* __restrict__ X, int dim,
                     const double* __restrict__ vols,
                     const long long* __restrict__ dofs,
                     const double* __restrict__ Ysurf,
                     const double* __restrict__ svolw2,
                     const double* __restrict__ normals, long long S, int Q2,
                     const long long* __restrict__ exclPtr,
                     const long long* __restrict__ exclIdx,
                     const double* __restrict__ PhiXw,
                     const double* __restrict__ PhiX, Profile pf,
                     int useNormals) {
    const long long c = blockIdx.x;
    const long long e0 = exclPtr[c], e1 = exclPtr[c + 1];
    double x[Q1][MAXDIM];
#pragma unroll
    for (int q = 0; q < Q1; ++q)
        for (int d = 0; d < dim; ++d) x[q][d] = X[(c * Q1 + q) * dim + d];

    double Rl[Q1];
#pragma unroll
    for (int q = 0; q < Q1; ++q) Rl[q] = 0.0;

    const long long M = S * Q2;
    for (long long m = threadIdx.x; m < M; m += blockDim.x) {
        const long long s = m / Q2;
        // binary search of s in the cell's sorted exclusion list
        long long lo = e0, hi = e1;
        while (lo < hi) {
            const long long mid = (lo + hi) >> 1;
            if (exclIdx[mid] < s) lo = mid + 1; else hi = mid;
        }
        if (lo < e1 && exclIdx[lo] == s) continue;
        const double* y = Ysurf + m * dim;
        const double sw = svolw2[m];
#pragma unroll
        for (int q = 0; q < Q1; ++q) {
            double r2 = 0.0, fac = 0.0;
            for (int d = 0; d < dim; ++d) {
                const double dd = y[d] - x[q][d];
                r2 += dd * dd;
                fac += normals[s * dim + d] * dd;
            }
            double g = radial<PC>(r2, pf);
            if (useNormals) g *= r2 > 0.0 ? fac / sqrt(r2) : 0.0;
            Rl[q] += g * sw;
        }
    }

    __shared__ double part[BOUNDARY_THREADS / 32][Q1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < Q1; ++q) {
        const double v = warpSum(Rl[q]);
        if (lane == 0) part[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    double R[Q1];
    const double vol = vols[c];
#pragma unroll
    for (int q = 0; q < Q1; ++q) {
        double s = 0.0;
        for (int k = 0; k < BOUNDARY_THREADS / 32; ++k) s += part[k][q];
        R[q] = vol * s;
    }
#pragma unroll
    for (int a = 0; a < DPE; ++a) {
        const long long row = dofs[c * DPE + a];
        if (row < 0) continue;
#pragma unroll
        for (int b = 0; b < DPE; ++b) {
            const long long col = dofs[c * DPE + b];
            if (col < 0) continue;
            double s = 0.0;
#pragma unroll
            for (int q = 0; q < Q1; ++q)
                s += PhiXw[a * Q1 + q] * PhiX[b * Q1 + q] * R[q];
            atomicAdd(A + row * N + col, s);
        }
    }
}

EXPORT int grid_boundary(double* A, long long N, const double* X, int Q1,
                         int dim, const double* vols, const long long* dofs,
                         int dpe, long long C, const double* Ysurf,
                         const double* svolw2, const double* normals,
                         long long S, int Q2, const long long* exclPtr,
                         const long long* exclIdx, const double* PhiXw,
                         const double* PhiX, int pcode, double Cg, double e,
                         double a, double C1, double C2,
                         double tl, int wcode, double wl, int useNormals,
                         cudaStream_t stream) {
    if (C <= 0) return 0;
    if (dim > MAXDIM || C > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
#define CASE(QQ, DD)                                                        \
    if (Q1 == QQ && dpe == DD) {                                            \
        grid_boundary_kernel<QQ, DD, PC>                                    \
            <<<(unsigned)C, BOUNDARY_THREADS, 0, stream>>>(                 \
                A, N, X, dim, vols, dofs, Ysurf, svolw2, normals, S, Q2,    \
                exclPtr, exclIdx, PhiXw, PhiX,                              \
                PROFILE_OF(Cg), useNormals);              \
        return static_cast<int>(cudaGetLastError());                        \
    }
    // order-4 cell rules: 6 triangle nodes (2D P1), 3 Gauss nodes (1D P1)
    PROFILE_SWITCH(pcode, CASE(6, 3) CASE(3, 2)
                   return static_cast<int>(cudaErrorInvalidValue))
#undef CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
