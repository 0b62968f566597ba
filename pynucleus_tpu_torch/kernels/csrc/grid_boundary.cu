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
// (compute); it reads only O(C + S) data.  The float32 instances
// (grid_boundary_f32, the float32 dense path: the power profile with its
// tempering and the gaussian's and exponential's boundary forms, replacing
// pynucleus_tpu/nl/assembly.py:240 _grid_boundary_blocks + :303 in
// float32) run the same kernel on float data.

#include "common.cuh"

constexpr int BOUNDARY_THREADS = 128;

template <int Q1, int DPE, int PC, typename T>
__global__ void __launch_bounds__(BOUNDARY_THREADS)
grid_boundary_kernel(T* __restrict__ A, long long N,
                     const T* __restrict__ X, int dim,
                     const T* __restrict__ vols,
                     const long long* __restrict__ dofs,
                     const T* __restrict__ Ysurf,
                     const T* __restrict__ svolw2,
                     const T* __restrict__ normals, long long S, int Q2,
                     const long long* __restrict__ exclPtr,
                     const long long* __restrict__ exclIdx,
                     const T* __restrict__ PhiXw,
                     const T* __restrict__ PhiX, Profile pf,
                     int useNormals) {
    const long long c = blockIdx.x;
    const long long e0 = exclPtr[c], e1 = exclPtr[c + 1];
    T x[Q1][MAXDIM];
#pragma unroll
    for (int q = 0; q < Q1; ++q)
        for (int d = 0; d < dim; ++d) x[q][d] = X[(c * Q1 + q) * dim + d];

    T Rl[Q1];
#pragma unroll
    for (int q = 0; q < Q1; ++q) Rl[q] = 0;

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
        const T* y = Ysurf + m * dim;
        const T sw = svolw2[m];
#pragma unroll
        for (int q = 0; q < Q1; ++q) {
            T r2 = 0, fac = 0;
            for (int d = 0; d < dim; ++d) {
                const T dd = y[d] - x[q][d];
                r2 += dd * dd;
                fac += normals[s * dim + d] * dd;
            }
            T g = radial<PC>(r2, pf);
            if (useNormals) g *= r2 > 0 ? fac / sqrtT(r2) : T(0);
            Rl[q] += g * sw;
        }
    }

    __shared__ T part[BOUNDARY_THREADS / 32][Q1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < Q1; ++q) {
        const T v = warpSum(Rl[q]);
        if (lane == 0) part[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    T R[Q1];
    const T vol = vols[c];
#pragma unroll
    for (int q = 0; q < Q1; ++q) {
        T s = 0;
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
            T s = 0;
#pragma unroll
            for (int q = 0; q < Q1; ++q)
                s += PhiXw[a * Q1 + q] * PhiX[b * Q1 + q] * R[q];
            atomicAdd(A + row * N + col, s);
        }
    }
}

template <typename T>
static int launchBoundary(T* A, long long N, const T* X, int Q1, int dim,
                          const T* vols, const long long* dofs, int dpe,
                          long long C, const T* Ysurf, const T* svolw2,
                          const T* normals, long long S, int Q2,
                          const long long* exclPtr, const long long* exclIdx,
                          const T* PhiXw, const T* PhiX, Profile pf,
                          int useNormals, cudaStream_t stream) {
    if (C <= 0) return 0;
    if (dim > MAXDIM || C > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
#define CASE(QQ, DD)                                                        \
    if (Q1 == QQ && dpe == DD) {                                            \
        grid_boundary_kernel<QQ, DD, PC, T>                                 \
            <<<(unsigned)C, BOUNDARY_THREADS, 0, stream>>>(                 \
                A, N, X, dim, vols, dofs, Ysurf, svolw2, normals, S, Q2,    \
                exclPtr, exclIdx, PhiXw, PhiX, pf, useNormals);             \
        return static_cast<int>(cudaGetLastError());                        \
    }
    // order-4 cell rules: 6 triangle nodes (2D P1), 3 Gauss nodes (1D P1)
    if constexpr (IS_F32<T>) {
        // float32: the power profile (with a tempering) and the boundary
        // forms of the gaussian and exponential kernels
        switch (pf.code) {
            PROFILE_CASE(PROFILE_POWER, CASE(6, 3) CASE(3, 2))
            default:
                F32_BOUNDARY_SWITCH(pf.code, CASE(6, 3) CASE(3, 2)
                                    return static_cast<int>(
                                        cudaErrorInvalidValue))
        }
    } else {
        PROFILE_SWITCH(pf.code, CASE(6, 3) CASE(3, 2)
                       return static_cast<int>(cudaErrorInvalidValue))
    }
#undef CASE
    return static_cast<int>(cudaErrorInvalidValue);
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
    return launchBoundary<double>(A, N, X, Q1, dim, vols, dofs, dpe, C,
                                  Ysurf, svolw2, normals, S, Q2, exclPtr,
                                  exclIdx, PhiXw, PhiX, PROFILE_OF(Cg),
                                  useNormals, stream);
}

// The float32 instances (the float32 dense path: the boundary kernel of
// the fractional kernel, tempered or not, and of the gaussian and
// exponential kernels; the constants rounded to float32 on the host): every
// array float32, each value and each sum a float, as _grid_boundary_blocks
// with dtype=float32 and _scatter_cell_blocks into a float32 A.
EXPORT int grid_boundary_f32(float* A, long long N, const float* X, int Q1,
                             int dim, const float* vols,
                             const long long* dofs, int dpe, long long C,
                             const float* Ysurf, const float* svolw2,
                             const float* normals, long long S, int Q2,
                             const long long* exclPtr,
                             const long long* exclIdx, const float* PhiXw,
                             const float* PhiX, int pcode, double Cg,
                             double e, double a, double C1, double C2,
                             double tl, int wcode, double wl, int useNormals,
                             cudaStream_t stream) {
    return launchBoundary<float>(A, N, X, Q1, dim, vols, dofs, dpe, C, Ysurf,
                                 svolw2, normals, S, Q2, exclPtr, exclIdx,
                                 PhiXw, PhiX, PROFILE_OF(Cg), useNormals,
                                 stream);
}
