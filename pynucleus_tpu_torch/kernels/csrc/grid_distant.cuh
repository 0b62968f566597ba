// K2 grid_distant: dense assembly of one distance window of distant cell
// pairs on the full C x C cell-pair grid.  The kernels and their launcher;
// the float64 entry point is in grid_distant.cu, the float32 one in
// grid_distant_f32.cu, so that nvcc compiles them in parallel.
//
// Replaces pynucleus_tpu/nl/assembly.py:_grid_distant_pass.  Ordered pair
// (c1, c2) is handled iff t_lo <= d2(c1, c2) < t_hi, d2 the squared
// float32 distance of the cell centers computed with the FIXED expression
// of pynucleus_tpu/nl/panels.py:_d2f32 (dd = c2 - c1 per dimension, then
// dd*dd summed in dimension order).  __fsub_rn/__fmul_rn/__fadd_rn keep
// nvcc from contracting it into an FMA, so host and card partition the
// pairs bit for bit.  With G[q,r] = gamma(|Y[c2,r] - X[c1,q]|^2) vol[c2]
// vol[c1] (X = Y: both sides use the same rule), each pair adds
//   cross:  A[dof(c1,a), dof(c2,b)] += 2 sum_{q,r} PhiXw[a,q] G PsiYw[b,r]
//   diag:   R[c1, q] += sum_r G[q,r] w[r]
// and a second kernel adds the per-cell diagonal blocks
//   A[dof(c,a), dof(c,b)] += 2 sum_q PhiXw[a,q] PhiX[b,q] R[c,q],
// which is Bxx + Byy of the JAX program: the window is symmetric and
// G(c1,c2)[q,r] = G(c2,c1)[r,q], so the column sums Byy equal Bxx.
// gamma is radial<PC>: the profile with its tempering and the smooth
// two-point weight exp(-wlam |x-y|) from the node pair's r2.  The JAX
// program evaluates gamma without x and y and so drops that weight (a
// fault of the reference, ROADMAP.md); the port applies it.
//
// Design: a 2D grid of (32 c2 x 8 c1) thread blocks, one ordered pair per
// thread, the dpe x dpe cross block in registers, one atomicAdd(double)
// per cross entry; the row sums R are reduced over the warp (fixed c1)
// before one atomic per node.  Rules with Q >= 12 nodes (the sparse
// close windows) share each pair's work over the warp (warpPairs).  None of the TPU program's intermediates
// ([C, Q2, Ct*Q1] tiles, the [N+1, K, Ct*Q1] incidence gather) exist.
// Bound on the card: Q^2 float64 pow per pair in the window (compute) and
// dpe^2 atomics per pair.  The float32 instances (grid_distant_f32: the
// float32 dense path) run the same kernels on float data, each sum a float
// and each atomic an atomicAdd(float), but the row sums R: float64 in
// both instances (the float warp sums added in float64, cast once in the
// diagonal pass), as the JAX program's einsum reduces a whole row of the
// grid before its one float32 rounding; thousands of atomicAdd(float) into
// R drifted 1e-5 of the entry from any other summation order.
#pragma once

#include "common.cuh"

// Rules with at least COOP_Q nodes take the warp-cooperative branch.
constexpr int COOP_Q = 12;

// In a sparse window (the order-6 window at noRef 6 holds about 1 % of
// the pairs) most lanes of a warp hold no pair, and a thread per pair
// leaves them idle through its Q^2 evaluations.  Here the warp takes its
// in-window pairs one after another and all 32 lanes share the Q*Q
// evaluations of each: lane k of round j owns the node pair
// idx = 32 j + k (q = idx / Q, r = idx % Q).  The cross block is reduced
// over the warp per pair; the row sums of c1 (fixed for the warp) stay in
// registers per round and are reduced once, through shared memory.
template <int Q, int DPE, int PC, typename T>
__device__ __forceinline__ void warpPairs(
        T* __restrict__ A, long long N, const T* __restrict__ X,
        int dim, const T* __restrict__ vols,
        const long long* __restrict__ dofs, const T* __restrict__ PhiXw,
        const T* __restrict__ PsiYw, const T* __restrict__ w,
        const Profile& pf, double* __restrict__ R, long long c1,
        long long c2, bool in) {
    constexpr int NR = (Q * Q + 31) / 32;
    const int lane = threadIdx.x & 31;
    T racc[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) racc[k] = 0;
    const T* x1 = X + c1 * Q * dim;
    unsigned mask = __ballot_sync(FULL_MASK, in);
    while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const long long pc2 = __shfl_sync(FULL_MASK, c2, src);
        const T vv = vols[pc2] * vols[c1];
        const T* y2 = X + pc2 * Q * dim;
        T cross[DPE][DPE];
#pragma unroll
        for (int a = 0; a < DPE; ++a)
#pragma unroll
            for (int b = 0; b < DPE; ++b) cross[a][b] = 0;
#pragma unroll
        for (int k = 0; k < NR; ++k) {
            const int idx = k * 32 + lane;
            if (idx < Q * Q) {
                const int q = idx / Q, r = idx - q * Q;
                T r2 = 0;
                for (int d = 0; d < dim; ++d) {
                    const T dd = y2[r * dim + d] - x1[q * dim + d];
                    r2 += dd * dd;
                }
                const T g = radial<PC>(r2, pf) * vv;
                racc[k] += g * w[r];
#pragma unroll
                for (int a = 0; a < DPE; ++a) {
                    const T ga = g * PhiXw[a * Q + q];
#pragma unroll
                    for (int b = 0; b < DPE; ++b)
                        cross[a][b] += ga * PsiYw[b * Q + r];
                }
            }
        }
#pragma unroll
        for (int a = 0; a < DPE; ++a)
#pragma unroll
            for (int b = 0; b < DPE; ++b) {
                const T v = warpSum(cross[a][b]);
                if (lane == a * DPE + b) {
                    const long long row = dofs[c1 * DPE + a];
                    const long long col = dofs[pc2 * DPE + b];
                    if (row >= 0 && col >= 0)
                        atomicAdd(A + row * N + col, T(2) * v);
                }
            }
    }
    __shared__ T rowSum[8][Q];  // one row per warp (blockDim.y == 8)
    T* rs = rowSum[threadIdx.y];
    for (int q = lane; q < Q; q += 32) rs[q] = 0;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NR; ++k) {
        const int idx = k * 32 + lane;
        if (idx < Q * Q) atomicAdd(rs + idx / Q, racc[k]);
    }
    __syncwarp();
    for (int q = lane; q < Q; q += 32)
        atomicAdd(R + c1 * Q + q, static_cast<double>(rs[q]));
}

// One ordered pair per thread: the cross block in registers, the row sums
// of c1 (fixed for the warp) reduced over the warp, one atomic per node.
template <int Q, int DPE, int PC, typename T>
__device__ __forceinline__ void threadPairs(
        T* __restrict__ A, long long N, const T* __restrict__ X,
        int dim, const T* __restrict__ vols,
        const long long* __restrict__ dofs, long long C,
        const T* __restrict__ PhiXw, const T* __restrict__ PsiYw,
        const T* __restrict__ w, const Profile& pf,
        double* __restrict__ R, long long c1, long long c2, bool in) {
    T Rx[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) Rx[q] = 0;

    if (in) {
        const T vv = vols[c2] * vols[c1];
        const T* x1 = X + c1 * Q * dim;
        const T* y2 = X + c2 * Q * dim;
        T cross[DPE][DPE];
#pragma unroll
        for (int a = 0; a < DPE; ++a)
#pragma unroll
            for (int b = 0; b < DPE; ++b) cross[a][b] = 0;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            T tq[DPE];
#pragma unroll
            for (int b = 0; b < DPE; ++b) tq[b] = 0;
            T rq = 0;
            for (int r = 0; r < Q; ++r) {
                T r2 = 0;
                for (int d = 0; d < dim; ++d) {
                    const T dd = y2[r * dim + d] - x1[q * dim + d];
                    r2 += dd * dd;
                }
                const T g = radial<PC>(r2, pf) * vv;
                rq += g * w[r];
#pragma unroll
                for (int b = 0; b < DPE; ++b) tq[b] += g * PsiYw[b * Q + r];
            }
            Rx[q] = rq;
#pragma unroll
            for (int a = 0; a < DPE; ++a)
#pragma unroll
                for (int b = 0; b < DPE; ++b)
                    cross[a][b] += PhiXw[a * Q + q] * tq[b];
        }
#pragma unroll
        for (int a = 0; a < DPE; ++a) {
            const long long row = dofs[c1 * DPE + a];
            if (row < 0) continue;
#pragma unroll
            for (int b = 0; b < DPE; ++b) {
                const long long col = dofs[c2 * DPE + b];
                if (col >= 0)
                    atomicAdd(A + row * N + col, T(2) * cross[a][b]);
            }
        }
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const T s = warpSum(Rx[q]);
        if (lane == 0 && c1 < C)
            atomicAdd(R + c1 * Q + q, static_cast<double>(s));
    }
}

template <int Q, int DPE, int PC, typename T>
__global__ void __launch_bounds__(256)
grid_distant_kernel(T* __restrict__ A, long long N,
                    const T* __restrict__ X, int dim,
                    const float* __restrict__ ccf,
                    const T* __restrict__ vols,
                    const long long* __restrict__ dofs, long long C,
                    const T* __restrict__ PhiXw,
                    const T* __restrict__ PsiYw,
                    const T* __restrict__ w, float t_lo, float t_hi,
                    Profile pf, double* __restrict__ R) {
    const long long c2 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long c1 = (long long)blockIdx.y * blockDim.y + threadIdx.y;
    bool in = (c1 < C) && (c2 < C);
    if (in) {
        float d2 = 0.0f;
        for (int d = 0; d < dim; ++d) {
            const float dd = __fsub_rn(ccf[c2 * dim + d], ccf[c1 * dim + d]);
            const float sq = __fmul_rn(dd, dd);
            d2 = d == 0 ? sq : __fadd_rn(d2, sq);
        }
        in = (d2 >= t_lo) && (d2 < t_hi);
    }
    // warps with no pair in the window do nothing (all lanes share c1)
    if (!__any_sync(FULL_MASK, in)) return;

    if constexpr (Q >= COOP_Q)
        warpPairs<Q, DPE, PC, T>(A, N, X, dim, vols, dofs, PhiXw, PsiYw, w,
                                 pf, R, c1, c2, in);
    else
        threadPairs<Q, DPE, PC, T>(A, N, X, dim, vols, dofs, C, PhiXw, PsiYw,
                                   w, pf, R, c1, c2, in);
}

template <int Q, int DPE, typename T>
__global__ void grid_diag_kernel(T* __restrict__ A, long long N,
                                 const long long* __restrict__ dofs,
                                 long long C,
                                 const T* __restrict__ PhiXw,
                                 const T* __restrict__ PhiX,
                                 const double* __restrict__ R) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
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
            for (int q = 0; q < Q; ++q)
                s += PhiXw[a * Q + q] * PhiX[b * Q + q]
                     * static_cast<T>(R[c * Q + q]);
            atomicAdd(A + row * N + col, T(2) * s);
        }
    }
}

template <int Q, int DPE, int PC, typename T>
static int launchGrid(T* A, long long N, const T* X, int dim,
                      const float* ccf, const T* vols,
                      const long long* dofs, long long C,
                      const T* PhiXw, const T* PhiX,
                      const T* PsiYw, const T* w, float t_lo,
                      float t_hi, Profile pf, double* R,
                      cudaStream_t stream) {
    const dim3 block(32, 8);
    const long long gx = (C + 31) / 32, gy = (C + 7) / 8;
    if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((unsigned)gx, (unsigned)gy);
    grid_distant_kernel<Q, DPE, PC, T><<<grid, block, 0, stream>>>(
        A, N, X, dim, ccf, vols, dofs, C, PhiXw, PsiYw, w, t_lo, t_hi, pf,
        R);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_diag_kernel<Q, DPE, T>
        <<<(unsigned)((C + 127) / 128), 128, 0, stream>>>(
        A, N, dofs, C, PhiXw, PhiX, R);
    return static_cast<int>(cudaGetLastError());
}
