// K1 panel_scatter: batched panel quadrature of explicit element pairs,
// scattered into the dense operator.
//
// Replaces pynucleus_tpu/nl/assembly.py:_bucket_contrib (+ the dense
// scatter _device_scatter_rows), _bucket_natural_scatter_scan and
// _bucket_rows_scatter_scan.  For pair p with simplices vi1[p], vi2[p]:
//   x_q = sum_v bary_x[v,q] V[vi1[p,v]],  y_q = sum_v bary_y[v,q] V[vi2[p,v]]
//   t_q = gamma(|x_q-y_q|^2) w_q volsym[p]  (* n_p.(y_q-x_q)/|y_q-x_q|)
//   M[I,J] = sum_q t_q PSIP[q, I*nPSI+J]
//   A[dofRows[p,I], dofRows[p,J]] += M[I,J]   for both dofs >= 0
// Negative dofs (boundary dofs -d-1 and DROP) are skipped; this replaces
// the JAX dump row N.
//
// Design: one warp per pair, lanes striding over the Q quadrature nodes
// (the 2D singular rules have 30-3000 nodes, so a thread per pair would
// leave lanes idle), the nPSI^2 local entries kept in registers, a warp
// butterfly reduction per entry, then one atomicAdd(double) per entry.
// Bound on the card: float64 pow per node and the nPSI^2 FMAs per node
// (compute); atomics are nPSI^2 per pair, negligible against Q >= 30.

#include "common.cuh"

template <int NPSI>
__global__ void __launch_bounds__(256)
panel_scatter_kernel(double* __restrict__ A, long long N,
                     const double* __restrict__ vertices, int dim,
                     const long long* __restrict__ vi1, int nv1,
                     const long long* __restrict__ vi2, int nv2,
                     const long long* __restrict__ dofRows,
                     const double* __restrict__ volsym,
                     const double* __restrict__ normals, long long P,
                     const double* __restrict__ bary_x,
                     const double* __restrict__ bary_y,
                     const double* __restrict__ w,
                     const double* __restrict__ PSIP, int Q,
                     double C, double e) {
    constexpr int NN = NPSI * NPSI;
    const int lane = threadIdx.x & 31;
    const long long pair = (long long)blockIdx.x * (blockDim.x >> 5)
                           + (threadIdx.x >> 5);
    if (pair >= P) return;  // uniform across the warp

    double v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM], nrm[MAXDIM];
    for (int a = 0; a < nv1; ++a) {
        const long long vid = vi1[pair * nv1 + a];
        for (int d = 0; d < dim; ++d) v1[a][d] = vertices[vid * dim + d];
    }
    for (int a = 0; a < nv2; ++a) {
        const long long vid = vi2[pair * nv2 + a];
        for (int d = 0; d < dim; ++d) v2[a][d] = vertices[vid * dim + d];
    }
    for (int d = 0; d < dim; ++d)
        nrm[d] = normals != nullptr ? normals[pair * dim + d] : 0.0;
    const double vs = volsym[pair];

    double acc[NN];
#pragma unroll
    for (int k = 0; k < NN; ++k) acc[k] = 0.0;

    for (int q = lane; q < Q; q += 32) {
        double x[MAXDIM], y[MAXDIM];
        double r2 = 0.0;
        for (int d = 0; d < dim; ++d) {
            double xd = 0.0, yd = 0.0;
            for (int a = 0; a < nv1; ++a) xd += bary_x[a * Q + q] * v1[a][d];
            for (int a = 0; a < nv2; ++a) yd += bary_y[a * Q + q] * v2[a][d];
            x[d] = xd;
            y[d] = yd;
            const double dd = xd - yd;
            r2 += dd * dd;
        }
        double t = radial(r2, C, e) * w[q];
        if (normals != nullptr) {
            double fac = 0.0;
            if (r2 > 0.0) {
                for (int d = 0; d < dim; ++d) fac += nrm[d] * (y[d] - x[d]);
                fac /= sqrt(r2);
            }
            t *= fac;
        }
        t *= vs;
        const double* ps = PSIP + (long long)q * NN;
#pragma unroll
        for (int k = 0; k < NN; ++k) acc[k] += t * __ldg(ps + k);
    }

#pragma unroll
    for (int k = 0; k < NN; ++k) acc[k] = warpSum(acc[k]);

    const long long* dr = dofRows + pair * NPSI;
#pragma unroll
    for (int k = 0; k < NN; ++k) {
        if ((k & 31) == lane) {
            const long long r = dr[k / NPSI], c = dr[k % NPSI];
            if (r >= 0 && c >= 0) atomicAdd(A + r * N + c, acc[k]);
        }
    }
}

EXPORT const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

EXPORT int panel_scatter(double* A, long long N, const double* vertices,
                         int dim, const long long* vi1, int nv1,
                         const long long* vi2, int nv2,
                         const long long* dofRows, int nPSI,
                         const double* volsym, const double* normals,
                         long long P, const double* bary_x,
                         const double* bary_y, const double* w,
                         const double* PSIP, int Q, double C, double e,
                         cudaStream_t stream) {
    if (P <= 0) return 0;
    if (dim > MAXDIM || nv1 > MAXNV || nv2 > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = (P + (threads / 32) - 1) / (threads / 32);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(NP)                                                          \
    panel_scatter_kernel<NP><<<(unsigned)blocks, threads, 0, stream>>>(    \
        A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, volsym, normals, \
        P, bary_x, bary_y, w, PSIP, Q, C, e)
    switch (nPSI) {
        case 2: LAUNCH(2); break;
        case 3: LAUNCH(3); break;
        case 4: LAUNCH(4); break;
        case 6: LAUNCH(6); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}
