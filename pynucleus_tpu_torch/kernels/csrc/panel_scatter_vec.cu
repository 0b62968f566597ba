// K21 panel_scatter_vec and K22 panel_scatter_nonsym_vec: batched panel
// quadrature of the vector-valued local matrices of explicit element pairs
// (the s-derivative kernels of a leftRight fractional order), scattered
// into the dense vector operator A [N, N, V].
//
// Replace pynucleus_tpu/nl/assembly.py:_bucket_contrib_vec (K21) and
// :_bucket_contrib_nonsym_vec (K22), with :_vec_eval and the log correction
// :_log_extra_scalar, and the host np.add.at of VectorDenseAccumulator.add.
// For pair p and node q (x_q, y_q: common.cuh panelNode<false>; r2 =
// |x_q - y_q|^2; side sigma of (x_q, y_q): 0 ll, 1 rr, 2 lr, 3 rl with
// left x[0] < interface):
//   T(x, y) = [ r2^e (c0 + c1 L + c2 L^2) w_q
//               (+ cw1_q (b r2^e + 2 c r2^e lnR) + cw2_q c r2^e) ] volsym[p]
//   with L = ln r2, lnR = L/2 - lnEta_q and (c0, c1, c2, b, c, e) the
//   side's row of the table; 0 at r2 == 0
//   K21  M[k, v] = sum_q T(x_q, y_q) G[sigma(x_q, y_q), v] PSIP[q, k]
//   K22  M[k, v] = sum_q T(x_q, y_q) G[sigma(x_q, y_q), v] PHIxPSI[q, k]
//                - sum_q T(y_q, x_q) G[sigma(y_q, x_q), v] PHIyPSI[q, k]
//   A[(dofRows[p,I] * N + dofRows[p,J]) * V + v] += M[I*nPSI+J, v]
//        for both dofs >= 0
// G [4, V] is the sides' gradient rows (0 or 1), the table (4 x 6
// coefficients, then G) nl/kernels.py VectorParams.table(); the log
// correction only with lnEta, cw1 and cw2 (a singular rule's tables).
//
// Design: one warp per pair.  Every node's side and scalar factor T (one
// pow and one log, two of each for K22) is computed once, by one lane, in
// chunks of 32 nodes; the lanes own the V nPSI^2 outputs (lane l the
// outputs l, l+32, ...) and walk the chunk's nodes in order, the factor and
// side broadcast by shuffles, so each output is a sequential sum over q in
// registers (at most 8 per accumulator) and the table sits in shared
// memory.  One atomicAdd(double) per output.  Compiled with -fmad=false
// (kernels.SOURCE_FLAGS): products and sums round as the plain version's
// separate operations do.  Bound on the card: the V nPSI^2 multiply-adds
// per node and the transcendental functions (compute).

#include "common.cuh"

// the largest number of components (leftRight with 4 parameters,
// derivative 2) and the per-side coefficient row length
constexpr int VEC_MAXV = 16;
constexpr int VEC_COEFS = 6;

// T of one node pair at r2 on the side whose coefficient row is cf, times
// vs (common.cuh vecTermCore and vecSide, shared with the component order
// of K1, K19 and K7).
__device__ __forceinline__ double vecTerm(double r2, const double* cf,
                                          double wq, const double* lnEta,
                                          const double* cw1,
                                          const double* cw2, int q,
                                          double vs) {
    if (!(r2 > 0.0)) return 0.0;
    return __dmul_rn(vecTermCore(r2, cf, wq, lnEta, cw1, cw2, q), vs);
}

template <int NPSI, bool NONSYM>
__global__ void __launch_bounds__(256)
panel_scatter_vec_kernel(double* __restrict__ A, long long N, int V,
                         const double* __restrict__ vertices, int dim,
                         const long long* __restrict__ vi1, int nv1,
                         const long long* __restrict__ vi2, int nv2,
                         const long long* __restrict__ dofRows,
                         const double* __restrict__ volsym, long long P,
                         const double* __restrict__ bary_x,
                         const double* __restrict__ bary_y,
                         const double* __restrict__ w,
                         const double* __restrict__ P1,
                         const double* __restrict__ P2, int Q,
                         const double* __restrict__ table, double iface,
                         const double* __restrict__ lnEta,
                         const double* __restrict__ cw1,
                         const double* __restrict__ cw2) {
    constexpr int NN = NPSI * NPSI;
    constexpr int OPL = (VEC_MAXV * NN + 31) / 32;   // outputs per lane
    __shared__ double tab[4 * VEC_COEFS + 4 * VEC_MAXV];
    for (int i = threadIdx.x; i < 4 * VEC_COEFS + 4 * V; i += blockDim.x)
        tab[i] = table[i];
    __syncthreads();
    const double* G = tab + 4 * VEC_COEFS;
    const int lane = threadIdx.x & 31;
    const long long pair = (long long)blockIdx.x * (blockDim.x >> 5)
                           + (threadIdx.x >> 5);
    if (pair >= P) return;  // uniform across the warp

    double v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM];
    loadSimplex(v1, vertices, vi1 + pair * nv1, nv1, dim);
    loadSimplex(v2, vertices, vi2 + pair * nv2, nv2, dim);
    const double vs = volsym[pair];
    const int nOut = V * NN;

    double acc1[OPL], acc2[OPL];
#pragma unroll
    for (int i = 0; i < OPL; ++i) acc1[i] = acc2[i] = 0.0;
    for (int base = 0; base < Q; base += 32) {
        const int q = base + lane;
        double t1 = 0.0, t2 = 0.0;
        int s1 = 0, s2 = 0;
        if (q < Q) {
            double x[MAXDIM], y[MAXDIM];
            const double r2 = panelNode<false>(x, y, v1, nv1, v2, nv2, dim,
                                               bary_x, bary_y, Q, q, nullptr);
            s1 = vecSide(x, y, iface);
            t1 = vecTerm(r2, tab + s1 * VEC_COEFS, w[q], lnEta, cw1, cw2, q,
                         vs);
            if constexpr (NONSYM) {
                s2 = vecSide(y, x, iface);
                t2 = vecTerm(r2, tab + s2 * VEC_COEFS, w[q], lnEta, cw1, cw2,
                             q, vs);
            }
        }
        const int nq = min(32, Q - base);
        for (int j = 0; j < nq; ++j) {
            const double a1 = __shfl_sync(FULL_MASK, t1, j);
            const int g1 = __shfl_sync(FULL_MASK, s1, j);
            const double a2 = NONSYM ? __shfl_sync(FULL_MASK, t2, j) : 0.0;
            const int g2 = NONSYM ? __shfl_sync(FULL_MASK, s2, j) : 0;
            const long long row = (long long)(base + j) * NN;
#pragma unroll
            for (int i = 0; i < OPL; ++i) {
                const int o = lane + 32 * i;
                if (o >= nOut) break;
                const int v = o / NN, k = o - v * NN;
                acc1[i] += a1 * G[g1 * V + v] * __ldg(P1 + row + k);
                if constexpr (NONSYM)
                    acc2[i] += a2 * G[g2 * V + v] * __ldg(P2 + row + k);
            }
        }
    }
    const long long* dr = dofRows + pair * NPSI;
#pragma unroll
    for (int i = 0; i < OPL; ++i) {
        const int o = lane + 32 * i;
        if (o >= nOut) break;
        const int v = o / NN, k = o - v * NN;
        const long long r = dr[k / NPSI], c = dr[k % NPSI];
        if (r >= 0 && c >= 0)
            atomicAdd(A + (r * N + c) * V + v,
                      NONSYM ? acc1[i] - acc2[i] : acc1[i]);
    }
}

template <bool NONSYM>
static int launchVec(double* A, long long N, int V, const double* vertices,
                     int dim, const long long* vi1, int nv1,
                     const long long* vi2, int nv2, const long long* dofRows,
                     int nPSI, const double* volsym, long long P,
                     const double* bary_x, const double* bary_y,
                     const double* w, const double* P1, const double* P2,
                     int Q, const double* table, double iface,
                     const double* lnEta, const double* cw1,
                     const double* cw2, cudaStream_t stream) {
    if (P <= 0) return 0;
    if (dim > MAXDIM || nv1 > MAXNV || nv2 > MAXNV || V < 1 || V > VEC_MAXV
        || ((lnEta == nullptr) != (cw1 == nullptr))
        || ((lnEta == nullptr) != (cw2 == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = (P + (threads / 32) - 1) / (threads / 32);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(NP)                                                           \
    panel_scatter_vec_kernel<NP, NONSYM>                                     \
        <<<(unsigned)blocks, threads, 0, stream>>>(                          \
            A, N, V, vertices, dim, vi1, nv1, vi2, nv2, dofRows, volsym, P,  \
            bary_x, bary_y, w, P1, P2, Q, table, iface, lnEta, cw1, cw2)
    switch (nPSI) {
        case 2: LAUNCH(2); break;
        case 4: LAUNCH(4); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

EXPORT int panel_scatter_vec(
    double* A, long long N, int V, const double* vertices, int dim,
    const long long* vi1, int nv1, const long long* vi2, int nv2,
    const long long* dofRows, int nPSI, const double* volsym, long long P,
    const double* bary_x, const double* bary_y, const double* w,
    const double* PSIP, int Q, const double* table, double iface,
    const double* lnEta, const double* cw1, const double* cw2,
    cudaStream_t stream) {
    return launchVec<false>(A, N, V, vertices, dim, vi1, nv1, vi2, nv2,
                            dofRows, nPSI, volsym, P, bary_x, bary_y, w, PSIP,
                            nullptr, Q, table, iface, lnEta, cw1, cw2,
                            stream);
}

EXPORT int panel_scatter_nonsym_vec(
    double* A, long long N, int V, const double* vertices, int dim,
    const long long* vi1, int nv1, const long long* vi2, int nv2,
    const long long* dofRows, int nPSI, const double* volsym, long long P,
    const double* bary_x, const double* bary_y, const double* w,
    const double* PHIxPSI, const double* PHIyPSI, int Q, const double* table,
    double iface, const double* lnEta, const double* cw1, const double* cw2,
    cudaStream_t stream) {
    return launchVec<true>(A, N, V, vertices, dim, vi1, nv1, vi2, nv2,
                           dofRows, nPSI, volsym, P, bary_x, bary_y, w,
                           PHIxPSI, PHIyPSI, Q, table, iface, lnEta, cw1,
                           cw2, stream);
}
