// K5 near_enum and K6 near_enum_quad: the device enumeration of the H2 near
// field's distant cell pairs.
//
// K5 replaces pynucleus_tpu/nl/assembly.py:_enum_phase1 (with
// _enum_elem_key).  One segment holds T <= 2^25 flat elements t of the cell
// products cells(I_p) x cells(J_p) of cluster pairs p (int32 throughout):
//   p = last index with cum[p] <= t,  l = t - cum[p]
//   a = ncArr[offI[p] + l / n2[p]],   b = ncArr[offJ[p] + l % n2[p]]
//   valid = a != b, no shared vertex, and a < b where the pair is also
//           enumerated the other way round (b incident to I_p, a to J_p)
//   key = snapped float32 order of (a, b) (panels.distantOrders) or 127
// and a 128-bin histogram of the keys.  One thread per element, p by
// binary search over the segment's cum; the histogram goes to shared
// memory, then one global atomic per bin and block.  Bound on the card:
// the gathers (ncArr, cells, cellNodes, centers, logh: ~100 B per
// element) and one logf; 5 B written per element.
// The float32 order model rounds each step as the plain PyTorch version's
// separate operations do: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn keep nvcc
// from contracting into FMAs, and logf (not __logf) is the accurate log
// that torch.log uses on the card.  Otherwise an order whose ceil sits on
// an integer could land in another quadrature bucket.
//
// K6 replaces _enum_phase2 (the compaction of one order's element ids is
// the caller's torch.nonzero).  One warp per compacted element: decode
// (p, c1, c2) as K5 does, K1's quadrature body (common.cuh panelQuad) over
// the order's rule with volsym 2 vol(c1) vol(c2), and K1's tree-slot
// epilogue for the dofs [dofs[c1], dofs[c2]] under cluster pair (I_p, J_p).
// Bound: float64 pow per node and the (2 dpe)^2 FMAs per node, as K1.

#include "common.cuh"

constexpr int ENUM_SENTINEL = 127;

__device__ __forceinline__ int segmentPair(const int* __restrict__ cum,
                                           int nP, int t) {
    // first index in cum[0..nP] with cum[idx] > t, minus one
    int lo = 0, hi = nP + 1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] <= t) lo = mid + 1; else hi = mid;
    }
    const int p = lo - 1;
    return p < 0 ? 0 : (p > nP - 1 ? nP - 1 : p);
}

// 2D order model of pynucleus_tpu/nl/panels.py:distantOrders in float32,
// snapped as _enum_elem_key does (even; (8,16] -> 16; > 16 -> multiple of 8).
__device__ __forceinline__ int orderKey(const float* __restrict__ centers,
                                        int C, const float* __restrict__ logh,
                                        int a, int b, float s, float c,
                                        float lH0) {
    const float dx = __fsub_rn(centers[a], centers[b]);
    const float dy = __fsub_rn(centers[C + a], centers[C + b]);
    const float r2c = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float logd = __fmul_rn(0.5f, logf(fmaxf(r2c, 1e-38f)));
    const float lh1 = logh[a], lh2 = logh[b];
    const float ldh1 = __fsub_rn(logd, lh1), ldh2 = __fsub_rn(logd, lh2);
    const float l1 = fabsf(__fsub_rn(lh1, lH0));
    const float l2 = fabsf(__fsub_rn(lh2, lH0));
    const float lmin = fmaxf(l1, l2);
    const float sm1 = __fsub_rn(s, 1.0f);
    const float num1 = __fsub_rn(__fadd_rn(__fadd_rn(c, __fmul_rn(sm1, l2)),
                                           lmin), __fmul_rn(s, ldh2));
    const float num2 = __fsub_rn(__fadd_rn(__fadd_rn(c, __fmul_rn(sm1, l1)),
                                           lmin), __fmul_rn(s, ldh1));
    const float o1 = ceilf(__fdiv_rn(num1, __fadd_rn(fmaxf(ldh1, 0.0f), 0.4f)));
    const float o2 = ceilf(__fdiv_rn(num2, __fadd_rn(fmaxf(ldh2, 0.0f), 0.4f)));
    const float of = fminf(fmaxf(fmaxf(fmaxf(o1, o2), 2.0f), 2.0f), 120.0f);
    int o = static_cast<int>(of);
    o = ((o + 1) / 2) * 2;
    if (o > 16) o = ((o + 7) / 8) * 8;
    if (o > 8 && o <= 16) o = 16;
    return o;
}

__global__ void __launch_bounds__(256)
near_enum_kernel(signed char* __restrict__ keys, int* __restrict__ pT,
                 int* __restrict__ hist, const int* __restrict__ cum, int nP,
                 const int* __restrict__ offI, const int* __restrict__ offJ,
                 const int* __restrict__ n2, const int* __restrict__ IA,
                 const int* __restrict__ JA, const int* __restrict__ ncArr,
                 const int* __restrict__ cells, int nv,
                 const int* __restrict__ cellNodes, int dpe,
                 const float* __restrict__ centers, int C,
                 const float* __restrict__ logh, float s, float c, float lH0,
                 int T) {
    __shared__ int sh[ENUM_SENTINEL + 1];
    for (int i = threadIdx.x; i <= ENUM_SENTINEL; i += blockDim.x) sh[i] = 0;
    __syncthreads();
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < T) {
        const int p = segmentPair(cum, nP, t);
        const int l = t - cum[p];
        const int n2p = n2[p];
        const int a = ncArr[offI[p] + l / n2p];
        const int b = ncArr[offJ[p] + l % n2p];
        const int I = IA[p], J = JA[p];
        bool share = false;
        for (int i = 0; i < nv; ++i)
            for (int j = 0; j < nv; ++j)
                share |= cells[a * nv + i] == cells[b * nv + j];
        bool bInI = false, aInJ = false;
        for (int i = 0; i < dpe; ++i) {
            bInI |= cellNodes[b * dpe + i] == I;
            aInJ |= cellNodes[a * dpe + i] == J;
        }
        const bool valid = a != b && !share && (!(bInI && aInJ) || a < b);
        const int key = valid ? orderKey(centers, C, logh, a, b, s, c, lH0)
                              : ENUM_SENTINEL;
        keys[t] = static_cast<signed char>(key);
        pT[t] = p;
        atomicAdd(&sh[key], 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i <= ENUM_SENTINEL; i += blockDim.x)
        if (sh[i]) atomicAdd(&hist[i], sh[i]);
}

EXPORT int near_enum(signed char* keys, int* pT, int* hist, const int* cum,
                     int nP, const int* offI, const int* offJ, const int* n2,
                     const int* IA, const int* JA, const int* ncArr,
                     const int* cells, int nv, const int* cellNodes, int dpe,
                     const float* centers, int C, const float* logh, float s,
                     float c, float lH0, int T, cudaStream_t stream) {
    if (T <= 0) return 0;
    const int threads = 256;
    const int blocks = (T + threads - 1) / threads;
    near_enum_kernel<<<blocks, threads, 0, stream>>>(
        keys, pT, hist, cum, nP, offI, offJ, n2, IA, JA, ncArr, cells, nv,
        cellNodes, dpe, centers, C, logh, s, c, lH0, T);
    return static_cast<int>(cudaGetLastError());
}

template <int NPSI>
__global__ void __launch_bounds__(256)
near_enum_quad_kernel(double* __restrict__ data, long long nnz,
                      const int* __restrict__ ids, int n,
                      const int* __restrict__ pT, const int* __restrict__ cum,
                      const int* __restrict__ offI,
                      const int* __restrict__ offJ,
                      const int* __restrict__ n2, const int* __restrict__ IA,
                      const int* __restrict__ JA,
                      const int* __restrict__ offF,
                      const int* __restrict__ offB,
                      const int* __restrict__ ncArr,
                      const double* __restrict__ vertices, int dim,
                      const long long* __restrict__ cells, int nv,
                      const double* __restrict__ vols,
                      const long long* __restrict__ dofs, TreeTables tt,
                      const double* __restrict__ bary_x,
                      const double* __restrict__ bary_y,
                      const double* __restrict__ w,
                      const double* __restrict__ PSIP, int Q, double C,
                      double e) {
    constexpr int DPE = NPSI / 2;
    constexpr int NN = NPSI * NPSI;
    const int lane = threadIdx.x & 31;
    const long long k = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (k >= n) return;  // uniform across the warp
    const int t = ids[k];
    const int p = pT[t];
    const int l = t - cum[p];
    const int n2p = n2[p];
    const long long c1 = ncArr[offI[p] + l / n2p];
    const long long c2 = ncArr[offJ[p] + l % n2p];

    double v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM];
    loadSimplex(v1, vertices, cells + c1 * nv, nv, dim);
    loadSimplex(v2, vertices, cells + c2 * nv, nv, dim);
    double acc[NN];
    panelQuad<NN>(acc, v1, nv, v2, nv, dim, nullptr,
                  vols[c1] * vols[c2] * 2.0, bary_x, bary_y, w, PSIP, Q, C,
                  e, lane, 32);
#pragma unroll
    for (int i = 0; i < NN; ++i) acc[i] = warpSum(acc[i]);
    long long dr[NPSI];
#pragma unroll
    for (int i = 0; i < DPE; ++i) {
        dr[i] = dofs[c1 * DPE + i];
        dr[DPE + i] = dofs[c2 * DPE + i];
    }
    treeScatter<NPSI>(data, nnz, tt, dr, IA[p], JA[p], offF[p], offB[p], acc,
                      lane);
}

EXPORT int near_enum_quad(double* data, long long nnz, const int* ids, int n,
                          const int* pT, const int* cum, const int* offI,
                          const int* offJ, const int* n2, const int* IA,
                          const int* JA, const int* offF, const int* offB,
                          const int* ncArr, const double* vertices, int dim,
                          const long long* cells, int nv, const double* vols,
                          const long long* dofs, int dpe, const int* dofNode,
                          const int* treePos, const int* indptrT,
                          const int* tStart, const double* bary_x,
                          const double* bary_y, const double* w,
                          const double* PSIP, int Q, double C, double e,
                          cudaStream_t stream) {
    if (n <= 0) return 0;
    if (dim > MAXDIM || nv > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = ((long long)n + (threads / 32) - 1) / (threads / 32);
    const TreeTables tt{dofNode, treePos, indptrT, tStart};
#define LAUNCH(NP)                                                          \
    near_enum_quad_kernel<NP><<<(unsigned)blocks, threads, 0, stream>>>(   \
        data, nnz, ids, n, pT, cum, offI, offJ, n2, IA, JA, offF, offB,     \
        ncArr, vertices, dim, cells, nv, vols, dofs, tt, bary_x, bary_y, w, \
        PSIP, Q, C, e)
    switch (dpe) {
        case 2: LAUNCH(4); break;
        case 3: LAUNCH(6); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}
