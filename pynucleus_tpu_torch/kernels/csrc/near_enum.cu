// K5 near_enum, K6 near_enum_quad and K13 tree_csr_quad: the flat and the
// host-enumeration engines of the H2 near field's distant cell pairs.
//
// K5 replaces pynucleus_tpu/nl/assembly.py:_enum_phase1 (with
// _enum_elem_key).  One segment holds T <= 2^25 flat elements t of the cell
// products cells(I_p) x cells(J_p) of cluster pairs p (int32 throughout):
//   p = last index with cum[p] <= t,  l = t - cum[p]
//   a = ncArr[offI[p] + l / n2[p]],   b = ncArr[offJ[p] + l % n2[p]]
//   key = snapped float32 order of (a, b) if nearValid (common.cuh), or 127
// and a 128-bin histogram of the keys.  One thread per element, p by
// binary search over the segment's cum; the histogram goes to shared
// memory, then one global atomic per bin and block.  Bound on the card:
// the gathers (ncArr, cells, cellNodes, centers, logh: ~100 B per
// element) and one logf; 5 B written per element.  The validity rules and
// the order model (common.cuh) are K11's and K12's too.
//
// K6 replaces _enum_phase2 (the compaction of one order's element ids is
// the caller's torch.nonzero).  One warp per compacted element: decode
// (p, c1, c2) as K5 does, then the element body below.  Its float32
// instance (near_enum_quad_f32, the power profile alone) runs the element
// body in float32 into float32 data: _enum_phase2 on the float32 H2 path's
// data.
//
// K13 replaces _bucket_tree_csr_scan, the quadrature of the host
// enumeration engine: the same element body over a host-made element list
// (c1, c2, I, J, offF, offB, sf), one warp per element.  Its float32
// instance (tree_csr_quad_f32, the power profile alone) runs the element
// body in float32 into float32 data: _bucket_tree_csr_scan on the float32
// H2 path's data (getH2 with nearEngine='host').
//
// The element body: K1's quadrature body (common.cuh panelQuad) over the
// order's rule with volsym sf vol(c1) vol(c2), and K1's tree-slot epilogue
// (global atomics) for the dofs [dofs[c1], dofs[c2]] under cluster pair
// (I, J).  Bound: a float64 pow (or the kernel's exp or erfc) per node
// and the (2 dpe)^2 FMAs per node, as K1.

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

__global__ void __launch_bounds__(256)
near_enum_kernel(signed char* __restrict__ keys, int* __restrict__ pT,
                 int* __restrict__ hist, const int* __restrict__ cum, int nP,
                 const int* __restrict__ offI, const int* __restrict__ offJ,
                 const int* __restrict__ n2, const int* __restrict__ IA,
                 const int* __restrict__ JA, EnumTables et, int T) {
    __shared__ int sh[ENUM_SENTINEL + 1];
    for (int i = threadIdx.x; i <= ENUM_SENTINEL; i += blockDim.x) sh[i] = 0;
    __syncthreads();
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < T) {
        const int p = segmentPair(cum, nP, t);
        const int l = t - cum[p];
        const int n2p = n2[p];
        const int a = et.ncArr[offI[p] + l / n2p];
        const int b = et.ncArr[offJ[p] + l % n2p];
        const int key = nearValid(et.cells, et.nv, et.cellNodes, et.dpe, a, b,
                                  IA[p], JA[p])
            ? orderKey(et.centers, et.dim, et.C, et.logh, a, b, et.s, et.c,
                       et.lH0)
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
                     const float* centers, int dimC, int C, const float* logh,
                     float s, float c, float lH0, int T, cudaStream_t stream) {
    if (T <= 0) return 0;
    const int threads = 256;
    const int blocks = (T + threads - 1) / threads;
    const EnumTables et{ncArr, cells, nv, cellNodes, dpe, centers, dimC, C,
                        logh, s, c, lH0};
    near_enum_kernel<<<blocks, threads, 0, stream>>>(
        keys, pT, hist, cum, nP, offI, offJ, n2, IA, JA, et, T);
    return static_cast<int>(cudaGetLastError());
}

// Mesh data and one rule of the quadrature elements (K6, K13), in the
// element body's type T (float64, or float32 for K6's float32 instance).
template <typename T>
struct QuadTables {
    const T* vertices;
    int dim;
    const long long* cells;  // [C, nv]
    int nv;
    const T* vols;           // [C]
    const long long* dofs;   // [C, dpe]
    const T* bary_x;         // [nv, Q]
    const T* bary_y;         // [nv, Q]
    const T* w;              // [Q]
    const T* PSIP;           // [Q, (2 dpe)^2]
    int Q;
    Profile pf;
};

// The element body of K6 and K13, run by one warp.
template <int NPSI, int PC, typename T>
__device__ __forceinline__ void treeElement(T* __restrict__ data,
                                            long long nnz, const TreeTables& tt,
                                            const QuadTables<T>& qt,
                                            long long c1, long long c2,
                                            NoDeduce<T> sf, int I, int J,
                                            int offF, int offB, int lane) {
    constexpr int DPE = NPSI / 2;
    constexpr int NN = NPSI * NPSI;
    T v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM];
    loadSimplex(v1, qt.vertices, qt.cells + c1 * qt.nv, qt.nv, qt.dim);
    loadSimplex(v2, qt.vertices, qt.cells + c2 * qt.nv, qt.nv, qt.dim);
    T acc[NN];
    panelQuad<NN, PC>(acc, v1, qt.nv, v2, qt.nv, qt.dim, nullptr,
                      qt.vols[c1] * qt.vols[c2] * sf, qt.bary_x, qt.bary_y,
                      qt.w, qt.PSIP, qt.Q, qt.pf, lane, 32);
#pragma unroll
    for (int i = 0; i < NN; ++i) acc[i] = warpSum(acc[i]);
    long long dr[NPSI];
#pragma unroll
    for (int i = 0; i < DPE; ++i) {
        dr[i] = qt.dofs[c1 * DPE + i];
        dr[DPE + i] = qt.dofs[c2 * DPE + i];
    }
    treeScatter<NPSI>(data, nnz, tt, dr, I, J, offF, offB, acc, lane);
}

template <int NPSI, int PC, typename T>
__global__ void __launch_bounds__(256)
near_enum_quad_kernel(T* __restrict__ data, long long nnz,
                      const int* __restrict__ ids, int n,
                      const int* __restrict__ pT, const int* __restrict__ cum,
                      const int* __restrict__ offI,
                      const int* __restrict__ offJ,
                      const int* __restrict__ n2, const int* __restrict__ IA,
                      const int* __restrict__ JA,
                      const int* __restrict__ offF,
                      const int* __restrict__ offB,
                      const int* __restrict__ ncArr, QuadTables<T> qt,
                      TreeTables tt) {
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
    treeElement<NPSI, PC>(data, nnz, tt, qt, c1, c2, T(2), IA[p], JA[p],
                          offF[p], offB[p], lane);
}

// K6's launch of the profile PC on the element ids of one order.
template <int PC, typename T>
static int launchEnumQuad(T* data, long long nnz, const int* ids, int n,
                          const int* pT, const int* cum, const int* offI,
                          const int* offJ, const int* n2, const int* IA,
                          const int* JA, const int* offF, const int* offB,
                          const int* ncArr, const QuadTables<T>& qt,
                          const TreeTables& tt, int dpe,
                          cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = ((long long)n + (threads / 32) - 1)
                             / (threads / 32);
#define LAUNCH(NP)                                                          \
    near_enum_quad_kernel<NP, PC, T><<<(unsigned)blocks, threads, 0,        \
                                       stream>>>(                           \
        data, nnz, ids, n, pT, cum, offI, offJ, n2, IA, JA, offF, offB,     \
        ncArr, qt, tt)
    switch (dpe) {
        case 2: LAUNCH(4); break;
        case 3: LAUNCH(6); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
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
                          const double* PSIP, int Q, int pcode, double C,
                          double e, double a,
                          double C1, double C2,
                          double tl, int wcode, double wl,
                          cudaStream_t stream) {
    if (n <= 0) return 0;
    if (dim > MAXDIM || nv > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const TreeTables tt{dofNode, treePos, indptrT, tStart};
    const QuadTables<double> qt{vertices, dim, cells, nv, vols, dofs, bary_x,
                                bary_y, w, PSIP, Q, PROFILE_OF(C)};
    PROFILE_SWITCH(pcode, return launchEnumQuad<PC>(
        data, nnz, ids, n, pT, cum, offI, offJ, n2, IA, JA, offF, offB,
        ncArr, qt, tt, dpe, stream))
    return 0;
}

// K6's float32 instance (the float32 H2 path: _enum_phase2 on float32
// data): every array float32, the power profile's code, C, e (rounded to
// float32 on the host), no tempering and no two-point weight; any other
// profile returns cudaErrorInvalidValue.
EXPORT int near_enum_quad_f32(float* data, long long nnz, const int* ids,
                              int n, const int* pT, const int* cum,
                              const int* offI, const int* offJ,
                              const int* n2, const int* IA, const int* JA,
                              const int* offF, const int* offB,
                              const int* ncArr, const float* vertices,
                              int dim, const long long* cells, int nv,
                              const float* vols, const long long* dofs,
                              int dpe, const int* dofNode,
                              const int* treePos, const int* indptrT,
                              const int* tStart, const float* bary_x,
                              const float* bary_y, const float* w,
                              const float* PSIP, int Q, int pcode, double C,
                              double e, double tl, int wcode,
                              cudaStream_t stream) {
    if (n <= 0) return 0;
    if (pcode != PROFILE_POWER || tl != 0.0 || wcode != TWO_POINT_NONE
        || dim > MAXDIM || nv > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const TreeTables tt{dofNode, treePos, indptrT, tStart};
    const QuadTables<float> qt{vertices, dim, cells, nv, vols, dofs, bary_x,
                               bary_y, w, PSIP, Q,
                               Profile{PROFILE_POWER, C, e, 0.0, 0.0, 0.0,
                                       0.0, TWO_POINT_NONE, 0.0}};
    return launchEnumQuad<PROFILE_POWER>(data, nnz, ids, n, pT, cum, offI,
                                         offJ, n2, IA, JA, offF, offB, ncArr,
                                         qt, tt, dpe, stream);
}

template <int NPSI, int PC, typename T>
__global__ void __launch_bounds__(256)
tree_csr_quad_kernel(T* __restrict__ data, long long nnz,
                     const int* __restrict__ c1A, const int* __restrict__ c2A,
                     const int* __restrict__ IA, const int* __restrict__ JA,
                     const int* __restrict__ offFA,
                     const int* __restrict__ offBA,
                     const T* __restrict__ sfA, long long n,
                     QuadTables<T> qt, TreeTables tt) {
    const int lane = threadIdx.x & 31;
    const long long k = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (k >= n) return;  // uniform across the warp
    treeElement<NPSI, PC>(data, nnz, tt, qt, c1A[k], c2A[k], sfA[k], IA[k],
                          JA[k], offFA[k], offBA[k], lane);
}

// K13's launch of the profile PC on n host-listed elements.
template <int PC, typename T>
static int launchTreeQuad(T* data, long long nnz, const int* c1,
                          const int* c2, const int* IA, const int* JA,
                          const int* offF, const int* offB, const T* sf,
                          long long n, const QuadTables<T>& qt,
                          const TreeTables& tt, int dpe,
                          cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = (n + (threads / 32) - 1) / (threads / 32);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(NP)                                                          \
    tree_csr_quad_kernel<NP, PC, T><<<(unsigned)blocks, threads, 0,         \
                                      stream>>>(                            \
        data, nnz, c1, c2, IA, JA, offF, offB, sf, n, qt, tt)
    switch (dpe) {
        case 2: LAUNCH(4); break;
        case 3: LAUNCH(6); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

EXPORT int tree_csr_quad(double* data, long long nnz, const int* c1,
                         const int* c2, const int* IA, const int* JA,
                         const int* offF, const int* offB, const double* sf,
                         long long n, const double* vertices, int dim,
                         const long long* cells, int nv, const double* vols,
                         const long long* dofs, int dpe, const int* dofNode,
                         const int* treePos, const int* indptrT,
                         const int* tStart, const double* bary_x,
                         const double* bary_y, const double* w,
                         const double* PSIP, int Q, int pcode, double C,
                         double e, double a,
                         double C1, double C2,
                         double tl, int wcode, double wl,
                         cudaStream_t stream) {
    if (n <= 0) return 0;
    if (dim > MAXDIM || nv > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const TreeTables tt{dofNode, treePos, indptrT, tStart};
    const QuadTables<double> qt{vertices, dim, cells, nv, vols, dofs, bary_x,
                                bary_y, w, PSIP, Q, PROFILE_OF(C)};
    PROFILE_SWITCH(pcode, return launchTreeQuad<PC>(
        data, nnz, c1, c2, IA, JA, offF, offB, sf, n, qt, tt, dpe, stream))
    return 0;
}

// K13's float32 instance (the float32 H2 path's host engine:
// _bucket_tree_csr_scan on float32 data): every array float32, the power
// profile's code, C, e (rounded to float32 on the host), no tempering and
// no two-point weight; any other profile returns cudaErrorInvalidValue.
EXPORT int tree_csr_quad_f32(float* data, long long nnz, const int* c1,
                             const int* c2, const int* IA, const int* JA,
                             const int* offF, const int* offB,
                             const float* sf, long long n,
                             const float* vertices, int dim,
                             const long long* cells, int nv,
                             const float* vols, const long long* dofs,
                             int dpe, const int* dofNode, const int* treePos,
                             const int* indptrT, const int* tStart,
                             const float* bary_x, const float* bary_y,
                             const float* w, const float* PSIP, int Q,
                             int pcode, double C, double e, double tl,
                             int wcode, cudaStream_t stream) {
    if (n <= 0) return 0;
    if (pcode != PROFILE_POWER || tl != 0.0 || wcode != TWO_POINT_NONE
        || dim > MAXDIM || nv > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const TreeTables tt{dofNode, treePos, indptrT, tStart};
    const QuadTables<float> qt{vertices, dim, cells, nv, vols, dofs, bary_x,
                               bary_y, w, PSIP, Q,
                               Profile{PROFILE_POWER, C, e, 0.0, 0.0, 0.0,
                                       0.0, TWO_POINT_NONE, 0.0}};
    return launchTreeQuad<PROFILE_POWER>(data, nnz, c1, c2, IA, JA, offF,
                                         offB, sf, n, qt, tt, dpe, stream);
}
