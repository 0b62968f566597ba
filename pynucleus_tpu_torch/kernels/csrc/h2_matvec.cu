// K8 h2_matvec: the apply of the H2 operator in its fused tree layout.
//
// Replaces pynucleus_tpu/nl/h2.py:_h2_matvec (fusedTree branch) with
// TreeNearOperator._x2, _matvec_tree and _scatter_tree.  Nodes are
// numbered level-major (coefficient row n of [nodes, M]); leaf l is near
// node l and owns tree rows tStartRow[l] .. + tLen[l].  One launch per pass
// and level that has work (a level without nodes and a far pass without
// pairs are skipped), in order on the stream:
//   gather       xt[t] = x[perm[t]]; coef = far = 0               [Nt]
//   moments      coef[leafNode[l], m] = sum_i leafPhi[l,i,m] xt[t0(l)+i]
//   up (level ell, finest first)
//                coef[parent[n], i] += sum_j T[n,i,j] coef[n,j]   (atomics)
//   far          far[dst[p], i] += sum_j K[p,i,j] coef[src[p],j]  (atomics)
//   down (level ell, coarsest first)
//                far[n, i] += sum_j T[n,j,i] far[parent[n], j]
//   near+leaf    y[perm[t]] = sum_c data[indptrT[t]+c] xt[tmpl_r[c]]
//                           + sum_m leafPhi[r,i,m] far[leafNode[r], m]
// The near block of leaf r is read in place in the tree CSR (every row of
// r shares the column template tmplAll[tmplStart[r]:]); no padded block
// copies.  xt, coef and far are the operator's own work buffers, reused by
// every apply; the gather zeroes coef and far.  At most 2 nLvl + 2 launches
// per apply; the entry point writes how many it made to *launched.
// Bound on the card: the near data, read once per apply (8 B per stored
// entry, a few hundred MB at 73k dofs), and the far blocks K; the per-level
// passes are small and latency-bound (launch overhead dominates them).
// The passes are templates on the value type: K8's float32 instance
// (h2_matvec_f32) runs them on the float32 H2 path's operator, x and work
// buffers (4 B per stored entry read), the sums in float32, as
// _h2_matvec on float32 arrays.  K20 is float64 alone.
//
// K20 h2_matvec_T: y = A^T x for a nonsymmetric H2 operator (a variable
// fractional order), in the same layout and on the same arrays.  Replaces
// pynucleus_tpu/nl/h2.py:_h2_matvec_T with TreeNearOperator.rmatvec.  The
// moments, up and down passes are K8's (the leaf basis serves rows and
// columns alike); its own passes:
//   farT         far[src[p], i] += sum_j K[p,j,i] coef[dst[p],j]  (atomics:
//                src and dst swapped, K transposed)
//   nearT        yt[tmpl_r[c]] += data[indptrT[t]+c] xt[t]         (atomics:
//                K8's near data read in place, scattered by column)
//   leafT        y[perm[t]] = yt[t] + sum_m leafPhi[r,i,m] far[leafNode[r], m]
// The near field is read in place (no transposed copy: the near data is the
// largest array of the operator); the column scatter costs one atomicAdd
// per stored entry.  yt is the operator's fourth work buffer, zeroed on the
// stream before nearT.  At most 2 nLvl + 3 launches per apply.

#include "common.cuh"

template <typename T>
__global__ void gather_kernel(T* __restrict__ xt, const T* __restrict__ x,
                              const int* __restrict__ perm, int Nt,
                              T* __restrict__ coef, T* __restrict__ far,
                              long long nCoef) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < Nt) xt[t] = x[perm[t]];
    if (t < nCoef) {
        coef[t] = T(0);
        far[t] = T(0);
    }
}

template <typename T>
__global__ void moments_kernel(T* __restrict__ coef,
                               const T* __restrict__ xt,
                               const T* __restrict__ leafPhi,
                               const int* __restrict__ leafNode,
                               const int* __restrict__ tStartRow,
                               const int* __restrict__ tLen, int L, int nbar,
                               int M) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)L * M) return;
    const int l = static_cast<int>(idx / M), m = static_cast<int>(idx % M);
    const int t0 = tStartRow[l], n = tLen[l];
    const T* ph = leafPhi + (long long)l * nbar * M + m;
    T s = T(0);
    for (int i = 0; i < n; ++i) s += ph[(long long)i * M] * xt[t0 + i];
    coef[(long long)leafNode[l] * M + m] = s;
}

template <typename S>
__global__ void up_kernel(S* __restrict__ coef, const S* __restrict__ T,
                          const int* __restrict__ parent, long long n0,
                          int cnt, int M) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)cnt * M) return;
    const long long n = n0 + idx / M;
    const int i = static_cast<int>(idx % M);
    const S* Tr = T + (n * M + i) * M;
    const S* c = coef + n * M;
    S v = S(0);
    for (int j = 0; j < M; ++j) v += Tr[j] * c[j];
    atomicAdd(coef + (long long)parent[n] * M + i, v);
}

template <typename T>
__global__ void far_kernel(T* __restrict__ far, const T* __restrict__ coef,
                           const T* __restrict__ K,
                           const int* __restrict__ src,
                           const int* __restrict__ dst, long long nFar,
                           int M) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= nFar * M) return;
    const long long p = idx / M;
    const int i = static_cast<int>(idx % M);
    const T* Kr = K + (p * M + i) * M;
    const T* c = coef + (long long)src[p] * M;
    T v = T(0);
    for (int j = 0; j < M; ++j) v += Kr[j] * c[j];
    atomicAdd(far + (long long)dst[p] * M + i, v);
}

template <typename S>
__global__ void down_kernel(S* __restrict__ far, const S* __restrict__ T,
                            const int* __restrict__ parent, long long n0,
                            int cnt, int M) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)cnt * M) return;
    const long long n = n0 + idx / M;
    const int i = static_cast<int>(idx % M);
    const S* Tn = T + n * M * M + i;
    const S* o = far + (long long)parent[n] * M;
    S v = S(0);
    for (int j = 0; j < M; ++j) v += Tn[(long long)j * M] * o[j];
    far[n * M + i] += v;
}

template <typename T>
__global__ void __launch_bounds__(256)
near_leaf_kernel(T* __restrict__ y, const T* __restrict__ xt,
                 const T* __restrict__ far,
                 const T* __restrict__ data,
                 const int* __restrict__ perm,
                 const int* __restrict__ rowNode,
                 const int* __restrict__ indptrT,
                 const int* __restrict__ tStartRow,
                 const int* __restrict__ rowLen,
                 const int* __restrict__ tmplStart,
                 const int* __restrict__ tmplAll,
                 const T* __restrict__ leafPhi,
                 const int* __restrict__ leafNode, int Nt, int nbar, int M) {
    const int lane = threadIdx.x & 31;
    const long long t = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (t >= Nt) return;  // uniform across the warp
    const int r = rowNode[t];
    const int i = static_cast<int>(t) - tStartRow[r];
    const long long start = indptrT[t];
    const int Lr = rowLen[r];
    const int* tm = tmplAll + tmplStart[r];
    T s = T(0);
    for (int c = lane; c < Lr; c += 32) s += data[start + c] * xt[tm[c]];
    const T* ph = leafPhi + ((long long)r * nbar + i) * M;
    const T* o = far + (long long)leafNode[r] * M;
    for (int m = lane; m < M; m += 32) s += ph[m] * o[m];
    s = warpSum(s);
    if (lane == 0) y[perm[t]] = s;
}


__global__ void farT_kernel(double* __restrict__ far,
                            const double* __restrict__ coef,
                            const double* __restrict__ K,
                            const int* __restrict__ src,
                            const int* __restrict__ dst, long long nFar,
                            int M) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= nFar * M) return;
    const long long p = idx / M;
    const int i = static_cast<int>(idx % M);
    const double* Kc = K + p * M * M + i;
    const double* c = coef + (long long)dst[p] * M;
    double v = 0.0;
    for (int j = 0; j < M; ++j) v += Kc[(long long)j * M] * c[j];
    atomicAdd(far + (long long)src[p] * M + i, v);
}

__global__ void __launch_bounds__(256)
nearT_kernel(double* __restrict__ yt, const double* __restrict__ xt,
             const double* __restrict__ data,
             const int* __restrict__ rowNode,
             const int* __restrict__ indptrT,
             const int* __restrict__ rowLen,
             const int* __restrict__ tmplStart,
             const int* __restrict__ tmplAll, int Nt) {
    const int lane = threadIdx.x & 31;
    const long long t = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (t >= Nt) return;  // uniform across the warp
    const int r = rowNode[t];
    const long long start = indptrT[t];
    const int Lr = rowLen[r];
    const int* tm = tmplAll + tmplStart[r];
    const double xv = xt[t];
    for (int c = lane; c < Lr; c += 32)
        atomicAdd(yt + tm[c], data[start + c] * xv);
}

__global__ void __launch_bounds__(256)
leafT_kernel(double* __restrict__ y, const double* __restrict__ yt,
             const double* __restrict__ far, const int* __restrict__ perm,
             const int* __restrict__ rowNode,
             const int* __restrict__ tStartRow,
             const double* __restrict__ leafPhi,
             const int* __restrict__ leafNode, int Nt, int nbar, int M) {
    const int lane = threadIdx.x & 31;
    const long long t = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (t >= Nt) return;  // uniform across the warp
    const int r = rowNode[t];
    const int i = static_cast<int>(t) - tStartRow[r];
    const double* ph = leafPhi + ((long long)r * nbar + i) * M;
    const double* o = far + (long long)leafNode[r] * M;
    double s = 0.0;
    for (int m = lane; m < M; m += 32) s += ph[m] * o[m];
    s = warpSum(s);
    if (lane == 0) y[perm[t]] = s + yt[t];
}

static inline unsigned gridFor(long long work, int threads) {
    return static_cast<unsigned>((work + threads - 1) / threads);
}

// K8's passes in the operator's type T (float64, or float32 on the float32
// H2 path).
template <typename T>
static int h2Apply(T* y, const T* x, T* xt, T* coef, T* far, int Nt, int L,
                   int nbar, int M, const int* perm, const int* rowNode,
                   const int* indptrT, const int* tStartRow, const int* tLen,
                   const int* rowLen, const int* tmplStart,
                   const int* tmplAll, const T* data, const T* leafPhi,
                   const int* leafNode, const T* T_, const int* parent,
                   const long long* levelOff, int nLvl, const T* K,
                   const int* src, const int* dst, long long nFar,
                   int* launched, cudaStream_t stream) {
    const int th = 256;
    int err;
    *launched = 0;
#define CHECK()                                                    \
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err; \
    ++*launched
    if (Nt <= 0) return 0;
    const long long nCoef = levelOff[nLvl] * M;
    gather_kernel<<<gridFor(nCoef > Nt ? nCoef : Nt, th), th, 0, stream>>>(
        xt, x, perm, Nt, coef, far, nCoef);
    CHECK();
    moments_kernel<<<gridFor((long long)L * M, th), th, 0, stream>>>(
        coef, xt, leafPhi, leafNode, tStartRow, tLen, L, nbar, M);
    CHECK();
    for (int ell = nLvl - 1; ell >= 1; --ell) {
        const long long n0 = levelOff[ell];
        const int cnt = static_cast<int>(levelOff[ell + 1] - n0);
        if (cnt == 0) continue;
        up_kernel<<<gridFor((long long)cnt * M, th), th, 0, stream>>>(
            coef, T_, parent, n0, cnt, M);
        CHECK();
    }
    if (nFar > 0) {
        far_kernel<<<gridFor(nFar * M, th), th, 0, stream>>>(
            far, coef, K, src, dst, nFar, M);
        CHECK();
    }
    for (int ell = 1; ell < nLvl; ++ell) {
        const long long n0 = levelOff[ell];
        const int cnt = static_cast<int>(levelOff[ell + 1] - n0);
        if (cnt == 0) continue;
        down_kernel<<<gridFor((long long)cnt * M, th), th, 0, stream>>>(
            far, T_, parent, n0, cnt, M);
        CHECK();
    }
    near_leaf_kernel<<<gridFor((long long)Nt * 32, th), th, 0, stream>>>(
        y, xt, far, data, perm, rowNode, indptrT, tStartRow, rowLen,
        tmplStart, tmplAll, leafPhi, leafNode, Nt, nbar, M);
    CHECK();
#undef CHECK
    return 0;
}

EXPORT int h2_matvec(double* y, const double* x, double* xt, double* coef,
                     double* far, int Nt, int L, int nbar, int M,
                     const int* perm, const int* rowNode, const int* indptrT,
                     const int* tStartRow, const int* tLen, const int* rowLen,
                     const int* tmplStart, const int* tmplAll,
                     const double* data, const double* leafPhi,
                     const int* leafNode, const double* T, const int* parent,
                     const long long* levelOff, int nLvl, const double* K,
                     const int* src, const int* dst, long long nFar,
                     int* launched, cudaStream_t stream) {
    return h2Apply(y, x, xt, coef, far, Nt, L, nbar, M, perm, rowNode,
                   indptrT, tStartRow, tLen, rowLen, tmplStart, tmplAll, data,
                   leafPhi, leafNode, T, parent, levelOff, nLvl, K, src, dst,
                   nFar, launched, stream);
}

// K8's float32 instance: every value array float32 (the operator of the
// float32 H2 path, x, y and the work buffers), the sums in float32.
EXPORT int h2_matvec_f32(float* y, const float* x, float* xt, float* coef,
                         float* far, int Nt, int L, int nbar, int M,
                         const int* perm, const int* rowNode,
                         const int* indptrT, const int* tStartRow,
                         const int* tLen, const int* rowLen,
                         const int* tmplStart, const int* tmplAll,
                         const float* data, const float* leafPhi,
                         const int* leafNode, const float* T,
                         const int* parent, const long long* levelOff,
                         int nLvl, const float* K, const int* src,
                         const int* dst, long long nFar, int* launched,
                         cudaStream_t stream) {
    return h2Apply(y, x, xt, coef, far, Nt, L, nbar, M, perm, rowNode,
                   indptrT, tStartRow, tLen, rowLen, tmplStart, tmplAll, data,
                   leafPhi, leafNode, T, parent, levelOff, nLvl, K, src, dst,
                   nFar, launched, stream);
}

EXPORT int h2_matvec_T(double* y, const double* x, double* xt, double* coef,
                       double* far, double* yt, int Nt, int L, int nbar,
                       int M, const int* perm, const int* rowNode,
                       const int* indptrT, const int* tStartRow,
                       const int* tLen, const int* rowLen,
                       const int* tmplStart, const int* tmplAll,
                       const double* data, const double* leafPhi,
                       const int* leafNode, const double* T,
                       const int* parent, const long long* levelOff,
                       int nLvl, const double* K, const int* src,
                       const int* dst, long long nFar, int* launched,
                       cudaStream_t stream) {
    const int th = 256;
    int err;
    *launched = 0;
#define CHECK()                                                    \
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err; \
    ++*launched
    if (Nt <= 0) return 0;
    const long long nCoef = levelOff[nLvl] * M;
    gather_kernel<<<gridFor(nCoef > Nt ? nCoef : Nt, th), th, 0, stream>>>(
        xt, x, perm, Nt, coef, far, nCoef);
    CHECK();
    if ((err = static_cast<int>(cudaMemsetAsync(yt, 0, sizeof(double) * Nt,
                                                stream))) != 0)
        return err;
    moments_kernel<<<gridFor((long long)L * M, th), th, 0, stream>>>(
        coef, xt, leafPhi, leafNode, tStartRow, tLen, L, nbar, M);
    CHECK();
    for (int ell = nLvl - 1; ell >= 1; --ell) {
        const long long n0 = levelOff[ell];
        const int cnt = static_cast<int>(levelOff[ell + 1] - n0);
        if (cnt == 0) continue;
        up_kernel<<<gridFor((long long)cnt * M, th), th, 0, stream>>>(
            coef, T, parent, n0, cnt, M);
        CHECK();
    }
    if (nFar > 0) {
        farT_kernel<<<gridFor(nFar * M, th), th, 0, stream>>>(
            far, coef, K, src, dst, nFar, M);
        CHECK();
    }
    for (int ell = 1; ell < nLvl; ++ell) {
        const long long n0 = levelOff[ell];
        const int cnt = static_cast<int>(levelOff[ell + 1] - n0);
        if (cnt == 0) continue;
        down_kernel<<<gridFor((long long)cnt * M, th), th, 0, stream>>>(
            far, T, parent, n0, cnt, M);
        CHECK();
    }
    nearT_kernel<<<gridFor((long long)Nt * 32, th), th, 0, stream>>>(
        yt, xt, data, rowNode, indptrT, rowLen, tmplStart, tmplAll, Nt);
    CHECK();
    leafT_kernel<<<gridFor((long long)Nt * 32, th), th, 0, stream>>>(
        y, yt, far, perm, rowNode, tStartRow, leafPhi, leafNode, Nt, nbar, M);
    CHECK();
#undef CHECK
    return 0;
}
