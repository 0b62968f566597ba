// K28 dist_h2_matvec: the per-shard body of the distributed H2 apply
// (pynucleus_tpu/parallel/dist_h2.py:571-710), split into phases at its
// collectives.  Every launch serves the shards of one card (the shard is
// the grid's y index); float64 values, int64 index arrays.  The
// collectives between the phases (psum of the shared partials, the
// exchange of the x halo and the coefficient outboxes by K29) run between
// the launches.
//
// Layout of one shard k (kernels/dist_h2.py holds the host side):
//   own, outOwn  [ownTot, M]  the owned nodes' coefficients, level by level
//                (level l at rows ownOff[l] ..., maxOwn[l] rows, at least
//                one); the padding rows stay 0
//   shr, outShr  [shrTot, M]  the shared nodes' coefficients, replicated
//                on every shard as in the JAX program
//   Town         [ownTot, M, M] child -> parent transfers of the owned
//                nodes; Tshr [shrTot, M, M] of the shared ones (one copy
//                for every shard)
//   every pair list is a CSR by its target node, sorted at set-up, so each
//   output row is summed by one thread with no atomics, in a fixed order.
//
// Phases (one launch each; per level for up, far and down):
//   near      y[r] = sum_e dat[e] xe[col[e]] over row r's entries, xe the
//             local x, then the received halo, then 0 (one warp per row)
//   moments   own[leaf row] = lfPhi^T x over the leaf's local dofs
//   up        own[parent] += sum_children Town own[child] (owned parents);
//             partial[q] = the same sum for the shared parents (to psum)
//   up_shared shr[q] += psum(partial)[q] + sum_children Tshr shr[child]
//   far       outOwn[d] += sum_A KA ce[src] (ce: own, shr, received
//             coefficients, 0); partC[q] = sum_C KC own[src] (to psum)
//   far_shared outShr[q] += psum(partC)[q] + sum_D KD shr[src]
//   down      outOwn[n] += Town^T (outOwn + outShr)[parent(n)];
//             outShr[q] += Tshr^T outShr[parent(q)]
//   leaf      y[dof] += lfPhi . outOwn[leaf row] for each local dof
//
// One thread per output value (a node row and a coefficient index); its
// loops run over the node's pairs and the M coefficients.  Bound on the
// card: bytes (the blocks KA, KC, KD, the transfers and the near data are
// read once per apply).

#include "common.cuh"

typedef long long ll;

__global__ void __launch_bounds__(256)
dh_near_kernel(double* __restrict__ y, ll R, const double* __restrict__ xl,
               const double* __restrict__ buf, ll bufStride, ll B,
               const ll* __restrict__ ptr, const ll* __restrict__ col,
               const double* __restrict__ dat, ll nnzStride) {
    const int lane = threadIdx.x & 31;
    const ll r = (ll)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const ll k = blockIdx.y;
    if (r >= R) return;  // uniform across the warp
    const ll* p = ptr + k * (R + 1);
    const ll start = p[r], end = p[r + 1];
    const ll* c = col + k * nnzStride;
    const double* d = dat + k * nnzStride;
    const double* x = xl + k * R;
    const double* b = buf + k * bufStride;
    double s = 0.0;
    for (ll e = start + lane; e < end; e += 32) {
        const ll q = c[e];
        double v = 0.0;
        if (q < R)
            v = x[q];
        else if (q < R + B)
            v = b[q - R];
        s += d[e] * v;
    }
    s = warpSum(s);
    if (lane == 0) y[k * R + r] = s;
}

__global__ void __launch_bounds__(256)
dh_moments_kernel(double* __restrict__ own, ll ownTot, int M,
                  const double* __restrict__ xl, ll R,
                  const double* __restrict__ lfPhi,
                  const ll* __restrict__ lfXslot,
                  const ll* __restrict__ lfRow, ll LP, int nbar) {
    const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
    const ll k = blockIdx.y;
    if (t >= LP * M) return;
    const ll q = t / M;
    const int m = (int)(t - q * M);
    const ll row = lfRow[k * LP + q];
    if (row < 0) return;
    const ll* xs = lfXslot + (k * LP + q) * nbar;
    const double* phi = lfPhi + (k * LP + q) * nbar * (ll)M;
    double s = 0.0;
    for (int n = 0; n < nbar; ++n) {
        const ll sl = xs[n];
        if (sl >= 0 && sl < R) s += phi[(ll)n * M + m] * xl[k * R + sl];
    }
    own[(k * ownTot + row) * M + m] = s;
}

// sum_c sum_j T[row_c, i, j] v[row_c, j] (trans: T[row_c, j, i]) over the
// rows of a CSR range
__device__ __forceinline__ double transferSum(const double* T,
                                              const double* v, int M, int i,
                                              const ll* idx, ll start, ll end,
                                              ll rowOff) {
    double s = 0.0;
    for (ll e = start; e < end; ++e) {
        const ll row = rowOff + idx[e];
        const double* Tr = T + (row * M + i) * M;
        const double* vr = v + row * M;
        for (int j = 0; j < M; ++j) s += Tr[j] * vr[j];
    }
    return s;
}

__global__ void __launch_bounds__(256)
dh_up_kernel(double* __restrict__ own, double* __restrict__ partial,
             ll ownTot, int M, const double* __restrict__ Town,
             const ll* __restrict__ ptr, const ll* __restrict__ idx,
             ll idxStride, ll moP, ll nShrP, ll rowOffChild,
             ll rowOffParent) {
    const ll nT = moP + nShrP;
    const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
    const ll k = blockIdx.y;
    if (t >= nT * M) return;
    const ll tg = t / M;
    const int i = (int)(t - tg * M);
    const ll* p = ptr + k * (nT + 1);
    const double s = transferSum(Town + k * ownTot * M * M,
                                 own + k * ownTot * M, M, i,
                                 idx + k * idxStride, p[tg], p[tg + 1],
                                 rowOffChild);
    if (tg < moP)
        own[(k * ownTot + rowOffParent + tg) * M + i] += s;
    else
        partial[(k * nShrP + (tg - moP)) * M + i] = s;
}

__global__ void __launch_bounds__(256)
dh_up_shared_kernel(double* __restrict__ shr, ll shrTot, int M,
                    const double* __restrict__ psum,
                    const double* __restrict__ Tshr,
                    const ll* __restrict__ ptr, const ll* __restrict__ idx,
                    ll nShrP, ll shrOffChild, ll shrOffParent) {
    const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
    const ll k = blockIdx.y;
    if (t >= nShrP * M) return;
    const ll q = t / M;
    const int i = (int)(t - q * M);
    double* sh = shr + k * shrTot * M;
    // Tshr is one copy for every shard; the coefficients are the shard's
    double s = 0.0;
    for (ll e = ptr[q]; e < ptr[q + 1]; ++e) {
        const ll row = shrOffChild + idx[e];
        const double* Tr = Tshr + (row * M + i) * M;
        const double* vr = sh + row * M;
        for (int j = 0; j < M; ++j) s += Tr[j] * vr[j];
    }
    sh[(shrOffParent + q) * M + i] += psum[q * M + i] + s;
}

__global__ void __launch_bounds__(256)
dh_far_kernel(double* __restrict__ outOwn, double* __restrict__ partC,
              const double* __restrict__ own, const double* __restrict__ shr,
              const double* __restrict__ buf, ll bufStride, ll nBufRows,
              ll ownTot, ll shrTot, int M, ll rowOff, ll shrOff, ll mo,
              ll nShr, const ll* __restrict__ ptrA,
              const ll* __restrict__ srcA, const double* __restrict__ KA,
              ll nA, const ll* __restrict__ ptrC,
              const ll* __restrict__ srcC, const double* __restrict__ KC,
              ll nC) {
    const ll nT = mo + nShr;
    const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
    const ll k = blockIdx.y;
    if (t >= nT * M) return;
    const ll tg = t / M;
    const int i = (int)(t - tg * M);
    const double* ow = own + k * ownTot * M;
    double s = 0.0;
    if (tg < mo) {
        const ll* p = ptrA + k * (mo + 1);
        for (ll e = p[tg]; e < p[tg + 1]; ++e) {
            const ll src = srcA[k * nA + e];
            const double* v;
            if (src < mo)
                v = ow + (rowOff + src) * M;
            else if (src < mo + nShr)
                v = shr + (k * shrTot + shrOff + src - mo) * M;
            else if (src - mo - nShr < nBufRows)
                v = buf + k * bufStride + (src - mo - nShr) * M;
            else
                continue;
            const double* Kr = KA + ((k * nA + e) * M + i) * M;
            for (int j = 0; j < M; ++j) s += Kr[j] * v[j];
        }
        outOwn[(k * ownTot + rowOff + tg) * M + i] += s;
    } else {
        const ll q = tg - mo;
        const ll* p = ptrC + k * (nShr + 1);
        for (ll e = p[q]; e < p[q + 1]; ++e) {
            const double* v = ow + (rowOff + srcC[k * nC + e]) * M;
            const double* Kr = KC + ((k * nC + e) * M + i) * M;
            for (int j = 0; j < M; ++j) s += Kr[j] * v[j];
        }
        partC[(k * nShr + q) * M + i] = s;
    }
}

__global__ void __launch_bounds__(256)
dh_far_shared_kernel(double* __restrict__ outShr,
                     const double* __restrict__ shr, ll shrTot, int M,
                     ll shrOff, ll nShr, const double* __restrict__ psum,
                     const ll* __restrict__ ptrD, const ll* __restrict__ srcD,
                     const double* __restrict__ KD) {
    const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
    const ll k = blockIdx.y;
    if (t >= nShr * M) return;
    const ll q = t / M;
    const int i = (int)(t - q * M);
    const double* sh = shr + k * shrTot * M;
    double s = 0.0;
    for (ll e = ptrD[q]; e < ptrD[q + 1]; ++e) {
        const double* v = sh + (shrOff + srcD[e]) * M;
        const double* Kr = KD + (e * M + i) * M;
        for (int j = 0; j < M; ++j) s += Kr[j] * v[j];
    }
    outShr[(k * shrTot + shrOff + q) * M + i] += psum[q * M + i] + s;
}

__global__ void __launch_bounds__(256)
dh_down_kernel(double* __restrict__ outOwn, double* __restrict__ outShr,
               ll ownTot, ll shrTot, int M, const double* __restrict__ Town,
               const ll* __restrict__ parOwnRow,
               const ll* __restrict__ parShrRow,
               const double* __restrict__ Tshr,
               const ll* __restrict__ shrParRow, ll rowOff, ll mo,
               ll shrOff, ll nShr) {
    const ll nT = mo + nShr;
    const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
    const ll k = blockIdx.y;
    if (t >= nT * M) return;
    const ll tg = t / M;
    const int i = (int)(t - tg * M);
    double* oo = outOwn + k * ownTot * M;
    double* os = outShr + k * shrTot * M;
    double s = 0.0;
    if (tg < mo) {
        const ll row = rowOff + tg;
        const ll po = parOwnRow[k * ownTot + row];
        const ll ps = parShrRow[k * ownTot + row];
        const double* T = Town + (k * ownTot + row) * M * M;
        for (int j = 0; j < M; ++j) {
            double par = 0.0;
            if (po >= 0) par += oo[po * M + j];
            if (ps >= 0) par += os[ps * M + j];
            s += T[j * M + i] * par;
        }
        oo[row * M + i] += s;
    } else {
        const ll row = shrOff + tg - mo;
        const ll pr = shrParRow[row];
        const double* T = Tshr + row * M * M;
        for (int j = 0; j < M; ++j) s += T[j * M + i] * os[pr * M + j];
        os[row * M + i] += s;
    }
}

__global__ void __launch_bounds__(256)
dh_leaf_kernel(double* __restrict__ y, ll R,
               const double* __restrict__ outOwn, ll ownTot, int M,
               const double* __restrict__ lfPhi,
               const ll* __restrict__ lfXslot, const ll* __restrict__ lfRow,
               ll LP, int nbar) {
    const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
    const ll k = blockIdx.y;
    if (t >= LP * nbar) return;
    const ll q = t / nbar;
    const ll row = lfRow[k * LP + q];
    const ll sl = lfXslot[k * LP * nbar + t];
    if (row < 0 || sl < 0 || sl >= R) return;
    const double* phi = lfPhi + (k * LP * nbar + t) * M;
    const double* v = outOwn + (k * ownTot + row) * M;
    double s = 0.0;
    for (int m = 0; m < M; ++m) s += phi[m] * v[m];
    y[k * R + sl] += s;
}

static dim3 grid(ll n, int nk, int perBlock = 256) {
    return dim3((unsigned)((n + perBlock - 1) / perBlock), (unsigned)nk);
}

static int done() { return static_cast<int>(cudaGetLastError()); }

EXPORT int dist_h2_near(double* y, ll R, const double* xl, const double* buf,
                        ll bufStride, ll B, const ll* ptr, const ll* col,
                        const double* dat, ll nnzStride, int nk,
                        cudaStream_t stream) {
    if (nk <= 0 || R <= 0) return 0;
    dh_near_kernel<<<grid(R, nk, 8), 256, 0, stream>>>(
        y, R, xl, buf, bufStride, B, ptr, col, dat, nnzStride);
    return done();
}

EXPORT int dist_h2_moments(double* own, ll ownTot, int M, const double* xl,
                           ll R, const double* lfPhi, const ll* lfXslot,
                           const ll* lfRow, ll LP, int nbar, int nk,
                           cudaStream_t stream) {
    if (nk <= 0 || LP <= 0) return 0;
    dh_moments_kernel<<<grid(LP * M, nk), 256, 0, stream>>>(
        own, ownTot, M, xl, R, lfPhi, lfXslot, lfRow, LP, nbar);
    return done();
}

EXPORT int dist_h2_up(double* own, double* partial, ll ownTot, int M,
                      const double* Town, const ll* ptr, const ll* idx,
                      ll idxStride, ll moP, ll nShrP, ll rowOffChild,
                      ll rowOffParent, int nk, cudaStream_t stream) {
    if (nk <= 0 || moP + nShrP <= 0) return 0;
    dh_up_kernel<<<grid((moP + nShrP) * M, nk), 256, 0, stream>>>(
        own, partial, ownTot, M, Town, ptr, idx, idxStride, moP, nShrP,
        rowOffChild, rowOffParent);
    return done();
}

EXPORT int dist_h2_up_shared(double* shr, ll shrTot, int M,
                             const double* psum, const double* Tshr,
                             const ll* ptr, const ll* idx, ll nShrP,
                             ll shrOffChild, ll shrOffParent, int nk,
                             cudaStream_t stream) {
    if (nk <= 0 || nShrP <= 0) return 0;
    dh_up_shared_kernel<<<grid(nShrP * M, nk), 256, 0, stream>>>(
        shr, shrTot, M, psum, Tshr, ptr, idx, nShrP, shrOffChild,
        shrOffParent);
    return done();
}

EXPORT int dist_h2_far(double* outOwn, double* partC, const double* own,
                       const double* shr, const double* buf, ll bufStride,
                       ll nBufRows, ll ownTot, ll shrTot, int M, ll rowOff,
                       ll shrOff, ll mo, ll nShr, const ll* ptrA,
                       const ll* srcA, const double* KA, ll nA,
                       const ll* ptrC, const ll* srcC, const double* KC,
                       ll nC, int nk, cudaStream_t stream) {
    if (nk <= 0 || mo + nShr <= 0) return 0;
    dh_far_kernel<<<grid((mo + nShr) * M, nk), 256, 0, stream>>>(
        outOwn, partC, own, shr, buf, bufStride, nBufRows, ownTot, shrTot, M,
        rowOff, shrOff, mo, nShr, ptrA, srcA, KA, nA, ptrC, srcC, KC, nC);
    return done();
}

EXPORT int dist_h2_far_shared(double* outShr, const double* shr, ll shrTot,
                              int M, ll shrOff, ll nShr, const double* psum,
                              const ll* ptrD, const ll* srcD,
                              const double* KD, int nk, cudaStream_t stream) {
    if (nk <= 0 || nShr <= 0) return 0;
    dh_far_shared_kernel<<<grid(nShr * M, nk), 256, 0, stream>>>(
        outShr, shr, shrTot, M, shrOff, nShr, psum, ptrD, srcD, KD);
    return done();
}

EXPORT int dist_h2_down(double* outOwn, double* outShr, ll ownTot,
                        ll shrTot, int M, const double* Town,
                        const ll* parOwnRow, const ll* parShrRow,
                        const double* Tshr, const ll* shrParRow, ll rowOff,
                        ll mo, ll shrOff, ll nShr, int nk,
                        cudaStream_t stream) {
    if (nk <= 0 || mo + nShr <= 0) return 0;
    dh_down_kernel<<<grid((mo + nShr) * M, nk), 256, 0, stream>>>(
        outOwn, outShr, ownTot, shrTot, M, Town, parOwnRow, parShrRow, Tshr,
        shrParRow, rowOff, mo, shrOff, nShr);
    return done();
}

EXPORT int dist_h2_leaf(double* y, ll R, const double* outOwn, ll ownTot,
                        int M, const double* lfPhi, const ll* lfXslot,
                        const ll* lfRow, ll LP, int nbar, int nk,
                        cudaStream_t stream) {
    if (nk <= 0 || LP <= 0) return 0;
    dh_leaf_kernel<<<grid(LP * nbar, nk), 256, 0, stream>>>(
        y, R, outOwn, ownTot, M, lfPhi, lfXslot, lfRow, LP, nbar);
    return done();
}
