// K19 panel_scatter_nonsym: batched panel quadrature of the nonsymmetric
// local matrices of explicit element pairs, scattered into the dense
// operator or into CSR data at explicit slots.  The kernel and its
// launcher; the C entry points are in panel_scatter_nonsym.cu, the dense
// target's instances with the orders of position in
// panel_scatter_nonsym_order.cu (launchNonsymPosition below).
#pragma once
//
// Replaces pynucleus_tpu/nl/assembly.py:_bucket_contrib_nonsym (with
// useLogCorr, :68 _log_extra_scalar at (x, y) and at (y, x), for a
// component kernel; with the dense scatter of DenseAccumulator.add, the per-pair entry-mask adds
// into the H2 near field's tree CSR of _runPairBuckets, the CSR adds of
// getSparse, and the indicator fallback of _runCutPairs, :2509-2537).
// For pair p:
//   x_q = sum_v bary_x[v,q] V[vi1[p,v]],  y_q = sum_v bary_y[v,q] V[vi2[p,v]]
//   t1_q = gamma(x_q, y_q) w_q chi(x_q, y_q) volsym[p]
//   t2_q = gamma(y_q, x_q) w_q chi(x_q, y_q) volsym[p]
//   M[k] = sum_q t1_q PHIxPSI[q, k] - sum_q t2_q PHIyPSI[q, k]
// with gamma the kernel's radial profile or its variable fractional order
// (common.cuh kernelXY, with the smooth two-point weight exp(-wlam |x-y|)
// of the profile after the value: pynucleus_tpu/nl/assembly.py:435-436),
// or a variable horizon's kernel (varHorizonXY
// below, delta at gamma's first point: delta(x) in t1, delta(y) in t2), chi
// the interaction indicator of a finite horizon (common.cuh inBall, applied
// after gamma as the JAX program applies jaxIndicator; code 0 none); both
// orderings share r2 and the node geometry of K1 (common.cuh panelNode).
// Two epilogues:
//   DENSE  A[dofRows[p,I], dofRows[p,J]] += M[I*nPSI+J]   for both dofs >= 0
//   SLOTS  data[slots[p, k]] += M[k]                      for 0 <= slot < nnz
//          (the H2 near field: the host masks a pair's entries by its
//          cluster pairs, a masked entry has no slot; the sparse format:
//          slots searched on the device)
//
// Design: as K1, one warp per pair with lanes striding over the Q nodes;
// both accumulators (2 nPSI^2 doubles, 32 for the 1D P1 pairs) stay in
// registers, a warp butterfly reduces each, and one atomicAdd(double) per
// entry adds M = acc1 - acc2, the order of the JAX program's two products
// and their difference.  Bound on the card: a variable order's two kernel
// evaluations per node (two pow, two lgamma and an exp each; the variable
// horizon's two pow each) and the 2 nPSI^2 FMAs (compute).  The variable
// horizon has its own template instances (VH; the interval's nPSI 2 and 4).
// The orders of position (common.cuh orderAt) and the component order
// (common.cuh componentTerm: its value and, with a singular rule's log
// tables, its log correction, in t1 at (x, y) and in t2 at (y, x)) have
// instances of their own (launchNonsym with POS): the dense target's with
// every one of them, nPSI 2 and 4 on the interval, 3 (identical triangles)
// and 6 (the other triangle pairs: both cells' dofs, the shared ones
// DROPped on the second) in 2D (panel_scatter_nonsym_order.cu); the slot
// target's with those of H2_ORDER_SWITCH on the interval, nPSI 2 and 4
// (the H2 near field's per-pair path, panel_scatter_nonsym_order_h2.cu).

#include "common.cuh"

enum NonsymTarget { NS_DENSE = 0, NS_SLOTS = 1 };

// A variable horizon delta(x) = min(max(c0 + c1 x[0], lo), hi) of a
// constant order s (pynucleus_tpu_torch/nl/kernels.py HorizonParams and
// horizonArgs; on = 0: none).  a = 2 - 2s, e = 2s - 2, d, gamma =
// Gamma(d/2) (scipy's), piD2 = pi^(d/2) and expo = -d/2 - s are the host
// values of the JAX expression's Python floats.
struct Horizon {
    int on;
    double c0, c1, lo, hi, a, e, d, gamma, piD2, expo;
    int normalized;
};

// variableHorizonFractionalKernel.evalXY (pynucleus_tpu/nl/kernels.py
// :1384-1398) at r2 with delta = delta(x) of its first point x, 0 at
// r2 = 0, each operation in the plain version's order, rounded on its own:
//   C = a delta^e d gamma / piD2 * 0.5   (or 0.5)
//   gamma(x, y) = C r2^expo  where r2 <= delta^2, else 0
__device__ __forceinline__ double varHorizonXY(double r2, const double* x,
                                               const Horizon& h) {
    if (!(r2 > 0.0)) return 0.0;
    const double delta =
        fmin(fmax(__dadd_rn(h.c0, __dmul_rn(h.c1, x[0])), h.lo), h.hi);
    double C = 0.5;
    if (h.normalized)
        C = __dmul_rn(
            __ddiv_rn(__dmul_rn(__dmul_rn(__dmul_rn(h.a, pow(delta, h.e)),
                                          h.d),
                                h.gamma),
                      h.piD2),
            0.5);
    const double val = __dmul_rn(C, pow(r2, h.expo));
    return r2 <= __dmul_rn(delta, delta) ? val : 0.0;
}

template <int NPSI, int TARGET, int PC, int OC, bool VH>
__global__ void __launch_bounds__(256)
panel_scatter_nonsym_kernel(double* __restrict__ out,
                            long long N /* dense: N; slots: nnz */,
                            const double* __restrict__ vertices, int dim,
                            const long long* __restrict__ vi1, int nv1,
                            const long long* __restrict__ vi2, int nv2,
                            const long long* __restrict__ dofRows,
                            const int* __restrict__ slots,
                            const double* __restrict__ volsym, long long P,
                            const double* __restrict__ bary_x,
                            const double* __restrict__ bary_y,
                            const double* __restrict__ w,
                            const double* __restrict__ PHIxPSI,
                            const double* __restrict__ PHIyPSI, int Q,
                            Profile pf, Inter in, Order od, Horizon hz) {
    constexpr int NN = NPSI * NPSI;
    const int lane = threadIdx.x & 31;
    const long long pair = (long long)blockIdx.x * (blockDim.x >> 5)
                           + (threadIdx.x >> 5);
    if (pair >= P) return;  // uniform across the warp

    double v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM];
    loadSimplex(v1, vertices, vi1 + pair * nv1, nv1, dim);
    loadSimplex(v2, vertices, vi2 + pair * nv2, nv2, dim);
    const double vs = volsym[pair];

    double acc1[NN], acc2[NN];
#pragma unroll
    for (int k = 0; k < NN; ++k) acc1[k] = acc2[k] = 0.0;
    for (int q = lane; q < Q; q += 32) {
        double x[MAXDIM], y[MAXDIM];
        const double r2 = panelNode(x, y, v1, nv1, v2, nv2, dim, bary_x,
                                    bary_y, Q, q, nullptr);
        double t1, t2;
        if constexpr (VH) {
            t1 = varHorizonXY(r2, x, hz) * w[q];
            t2 = varHorizonXY(r2, y, hz) * w[q];
        } else if constexpr (OC == ORDER_COMPONENT) {
            t1 = componentTerm(r2, x, y, od, w[q], q, true);
            t2 = componentTerm(r2, y, x, od, w[q], q, true);
        } else {
            t1 = kernelXY<PC, OC>(r2, x, y, pf, od) * w[q];
            t2 = kernelXY<PC, OC>(r2, y, x, pf, od) * w[q];
        }
        if (!inBall(in, x, y, dim)) t1 = t2 = 0.0;
        t1 *= vs;
        t2 *= vs;
        const double* px = PHIxPSI + (long long)q * NN;
        const double* py = PHIyPSI + (long long)q * NN;
#pragma unroll
        for (int k = 0; k < NN; ++k) {
            acc1[k] += t1 * __ldg(px + k);
            acc2[k] += t2 * __ldg(py + k);
        }
    }
#pragma unroll
    for (int k = 0; k < NN; ++k) {
        acc1[k] = warpSum(acc1[k]);
        acc2[k] = warpSum(acc2[k]);
    }
#pragma unroll
    for (int k = 0; k < NN; ++k) {
        if ((k & 31) != lane) continue;
        const double m = acc1[k] - acc2[k];
        if (TARGET == NS_DENSE) {
            const long long* dr = dofRows + pair * NPSI;
            const long long r = dr[k / NPSI], c = dr[k % NPSI];
            if (r >= 0 && c >= 0) atomicAdd(out + r * N + c, m);
        } else {
            const long long s = slots[pair * NN + k];
            if (s >= 0 && s < N) atomicAdd(out + s, m);
        }
    }
}

template <int TARGET, bool POS = false>
static int launchNonsym(double* out, long long N, const double* vertices,
                        int dim, const long long* vi1, int nv1,
                        const long long* vi2, int nv2,
                        const long long* dofRows, const int* slots, int nPSI,
                        const double* volsym, long long P,
                        const double* bary_x, const double* bary_y,
                        const double* w, const double* PHIxPSI,
                        const double* PHIyPSI, int Q, Profile pf, Inter in,
                        Order od, Horizon hz, cudaStream_t stream) {
    if (P <= 0) return 0;
    if (dim > MAXDIM || nv1 > MAXNV || nv2 > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = (P + (threads / 32) - 1) / (threads / 32);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(NP, VH)                                                       \
    panel_scatter_nonsym_kernel<NP, TARGET, PC, OC, VH>                      \
        <<<(unsigned)blocks, threads, 0, stream>>>(                          \
            out, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, slots,       \
            volsym, P, bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, pf, in, od,   \
            hz)
    if constexpr (POS && TARGET == NS_DENSE) {
        if (hz.on) return static_cast<int>(cudaErrorInvalidValue);
        POSITION_ORDER_SWITCH(pf.code, od.code, switch (nPSI) {
            case 2: LAUNCH(2, false); break;
            case 3: LAUNCH(3, false); break;
            case 4: LAUNCH(4, false); break;
            case 6: LAUNCH(6, false); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        })
    } else if constexpr (POS) {
        // the H2 near field's per-pair path on the interval
        if (hz.on) return static_cast<int>(cudaErrorInvalidValue);
        H2_ORDER_SWITCH(pf.code, od.code, switch (nPSI) {
            case 2: LAUNCH(2, false); break;
            case 4: LAUNCH(4, false); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        })
    } else if (hz.on) {
        // the variable horizon of a constant order (a fractional kernel) on
        // the interval (1D P1: identical cells nPSI 2, pairs nPSI 4)
        if (pf.code != PROFILE_POWER || od.code != ORDER_NONE || dim != 1)
            return static_cast<int>(cudaErrorInvalidValue);
        constexpr int OC = ORDER_NONE, PC = PROFILE_POWER;
        switch (nPSI) {
            case 2: LAUNCH(2, true); break;
            case 4: LAUNCH(4, true); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    } else {
        KERNEL_SWITCH(pf.code, od.code, switch (nPSI) {
            case 2: LAUNCH(2, false); break;
            case 3: LAUNCH(3, false); break;
            case 4: LAUNCH(4, false); break;
            case 6: LAUNCH(6, false); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        })
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}


// The dense target with an order of position or the component order:
// launchNonsym<NS_DENSE, true>, instantiated in
// panel_scatter_nonsym_order.cu; the slot target with those of
// H2_ORDER_SWITCH: launchNonsym<NS_SLOTS, true>, instantiated in
// panel_scatter_nonsym_order_h2.cu; the entry points
// (panel_scatter_nonsym.cu) call them for the codes from ORDER_INNER_OUTER
// on.
int launchNonsymPosition(double* A, long long N, const double* vertices,
                         int dim, const long long* vi1, int nv1,
                         const long long* vi2, int nv2,
                         const long long* dofRows, int nPSI,
                         const double* volsym, long long P,
                         const double* bary_x, const double* bary_y,
                         const double* w, const double* PHIxPSI,
                         const double* PHIyPSI, int Q, Profile pf, Inter in,
                         Order od, Horizon hz, cudaStream_t stream);
int launchNonsymSlotsPosition(double* data, long long nnz,
                              const double* vertices, int dim,
                              const long long* vi1, int nv1,
                              const long long* vi2, int nv2,
                              const int* slots, int nPSI,
                              const double* volsym, long long P,
                              const double* bary_x, const double* bary_y,
                              const double* w, const double* PHIxPSI,
                              const double* PHIyPSI, int Q, Profile pf,
                              Inter in, Order od, Horizon hz,
                              cudaStream_t stream);
