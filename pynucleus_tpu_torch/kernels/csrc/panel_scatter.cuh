// K1 panel_scatter: batched panel quadrature of explicit element pairs,
// scattered into the dense operator, into CSR data (the H2 near field, the
// sparse format) or into the interior x boundary coupling A_BC.  The kernel
// and its launcher; the C entry points of its targets are in three
// sources, and the instances of the orders of position and of the component
// order in two more, so that nvcc compiles them in parallel:
// panel_scatter.cu (DENSE, DIAG), panel_scatter_csr.cu (SLOTS, TREE),
// panel_scatter_cross.cu (CROSS), panel_scatter_order.cu (DENSE with the
// orders of position and the component order) and panel_scatter_order_h2.cu
// (SLOTS and TREE with those of H2_ORDER_SWITCH).
#pragma once

//
// Replaces pynucleus_tpu/nl/assembly.py:_bucket_contrib (+ the dense
// scatter _device_scatter_rows; with useLogCorr, :68 _log_extra_scalar,
// for a component kernel), _bucket_natural_scatter_scan,
// _bucket_rows_scatter_scan, _bucket_masked_csr_scan and
// _bucket_surface_tree_scan.  For pair p with simplices vi1[p], vi2[p]:
//   x_q = sum_v bary_x[v,q] V[vi1[p,v]],  y_q = sum_v bary_y[v,q] V[vi2[p,v]]
//         (+ yShift[p], a variable order's surface items)
//   t_q = gamma(x_q, y_q) w_q volsym[p]  (* n_p.(y_q-x_q)/|y_q-x_q|)
//         (* chi(x_q, y_q), the interaction indicator of a finite horizon:
//         ball2, ballInf, ball1 or the ellipse, or of a complement kernel,
//         |x_q-y_q|^2 >= h2; common.cuh inBall)
//   M[I,J] = sum_q t_q PSIP[q, I*nPSI+J]
// x_q and y_q sum their vertices in order, each term a fused multiply-add
// (common.cuh panelNode<true>, __fma_rn): the rounding of the JAX package's
// einsum on the CPU, which decides the complement indicator at |x_q - y_q|
// = delta where the horizon spans whole cells; the plain version sums them
// so for that indicator (nl/assembly.py _fmaNodes).
// gamma is the kernel's radial profile (with its tempering and its smooth
// two-point weight, common.cuh radial and twoPoint, from r2 of the node
// pair: pynucleus_tpu/nl/assembly.py:58-62) or, for a variable fractional
// order
// (constantNonSym, leftRight: pynucleus_tpu/nl/kernels.py
// FractionalKernel.evalXY, reached through _radial_eval), s(x, y) and its
// normalization per node (common.cuh kernelXY); the kernel is a template on
// both codes and each launcher switches once (KERNEL_SWITCH).  The orders
// of position (innerOuter, islands, layers, smoothedLeftRight,
// linearLeftRight, smoothedInnerOuter, fe: common.cuh orderAt) and the
// component order of a vector kernel's component (common.cuh
// componentTerm: its value, and with a singular rule's log tables its log
// correction, t_q = gamma_q w_q + cw1_q (b_q + 2 c_q lnR_q) + cw2_q c_q)
// have instances of their own, launchPanel with POS: the DENSE target's
// with every one of them (POSITION_ORDER_SWITCH; the dense operator of a
// symmetric order on the interval and on triangles, and the zero-exterior
// term, with normals in 2D, of each), the SLOTS and TREE targets' with
// those of H2_ORDER_SWITCH on the interval (nPSI 2 and 4: the singular
// panels, the distant pairs of the near cluster pairs and the union
// surfaces, with and without the y shift, of an H2 near field); the entry
// points reach them by the code (launchPanelPosition,
// launchPanelH2Position below).
// One quadrature body (common.cuh panelQuad), four epilogues:
//   DENSE  A[dofRows[p,I], dofRows[p,J]] += M[I,J]   for both dofs >= 0
//          (negative dofs, boundary -d-1 and DROP, replace the JAX dump row)
//          and bit I*nPSI+J of the launch's entry mask set (emask; -1 keeps
//          every entry): the JAX entryMask, DROP where it is False, which
//          is the same for every pair of the complement cross operator
//          (pynucleus_tpu/nl/assembly.py _getComplementCross, emBlock: the
//          off-diagonal blocks of each local matrix)
//   SLOTS  data[slots[p, I*nPSI+J]] += M[I,J]       for 0 <= slot < nnz
//          (host slots of the identical-cell and touching near pairs)
//   TREE   data[treeSlot(dofRows[p,I], dofRows[p,J]; I_p, J_p, offF_p,
//          offB_p)] += M[I,J] (union surfaces; the slot is arithmetic in the
//          tree-ordered CSR, see common.cuh treeSlot)
//   CROSS  A[dofRows[p,I], -dofRows[p,J]-1] += M[I,J]  for an interior row
//          (>= 0) and a boundary column (DROP_HALF < c < 0): A_BC [N, NB]
//          of pynucleus_tpu/nl/assembly.py:getDenseCross / BCAccumulator
//   DIAG   d[r] += M[I,J] where r = dofRows[p,I] = dofRows[p,J] >= 0: the
//          diagonal alone (pynucleus_tpu/nl/assembly.py _DiagAccumulator
//          of getDiagonal); radial profiles without a variable order
//
// The complex variant is the instance of the complex GREENS_2D profile
// (PC == PROFILE_GREENS_2D; common.cuh radialC, the A&S Bessel functions
// of ComplexKernel._radialJax): t_q and M are complex, kept as separate re
// and im sums (2 nPSI^2 doubles a lane, panelQuad's acc and acci), reduced
// the same way and added into the float64 view of the complex128 target
// (re at 2 k, im at 2 k + 1) with two atomicAdd(double) each; its targets
// are DENSE and DIAG (the complex DenseAccumulator and _DiagAccumulator of
// getDense and getDiagonal), triangles only (nPSI 3 or 6).  No normals and
// no variable order: a complex kernel has no zero-exterior term.
//
// The float32 instances (T = float; panel_scatter_f32.cu) are the DENSE,
// SLOTS, TREE and DIAG targets' with the power profile and no order or
// shift: the float32 dense path (its explicit pairs, its natural-order
// buckets and the zero-exterior rows with normals in 2D) and the float32 H2
// path (the singular panels at explicit slots of the near data, the union
// surfaces at tree slots, with normals in 2D), every value a float, the
// nodes summed with __fmaf_rn, each entry added with atomicAdd(float); and,
// with the indicator of a finite horizon (common.cuh inBall on floats),
// the float32 sparse path and getDiagonal: the SLOTS and DIAG targets'
// float32 local entries added into float64 data (TO = double, one
// atomicAdd(double) of the exact widening each), the float64 host sums of
// the JAX package's CSRAccumulator and _DiagAccumulator.
//
// Design: one warp per pair, lanes striding over the Q quadrature nodes
// (the 2D singular rules have 30-3000 nodes, so a thread per pair would
// leave lanes idle), the nPSI^2 local entries kept in registers, a warp
// butterfly reduction per entry, then one atomicAdd(double) per entry.
// Bound on the card: float64 pow per node and the nPSI^2 FMAs per node
// (compute); atomics are nPSI^2 per pair, negligible against Q >= 30.  The
// complex variant: the Bessel branch per node (a log, or a cos, a sin and
// a sqrt, and four rational polynomials) and 2 nPSI^2 FMAs per node.

#include "common.cuh"

enum Target { DENSE = 0, SLOTS = 1, TREE = 2, CROSS = 3, DIAG = 4 };

template <int NPSI, int TARGET, int PC, int OC, typename T = double,
          typename TO = T>
__global__ void __launch_bounds__(256)
panel_scatter_kernel(TO* __restrict__ out,
                     long long N /* dense: N; CSR: nnz; cross: NB */,
                     const T* __restrict__ vertices, int dim,
                     const long long* __restrict__ vi1, int nv1,
                     const long long* __restrict__ vi2, int nv2,
                     const long long* __restrict__ dofRows,
                     const int* __restrict__ slots,
                     const T* __restrict__ volsym,
                     const T* __restrict__ normals, long long P,
                     const int* __restrict__ I, const int* __restrict__ J,
                     const int* __restrict__ offF,
                     const int* __restrict__ offB, TreeTables tt,
                     const T* __restrict__ bary_x,
                     const T* __restrict__ bary_y,
                     const T* __restrict__ w,
                     const T* __restrict__ PSIP, int Q,
                     Profile pf, Inter in, Order od,
                     const T* __restrict__ yShift, long long emask) {
    constexpr int NN = NPSI * NPSI;
    constexpr bool CPLX = PC == PROFILE_GREENS_2D;
    static_assert(!CPLX || TARGET == DENSE || TARGET == DIAG,
                  "the complex profile scatters into dense A or the diagonal");
    static_assert(!IS_F32<T> || TARGET == DENSE || TARGET == SLOTS
                      || TARGET == TREE || TARGET == DIAG,
                  "float32: the dense, CSR and diagonal targets only");
    static_assert(std::is_same<T, TO>::value
                      || (TARGET == SLOTS || TARGET == DIAG),
                  "a wider target: the slots and the diagonal only");
    const int lane = threadIdx.x & 31;
    const long long pair = (long long)blockIdx.x * (blockDim.x >> 5)
                           + (threadIdx.x >> 5);
    if (pair >= P) return;  // uniform across the warp

    T v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM], nrm[MAXDIM];
    loadSimplex(v1, vertices, vi1 + pair * nv1, nv1, dim);
    loadSimplex(v2, vertices, vi2 + pair * nv2, nv2, dim);
    if (normals != nullptr)
        for (int d = 0; d < dim; ++d) nrm[d] = normals[pair * dim + d];

    T acc[NN], acci[CPLX ? NN : 1];
    panelQuad<NN, PC, OC>(acc, v1, nv1, v2, nv2, dim,
                          normals != nullptr ? nrm : nullptr, volsym[pair],
                          bary_x, bary_y, w, PSIP, Q, pf, lane, 32, in, od,
                          yShift != nullptr ? yShift + pair * dim : nullptr,
                          acci);
#pragma unroll
    for (int k = 0; k < NN; ++k) acc[k] = warpSum(acc[k]);

    if constexpr (CPLX) {
#pragma unroll
        for (int k = 0; k < NN; ++k) acci[k] = warpSum(acci[k]);
        const long long* dr = dofRows + pair * NPSI;
#pragma unroll
        for (int k = 0; k < NN; ++k) {
            if ((k & 31) != lane) continue;
            const long long r = dr[k / NPSI], c = dr[k % NPSI];
            long long at = -1;
            if (TARGET == DENSE) {
                if (r >= 0 && c >= 0 && ((emask >> k) & 1)) at = r * N + c;
            } else if (r >= 0 && r == c) {
                at = r;
            }
            if (at >= 0) {
                atomicAdd(out + 2 * at, acc[k]);
                atomicAdd(out + 2 * at + 1, acci[k]);
            }
        }
        return;
    }
    if constexpr (TARGET == TREE) {
        long long dr[NPSI];
#pragma unroll
        for (int i = 0; i < NPSI; ++i) dr[i] = dofRows[pair * NPSI + i];
        treeScatter<NPSI>(out, N, tt, dr, I[pair], J[pair], offF[pair],
                          offB[pair], acc, lane);
        return;
    }
#pragma unroll
    for (int k = 0; k < NN; ++k) {
        if ((k & 31) != lane) continue;
        if (TARGET == DENSE) {
            const long long* dr = dofRows + pair * NPSI;
            const long long r = dr[k / NPSI], c = dr[k % NPSI];
            if (r >= 0 && c >= 0 && ((emask >> k) & 1))
                atomicAdd(out + r * N + c, static_cast<TO>(acc[k]));
        } else if (TARGET == CROSS) {
            const long long* dr = dofRows + pair * NPSI;
            const long long r = dr[k / NPSI], c = dr[k % NPSI];
            if (r >= 0 && c < 0 && c > DROP_HALF)
                atomicAdd(out + r * N - c - 1, static_cast<TO>(acc[k]));
        } else if (TARGET == DIAG) {
            const long long* dr = dofRows + pair * NPSI;
            const long long r = dr[k / NPSI];
            if (r >= 0 && r == dr[k % NPSI])
                atomicAdd(out + r, static_cast<TO>(acc[k]));
        } else {
            const long long s = slots[pair * NN + k];
            if (s >= 0 && s < N) atomicAdd(out + s, static_cast<TO>(acc[k]));
        }
    }
}

template <int TARGET, bool POS = false>
static int launchPanel(double* out, long long N, const double* vertices,
                       int dim, const long long* vi1, int nv1,
                       const long long* vi2, int nv2,
                       const long long* dofRows, const int* slots, int nPSI,
                       const double* volsym, const double* normals,
                       long long P, const int* I, const int* J,
                       const int* offF, const int* offB, TreeTables tt,
                       const double* bary_x, const double* bary_y,
                       const double* w, const double* PSIP, int Q, Profile pf,
                       Inter in, Order od, const double* yShift,
                       long long emask, cudaStream_t stream) {
    if (P <= 0) return 0;
    if (dim > MAXDIM || nv1 > MAXNV || nv2 > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = (P + (threads / 32) - 1) / (threads / 32);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(NP)                                                          \
    panel_scatter_kernel<NP, TARGET, PC, OC><<<(unsigned)blocks, threads, 0, \
                                               stream>>>(                    \
        out, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, slots, volsym,  \
        normals, P, I, J, offF, offB, tt, bary_x, bary_y, w, PSIP, Q, pf,  \
        in, od, yShift, emask)
#define NPSI_SWITCH                                                    \
    switch (nPSI) {                                                     \
        case 2: LAUNCH(2); break;                                       \
        case 3: LAUNCH(3); break;                                       \
        case 4: LAUNCH(4); break;                                       \
        case 6: LAUNCH(6); break;                                       \
        default: return static_cast<int>(cudaErrorInvalidValue);       \
    }
    if constexpr (POS && TARGET == DENSE) {
        // the orders of position and the component order
        POSITION_ORDER_SWITCH(pf.code, od.code, NPSI_SWITCH)
    } else if constexpr (POS) {
        // their H2 orders on the interval: the near field's CSR targets
        static_assert(TARGET == SLOTS || TARGET == TREE,
                      "the orders of position: DENSE, SLOTS, TREE");
        H2_ORDER_SWITCH(pf.code, od.code, switch (nPSI) {
            case 2: LAUNCH(2); break;
            case 4: LAUNCH(4); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        })
    } else if (pf.code == PROFILE_GREENS_2D) {
        // the complex profile (out the float64 view of a complex128
        // target): dense A or the diagonal, triangles (nPSI 3 for an
        // identical cell, else 6), no order, no normals, no shift
        if constexpr (TARGET == DENSE || TARGET == DIAG) {
            if (od.code != ORDER_NONE || normals != nullptr
                || yShift != nullptr)
                return static_cast<int>(cudaErrorInvalidValue);
            constexpr int PC = PROFILE_GREENS_2D, OC = ORDER_NONE;
            switch (nPSI) {
                case 3: LAUNCH(3); break;
                case 6: LAUNCH(6); break;
                default: return static_cast<int>(cudaErrorInvalidValue);
            }
        } else {
            return static_cast<int>(cudaErrorInvalidValue);
        }
    } else if constexpr (TARGET == DIAG) {
        // the diagonal of a radial profile: no variable order instances
        if (od.code != ORDER_NONE)
            return static_cast<int>(cudaErrorInvalidValue);
        constexpr int OC = ORDER_NONE;
        PROFILE_SWITCH(pf.code, NPSI_SWITCH)
    } else {
        KERNEL_SWITCH(pf.code, od.code, NPSI_SWITCH)
    }
#undef NPSI_SWITCH
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// The DENSE target with an order of position or the component order:
// launchPanel<DENSE, true>, instantiated in panel_scatter_order.cu; the
// dense entry point (panel_scatter.cu) calls it for the codes from
// ORDER_INNER_OUTER on.
int launchPanelPosition(double* A, long long N, const double* vertices,
                        int dim, const long long* vi1, int nv1,
                        const long long* vi2, int nv2,
                        const long long* dofRows, int nPSI,
                        const double* volsym, const double* normals,
                        long long P, const double* bary_x,
                        const double* bary_y, const double* w,
                        const double* PSIP, int Q, Profile pf, Inter in,
                        Order od, const double* yShift, long long emask,
                        cudaStream_t stream);

// The SLOTS and TREE targets with the orders of H2_ORDER_SWITCH:
// launchPanel<SLOTS or TREE, true>, instantiated in
// panel_scatter_order_h2.cu; the CSR entry points (panel_scatter_csr.cu)
// call it for the codes from ORDER_INNER_OUTER on, ``slots`` null for the
// tree target.
int launchPanelH2Position(double* data, long long nnz,
                          const double* vertices, int dim,
                          const long long* vi1, int nv1,
                          const long long* vi2, int nv2,
                          const long long* dofRows, const int* slots,
                          int nPSI, const double* volsym,
                          const double* normals, long long P, const int* I,
                          const int* J, const int* offF, const int* offB,
                          TreeTables tt, const double* bary_x,
                          const double* bary_y, const double* w,
                          const double* PSIP, int Q, Profile pf, Order od,
                          const double* yShift, cudaStream_t stream);
