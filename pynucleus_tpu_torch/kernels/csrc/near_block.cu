// K11 block_near_count and K12 block_near_quad: the block engine of the H2
// near field's distant cell pairs (the default engine, as in the JAX
// package).
//
// Each near cluster pair p = (I, J), I <= J, is the dense n1 x n2 grid of
// its cell lists: a = ncArr[offI + i], b = ncArr[offJ + j].  An element
// (a, b) is quadrature work iff nearValid, and its order is orderKey (both
// in common.cuh, shared with K5).
//
// K11 replaces pynucleus_tpu/nl/assembly.py:_block_mask_order +
// _block_near_count.  One CTA per cluster pair; its threads stride over
// the n1 x n2 grid and count the valid elements of each class (orders 2, 4,
// 6, 8 and "> 8") into shared memory; one int32 row of 5 counts per pair.
// Bound on the card: the gathers (ncArr, cells, cellNodes, centers, logh)
// per element; a pair's rows and columns are read n2 and n1 times, which
// the caches serve.
//
// K12 replaces _block_near_quad.  One CTA per cluster pair that holds
// low-order elements; its warps stride over the pair's elements.  A warp
// takes each valid element whose order is in the requested set (orders 2-8,
// one rule table each): K1's quadrature body (common.cuh panelQuad) over
// that order's distant rule with volsym 2 vol(a) vol(b), the same compact
// product rule that _block_near_quad tensorises; then the entries whose row
// dof lies in I and column dof in J go into the pair's [tLen(I), tLen(J)]
// block in shared memory (shared-memory atomics), float64, or float32 in the
// float32 instance (block_near_quad_f32: the power profile, every value a
// float, _block_near_quad on the float32 H2 path's data).  At the end the
// CTA adds the block to the tree-ordered CSR data at baseF + i LI + j and,
// for I != J, its transpose at baseB + j LJ + i (for I == J the block holds
// the whole symmetric local matrix).  Each unordered pair is one CTA, so
// the CTA owns its two blocks within the launch: the final add is plain,
// deterministic and needs no global atomics.  The TPU's one-hot placement
// einsums, size buckets and pair chunks are not carried over.  Bound: a
// float64 pow (or the kernel's exp or erfc) per node and the (2 dpe)^2
// FMAs per node, as K1.  Segments (1D, nv = dpe = 2) and triangles (2D,
// nv = dpe = 3) take the same code.

#include "common.cuh"

// Per cluster pair descriptors (int32 [nP] each).
struct BlockPairs {
    const int* offI;   // start of I's cell list in ncArr
    const int* offJ;
    const int* n1;     // cells of I
    const int* n2;     // cells of J
    const int* I;      // cluster node ids
    const int* J;
    const int* tSI;    // first tree position of I
    const int* tSJ;
    const int* baseF;  // slot of block entry (0, 0) of (I, J)
    const int* baseB;  // slot of entry (0, 0) of the transpose block (J, I)
    const int* LI;     // row length of I's rows
    const int* LJ;
    const int* nI;     // dofs of I (block rows)
    const int* nJ;     // dofs of J (block columns)
};

__global__ void __launch_bounds__(256)
block_near_count_kernel(int* __restrict__ counts, BlockPairs bp,
                        EnumTables et) {
    __shared__ int sh[5];
    if (threadIdx.x < 5) sh[threadIdx.x] = 0;
    __syncthreads();
    const int p = blockIdx.x;
    const int offI = bp.offI[p], offJ = bp.offJ[p], I = bp.I[p], J = bp.J[p];
    const int n2 = bp.n2[p];
    const long long nEl = (long long)bp.n1[p] * n2;
    int cnt[5] = {0, 0, 0, 0, 0};
    for (long long el = threadIdx.x; el < nEl; el += blockDim.x) {
        const int a = et.ncArr[offI + (int)(el / n2)];
        const int b = et.ncArr[offJ + (int)(el % n2)];
        if (!nearValid(et.cells, et.nv, et.cellNodes, et.dpe, a, b, I, J))
            continue;
        const int o = orderKey(et.centers, et.dim, et.C, et.logh, a, b, et.s,
                               et.c, et.lH0);
        ++cnt[o <= 8 ? o / 2 - 1 : 4];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k)
        if (cnt[k]) atomicAdd(&sh[k], cnt[k]);
    __syncthreads();
    if (threadIdx.x < 5) counts[p * 5 + threadIdx.x] = sh[threadIdx.x];
}

EXPORT int block_near_count(int* counts, int nP, const int* offI,
                            const int* offJ, const int* n1, const int* n2,
                            const int* I, const int* J, const int* ncArr,
                            const int* cells, int nv, const int* cellNodes,
                            int dpe, const float* centers, int dimC, int C,
                            const float* logh, float s, float c, float lH0,
                            cudaStream_t stream) {
    if (nP <= 0) return 0;
    const BlockPairs bp{offI, offJ, n1, n2, I, J, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, nullptr};
    const EnumTables et{ncArr, cells, nv, cellNodes, dpe, centers, dimC, C,
                        logh, s, c, lH0};
    block_near_count_kernel<<<nP, 256, 0, stream>>>(counts, bp, et);
    return static_cast<int>(cudaGetLastError());
}

// The rules of orders 2, 4, 6 and 8 (class k = order / 2 - 1) in one
// table of the data's type: class k's bary_x [nv, Q], bary_y [nv, Q], w
// [Q] and PSIP [Q, (2 dpe)^2] lie one after the other from rules + off[k];
// Q[k] == 0 where the order is not to run.
struct RuleSet {
    int Q[4];
    long long off[4];
};

// T is the data's type: float64, or float32 for the float32 instance
// (the block in shared memory, the rules, vertices, volumes and the
// quadrature body in float32, as _block_near_quad on float32 data).
template <int NPSI, int PC, typename T>
__global__ void __launch_bounds__(256)
block_near_quad_kernel(T* __restrict__ data, BlockPairs bp,
                       EnumTables et, const T* __restrict__ vertices,
                       int dim, const T* __restrict__ vols,
                       const long long* __restrict__ dofs,
                       const int* __restrict__ treePos,
                       const T* __restrict__ rules, RuleSet rs,
                       Profile pf) {
    constexpr int DPE = NPSI / 2;
    constexpr int NN = NPSI * NPSI;
    extern __shared__ __align__(16) unsigned char blkBytes[];
    T* blk = reinterpret_cast<T*>(blkBytes);
    const int p = blockIdx.x;
    const int nI = bp.nI[p], nJ = bp.nJ[p];
    for (int k = threadIdx.x; k < nI * nJ; k += blockDim.x) blk[k] = T(0);
    __syncthreads();
    const int offI = bp.offI[p], offJ = bp.offJ[p], I = bp.I[p], J = bp.J[p];
    const int tSI = bp.tSI[p], tSJ = bp.tSJ[p];
    const int n2 = bp.n2[p];
    const long long nEl = (long long)bp.n1[p] * n2;
    const int lane = threadIdx.x & 31;
    const int nv = et.nv;
    for (long long el = threadIdx.x >> 5; el < nEl; el += blockDim.x >> 5) {
        // every lane decides alike: the branches are uniform across the warp
        const int a = et.ncArr[offI + (int)(el / n2)];
        const int b = et.ncArr[offJ + (int)(el % n2)];
        if (!nearValid(et.cells, nv, et.cellNodes, DPE, a, b, I, J)) continue;
        const int o = orderKey(et.centers, et.dim, et.C, et.logh, a, b, et.s,
                               et.c, et.lH0);
        if (o > 8) continue;
        const int Q = rs.Q[o / 2 - 1];
        if (Q == 0) continue;
        const T* bx = rules + rs.off[o / 2 - 1];
        const T* by = bx + nv * Q;
        const T* w = by + nv * Q;
        const T* PSIP = w + Q;
        T v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM];
        loadSimplex(v1, vertices, et.cells + a * nv, nv, dim);
        loadSimplex(v2, vertices, et.cells + b * nv, nv, dim);
        T acc[NN];
        panelQuad<NN, PC>(acc, v1, nv, v2, nv, dim, nullptr,
                          vols[a] * vols[b] * T(2), bx, by, w, PSIP, Q, pf,
                          lane, 32);
#pragma unroll
        for (int k = 0; k < NN; ++k) acc[k] = warpSum(acc[k]);
        // block row of each local dof in I, block column in J, else -1
        int ri[NPSI], cj[NPSI];
#pragma unroll
        for (int i = 0; i < NPSI; ++i) {
            const int cell = i < DPE ? a : b;
            const int node = et.cellNodes[cell * DPE + i % DPE];
            const long long dof = dofs[(long long)cell * DPE + i % DPE];
            const int tp = dof >= 0 ? treePos[dof] : 0;
            ri[i] = dof >= 0 && node == I ? tp - tSI : -1;
            cj[i] = dof >= 0 && node == J ? tp - tSJ : -1;
        }
#pragma unroll
        for (int k = 0; k < NN; ++k) {
            if ((k & 31) == lane) {
                const int r = ri[k / NPSI], c = cj[k % NPSI];
                if (r >= 0 && c >= 0) atomicAdd(&blk[r * nJ + c], acc[k]);
            }
        }
    }
    __syncthreads();
    const long long baseF = bp.baseF[p], baseB = bp.baseB[p];
    const int LI = bp.LI[p], LJ = bp.LJ[p];
    for (int k = threadIdx.x; k < nI * nJ; k += blockDim.x) {
        const int i = k / nJ, j = k % nJ;
        const T v = blk[k];
        data[baseF + (long long)i * LI + j] += v;
        if (I != J) data[baseB + (long long)j * LJ + i] += v;
    }
}

// K12's launch of the profile PC: one CTA per pair, the largest block in
// dynamic shared memory (above the 48 KiB default only after opting in;
// 227 KiB on the H100).
template <int PC, typename T>
static int launchBlockQuad(T* data, int nP, const BlockPairs& bp,
                           const EnumTables& et, int maxBlock,
                           const T* vertices, int dim, const T* vols,
                           const long long* dofs, const int* treePos,
                           const T* rules, const RuleSet& rs,
                           const Profile& pf, int dpe, cudaStream_t stream) {
    const size_t shmem = (size_t)maxBlock * sizeof(T);
#define LAUNCH(NP)                                                          \
    {                                                                       \
        if (shmem > 48 * 1024) {                                            \
            const cudaError_t err = cudaFuncSetAttribute(                   \
                block_near_quad_kernel<NP, PC, T>,                          \
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);   \
            if (err != cudaSuccess) return static_cast<int>(err);           \
        }                                                                   \
        block_near_quad_kernel<NP, PC, T><<<nP, 256, shmem, stream>>>(      \
            data, bp, et, vertices, dim, vols, dofs, treePos, rules, rs,    \
            pf);                                                            \
    }
    switch (dpe) {
        case 2: LAUNCH(4); break;
        case 3: LAUNCH(6); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

static RuleSet ruleSet(const int* ruleQ, const long long* ruleOff) {
    RuleSet rs;
    for (int k = 0; k < 4; ++k) {
        rs.Q[k] = ruleQ[k];
        rs.off[k] = ruleOff[k];
    }
    return rs;
}

EXPORT int block_near_quad(double* data, int nP, const int* offI,
                           const int* offJ, const int* n1, const int* n2,
                           const int* I, const int* J, const int* tSI,
                           const int* tSJ, const int* baseF, const int* baseB,
                           const int* LI, const int* LJ, const int* nI,
                           const int* nJ, int maxBlock, const int* ncArr,
                           const int* cells, int nv, const int* cellNodes,
                           int dpe, const float* centers, int dimC, int C,
                           const float* logh, float s, float c, float lH0,
                           const double* vertices, int dim, const double* vols,
                           const long long* dofs, const int* treePos,
                           const double* rules, const int* ruleQ,
                           const long long* ruleOff, int pcode, double Cg,
                           double e, double a,
                           double C1, double C2,
                           double tl, int wcode, double wl,
                           cudaStream_t stream) {
    if (nP <= 0) return 0;
    if (dim > MAXDIM || nv > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const BlockPairs bp{offI, offJ, n1, n2, I, J, tSI, tSJ, baseF, baseB, LI,
                        LJ, nI, nJ};
    const EnumTables et{ncArr, cells, nv, cellNodes, dpe, centers, dimC, C,
                        logh, s, c, lH0};
    const RuleSet rs = ruleSet(ruleQ, ruleOff);
    PROFILE_SWITCH(pcode, return launchBlockQuad<PC>(
        data, nP, bp, et, maxBlock, vertices, dim, vols, dofs, treePos,
        rules, rs, PROFILE_OF(Cg), dpe, stream))
    return 0;
}

// K12's float32 instance (the float32 H2 path: _block_near_quad on
// float32 data): data, vertices, vols and the rules float32, the power
// profile (its constants rounded to float32 on the host; Cg its C), no
// tempering and no two-point weight; any other profile returns
// cudaErrorInvalidValue.
EXPORT int block_near_quad_f32(float* data, int nP, const int* offI,
                               const int* offJ, const int* n1, const int* n2,
                               const int* I, const int* J, const int* tSI,
                               const int* tSJ, const int* baseF,
                               const int* baseB, const int* LI,
                               const int* LJ, const int* nI, const int* nJ,
                               int maxBlock, const int* ncArr,
                               const int* cells, int nv, const int* cellNodes,
                               int dpe, const float* centers, int dimC, int C,
                               const float* logh, float s, float c, float lH0,
                               const float* vertices, int dim,
                               const float* vols, const long long* dofs,
                               const int* treePos, const float* rules,
                               const int* ruleQ, const long long* ruleOff,
                               int pcode, double Cg, double e, double a,
                               double C1, double C2, double tl, int wcode,
                               double wl, cudaStream_t stream) {
    if (nP <= 0) return 0;
    if (pcode != PROFILE_POWER || tl != 0.0 || wcode != TWO_POINT_NONE
        || dim > MAXDIM || nv > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const BlockPairs bp{offI, offJ, n1, n2, I, J, tSI, tSJ, baseF, baseB, LI,
                        LJ, nI, nJ};
    const EnumTables et{ncArr, cells, nv, cellNodes, dpe, centers, dimC, C,
                        logh, s, c, lH0};
    return launchBlockQuad<PROFILE_POWER>(
        data, nP, bp, et, maxBlock, vertices, dim, vols, dofs, treePos,
        rules, ruleSet(ruleQ, ruleOff),
        PROFILE_OF(Cg), dpe, stream);
}
