// Shared device helpers of the port's CUDA kernels (sm_90a, float64).
#pragma once

#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

#define FULL_MASK 0xffffffffu

// gamma(r2) = C * r2^e for the constant-order fractional kernel and its
// boundary kernel; exactly 0 at r2 == 0 (coincident points of the singular
// rules), as pynucleus_tpu/nl/assembly.py:_radial_eval.  K1, K6 and K7
// share it.
__device__ __forceinline__ double radial(double r2, double C, double e) {
    return r2 > 0.0 ? C * pow(r2, e) : 0.0;
}

__device__ __forceinline__ double warpSum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

// Largest dimension and simplex vertex count the kernels take (triangles
// in 2D; tetrahedra would need 4).
constexpr int MAXDIM = 3;
constexpr int MAXNV = 3;

// v[a][d] = vertices[vid[a], d] for the nv vertex ids of one simplex.
__device__ __forceinline__ void loadSimplex(double v[MAXNV][MAXDIM],
                                            const double* __restrict__ vertices,
                                            const long long* vid, int nv,
                                            int dim) {
    for (int a = 0; a < nv; ++a)
        for (int d = 0; d < dim; ++d) v[a][d] = vertices[vid[a] * dim + d];
}

// K1's quadrature body, shared by its three scatter targets and by K6:
// lanes lane, lane+nl, ... of the pair's Q nodes accumulate
//   x_q = sum_v bary_x[v,q] v1[v],  y_q = sum_v bary_y[v,q] v2[v]
//   t_q = gamma(|x_q-y_q|^2) w_q (* n.(y_q-x_q)/|y_q-x_q|) volsym
//   acc[k] += t_q PSIP[q, k]
// (acc zeroed here); the caller reduces across its nl lanes.
template <int NN>
__device__ __forceinline__ void panelQuad(
    double acc[NN], double v1[MAXNV][MAXDIM], int nv1,
    double v2[MAXNV][MAXDIM], int nv2, int dim,
    const double* nrm /* [dim] or nullptr */, double vs,
    const double* __restrict__ bary_x, const double* __restrict__ bary_y,
    const double* __restrict__ w, const double* __restrict__ PSIP, int Q,
    double C, double e, int lane, int nl) {
#pragma unroll
    for (int k = 0; k < NN; ++k) acc[k] = 0.0;
    for (int q = lane; q < Q; q += nl) {
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
        if (nrm != nullptr) {
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
}

// Tables of the tree-ordered near-field CSR (int32: nnz < 2^31).
struct TreeTables {
    const int* dofNode;   // [N]      cluster node id of each dof
    const int* treePos;   // [N]      tree position of each dof
    const int* indptrT;   // [Nt+1]   row pointer in tree order
    const int* tStart;    // [nodes]  first tree position of each node
};

// Arithmetic tree slot of local entry (a, b) of a pair owned by cluster
// pair (I, J) (pynucleus_tpu/nl/assembly.py:1598-1612):
//   a in I, b in J:  indptrT[tree(a)] + offF + tree(b) - tStart[J]
//   a in J, b in I:  indptrT[tree(a)] + offB + tree(b) - tStart[I]
//   otherwise (or a negative dof): -1
__device__ __forceinline__ long long treeSlot(const TreeTables& tt,
                                              long long a, long long b, int I,
                                              int J, int offF, int offB) {
    if (a < 0 || b < 0) return -1;
    const int na = tt.dofNode[a], nb = tt.dofNode[b];
    const bool fwd = na == I && nb == J;
    if (!fwd && !(na == J && nb == I)) return -1;
    const long long row = tt.indptrT[tt.treePos[a]];
    const long long col = tt.treePos[b];
    return fwd ? row + offF + col - tt.tStart[J]
               : row + offB + col - tt.tStart[I];
}

// Adds the warp-reduced entries acc[k] (k = i*NPSI+j, every lane holding
// the full sum) at the tree slots of (dr[i], dr[j]); lane k % 32 adds
// entry k.  Slots outside [0, nnz) are skipped.
template <int NPSI>
__device__ __forceinline__ void treeScatter(double* __restrict__ data,
                                            long long nnz, const TreeTables& tt,
                                            const long long dr[NPSI], int I,
                                            int J, int offF, int offB,
                                            const double acc[NPSI * NPSI],
                                            int lane) {
#pragma unroll
    for (int k = 0; k < NPSI * NPSI; ++k) {
        if ((k & 31) == lane) {
            const long long s = treeSlot(tt, dr[k / NPSI], dr[k % NPSI], I, J,
                                         offF, offB);
            if (s >= 0 && s < nnz) atomicAdd(data + s, acc[k]);
        }
    }
}
