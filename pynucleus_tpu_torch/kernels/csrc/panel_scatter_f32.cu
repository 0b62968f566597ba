// K1 panel_scatter (panel_scatter.cuh): its float32 instances, in a source
// of their own so that nvcc compiles them beside the others.  The
// constant-order fractional kernel and its boundary kernel (the power
// profile), no order, indicator, y shift or entry mask.  Every value is a
// float: the nodes summed with __fmaf_rn, gamma = C r2^e by powf
// (common.cuh radial<PC, float>), each local entry added with one
// atomicAdd(float).  Three targets:
//   DENSE (panel_scatter_f32) replaces, with params={'dtype': float32},
//         pynucleus_tpu/nl/assembly.py:_bucket_contrib +
//         _device_scatter_rows (explicit pairs), _bucket_natural_scatter_scan
//         and _bucket_natural_scatter (natural-order buckets, gathered on
//         the device by the caller) and _bucket_rows_scatter_scan (the
//         zero-exterior rows, with normals in 2D): the float32 dense path;
//   SLOTS (panel_scatter_slots_f32) replaces _bucket_masked_csr_scan and
//         the host adds of _bucket_contrib's touching-pair matrices
//         (DeviceCSRAccumulator.add) in float32: the singular panels of the
//         float32 H2 near field at explicit slots;
//   TREE  (panel_scatter_tree_f32) replaces _bucket_surface_tree_scan in
//         float32: the union surfaces at arithmetic tree slots (normals in
//         2D).

#include "panel_scatter.cuh"

// One launch of K1's float32 instance of TARGET; the profile the power
// code with no tempering and no two-point weight (pcode, C, e already
// rounded to float32 on the host); any other profile returns
// cudaErrorInvalidValue.
template <int TARGET>
static int launchF32(float* out, long long N, const float* vertices,
                     int dim, const long long* vi1, int nv1,
                     const long long* vi2, int nv2, const long long* dofRows,
                     const int* slots, int nPSI, const float* volsym,
                     const float* normals, long long P, const int* I,
                     const int* J, const int* offF, const int* offB,
                     TreeTables tt, const float* bary_x, const float* bary_y,
                     const float* w, const float* PSIP, int Q, int pcode,
                     double C, double e, double tl, int wcode,
                     cudaStream_t stream) {
    if (P <= 0) return 0;
    if (pcode != PROFILE_POWER || tl != 0.0 || wcode != TWO_POINT_NONE
        || dim > MAXDIM || nv1 > MAXNV || nv2 > MAXNV)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = (P + (threads / 32) - 1) / (threads / 32);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const Profile pf{PROFILE_POWER, C, e, 0.0, 0.0, 0.0, 0.0,
                     TWO_POINT_NONE, 0.0};
#define F32_CASE(NP)                                                       \
    case NP:                                                               \
        panel_scatter_kernel<NP, TARGET, PROFILE_POWER, ORDER_NONE, float> \
            <<<(unsigned)blocks, threads, 0, stream>>>(                    \
                out, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, slots, \
                volsym, normals, P, I, J, offF, offB, tt, bary_x, bary_y,  \
                w, PSIP, Q, pf, Inter{}, Order{}, nullptr, -1LL);          \
        break;
    switch (nPSI) {
        F32_CASE(2)
        F32_CASE(3)
        F32_CASE(4)
        F32_CASE(6)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef F32_CASE
    return static_cast<int>(cudaGetLastError());
}

// A: dense float32 [N, N].
EXPORT int panel_scatter_f32(float* A, long long N, const float* vertices,
                             int dim, const long long* vi1, int nv1,
                             const long long* vi2, int nv2,
                             const long long* dofRows, int nPSI,
                             const float* volsym, const float* normals,
                             long long P, const float* bary_x,
                             const float* bary_y, const float* w,
                             const float* PSIP, int Q, int pcode, double C,
                             double e, double tl, int wcode,
                             cudaStream_t stream) {
    return launchF32<DENSE>(A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows,
                            nullptr, nPSI, volsym, normals, P, nullptr,
                            nullptr, nullptr, nullptr, TreeTables{}, bary_x,
                            bary_y, w, PSIP, Q, pcode, C, e, tl, wcode,
                            stream);
}

// data: float32 CSR data [nnz+1]; slots [P, nPSI^2] int32.
EXPORT int panel_scatter_slots_f32(float* data, long long nnz,
                                   const float* vertices, int dim,
                                   const long long* vi1, int nv1,
                                   const long long* vi2, int nv2,
                                   const int* slots, int nPSI,
                                   const float* volsym, const float* normals,
                                   long long P, const float* bary_x,
                                   const float* bary_y, const float* w,
                                   const float* PSIP, int Q, int pcode,
                                   double C, double e, double tl, int wcode,
                                   cudaStream_t stream) {
    return launchF32<SLOTS>(data, nnz, vertices, dim, vi1, nv1, vi2, nv2,
                            nullptr, slots, nPSI, volsym, normals, P, nullptr,
                            nullptr, nullptr, nullptr, TreeTables{}, bary_x,
                            bary_y, w, PSIP, Q, pcode, C, e, tl, wcode,
                            stream);
}

// data: float32 tree-ordered CSR data [nnz+1]; the tree tables int32.
EXPORT int panel_scatter_tree_f32(float* data, long long nnz,
                                  const float* vertices, int dim,
                                  const long long* vi1, int nv1,
                                  const long long* vi2, int nv2,
                                  const long long* dofRows, int nPSI,
                                  const float* volsym, const float* normals,
                                  long long P, const int* I, const int* J,
                                  const int* offF, const int* offB,
                                  const int* dofNode, const int* treePos,
                                  const int* indptrT, const int* tStart,
                                  const float* bary_x, const float* bary_y,
                                  const float* w, const float* PSIP, int Q,
                                  int pcode, double C, double e, double tl,
                                  int wcode, cudaStream_t stream) {
    return launchF32<TREE>(data, nnz, vertices, dim, vi1, nv1, vi2, nv2,
                           dofRows, nullptr, nPSI, volsym, normals, P, I, J,
                           offF, offB,
                           TreeTables{dofNode, treePos, indptrT, tStart},
                           bary_x, bary_y, w, PSIP, Q, pcode, C, e, tl,
                           wcode, stream);
}
