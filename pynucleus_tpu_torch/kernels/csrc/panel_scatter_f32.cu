// K1 panel_scatter (panel_scatter.cuh): its float32 instances of the
// power profile (the constant-order fractional kernel with its tempering
// and its smooth two-point weight, its boundary kernel, the indicator,
// peridynamic and monomial kernels) and the float32 entry points; the
// other profiles' instances are in panel_scatter_f32_profiles.cu and
// panel_scatter_f32_wide.cu (launchF32Smooth), in sources of their own so
// that nvcc compiles them beside the others.  No order or y shift.  Every
// value is a float: the nodes summed with __fmaf_rn, gamma by common.cuh
// radial<PC, float>, each local entry added with one atomicAdd (float, or
// double into a float64 target).  Seven targets:
//   DENSE (panel_scatter_f32) replaces, with params={'dtype': float32},
//         pynucleus_tpu/nl/assembly.py:_bucket_contrib +
//         _device_scatter_rows (explicit pairs), _bucket_natural_scatter_scan
//         and _bucket_natural_scatter (natural-order buckets, gathered on
//         the device by the caller) and _bucket_rows_scatter_scan (the
//         zero-exterior rows, with normals in 2D): the float32 dense path,
//         with the indicator of a finite horizon the runs of
//         _bucket_contrib into the float32 DenseAccumulator of getDense
//         (:2609-2610);
//   SLOTS (panel_scatter_slots_f32) replaces _bucket_masked_csr_scan and
//         the host adds of _bucket_contrib's touching-pair matrices
//         (DeviceCSRAccumulator.add) in float32: the singular panels of the
//         float32 H2 near field at explicit slots (the power profile);
//   TREE  (panel_scatter_tree_f32) replaces _bucket_surface_tree_scan in
//         float32: the union surfaces at arithmetic tree slots (normals in
//         2D; the power profile);
//   SLOTS into float64 data (panel_scatter_slots_f32d), with the
//         interaction indicator of a finite horizon, replaces
//         _bucket_masked_csr_scan / _bucket_contrib with jaxIndicator in
//         float32 into CSRAccumulator (:1033, getSparse): the identical,
//         touching and distant pairs of the float32 sparse operator, their
//         float32 local entries summed in float64 (the caller casts the
//         sum to float32 once); on the float32 H2 path the touching panels
//         of the near field into the float64 shadow of the JAX package's
//         DeviceCSRAccumulator.add (:1665, cast once at result, :1691);
//   DIAG  (panel_scatter_diag_f32) replaces the runs of _bucket_contrib in
//         float32 into _DiagAccumulator (:926, getDiagonal): float32 local
//         entries added into a float64 diagonal, with the indicator of a
//         finite horizon, or the zero-exterior term's pairs (normals in
//         2D);
//   CROSS into float64 (panel_scatter_cross_f32) replaces the runs of
//         _bucket_contrib in float32 into BCAccumulator (:1011,
//         getDenseCross): float32 local entries with the indicator added
//         into the float64 A_BC [N, NB];
//   DENSE into float64 (panel_scatter_f32d) replaces the runs of
//         _bucket_contrib in float32 with ball2Complement.jaxIndicator and
//         the block entryMask into the float64 DenseAccumulator(N) of
//         _getComplementCross (:4076-4135, H2corrected's cross operator).

#include "panel_scatter.cuh"

// One launch of K1's float32 instance of TARGET into a target of type TO:
// the power profile here, every other code through launchF32Smooth.
template <int TARGET, typename TO = float>
static int launchF32(TO* out, const F32Launch& a, cudaStream_t stream) {
    if (a.pf.code == PROFILE_POWER)
        return launchF32At<TARGET, PROFILE_POWER, TO>(out, a, stream);
    return launchF32Smooth<TARGET, TO>(out, a, stream);
}

// The H2 path's float32 instances: the power profile without a tempering
// or a two-point weight (its constants rounded to float32 on the host).
static bool h2Profile(int pcode, double tl, int wcode) {
    return pcode == PROFILE_POWER && tl == 0.0 && wcode == TWO_POINT_NONE;
}

// The interaction indicator (code 0 none, 1 ball2, 2 ballInf, 3 ball1, 4
// the ellipse with T, 5 the complement of ball2; common.cuh Inter).
#define INTER_PARAMS                                                     \
    int icode, double h2, double t00, double t01, double t10, double t11
#define INTER_OF() Inter{icode, h2, t00, t01, t10, t11}

// The arguments shared by the entry points up to the profile.
#define F32_HEAD(out)                                                     \
    out, long long N, const float* vertices, int dim,                     \
        const long long* vi1, int nv1, const long long* vi2, int nv2
#define F32_TABLES                                                        \
    const float *bary_x, const float *bary_y, const float *w,             \
        const float *PSIP, int Q

// F32Launch of a dof-indexed target (dense, cross, diagonal).
static F32Launch dofLaunch(long long N, const float* vertices, int dim,
                           const long long* vi1, int nv1,
                           const long long* vi2, int nv2,
                           const long long* dofRows, int nPSI,
                           const float* volsym, const float* normals,
                           long long P, const float* bary_x,
                           const float* bary_y, const float* w,
                           const float* PSIP, int Q, Profile pf, Inter in,
                           long long emask) {
    return F32Launch{N, vertices, dim, vi1, nv1, vi2, nv2, dofRows,
                     nullptr, nPSI, volsym, normals, P, nullptr, nullptr,
                     nullptr, nullptr, TreeTables{}, bary_x, bary_y, w,
                     PSIP, Q, pf, in, emask};
}

// A: dense float32 [N, N]; the indicator of a finite horizon (or code 0).
EXPORT int panel_scatter_f32(F32_HEAD(float* A), const long long* dofRows,
                             int nPSI, const float* volsym,
                             const float* normals, long long P, F32_TABLES,
                             PROFILE_PARAMS, INTER_PARAMS,
                             cudaStream_t stream) {
    if (icode < 0 || icode > 4) return static_cast<int>(cudaErrorInvalidValue);
    return launchF32<DENSE>(
        A, dofLaunch(N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI,
                     volsym, normals, P, bary_x, bary_y, w, PSIP, Q,
                     PROFILE_OF(C), INTER_OF(), -1LL),
        stream);
}

// A: dense float64 [N, N]; the float32 local entries of the complement
// kernel (code 5; the power profile) with the launch-wide entry mask emask
// (bit I*nPSI+J keeps local entry (I, J)) added in float64.
EXPORT int panel_scatter_f32d(F32_HEAD(double* A), const long long* dofRows,
                              int nPSI, const float* volsym,
                              const float* normals, long long P, F32_TABLES,
                              PROFILE_PARAMS, INTER_PARAMS, long long emask,
                              cudaStream_t stream) {
    if (icode != 5 || pcode != PROFILE_POWER)
        return static_cast<int>(cudaErrorInvalidValue);
    return launchF32At<DENSE, PROFILE_POWER, double>(
        A, dofLaunch(N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI,
                     volsym, normals, P, bary_x, bary_y, w, PSIP, Q,
                     PROFILE_OF(C), INTER_OF(), emask),
        stream);
}

// A: float64 A_BC [N, NB] (N the column count NB); the float32 local
// entries with the indicator of a finite horizon added in float64.
EXPORT int panel_scatter_cross_f32(F32_HEAD(double* A),
                                   const long long* dofRows, int nPSI,
                                   const float* volsym, const float* normals,
                                   long long P, F32_TABLES, PROFILE_PARAMS,
                                   INTER_PARAMS, cudaStream_t stream) {
    if (icode < 1 || icode > 4) return static_cast<int>(cudaErrorInvalidValue);
    return launchF32<CROSS, double>(
        A, dofLaunch(N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI,
                     volsym, normals, P, bary_x, bary_y, w, PSIP, Q,
                     PROFILE_OF(C), INTER_OF(), -1LL),
        stream);
}

// data: float32 CSR data [nnz+1]; slots [P, nPSI^2] int32.
EXPORT int panel_scatter_slots_f32(F32_HEAD(float* data), const int* slots,
                                   int nPSI, const float* volsym,
                                   const float* normals, long long P,
                                   F32_TABLES, PROFILE_PARAMS,
                                   cudaStream_t stream) {
    if (!h2Profile(pcode, tl, wcode))
        return static_cast<int>(cudaErrorInvalidValue);
    return launchF32At<SLOTS, PROFILE_POWER, float>(
        data, F32Launch{N, vertices, dim, vi1, nv1, vi2, nv2, nullptr, slots,
                        nPSI, volsym, normals, P, nullptr, nullptr, nullptr,
                        nullptr, TreeTables{}, bary_x, bary_y, w, PSIP, Q,
                        PROFILE_OF(C), Inter{}, -1LL},
        stream);
}

// data: float32 tree-ordered CSR data [nnz+1]; the tree tables int32.
EXPORT int panel_scatter_tree_f32(F32_HEAD(float* data),
                                  const long long* dofRows, int nPSI,
                                  const float* volsym, const float* normals,
                                  long long P, const int* I, const int* J,
                                  const int* offF, const int* offB,
                                  const int* dofNode, const int* treePos,
                                  const int* indptrT, const int* tStart,
                                  F32_TABLES, PROFILE_PARAMS,
                                  cudaStream_t stream) {
    if (!h2Profile(pcode, tl, wcode))
        return static_cast<int>(cudaErrorInvalidValue);
    return launchF32At<TREE, PROFILE_POWER, float>(
        data, F32Launch{N, vertices, dim, vi1, nv1, vi2, nv2, dofRows,
                        nullptr, nPSI, volsym, normals, P, I, J, offF, offB,
                        TreeTables{dofNode, treePos, indptrT, tStart},
                        bary_x, bary_y, w, PSIP, Q, PROFILE_OF(C), Inter{},
                        -1LL},
        stream);
}

// data: float64 CSR data [nnz+1]; slots [P, nPSI^2] int32; the float32
// local entries (with the indicator) added in float64.
EXPORT int panel_scatter_slots_f32d(F32_HEAD(double* data), const int* slots,
                                    int nPSI, const float* volsym,
                                    const float* normals, long long P,
                                    F32_TABLES, PROFILE_PARAMS, INTER_PARAMS,
                                    cudaStream_t stream) {
    if (icode < 0 || icode > 4) return static_cast<int>(cudaErrorInvalidValue);
    return launchF32<SLOTS, double>(
        data, F32Launch{N, vertices, dim, vi1, nv1, vi2, nv2, nullptr, slots,
                        nPSI, volsym, normals, P, nullptr, nullptr, nullptr,
                        nullptr, TreeTables{}, bary_x, bary_y, w, PSIP, Q,
                        PROFILE_OF(C), INTER_OF(), -1LL},
        stream);
}

// d: the float64 diagonal [N]; dofRows [P, nPSI] int64; the float32 local
// entries of equal row and column dofs (with the indicator, or normals of
// the 2D zero-exterior rows) added in float64.
EXPORT int panel_scatter_diag_f32(F32_HEAD(double* d),
                                  const long long* dofRows, int nPSI,
                                  const float* volsym, const float* normals,
                                  long long P, F32_TABLES, PROFILE_PARAMS,
                                  INTER_PARAMS, cudaStream_t stream) {
    if (icode < 0 || icode > 4) return static_cast<int>(cudaErrorInvalidValue);
    return launchF32<DIAG, double>(
        d, dofLaunch(N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI,
                     volsym, normals, P, bary_x, bary_y, w, PSIP, Q,
                     PROFILE_OF(C), INTER_OF(), -1LL),
        stream);
}
