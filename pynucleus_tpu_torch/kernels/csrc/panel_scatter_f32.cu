// K1 panel_scatter (panel_scatter.cuh): its float32 instances, the DENSE
// target of the float32 dense path, in a source of their own so that nvcc
// compiles them beside the others.  Replaces, with params={'dtype':
// float32}, pynucleus_tpu/nl/assembly.py:_bucket_contrib +
// _device_scatter_rows (explicit pairs), _bucket_natural_scatter_scan
// and _bucket_natural_scatter (natural-order buckets, gathered on the
// device by the caller) and _bucket_rows_scatter_scan (the zero-exterior
// rows, with normals in 2D): the constant-order fractional kernel and its
// boundary kernel (the power profile), no order, indicator, y shift or
// entry mask.  Every value is a float: the nodes summed with __fmaf_rn,
// gamma = C r2^e by powf (common.cuh radial<PC, float>), each local entry
// added with one atomicAdd(float).

#include "panel_scatter.cuh"

template <int NP>
static void launchF32(float* A, long long N, const float* vertices, int dim,
                      const long long* vi1, int nv1, const long long* vi2,
                      int nv2, const long long* dofRows,
                      const float* volsym, const float* normals, long long P,
                      const float* bary_x, const float* bary_y,
                      const float* w, const float* PSIP, int Q, Profile pf,
                      unsigned blocks, int threads, cudaStream_t stream) {
    panel_scatter_kernel<NP, DENSE, PROFILE_POWER, ORDER_NONE, float>
        <<<blocks, threads, 0, stream>>>(
            A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nullptr,
            volsym, normals, P, nullptr, nullptr, nullptr, nullptr,
            TreeTables{}, bary_x, bary_y, w, PSIP, Q, pf, Inter{}, Order{},
            nullptr, -1LL);
}

// A: dense float32 [N, N]; the profile the power code with no tempering
// and no two-point weight (pcode, C, e already rounded to float32 on the
// host); any other profile returns cudaErrorInvalidValue.
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
        launchF32<NP>(A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows,    \
                      volsym, normals, P, bary_x, bary_y, w, PSIP, Q, pf,  \
                      (unsigned)blocks, threads, stream);                  \
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
