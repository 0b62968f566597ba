// K7 far_field: kernel blocks of the H2 far field on Chebyshev grids.
//
// Replaces pynucleus_tpu/nl/assembly.py:_farFieldBlocks:
//   K[p, a, b] = gamma(gi[p, a], gj[p, b]),  gi, gj [P, M, dim]
// with gamma the kernel's radial profile or its variable fractional order
// (kernel.jaxEval -> evalXY; common.cuh kernelXY), the same as K1's (getH2
// scales the result by -2): the orders of H2_ORDER_SWITCH (innerOuter,
// islands, layers, fe and the component order of a vector kernel's
// component, common.cuh componentTerm) in instances of their own.  One thread per entry; the M <= 64 grid points of a pair
// stay in L1/L2.  Bound on the card: the float64 pow per entry (compute);
// the output, 8 B per entry, is the only large traffic (343 MB at 17,852
// pairs of M = 49).
//
// Its float32 instance (far_field_f32: _farFieldBlocks on the float32 H2
// path's float32 grids) takes the power profile alone: r2 summed over the
// dimensions with each product and sum rounded on its own (the plain
// version's ((x - y) ** 2).sum(-1)), gamma = C r2^e by powf with C and e
// rounded to float32 on the host (common.cuh radial<PC, float>); 4 B per
// entry written.

#include "common.cuh"

template <int PC, int OC, typename T>
__global__ void __launch_bounds__(256)
far_field_kernel(T* __restrict__ K, const T* __restrict__ gi,
                 const T* __restrict__ gj, long long total, int M,
                 int dim, Profile pf, Order od) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const long long MM = (long long)M * M;
    const long long p = idx / MM;
    const int a = static_cast<int>((idx / M) % M);
    const int b = static_cast<int>(idx % M);
    const T* x = gi + (p * M + a) * dim;
    const T* y = gj + (p * M + b) * dim;
    if constexpr (IS_F32<T>) {
        float r2 = 0.0f;
        for (int d = 0; d < dim; ++d) {
            const float dd = __fsub_rn(x[d], y[d]);
            r2 = __fadd_rn(r2, __fmul_rn(dd, dd));
        }
        K[idx] = radial<PC>(r2, pf);
    } else {
        double r2 = 0.0;
        for (int d = 0; d < dim; ++d) {
            const double dd = x[d] - y[d];
            r2 += dd * dd;
        }
        K[idx] = kernelXY<PC, OC>(r2, x, y, pf, od);
    }
}

static inline long long farBlocks(long long total, int threads) {
    return (total + threads - 1) / threads;
}

EXPORT int far_field(double* K, const double* gi, const double* gj,
                     long long P, int M, int dim, int pcode, double C,
                     double e, double a, double C1, double C2,
                     double tl, int wcode, double wl, ORDER_PARAMS,
                     cudaStream_t stream) {
    const long long total = P * M * M;
    if (total <= 0) return 0;
    const int threads = 256;
    const long long blocks = farBlocks(total, threads);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const Order od = ORDER_OF;
#define LAUNCH_FAR                                                        \
    far_field_kernel<PC, OC, double><<<(unsigned)blocks, threads, 0,     \
                                       stream>>>(K, gi, gj, total, M, dim, \
                                                 PROFILE_OF(C), od)
    if (ocode >= ORDER_INNER_OUTER) {
        H2_ORDER_SWITCH(pcode, ocode, LAUNCH_FAR)
    } else {
        KERNEL_SWITCH(pcode, ocode, LAUNCH_FAR)
    }
#undef LAUNCH_FAR
    return static_cast<int>(cudaGetLastError());
}

// K [P, M, M], gi, gj [P, M, dim] float32; the power profile (its
// constants rounded to float32 on the host), no tempering, no two-point
// weight and no order; any other profile returns cudaErrorInvalidValue.
EXPORT int far_field_f32(float* K, const float* gi, const float* gj,
                         long long P, int M, int dim, PROFILE_PARAMS,
                         cudaStream_t stream) {
    const long long total = P * M * M;
    if (total <= 0) return 0;
    if (pcode != PROFILE_POWER || tl != 0.0 || wcode != TWO_POINT_NONE)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const long long blocks = farBlocks(total, threads);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    far_field_kernel<PROFILE_POWER, ORDER_NONE, float>
        <<<(unsigned)blocks, threads, 0, stream>>>(
            K, gi, gj, total, M, dim, PROFILE_OF(C), Order{});
    return static_cast<int>(cudaGetLastError());
}
