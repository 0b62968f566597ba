// K9 csr_spmv: y = A x (or y += A x) for a CSR matrix A with int32 row
// pointers and column indices, in four instances of one template on the
// value types: float64 data and x (the real operators), float64 data with
// complex128 x (a real prolongation or restriction applied to a complex
// vector), complex128 data and x (a complex operator), and float32 data
// and x (the float32 sparse operator of a finite horizon, its sums in
// float32 as the JAX float32 segment sum).  Complex values are
// interleaved (re, im) pairs, read as double2.
//
// Replaces pynucleus_tpu/base/linear_operators.py:310 CSR_LinearOperator
// .matvec (gather data * x[indices], segment sum over rows) and, run on
// the CSR of the transpose, :314 rmatvec, with float64 and complex128
// data.  In the multigrid V-cycle it applies the prolongation P
// (accumulate: x += P xc) and the restriction P^T (defect = P^T res); on
// the complex Helmholtz path also the level operators A.
//
// One warp per row: the lanes stride over the row's entries, a shuffle
// reduction sums them, lane 0 writes.  No atomics, so the sum of a row is
// the same in every run.  A P1 prolongation row holds 1-2 entries and a
// row of P^T or of a P1 operator up to about 7, so most lanes idle: a
// simple first design.  Bound on the card: memory (12 B per real entry, 20
// B per complex one, 8 B per float32 one, 16-24 B per row, and the
// gathered x), far below the float64 rate.

#include "common.cuh"

__device__ __forceinline__ double2 warpSum(double2 v) {
    v.x = warpSum(v.x);
    v.y = warpSum(v.y);
    return v;
}

__device__ __forceinline__ void madd(double& s, double a, double x) {
    s += a * x;
}

__device__ __forceinline__ void madd(float& s, float a, float x) {
    s += a * x;
}

__device__ __forceinline__ void madd(double2& s, double a, double2 x) {
    s.x += a * x.x;
    s.y += a * x.y;
}

__device__ __forceinline__ void madd(double2& s, double2 a, double2 x) {
    s.x += a.x * x.x - a.y * x.y;
    s.y += a.x * x.y + a.y * x.x;
}

__device__ __forceinline__ double plus(double a, double b) { return a + b; }

__device__ __forceinline__ float plus(float a, float b) { return a + b; }

__device__ __forceinline__ double2 plus(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}

template <typename TD, typename TX>
__global__ void __launch_bounds__(256)
csr_spmv_kernel(TX* __restrict__ y, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const TD* __restrict__ data,
                const TX* __restrict__ x, int nRows, int accumulate) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * (blockDim.x >> 5)
                          + (threadIdx.x >> 5);
    if (row >= nRows) return;  // uniform across the warp
    const int start = indptr[row], end = indptr[row + 1];
    TX s = {};
    for (int k = start + lane; k < end; k += 32)
        madd(s, data[k], x[indices[k]]);
    s = warpSum(s);
    if (lane == 0) y[row] = accumulate ? plus(y[row], s) : s;
}

// the value types of A and x (pynucleus_tpu_torch/base/linear_operators.py
// csr_spmv passes the code)
enum SpmvTypes { REAL_REAL = 0, REAL_COMPLEX = 1, COMPLEX_COMPLEX = 2,
                 FLOAT_FLOAT = 3 };

template <typename TD, typename TX>
static int launch(void* y, const int* indptr, const int* indices,
                  const void* data, const void* x, int nRows, int accumulate,
                  cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = ((long long)nRows * 32 + threads - 1) / threads;
    csr_spmv_kernel<TD, TX><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<TX*>(y), indptr, indices, static_cast<const TD*>(data),
        static_cast<const TX*>(x), nRows, accumulate);
    return static_cast<int>(cudaGetLastError());
}

EXPORT int csr_spmv(void* y, const int* indptr, const int* indices,
                    const void* data, const void* x, int nRows,
                    int accumulate, int types, cudaStream_t stream) {
    if (nRows <= 0) return 0;
    switch (types) {
    case REAL_REAL:
        return launch<double, double>(y, indptr, indices, data, x, nRows,
                                      accumulate, stream);
    case REAL_COMPLEX:
        return launch<double, double2>(y, indptr, indices, data, x, nRows,
                                       accumulate, stream);
    case COMPLEX_COMPLEX:
        return launch<double2, double2>(y, indptr, indices, data, x, nRows,
                                        accumulate, stream);
    case FLOAT_FLOAT:
        return launch<float, float>(y, indptr, indices, data, x, nRows,
                                    accumulate, stream);
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}
