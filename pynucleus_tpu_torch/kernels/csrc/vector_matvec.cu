// K23 vector_matvec: the apply and the transposed apply of a dense
// vector-valued operator A [N, M, V] (float64, row-major):
//   vector_matvec    y[n, k] = sum_m A[n, m, k] x[m]      y [N, V]
//   vector_matvec_T  y[m, k] = sum_n A[n, m, k] x[n]      y [M, V]
//
// Replaces pynucleus_tpu/base/linear_operators.py:156
// Dense_VectorLinearOperator.matvec (einsum('nmk,m->nk')) and :159
// matvecTrans (einsum('nmk,n->mk')).  Bound on the card: one read of A
// (bytes).
//
// Design.  The apply: one block per row n reads the row's M V values in
// order, so neighbouring threads read neighbouring addresses; with a block
// of a multiple of V threads each thread keeps one component k = t % V and
// one register sum, then the block reduces the sums of each k (shuffles
// within a warp when V is a power of two up to 32, then across warps in
// shared memory; else a sequential sum per k).  The transposed apply: the
// threads of a block own consecutive entries j = m V + k of the output and
// walk the rows of one row chunk, again reading neighbouring addresses;
// the row chunks (blockIdx.y) add their partial sums with atomicAdd(double)
// into y, which the caller zeroes, so the grid has enough blocks when N is
// small against M V.

#include "common.cuh"

constexpr int VM_THREADS = 256;

__global__ void __launch_bounds__(VM_THREADS)
vector_matvec_kernel(double* __restrict__ y, const double* __restrict__ A,
                     const double* __restrict__ x, long long M, int V,
                     int pow2) {
    __shared__ double sh[VM_THREADS];
    const int t = threadIdx.x, nt = blockDim.x;
    const double* row = A + (long long)blockIdx.x * M * V;
    const long long L = M * V;
    const int step = nt / V;
    double acc = 0.0;
    long long m = t / V;
    for (long long j = t; j < L; j += nt, m += step) acc += row[j] * x[m];
    if (pow2) {
        // lanes l and l ^ o (o >= V) hold the same component
        for (int o = 16; o >= V; o >>= 1)
            acc += __shfl_xor_sync(FULL_MASK, acc, o);
    }
    sh[t] = acc;
    __syncthreads();
    if (t < V) {
        double s = 0.0;
        if (pow2) {
            for (int wp = 0; wp < nt; wp += 32) s += sh[wp + t];
        } else {
            for (int i = t; i < nt; i += V) s += sh[i];
        }
        y[(long long)blockIdx.x * V + t] = s;
    }
}

__global__ void __launch_bounds__(VM_THREADS)
vector_matvec_T_kernel(double* __restrict__ y, const double* __restrict__ A,
                       const double* __restrict__ x, long long N, long long L,
                       long long rowsPerChunk) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= L) return;
    const long long n0 = (long long)blockIdx.y * rowsPerChunk;
    const long long n1 = min(N, n0 + rowsPerChunk);
    double acc = 0.0;
    for (long long n = n0; n < n1; ++n) acc += A[n * L + j] * x[n];
    atomicAdd(y + j, acc);
}

EXPORT int vector_matvec(double* y, const double* A, const double* x,
                         long long N, long long M, int V,
                         cudaStream_t stream) {
    if (N <= 0 || M <= 0) return 0;
    if (V < 1 || V > VM_THREADS || N > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const int pow2 = V <= 32 && (V & (V - 1)) == 0;
    const int threads = (VM_THREADS / V) * V;
    vector_matvec_kernel<<<(unsigned)N, threads, 0, stream>>>(y, A, x, M, V,
                                                              pow2);
    return static_cast<int>(cudaGetLastError());
}

// y [M V] must be zero: the row chunks add into it.
EXPORT int vector_matvec_T(double* y, const double* A, const double* x,
                           long long N, long long M, int V,
                           cudaStream_t stream) {
    if (N <= 0 || M <= 0) return 0;
    if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long L = M * V;
    const long long colBlocks = (L + VM_THREADS - 1) / VM_THREADS;
    if (colBlocks > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    // about four blocks per SM of the 132, at most 32 row chunks
    long long chunks = (528 + colBlocks - 1) / colBlocks;
    chunks = max(1LL, min(chunks, min(32LL, N)));
    const long long rowsPerChunk = (N + chunks - 1) / chunks;
    chunks = (N + rowsPerChunk - 1) / rowsPerChunk;
    const dim3 grid((unsigned)colBlocks, (unsigned)chunks);
    vector_matvec_T_kernel<<<grid, VM_THREADS, 0, stream>>>(y, A, x, N, L,
                                                            rowsPerChunk);
    return static_cast<int>(cudaGetLastError());
}
