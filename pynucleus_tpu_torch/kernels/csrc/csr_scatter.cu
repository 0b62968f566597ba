// K16 csr_scatter: CSR data [nnz] from the local matrices of a finite
// element assembly, each slot the sum of its contributions.
//
// Replaces the jax.ops.segment_sum of pynucleus_tpu/fem/assembly.py:87
// scatterToCSR (called by :134 assembleStiffness and :99 assembleMass):
// the [C, dpe, dpe] local values, flattened, go to their nnz slots, the
// dropped boundary entries to a dump slot.
//
// A gather, not atomics: the host sorts the kept contributions by slot
// once (a stable sort, so each slot's contributions stay in flat-index
// order) and gives each slot its range of that order through offsets
// [nnz+1].  One thread per slot adds its contributions from 0.0 in that
// order, which is the order of the JAX package's sequential segment sum on
// the CPU: the result is the same in every run and equal to the plain
// version's bit for bit (additions only, nothing for FMA to contract).
// Bound on the card: memory (the kept values and their order read once,
// 8 + 4 B each, 4 B of offsets and 8 B of data per slot); the values are
// gathered, so the reads of neighbouring threads are not coalesced.

#include "common.cuh"

__global__ void __launch_bounds__(256)
csr_scatter_kernel(double* __restrict__ data, const double* __restrict__ vals,
                   const int* __restrict__ order,
                   const int* __restrict__ offsets, int nnz) {
    const long long slot = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (slot >= nnz) return;
    const int end = offsets[slot + 1];
    double s = 0.0;
    for (int k = offsets[slot]; k < end; ++k) s += vals[order[k]];
    data[slot] = s;
}

EXPORT int csr_scatter(double* data, const double* vals, const int* order,
                       const int* offsets, int nnz, cudaStream_t stream) {
    if (nnz <= 0) return 0;
    const int threads = 256;
    const long long blocks = ((long long)nnz + threads - 1) / threads;
    csr_scatter_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        data, vals, order, offsets, nnz);
    return static_cast<int>(cudaGetLastError());
}
