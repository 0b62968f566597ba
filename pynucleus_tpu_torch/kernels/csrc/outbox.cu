// K29 outbox: the packed-outbox gathers of the sharded programs, for the
// shards of one card in one launch (the shard is the grid's y index).
// float64 values, int64 or int32 index arrays.
//
//   pack        out[k, p, w] = slot[k, p] >= 0 ? src[k, slot[k, p], w] : 0
//               for rows of width W (1: vector entries; M: the cluster
//               coefficients of a level); src may be one array for every
//               shard (srcStride 0: the global vector gathered into the
//               shards' local rows).  Replaces the outbox packing of
//               pynucleus_tpu/parallel/dist_h2.py:578-580 (x halo), :632-634
//               (coefficients), :824-826 (the CSR halo) and the halo strips
//               of parallel/dist.py:231-290.
//   receive-add X[k, rs[k, i]] += sum_c buf[rp[k, i, c]] with positions at
//               or beyond nbuf reading the zero pad lane; a row whose every
//               position is the pad adds nothing (the padding rows, which
//               all name slot 0).  Replaces parallel/overlaps.py:240-246.
//   gather2d    out[k, i] = buf[gp[k, i], gs[k, i]] * vm[k, i] from the
//               all-gathered buffer [nd, L].  Replaces parallel/overlaps.py
//               :301-305.
//
// One thread per output element; no atomics: the packed rows are distinct,
// and the slots of a receive-add differ within a shard, so every result
// is the same in every run.  Bound on the card: bytes (an index and a
// value read, a value written per element).

#include "common.cuh"

template <typename TI>
__global__ void __launch_bounds__(256)
outbox_pack_kernel(double* __restrict__ out, const double* __restrict__ src,
                   long long srcStride, long long S,
                   const TI* __restrict__ slot, long long P, int W) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long k = blockIdx.y;
    if (t >= P * W) return;
    const long long p = t / W;
    const int w = (int)(t - p * W);
    const long long s = (long long)slot[k * P + p];
    double v = 0.0;
    if (s >= 0 && s < S) v = src[k * srcStride + s * W + w];
    out[(k * P + p) * W + w] = v;
}

template <typename TI>
__global__ void __launch_bounds__(256)
outbox_recv_add_kernel(double* __restrict__ X, long long L,
                       const double* __restrict__ buf, long long nbuf,
                       const TI* __restrict__ rp,
                       const TI* __restrict__ rs, long long nI, int C) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long k = blockIdx.y;
    if (i >= nI) return;
    const TI* r = rp + (k * nI + i) * C;
    double acc = 0.0;
    bool any = false;
    for (int c = 0; c < C; ++c) {
        const long long q = (long long)r[c];
        if (q >= 0 && q < nbuf) {
            acc += buf[q];
            any = true;
        }
    }
    if (any) X[k * L + (long long)rs[k * nI + i]] += acc;
}

template <typename TI>
__global__ void __launch_bounds__(256)
outbox_gather2d_kernel(double* __restrict__ out,
                       const double* __restrict__ buf, long long L,
                       const TI* __restrict__ gp, const TI* __restrict__ gs,
                       const double* __restrict__ vm, long long nI) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long k = blockIdx.y;
    if (i >= nI) return;
    const long long e = k * nI + i;
    out[e] = buf[(long long)gp[e] * L + (long long)gs[e]] * vm[e];
}

static dim3 grid(long long n, int nk) {
    return dim3((unsigned)((n + 255) / 256), (unsigned)nk);
}

// idx64: the index arrays are int64 (1) or int32 (0)
EXPORT int outbox_pack(double* out, const double* src, long long srcStride,
                       long long S, const void* slot, int idx64, int nk,
                       long long P, int W, cudaStream_t stream) {
    if (nk <= 0 || P <= 0 || W <= 0) return 0;
    if (idx64)
        outbox_pack_kernel<long long><<<grid(P * W, nk), 256, 0, stream>>>(
            out, src, srcStride, S, static_cast<const long long*>(slot), P,
            W);
    else
        outbox_pack_kernel<int><<<grid(P * W, nk), 256, 0, stream>>>(
            out, src, srcStride, S, static_cast<const int*>(slot), P, W);
    return static_cast<int>(cudaGetLastError());
}

EXPORT int outbox_recv_add(double* X, long long L, const double* buf,
                           long long nbuf, const void* rp, const void* rs,
                           int idx64, int nk, long long nI, int C,
                           cudaStream_t stream) {
    if (nk <= 0 || nI <= 0) return 0;
    if (idx64)
        outbox_recv_add_kernel<long long><<<grid(nI, nk), 256, 0, stream>>>(
            X, L, buf, nbuf, static_cast<const long long*>(rp),
            static_cast<const long long*>(rs), nI, C);
    else
        outbox_recv_add_kernel<int><<<grid(nI, nk), 256, 0, stream>>>(
            X, L, buf, nbuf, static_cast<const int*>(rp),
            static_cast<const int*>(rs), nI, C);
    return static_cast<int>(cudaGetLastError());
}

EXPORT int outbox_gather2d(double* out, const double* buf, long long L,
                           const void* gp, const void* gs, const double* vm,
                           int idx64, int nk, long long nI,
                           cudaStream_t stream) {
    if (nk <= 0 || nI <= 0) return 0;
    if (idx64)
        outbox_gather2d_kernel<long long><<<grid(nI, nk), 256, 0, stream>>>(
            out, buf, L, static_cast<const long long*>(gp),
            static_cast<const long long*>(gs), vm, nI);
    else
        outbox_gather2d_kernel<int><<<grid(nI, nk), 256, 0, stream>>>(
            out, buf, L, static_cast<const int*>(gp),
            static_cast<const int*>(gs), vm, nI);
    return static_cast<int>(cudaGetLastError());
}
