// K14 cut1d and K15 cut2d_polar: element pairs cut by the horizon of a
// finite-horizon kernel, by exact clipping of the y-domain to the
// interaction ball, scattered into the dense operator, into CSR data at
// explicit slots (the sparse format) or into A_BC (the cross target of K1).
//
// K14 replaces pynucleus_tpu/nl/assembly.py:_bucket_cut1d.  For pair p
// (segments K1 = [v10, v11], K2 = [v20, v21]) and nodes (a, b) of the two
// Gauss rules (tq, wq), (ur, wr) on [0, 1]:
//   x = v10 + tq_a (v11 - v10),  [lo, hi] = K2 n [x - delta, x + delta],
//   len = max(hi - lo, 0),  y = lo + ur_b len,
//   W = gamma((x-y)^2) wq_a wr_b len vol1,  psi = [phi1(x); -phi2(y)]
//   M += W psi psi^T                                   (P1: 2 dpe = 4)
// Both orderings of an unordered pair are separate rows of the launch.
//
// K15 replaces pynucleus_tpu/nl/assembly.py:_bucket_cut2d_polar.  Per x
// node (simplexDuffy rule bary_x, wx of cell 1) the y-integral over
// cell 2 n B(x, delta) is taken in polar coordinates around x:
//   - the angular window of cell 2 seen from x: vertex angles recentred on
//     the centroid direction with a floor-mod (the sign follows the
//     divisor, as jnp.mod and torch.remainder; C's fmod alone would
//     follow the dividend);
//   - kink candidates: the 3 vertex directions, plus the corner directions
//     (0.25, 0.75, 1.25, 1.75) pi of ballInf or (0, 0.5, 1, 1.5) pi of
//     ball1 (the ellipse is smooth: none); clipped to the window and
//     sorted with its ends (at most 9 bounds, 8 segments);
//   - per segment the Gauss angles (thetas, wtheta); per angle the ray's
//     entry and exit through the triangle (edge hits with the 1e-14 and
//     1e-12 thresholds of the JAX program, at least 2 hits), the exit
//     clipped at delta / |d| (the interaction norm of the direction,
//     jaxDirNorm: |d|_2 for ball2, max|d_i| for ballInf, |d_0| + |d_1| for
//     ball1, |T d|_2 for the ellipse, T applied as jnp.einsum does);
//   - the radial Gauss rule (rq, wr) on [rLo, rHi]; y = x + r d and its
//     barycentrics in cell 2 (the P1 shape functions);
//   W = gamma(r^2) r w_r w_theta w_x,  M += W psi psi^T, M *= 2 vol1.
// Unordered pairs once: the symmetric kernel's full (2 dpe)^2 block.
//
// Design: one warp per pair.  K15's lanes first build the sorted window
// bounds of the pair's x nodes into shared memory (one x node per lane),
// then stride over the (x node, segment, angle) rays; K14's lanes stride
// over the (x node, y node) products.  The upper triangle of the symmetric
// local matrix stays in registers, a warp butterfly reduces it, and one
// atomicAdd(double) per entry scatters it.  Bound on the card: the float64
// pow per node and the (2 dpe)^2 FMAs per node (K15 also two trig calls
// and three ray-edge solves per ray); atomics are (2 dpe)^2 per pair.
//
// Targets: dense A, CSR slots, A_BC (cross), the diagonal alone (DIAG:
// d[r] += M[i,j] where dofRows[p,i] = dofRows[p,j] = r >= 0, the
// _DiagAccumulator of getDiagonal) and a float32 dense A (DENSE32, the
// float32 getDense of a finite horizon: each float64 entry added as
// A = fl32(A + v), one compare-and-swap step, the rounding of the float32
// DenseAccumulator's np.add.at).  Both kernels take the kernel's
// profile (common.cuh radial<PC>, one instance per code of
// CUT_PROFILE_SWITCH: the profiles of a finite horizon, the power C r2^e
// with its tempering, the gaussian, the exponential, the log-inverse
// distance and the polynomial) with its smooth two-point weight, evaluated
// at the node's r2 (K15: r^2 where the JAX program weighs |x - y| of y = x
// + r d, the same distance to rounding).  K15 also takes the complex
// GREENS_2D profile (common.cuh radialC, the greens2D kernel of
// ComplexKernel): then W and M are complex, kept as re and im sums of the
// upper triangle (21 each), and added into the float64 view of a
// complex128 dense A or diagonal (re at 2 k, im at 2 k + 1).  A host
// two-point weight of the pair is folded into vols1 by the caller.
//
// This file is compiled with -fmad=false: the window ends, the order of
// the kink candidates, the edge hits and the clipped interval decide the
// integration domain, and a contracted multiply-add could round a
// near-grazing ray differently from the plain versions' separate
// operations.
#include "common.cuh"

// The profiles of the cut-pair kernels' instances (a finite horizon's
// kernels; the boundary and power-log profiles have none).
#define CUT_PROFILE_SWITCH(code, ...)                               \
    switch (code) {                                                 \
        PROFILE_CASE(PROFILE_POWER, __VA_ARGS__)                    \
        PROFILE_CASE(PROFILE_GAUSSIAN, __VA_ARGS__)                 \
        PROFILE_CASE(PROFILE_EXPONENTIAL, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_LOG_INVERSE, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_POLYNOMIAL, __VA_ARGS__)               \
        default: return static_cast<int>(cudaErrorInvalidValue);    \
    }

enum CutTarget {
    CUT_DENSE = 0,
    CUT_SLOTS = 1,
    CUT_CROSS = 2,
    CUT_DIAG = 3,
    CUT_DENSE32 = 4
};

// *a = fl32(*a + v) in one atomic step: the float64 sum of the float32
// entry and v, rounded to float32 once.
__device__ __forceinline__ void atomicAddRounded(float* a, double v) {
    unsigned int* p = reinterpret_cast<unsigned int*>(a);
    unsigned int old = *p, assumed;
    do {
        assumed = old;
        const float nv = __double2float_rn(
            __dadd_rn(static_cast<double>(__uint_as_float(assumed)), v));
        old = atomicCAS(p, assumed, __float_as_uint(nv));
    } while (old != assumed);
}

// Adds the warp-reduced symmetric local matrix of one pair, held as its
// upper triangle up[] (row-major over i <= j), at the pair's target:
// dense A[dr[i], dr[j]] (both >= 0; DENSE32: out is a float32 A),
// CSR data[slots[p, i*n2+j]] (slot in [0, nnz)), or cross
// A[dr[i], -dr[j]-1] (row >= 0, DROP_HALF < col < 0).  Lane k % 32 adds
// entry k.
template <int N2, int TARGET>
__device__ __forceinline__ void cutScatter(double* __restrict__ out,
                                           long long N,
                                           const long long* __restrict__ dr,
                                           const int* __restrict__ slots,
                                           const double* up, int lane) {
#pragma unroll
    for (int k = 0; k < N2 * N2; ++k) {
        if ((k & 31) != lane) continue;
        const int i = k / N2, j = k % N2;
        const int a = i < j ? i : j, b = i < j ? j : i;
        const double v = up[a * N2 - a * (a - 1) / 2 + (b - a)];
        if (TARGET == CUT_SLOTS) {
            const long long s = slots[k];
            if (s >= 0 && s < N) atomicAdd(out + s, v);
        } else if (TARGET == CUT_DIAG) {
            const long long r = dr[i];
            if (r >= 0 && r == dr[j]) atomicAdd(out + r, v);
        } else {
            const long long r = dr[i], c = dr[j];
            if (TARGET == CUT_DENSE) {
                if (r >= 0 && c >= 0) atomicAdd(out + r * N + c, v);
            } else if (TARGET == CUT_DENSE32) {
                if (r >= 0 && c >= 0)
                    atomicAddRounded(
                        reinterpret_cast<float*>(out) + r * N + c, v);
            } else if (r >= 0 && c < 0 && c > DROP_HALF) {
                atomicAdd(out + r * N - c - 1, v);
            }
        }
    }
}

// The complex form of cutScatter, for the DENSE and DIAG targets: the
// upper triangles re[] and im[] added into the float64 view of a
// complex128 dense A [N, N] or diagonal [N].
template <int N2, int TARGET>
__device__ __forceinline__ void cutScatterC(double* __restrict__ out,
                                            long long N,
                                            const long long* __restrict__ dr,
                                            const double* re,
                                            const double* im, int lane) {
    static_assert(TARGET == CUT_DENSE || TARGET == CUT_DIAG,
                  "complex cut pairs: dense or diagonal target");
#pragma unroll
    for (int k = 0; k < N2 * N2; ++k) {
        if ((k & 31) != lane) continue;
        const int i = k / N2, j = k % N2;
        const int a = i < j ? i : j, b = i < j ? j : i;
        const int u = a * N2 - a * (a - 1) / 2 + (b - a);
        const long long r = dr[i], c = dr[j];
        long long at = -1;
        if (TARGET == CUT_DENSE) {
            if (r >= 0 && c >= 0) at = r * N + c;
        } else if (r >= 0 && r == c) {
            at = r;
        }
        if (at >= 0) {
            atomicAdd(out + 2 * at, re[u]);
            atomicAdd(out + 2 * at + 1, im[u]);
        }
    }
}

// acc[upper(i, j)] += W psi_i psi_j for i <= j.
template <int N2>
__device__ __forceinline__ void addOuter(double* acc, const double* psi,
                                         double W) {
    int u = 0;
#pragma unroll
    for (int i = 0; i < N2; ++i) {
        const double wi = W * psi[i];
#pragma unroll
        for (int j = i; j < N2; ++j) acc[u++] += wi * psi[j];
    }
}

// ------------------------------------------------------------------ K14 --

template <int TARGET, int PC>
__global__ void __launch_bounds__(256)
cut1d_kernel(double* __restrict__ out, long long N,
             const double* __restrict__ vertices,
             const long long* __restrict__ vi1,
             const long long* __restrict__ vi2,
             const double* __restrict__ vols1,
             const long long* __restrict__ dofRows,
             const int* __restrict__ slots, long long P,
             const double* __restrict__ tq, const double* __restrict__ wq,
             int Qx, const double* __restrict__ ur,
             const double* __restrict__ wr, int Qy, double horizon,
             Profile pf) {
    constexpr int N2 = 4, NU = N2 * (N2 + 1) / 2;
    const int lane = threadIdx.x & 31;
    const long long pair = (long long)blockIdx.x * (blockDim.x >> 5)
                           + (threadIdx.x >> 5);
    if (pair >= P) return;  // uniform across the warp
    const double v10 = vertices[vi1[2 * pair]];
    const double v11 = vertices[vi1[2 * pair + 1]];
    const double v20 = vertices[vi2[2 * pair]];
    const double v21 = vertices[vi2[2 * pair + 1]];
    const double lo2 = fmin(v20, v21), hi2 = fmax(v20, v21);
    const double vol = vols1[pair];
    double acc[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[u] = 0.0;
    for (int q = lane; q < Qx * Qy; q += 32) {
        const int a = q / Qy, b = q % Qy;
        const double t = tq[a];
        const double x = v10 + t * (v11 - v10);
        const double lo = fmax(lo2, x - horizon);
        const double hi = fmin(hi2, x + horizon);
        const double len = fmax(hi - lo, 0.0);
        const double y = lo + ur[b] * len;
        const double t2 = (y - v20) / (v21 - v20);
        const double d = x - y;
        const double W = radial<PC>(d * d, pf)
                         * (((wq[a] * wr[b]) * len) * vol);
        const double psi[N2] = {1.0 - t, t, -(1.0 - t2), -t2};
        addOuter<N2>(acc, psi, W);
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[u] = warpSum(acc[u]);
    cutScatter<N2, TARGET>(out, N, dofRows + pair * N2,
                           slots + pair * N2 * N2, acc, lane);
}

// ------------------------------------------------------------------ K15 --

constexpr int CUT_WARPS = 8;   // warps (pairs) per block
constexpr int MAXQX = 32;      // x nodes of a cut rule (orders <= 16: 25)
constexpr int MAXB = 9;        // window ends, 3 vertices, 4 ball corners
constexpr double PI_D = 3.141592653589793;
constexpr double TWO_PI_D = 6.283185307179586;

// a mod 2 pi with the sign of the divisor (jnp.mod, torch.remainder).
__device__ __forceinline__ double mod2pi(double a) {
    double m = fmod(a, TWO_PI_D);
    if (m != 0.0 && m < 0.0) m += TWO_PI_D;
    return m;
}

template <int TARGET, bool CPLX, int PC>
__global__ void __launch_bounds__(CUT_WARPS * 32)
cut2d_polar_kernel(double* __restrict__ out, long long N,
                   const double* __restrict__ vertices,
                   const long long* __restrict__ vi1,
                   const long long* __restrict__ vi2,
                   const double* __restrict__ vols1,
                   const long long* __restrict__ dofRows,
                   const int* __restrict__ slots, long long P,
                   const double* __restrict__ bary_x,
                   const double* __restrict__ wx, int Qx,
                   const double* __restrict__ thetas,
                   const double* __restrict__ wtheta, int Qt,
                   const double* __restrict__ rq,
                   const double* __restrict__ wr, int Qr, double horizon,
                   Inter in, Profile pf) {
    constexpr int N2 = 6, NU = N2 * (N2 + 1) / 2;
    __shared__ double bnd[CUT_WARPS][MAXQX][MAXB];
    __shared__ double xs[CUT_WARPS][MAXQX][2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long pair = (long long)blockIdx.x * CUT_WARPS + warp;
    if (pair >= P) return;  // uniform across the warp

    double v1[MAXNV][MAXDIM], v2[MAXNV][MAXDIM];
    loadSimplex(v1, vertices, vi1 + pair * 3, 3, 2);
    loadSimplex(v2, vertices, vi2 + pair * 3, 3, 2);
    // the corner directions of ballInf (code 2) and ball1 (code 3)
    const bool corners = in.code == 2 || in.code == 3;
    const int nb = corners ? 9 : 5;  // sorted window bounds
    const int S = nb - 1;               // segments

    // the window bounds of each x node, one x node per lane
    for (int ix = lane; ix < Qx; ix += 32) {
        double x[2];
        for (int d = 0; d < 2; ++d) {
            double s = 0.0;
            for (int a = 0; a < 3; ++a) s += v1[a][d] * bary_x[a * Qx + ix];
            x[d] = s;
            xs[warp][ix][d] = s;
        }
        const double cen0 = (v2[0][0] + v2[1][0] + v2[2][0]) / 3.0;
        const double cen1 = (v2[0][1] + v2[1][1] + v2[2][1]) / 3.0;
        const double angC = atan2(cen1 - x[1], cen0 - x[0]);
        double dAng[3], dMin = 0.0, dMax = 0.0;
        for (int a = 0; a < 3; ++a) {
            const double angV = atan2(v2[a][1] - x[1], v2[a][0] - x[0]);
            dAng[a] = mod2pi(angV - angC + PI_D) - PI_D;
            dMin = a == 0 ? dAng[a] : fmin(dMin, dAng[a]);
            dMax = a == 0 ? dAng[a] : fmax(dMax, dAng[a]);
        }
        const double thLo = angC + dMin, thHi = angC + dMax;
        double* bb = bnd[warp][ix];
        bb[0] = thLo;
        for (int a = 0; a < 3; ++a)
            bb[1 + a] = fmin(fmax(angC + dAng[a], thLo), thHi);
        if (corners) {
            const double omInf[4] = {0.25, 0.75, 1.25, 1.75};
            const double om1[4] = {0.0, 0.5, 1.0, 1.5};
            for (int c = 0; c < 4; ++c) {
                const double om = in.code == 2 ? omInf[c] : om1[c];
                const double rec = angC + mod2pi(om * PI_D - angC + PI_D)
                                   - PI_D;
                bb[4 + c] = fmin(fmax(rec, thLo), thHi);
            }
        }
        bb[nb - 1] = thHi;
        for (int i = 1; i < nb; ++i) {  // insertion sort, nb <= 9
            const double v = bb[i];
            int j = i - 1;
            while (j >= 0 && bb[j] > v) {
                bb[j + 1] = bb[j];
                --j;
            }
            bb[j + 1] = v;
        }
    }
    __syncwarp();

    // cell 2's affine inverse (barycentrics of y): the edge vectors e1, e2
    // from vertex 0 are the columns of the span, xi = span^-1 (y - v0)
    const double e1x = v2[1][0] - v2[0][0], e1y = v2[1][1] - v2[0][1];
    const double e2x = v2[2][0] - v2[0][0], e2y = v2[2][1] - v2[0][1];
    const double det = e1x * e2y - e2x * e1y;
    const double i00 = e2y / det, i01 = -e2x / det;
    const double i10 = -e1y / det, i11 = e1x / det;

    double acc[NU], acci[CPLX ? NU : 1];
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[u] = 0.0;
    if constexpr (CPLX) {
#pragma unroll
        for (int u = 0; u < NU; ++u) acci[u] = 0.0;
    }
    const int T = S * Qt;
    for (int k = lane; k < Qx * T; k += 32) {
        const int ix = k / T, rem = k % T, sg = rem / Qt, it = rem % Qt;
        const double b0 = bnd[warp][ix][sg];
        const double seg = bnd[warp][ix][sg + 1] - b0;
        const double th = b0 + seg * thetas[it];
        const double wth = seg * wtheta[it];
        const double d0 = cos(th), d1 = sin(th);
        const double x0 = xs[warp][ix][0], x1 = xs[warp][ix][1];
        double tIn = 0.0, tOut = 0.0;
        int hits = 0;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            const int m2 = m == 2 ? 0 : m + 1;
            const double E0 = v2[m2][0] - v2[m][0], E1 = v2[m2][1] - v2[m][1];
            const double a0 = v2[m][0] - x0, a1 = v2[m][1] - x1;
            const double denom = d0 * E1 - d1 * E0;
            const bool ok = fabs(denom) > 1e-14;
            const double safe = ok ? denom : 1.0;
            const double t = (a0 * E1 - a1 * E0) / safe;
            const double u = (a0 * d1 - a1 * d0) / safe;
            if (ok && u >= -1e-12 && u <= 1.0 + 1e-12 && t > 0.0) {
                tIn = hits == 0 ? t : fmin(tIn, t);
                tOut = hits == 0 ? t : fmax(tOut, t);
                ++hits;
            }
        }
        if (hits < 2) continue;  // rLo = rHi = 0: no contribution
        double dNorm;
        if (in.code == 2) {
            dNorm = fmax(fabs(d0), fabs(d1));
        } else if (in.code == 3) {
            dNorm = fabs(d0) + fabs(d1);
        } else if (in.code == 4) {
            const double a = in.t00 * d0 + in.t01 * d1;
            const double b = in.t10 * d0 + in.t11 * d1;
            dNorm = sqrt(a * a + b * b);
        } else {
            dNorm = sqrt(d0 * d0 + d1 * d1);
        }
        const double rBall = horizon / fmax(dNorm, 1e-30);
        const double rLo = tIn;
        const double rHi = fmax(fmin(tOut, rBall), rLo);
        const double len = rHi - rLo;
        const double wxa = wx[ix];
        double psi[N2];
#pragma unroll
        for (int a = 0; a < 3; ++a) psi[a] = bary_x[a * Qx + ix];
        for (int ir = 0; ir < Qr; ++ir) {
            const double r = rLo + len * rq[ir];
            const double wrad = len * wr[ir];
            const double y0 = x0 + r * d0, y1 = x1 + r * d1;
            const double rel0 = y0 - v2[0][0], rel1 = y1 - v2[0][1];
            const double xi0 = rel0 * i00 + rel1 * i01;
            const double xi1 = rel0 * i10 + rel1 * i11;
            psi[3] = -(1.0 - (xi0 + xi1));
            psi[4] = -xi0;
            psi[5] = -xi1;
            if constexpr (CPLX) {
                const double2 g = radialC(r * r, pf);
                addOuter<N2>(acc, psi, (((g.x * r) * wrad) * wth) * wxa);
                addOuter<N2>(acci, psi, (((g.y * r) * wrad) * wth) * wxa);
            } else {
                const double W =
                    (((radial<PC>(r * r, pf) * r) * wrad) * wth) * wxa;
                addOuter<N2>(acc, psi, W);
            }
        }
    }
    const double fac = 2.0 * vols1[pair];
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[u] = warpSum(acc[u]) * fac;
    if constexpr (CPLX) {
#pragma unroll
        for (int u = 0; u < NU; ++u) acci[u] = warpSum(acci[u]) * fac;
        cutScatterC<N2, TARGET>(out, N, dofRows + pair * N2, acc, acci,
                                lane);
    } else {
        cutScatter<N2, TARGET>(out, N, dofRows + pair * N2,
                               slots + pair * N2 * N2, acc, lane);
    }
}

// ---------------------------------------------------------- entry points --

EXPORT int cut1d(double* out, long long N, int target,
                 const double* vertices, const long long* vi1,
                 const long long* vi2, const double* vols1,
                 const long long* dofRows, const int* slots, long long P,
                 const double* tq, const double* wq, int Qx, const double* ur,
                 const double* wr, int Qy, double horizon, PROFILE_PARAMS,
                 cudaStream_t stream) {
    if (P <= 0) return 0;
    const int threads = 256;
    const long long blocks = (P + (threads / 32) - 1) / (threads / 32);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    if (target < CUT_DENSE || target > CUT_DENSE32)
        return static_cast<int>(cudaErrorInvalidValue);
    const Profile pf = PROFILE_OF(C);
#define LAUNCH(T)                                                           \
    cut1d_kernel<T, PC><<<(unsigned)blocks, threads, 0, stream>>>(          \
        out, N, vertices, vi1, vi2, vols1, dofRows, slots, P, tq, wq, Qx,   \
        ur, wr, Qy, horizon, pf)
#define TARGET_SWITCH                                   \
    switch (target) {                                   \
        case CUT_DENSE: LAUNCH(CUT_DENSE); break;       \
        case CUT_SLOTS: LAUNCH(CUT_SLOTS); break;       \
        case CUT_CROSS: LAUNCH(CUT_CROSS); break;       \
        case CUT_DIAG: LAUNCH(CUT_DIAG); break;         \
        default: LAUNCH(CUT_DENSE32); break;            \
    }
    CUT_PROFILE_SWITCH(pcode, TARGET_SWITCH)
#undef TARGET_SWITCH
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// out: float64 (a real profile; float32 for DENSE32), or the float64 view
// of a complex128 dense A or diagonal (the GREENS_2D profile: targets dense
// and diagonal).
EXPORT int cut2d_polar(double* out, long long N, int target,
                       const double* vertices, const long long* vi1,
                       const long long* vi2, const double* vols1,
                       const long long* dofRows, const int* slots,
                       long long P, const double* bary_x, const double* wx,
                       int Qx, const double* thetas, const double* wtheta,
                       int Qt, const double* rq, const double* wr, int Qr,
                       double horizon, int inter, double t00, double t01,
                       double t10, double t11, PROFILE_PARAMS,
                       cudaStream_t stream) {
    if (P <= 0) return 0;
    if (Qx > MAXQX || inter < 1 || inter > 4)
        return static_cast<int>(cudaErrorInvalidValue);
    if (target < CUT_DENSE || target > CUT_DENSE32)
        return static_cast<int>(cudaErrorInvalidValue);
    const Inter in{inter, 0.0, t00, t01, t10, t11};
    const long long blocks = (P + CUT_WARPS - 1) / CUT_WARPS;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const Profile pf = PROFILE_OF(C);
#define LAUNCH(T, CX)                                                       \
    cut2d_polar_kernel<T, CX, PC><<<(unsigned)blocks, CUT_WARPS * 32, 0,    \
                                    stream>>>(                              \
        out, N, vertices, vi1, vi2, vols1, dofRows, slots, P, bary_x, wx,   \
        Qx, thetas, wtheta, Qt, rq, wr, Qr, horizon, in, pf)
    if (pcode == PROFILE_GREENS_2D) {
        constexpr int PC = PROFILE_GREENS_2D;
        switch (target) {
            case CUT_DENSE: LAUNCH(CUT_DENSE, true); break;
            case CUT_DIAG: LAUNCH(CUT_DIAG, true); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    } else {
#define TARGET_SWITCH                                          \
    switch (target) {                                          \
        case CUT_DENSE: LAUNCH(CUT_DENSE, false); break;       \
        case CUT_SLOTS: LAUNCH(CUT_SLOTS, false); break;       \
        case CUT_CROSS: LAUNCH(CUT_CROSS, false); break;       \
        case CUT_DIAG: LAUNCH(CUT_DIAG, false); break;         \
        default: LAUNCH(CUT_DENSE32, false); break;            \
    }
        CUT_PROFILE_SWITCH(pcode, TARGET_SWITCH)
#undef TARGET_SWITCH
    }
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}
