// Shared device helpers of the port's CUDA kernels (sm_90a, float64; the
// node geometry, the power profile, the quadrature body of K1 and the tree
// scatter also in float32, for the float32 dense and H2 paths).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// T as a parameter type that takes no part in template argument deduction:
// the scalar type of a templated helper comes from one argument alone
// (nullptr and literals pass for the others).
template <typename T>
struct NoDeduceT { using type = T; };
template <typename T>
using NoDeduce = typename NoDeduceT<T>::type;

template <typename T>
constexpr bool IS_F32 = std::is_same<T, float>::value;

// The operations rounded on their own (no contraction into an FMA), and
// the fused multiply-add, in float64 and float32.
__device__ __forceinline__ double addRN(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float addRN(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double mulRN(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float mulRN(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double fmaRN(double a, double b, double c) {
    return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fmaRN(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double sqrtT(double v) { return sqrt(v); }
__device__ __forceinline__ float sqrtT(float v) { return sqrtf(v); }

#define EXPORT extern "C" __attribute__((visibility("default")))

#define FULL_MASK 0xffffffffu

// A kernel's radial profile (pynucleus_tpu_torch/nl/kernels.py Profile and
// its codes): the power C r2^e (the constant-order fractional kernel and
// its boundary kernel, the indicator, peridynamic and monomial kernels) and
// the smooth kernels of pynucleus_tpu/nl/kernels.py:_radialJax with their
// boundary forms, the power-log profile of the s-derivatives of a
// constant fractional order (DerivativeFractionalKernel._radialJax), and
// the log-inverse-distance and polynomial profiles (:1122-1128).  t is
// the tempering of the power and power-log profiles (their value times
// exp(-t r), :1095-1096, :1480-1481), (wcode, wlam) the smooth two-point
// weight (TwoPointCode) that multiplies the kernel after its value
// (pynucleus_tpu/nl/assembly.py:54-64 _radial_eval with phiJax).
enum ProfileCode {
    PROFILE_POWER = 0,          // C r2^e
    PROFILE_GAUSSIAN = 1,       // C exp(-a r2)
    PROFILE_EXPONENTIAL = 2,    // C exp(-a r)
    PROFILE_GAUSSIAN_B1 = 3,    // C 1/2 sqrt(pi/a) erfc(sqrt(a) r)
    PROFILE_GAUSSIAN_B2 = 4,    // C exp(-a r2) / (2 a r)
    PROFILE_EXPONENTIAL_B1 = 5, // C/a exp(-a r)
    PROFILE_EXPONENTIAL_B2 = 6, // C exp(-a r) (r/a + 1/a^2) / r
    PROFILE_POWER_LOG = 7,      // r2^e (C + C1 ln r2 + C2 ln^2 r2)
    PROFILE_GREENS_2D = 8,      // C (-Y0(a r) + i J0(a r)), complex: radialC
    // code 9 (greens3D) is a profile of the plain versions only
    PROFILE_LOG_INVERSE = 10,   // C ln(1 / sqrt(r2))
    PROFILE_POLYNOMIAL = 11     // C (1 - r2 / a^2)^2
};

// the two-point weight: none, or temperedTwoPoint's exp(-wlam |x-y|)
enum TwoPointCode { TWO_POINT_NONE = 0, TWO_POINT_TEMPERED = 1 };

struct Profile {
    int code;
    double C, e, a, C1, C2;
    double t;     // tempering of the power and power-log values
    int wcode;    // TwoPointCode
    double wlam;  // the tempered weight's lambda
};

// The entry points' profile arguments and the Profile they make.
#define PROFILE_PARAMS                                                  \
    int pcode, double C, double e, double a, double C1, double C2,      \
        double tl, int wcode, double wl
#define PROFILE_OF(Cv) Profile{pcode, Cv, e, a, C1, C2, tl, wcode, wl}

// v times exp(-lam sqrt(r2)), the product rounded on its own (the JAX
// expression val * jnp.exp(-lam * jnp.sqrt(r2))).
__device__ __forceinline__ double temper(double v, double lam, double r2) {
    return __dmul_rn(v, exp(__dmul_rn(-lam, sqrt(r2))));
}

// v times the smooth two-point weight of p at r2 = |x-y|^2: the tempered
// exp(-wlam |x-y|) (temperedTwoPoint.jaxEval), applied after the kernel's
// value; v itself without a weight.
__device__ __forceinline__ double twoPoint(double v, double r2,
                                           const Profile& p) {
    return p.wcode == TWO_POINT_TEMPERED ? temper(v, p.wlam, r2) : v;
}

// The value of the profile PC at r2 > 0, before the tempering and the
// weight (radial<PC>).
template <int PC>
__device__ __forceinline__ double radialValue(double r2, const Profile& p) {
    if constexpr (PC == PROFILE_POWER) {
        return __dmul_rn(p.C, pow(r2, p.e));
    } else if constexpr (PC == PROFILE_GAUSSIAN) {
        return __dmul_rn(p.C, exp(__dmul_rn(-p.a, r2)));
    } else if constexpr (PC == PROFILE_EXPONENTIAL) {
        return __dmul_rn(p.C, exp(__dmul_rn(-p.a, sqrt(r2))));
    } else if constexpr (PC == PROFILE_GAUSSIAN_B1) {
        const double k = __dmul_rn(__dmul_rn(p.C, 0.5),
                                   sqrt(__ddiv_rn(3.141592653589793, p.a)));
        return __dmul_rn(k, erfc(__dmul_rn(sqrt(p.a), sqrt(r2))));
    } else if constexpr (PC == PROFILE_GAUSSIAN_B2) {
        return __ddiv_rn(__dmul_rn(p.C, exp(__dmul_rn(-p.a, r2))),
                         __dmul_rn(__dmul_rn(2.0, p.a), sqrt(r2)));
    } else if constexpr (PC == PROFILE_EXPONENTIAL_B1) {
        return __dmul_rn(__ddiv_rn(p.C, p.a),
                         exp(__dmul_rn(-p.a, sqrt(r2))));
    } else if constexpr (PC == PROFILE_POWER_LOG) {
        const double L = log(r2);
        const double poly = __dadd_rn(__dadd_rn(p.C, __dmul_rn(p.C1, L)),
                                      __dmul_rn(p.C2, __dmul_rn(L, L)));
        return __dmul_rn(pow(r2, p.e), poly);
    } else if constexpr (PC == PROFILE_LOG_INVERSE) {
        return __dmul_rn(p.C, log(__ddiv_rn(1.0, sqrt(r2))));
    } else if constexpr (PC == PROFILE_POLYNOMIAL) {
        // a^2 as the Python float a ** 2 of the JAX expression
        const double q = __dsub_rn(1.0, __ddiv_rn(r2, __dmul_rn(p.a, p.a)));
        return __dmul_rn(p.C, __dmul_rn(q, q));
    } else {
        static_assert(PC == PROFILE_EXPONENTIAL_B2, "unknown profile code");
        const double r = sqrt(r2);
        const double t = __dadd_rn(__ddiv_rn(r, p.a),
                                   __ddiv_rn(1.0, __dmul_rn(p.a, p.a)));
        return __ddiv_rn(__dmul_rn(__dmul_rn(p.C, exp(__dmul_rn(-p.a, r))), t),
                         r);
    }
}

// gamma(r2) of the profile PC (a ProfileCode, fixed when the kernel is
// compiled: each launcher switches on the code once, PROFILE_SWITCH), with
// the parameters of p; exactly 0 at r2 == 0 (coincident points of the
// singular rules), as pynucleus_tpu/nl/assembly.py:_radial_eval: the
// profile's value, for the power and power-log profiles times the
// tempering exp(-t r) where t != 0, then times the smooth two-point weight
// (twoPoint; its r2 is |x-y|^2 at the node, which each kernel passes).
// Every kernel that evaluates a kernel shares it.  Each operation is the
// plain version's (nl/kernels.py radialEval), in its order and rounded on
// its own (the _rn intrinsics keep nvcc from contracting a product into an
// FMA); exp, pow, log and erfc are CUDA's double-precision functions.
// With T = float (the float32 paths) radialValueF<PC>: every profile but
// the power-log and the complex ones, in float32, each constant rounded to
// float32 once on the host (nl/kernels.py Profile.rounded), as the JAX
// expressions round their Python floats against a float32 array; the
// tempering and the smooth two-point weight in float32 too.
template <int PC, typename T = double>
__device__ __forceinline__ T radial(T r2, const Profile& p);

// exp(-lam sqrt(r2)) times v in float32 (the tempering and the smooth
// two-point weight of a float32 node), lam rounded to float32 on the host.
__device__ __forceinline__ float temperF(float v, double lam, float r2) {
    return __fmul_rn(v, expf(__fmul_rn(-static_cast<float>(lam),
                                       sqrtf(r2))));
}

// The value of the profile PC at a float32 r2 > 0, before the tempering
// and the weight: the plain version's expressions (nl/kernels.py
// radialEval) on float32 tensors, each tensor operation a float; the
// scalar factors that the plain version forms from Python floats (C/a,
// 2a, a^2, C/2 sqrt(pi/a)) formed in float64 and rounded to float32 once.
template <int PC>
__device__ __forceinline__ float radialValueF(float r2, const Profile& p) {
    const float C = static_cast<float>(p.C);
    if constexpr (PC == PROFILE_POWER) {
        return __fmul_rn(C, powf(r2, static_cast<float>(p.e)));
    } else if constexpr (PC == PROFILE_GAUSSIAN) {
        return __fmul_rn(C, expf(__fmul_rn(-static_cast<float>(p.a), r2)));
    } else if constexpr (PC == PROFILE_EXPONENTIAL) {
        return __fmul_rn(C, expf(__fmul_rn(-static_cast<float>(p.a),
                                           sqrtf(r2))));
    } else if constexpr (PC == PROFILE_GAUSSIAN_B1) {
        const float k = __double2float_rn(__dmul_rn(
            __dmul_rn(p.C, 0.5), sqrt(__ddiv_rn(3.141592653589793, p.a))));
        const float sa = __double2float_rn(sqrt(p.a));
        return __fmul_rn(k, erfcf(__fmul_rn(sa, sqrtf(r2))));
    } else if constexpr (PC == PROFILE_GAUSSIAN_B2) {
        const float a2 = __double2float_rn(__dmul_rn(2.0, p.a));
        return __fdiv_rn(__fmul_rn(C, expf(__fmul_rn(-static_cast<float>(p.a),
                                                     r2))),
                         __fmul_rn(a2, sqrtf(r2)));
    } else if constexpr (PC == PROFILE_EXPONENTIAL_B1) {
        const float ca = __double2float_rn(__ddiv_rn(p.C, p.a));
        return __fmul_rn(ca, expf(__fmul_rn(-static_cast<float>(p.a),
                                            sqrtf(r2))));
    } else if constexpr (PC == PROFILE_EXPONENTIAL_B2) {
        const float r = sqrtf(r2);
        const float ia2 = __double2float_rn(__ddiv_rn(1.0,
                                                      __dmul_rn(p.a, p.a)));
        const float t = __fadd_rn(__fdiv_rn(r, static_cast<float>(p.a)),
                                  ia2);
        return __fdiv_rn(__fmul_rn(__fmul_rn(C, expf(__fmul_rn(
                             -static_cast<float>(p.a), r))), t), r);
    } else if constexpr (PC == PROFILE_LOG_INVERSE) {
        return __fmul_rn(C, logf(__fdiv_rn(1.0f, sqrtf(r2))));
    } else {
        static_assert(PC == PROFILE_POLYNOMIAL,
                      "float32: no power-log or complex profile");
        const float a2 = __double2float_rn(__dmul_rn(p.a, p.a));
        const float q = __fsub_rn(1.0f, __fdiv_rn(r2, a2));
        return __fmul_rn(C, __fmul_rn(q, q));
    }
}

template <int PC, typename T>
__device__ __forceinline__ T radial(T r2, const Profile& p) {
    if constexpr (IS_F32<T>) {
        if (!(r2 > 0.0f)) return 0.0f;
        float v = radialValueF<PC>(r2, p);
        if constexpr (PC == PROFILE_POWER) {
            if (p.t != 0.0) v = temperF(v, p.t, r2);
        }
        return p.wcode == TWO_POINT_TEMPERED ? temperF(v, p.wlam, r2) : v;
    } else {
        if (!(r2 > 0.0)) return 0.0;
        double v = radialValue<PC>(r2, p);
        if constexpr (PC == PROFILE_POWER || PC == PROFILE_POWER_LOG) {
            if (p.t != 0.0) v = temper(v, p.t, r2);
        }
        return twoPoint(v, r2, p);
    }
}

// p = c[n-1]; p = c[k] + t p for k = n-2 .. 0, each operation rounded on
// its own: the Horner order of the JAX expressions
// c0 + t*(c1 + t*(... + t*c[n-1])).
template <int NC>
__device__ __forceinline__ double hornerRN(double t, const double (&c)[NC]) {
    double p = c[NC - 1];
#pragma unroll
    for (int k = NC - 2; k >= 0; --k) p = __dadd_rn(c[k], __dmul_rn(t, p));
    return p;
}

// J0(x), Y0(x) for x > 0: pynucleus_tpu/nl/kernels.py _bessel_j0y0, the
// Abramowitz & Stegun 9.4.1-9.4.3 rational approximations (about 1e-7
// from the exact functions) with their coefficients, the 1e-30 floor, the
// series in t = (x/3)^2 for x <= 3 and the modulus and phase form beyond
// (u = 3/x, the JAX literal 0.78539816 for pi/4), each operation in the
// order of the JAX expression and of the plain version (nl/kernels.py
// besselJ0Y0), rounded on its own.  It is that approximation, not a better
// one: the port is held to the JAX program, not to the exact functions.
__device__ __forceinline__ void besselJ0Y0(double x, double& j0,
                                           double& y0) {
    const double xs = x > 1e-30 ? x : 1e-30;
    if (xs <= 3.0) {
        const double q = __ddiv_rn(xs, 3.0);
        const double t = __dmul_rn(q, q);
        const double cj[7] = {1.0, -2.2499997, 1.2656208, -0.3163866,
                              0.0444479, -0.0039444, 0.0002100};
        const double cy[7] = {0.36746691, 0.60559366, -0.74350384,
                              0.25300117, -0.04261214, 0.00427916,
                              -0.00024846};
        j0 = hornerRN(t, cj);
        // (2 / pi) as the Python float 2.0 / np.pi
        y0 = __dadd_rn(__dmul_rn(__dmul_rn(0.6366197723675814,
                                           log(__dmul_rn(0.5, xs))),
                                 j0),
                       hornerRN(t, cy));
    } else {
        const double u = __ddiv_rn(3.0, xs);
        const double cf[7] = {0.79788456, -0.00000077, -0.00552740,
                              -0.00009512, 0.00137237, -0.00072805,
                              0.00014476};
        const double ct[6] = {-0.04166397, -0.00003954, 0.00262573,
                              -0.00054125, -0.00029333, 0.00013558};
        const double f = hornerRN(u, cf);
        const double th = __dadd_rn(__dsub_rn(xs, 0.78539816),
                                    __dmul_rn(u, hornerRN(u, ct)));
        const double rsqrt = __ddiv_rn(1.0, sqrt(xs));
        j0 = __dmul_rn(__dmul_rn(f, cos(th)), rsqrt);
        y0 = __dmul_rn(__dmul_rn(f, sin(th)), rsqrt);
    }
}

// The complex profile PROFILE_GREENS_2D, C i H0^(1)(a r) = C (-Y0(a r) +
// i J0(a r)) as (re, im), exactly 0 at r2 == 0 as radial<PC>: the greens2D
// kernel of pynucleus_tpu/nl/kernels.py ComplexKernel._radialJax through
// _radial_eval, a the wavenumber -Im(greensLambda).
// The smooth two-point weight multiplies both parts (a complex value times
// a real weight).
__device__ __forceinline__ double2 radialC(double r2, const Profile& p) {
    if (!(r2 > 0.0)) return make_double2(0.0, 0.0);
    double j0, y0;
    besselJ0Y0(__dmul_rn(p.a, sqrt(r2)), j0, y0);
    return make_double2(twoPoint(__dmul_rn(p.C, -y0), r2, p),
                        twoPoint(__dmul_rn(p.C, j0), r2, p));
}

// Runs the statements ... with the compile-time constant PC equal to the
// runtime profile code `code`; an unknown code returns
// cudaErrorInvalidValue from the enclosing launcher.
#define PROFILE_CASE(P, ...) \
    case P: {                \
        constexpr int PC = P; \
        __VA_ARGS__;         \
    } break;
#define PROFILE_SWITCH(code, ...)                                   \
    switch (code) {                                                 \
        PROFILE_CASE(PROFILE_POWER, __VA_ARGS__)                    \
        PROFILE_CASE(PROFILE_GAUSSIAN, __VA_ARGS__)                 \
        PROFILE_CASE(PROFILE_EXPONENTIAL, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_GAUSSIAN_B1, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_GAUSSIAN_B2, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_EXPONENTIAL_B1, __VA_ARGS__)           \
        PROFILE_CASE(PROFILE_EXPONENTIAL_B2, __VA_ARGS__)           \
        PROFILE_CASE(PROFILE_POWER_LOG, __VA_ARGS__)                \
        PROFILE_CASE(PROFILE_LOG_INVERSE, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_POLYNOMIAL, __VA_ARGS__)               \
        default: return static_cast<int>(cudaErrorInvalidValue);    \
    }

// The float32 instances' profiles beside the power one (radialValueF):
// the smooth kernels of an infinite horizon with their boundary forms and
// the log-inverse-distance one (F32_SMOOTH_SWITCH), and the profiles of a
// finite horizon that K14 and K15 take, without the power one
// (F32_FINITE_SWITCH); an unknown code returns cudaErrorInvalidValue.
#define F32_FINITE_CASES(...)                                       \
    PROFILE_CASE(PROFILE_GAUSSIAN, __VA_ARGS__)                     \
    PROFILE_CASE(PROFILE_EXPONENTIAL, __VA_ARGS__)                  \
    PROFILE_CASE(PROFILE_LOG_INVERSE, __VA_ARGS__)                  \
    PROFILE_CASE(PROFILE_POLYNOMIAL, __VA_ARGS__)
#define F32_FINITE_SWITCH(code, ...)                                \
    switch (code) {                                                 \
        F32_FINITE_CASES(__VA_ARGS__)                               \
        default: return static_cast<int>(cudaErrorInvalidValue);    \
    }
#define F32_BOUNDARY_SWITCH(code, ...)                              \
    switch (code) {                                                 \
        PROFILE_CASE(PROFILE_GAUSSIAN_B1, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_GAUSSIAN_B2, __VA_ARGS__)              \
        PROFILE_CASE(PROFILE_EXPONENTIAL_B1, __VA_ARGS__)           \
        PROFILE_CASE(PROFILE_EXPONENTIAL_B2, __VA_ARGS__)           \
        default: return static_cast<int>(cudaErrorInvalidValue);    \
    }

// A variable fractional order (pynucleus_tpu_torch/nl/kernels.py
// OrderParams and its codes): ORDER_NONE, the kernel is its radial profile;
// ORDER_CONST, s(x, y) = sll; ORDER_LEFT_RIGHT, sll / srr / slr / srl by
// the sides x[0] < interface and y[0] < interface (strict, as
// pynucleus_tpu/nl/kernels.py leftRightFractionalOrder.jaxEval).  piD2 =
// pi^(d/2), halfDim = d/2 and eBase (-d/2, or (1-d)/2 for the boundary
// kernel) are the host values of the JAX expression's Python floats.
// The orders of position (the codes from ORDER_INNER_OUTER on:
// pynucleus_tpu/nl/kernels.py:206-475, their jaxEval) also take the point
// dimension xdim, up to four host constants g0-g3 (OrderParams.g, formed
// from Python floats as the JAX expressions form them) and a table of n
// (layers: its n - 1 inner boundaries, then its [n, n] orders; fe: its
// raster [n] or [n, n]) with fe's box lo, hi:
//   ORDER_INNER_OUTER   x in iff |x - (g0, g1)|^2 < g2 (= r^2), strict;
//                       sll (sii) in-in, srr (soo) out-out, slr (sio) x
//                       in, srl (soi) y in
//   ORDER_ISLANDS       x in iff g0 <= |x_d| <= g1 for every d; as above
//   ORDER_LAYERS        the layer of x[xdim-1]: the count of boundaries
//                       <= it (searchsorted, side 'right'); orders[I, J]
//   ORDER_SMOOTHED_LR   t = (x[0] - g0) g1 + 0.5 clipped to [0, 1],
//                       sll + (srr - sll) (3 t^2 - 2 t (t t))
//   ORDER_LINEAR_LR     t = ((x[0] - g0) + g1) / g2 clipped, sll + (srr -
//                       sll) t
//   ORDER_SMOOTHED_IO   t = (sqrt(sum_d x_d^2) - g0) g1 + 0.5, then as
//                       ORDER_SMOOTHED_LR
//   ORDER_FE            t_d = clip((x_d - lo_d) / (hi_d - lo_d)) (n - 1),
//                       i_d = clamp(floor(t_d), 0, n - 2), f_d = t_d - i_d;
//                       the raster interpolated linearly (bilinearly in
//                       2D, the JAX expression's four terms summed in
//                       order)
// Each comparison is the JAX expression's (a value on a branch point takes
// the JAX package's branch) and each operation is rounded on its own.
// ORDER_COMPONENT is component q of a vector s-derivative kernel of a
// leftRight order (nl/kernels.py _ComponentFractionalKernel): table holds
// per side (0 ll, 1 rr, 2 lr, 3 rl; left is x[0] < interface) the row
// (c0, c1, c2, b, c, e, G_q) of COMPONENT_ROW doubles (componentTerm
// below); with a singular rule's log tables lnEta, cw1 and cw2 [Q] (set by
// the entry points that take them, else null) K1 and K19 add the rule's
// log correction per node.
enum OrderCode {
    ORDER_NONE = 0,
    ORDER_CONST = 1,
    ORDER_LEFT_RIGHT = 2,
    ORDER_INNER_OUTER = 3,
    ORDER_ISLANDS = 4,
    ORDER_LAYERS = 5,
    ORDER_SMOOTHED_LR = 6,
    ORDER_LINEAR_LR = 7,
    ORDER_SMOOTHED_IO = 8,
    ORDER_FE = 9,
    ORDER_COMPONENT = 10
};

constexpr int COMPONENT_ROW = 7;

struct Order {
    int code;
    double sll, srr, slr, srl, interface;
    double piD2, halfDim, eBase;
    int boundary;
    // the orders of position
    int xdim;
    double g0, g1, g2, g3;
    const double* table;
    int n;
    double lo0, lo1, hi0, hi1;
    // the singular rule's log tables of a component order (null: none)
    const double *lnEta, *cw1, *cw2;
};

// Every entry point that takes an order takes a whole Order
// (nl/kernels.py orderArgs).
#define ORDER_PARAMS                                                      \
    int ocode, double sll, double srr, double slr, double srl,           \
        double iface, double piD2, double halfDim, double eBase,         \
        int boundary, int xdim, double g0, double g1, double g2,         \
        double g3, const double* table, int tn, double lo0, double lo1,  \
        double hi0, double hi1
#define ORDER_OF                                                          \
    Order{ocode, sll, srr, slr, srl, iface, piD2, halfDim, eBase,        \
          boundary, xdim, g0, g1, g2, g3, table, tn, lo0, lo1, hi0, hi1}

// A whole Order (ORDER_OF) with a singular rule's log tables le, c1, c2
// [Q] (null: none; the entry points of K1's dense and tree targets and of
// K19 take them, nl/assembly.py _logArgs).
#define ORDER_WITH_LOGS(le, c1, c2)                                        \
    [&] {                                                                  \
        Order o_ = ORDER_OF;                                               \
        o_.lnEta = (le);                                                   \
        o_.cw1 = (c1);                                                     \
        o_.cw2 = (c2);                                                     \
        return o_;                                                         \
    }()

// sll where x and y are in, srr where both are out, slr / srl across (x
// in / y in): the jnp.where nest of innerOuter, islands and leftRight.
__device__ __forceinline__ double mixedOrder(bool xi, bool yi,
                                             const Order& o) {
    return (xi && yi) ? o.sll : ((!xi && !yi) ? o.srr : (xi ? o.slr : o.srl));
}

// sum_d (x_d - c_d)^2 over the xdim coordinates (c = 0 where center is
// false), in order from d = 0.
__device__ __forceinline__ double sumSquares(const double* x, const Order& o,
                                             bool center) {
    double r2 = 0.0;
    for (int d = 0; d < o.xdim; ++d) {
        const double dd =
            center ? __dsub_rn(x[d], d == 0 ? o.g0 : o.g1) : x[d];
        r2 = __dadd_rn(r2, __dmul_rn(dd, dd));
    }
    return r2;
}

// sll + (srr - sll) * (3 t^2 - 2 t^3) of t clipped to [0, 1], t^3 as
// t (t t) (lax.integer_pow's order).
__device__ __forceinline__ double smoothOrder(double t, const Order& o) {
    t = fmin(fmax(t, 0.0), 1.0);
    const double t2 = __dmul_rn(t, t);
    const double ss = __dsub_rn(__dmul_rn(3.0, t2),
                                __dmul_rn(2.0, __dmul_rn(t, t2)));
    return __dadd_rn(o.sll, __dmul_rn(__dsub_rn(o.srr, o.sll), ss));
}

// The layer of the last coordinate c: the number of inner boundaries
// (sorted) that are <= c.
__device__ __forceinline__ int layerOf(const double* x, const Order& o) {
    const double c = x[o.xdim - 1];
    int idx = 0;
    for (int k = 0; k < o.n - 1; ++k) idx += o.table[k] <= c;
    return idx;
}

// fe's raster at x (feFractionalOrder.jaxEval).
__device__ __forceinline__ double feRaster(const double* x, const Order& o) {
    const double lo[2] = {o.lo0, o.lo1}, hi[2] = {o.hi0, o.hi1};
    double f[2];
    int i[2];
    for (int d = 0; d < o.xdim; ++d) {
        const double u = fmin(
            fmax(__ddiv_rn(__dsub_rn(x[d], lo[d]), __dsub_rn(hi[d], lo[d])),
                 0.0),
            1.0);
        const double t = __dmul_rn(u, (double)(o.n - 1));
        i[d] = min(max((int)floor(t), 0), o.n - 2);
        f[d] = __dsub_rn(t, (double)i[d]);
    }
    const double* g = o.table;
    if (o.xdim == 1)
        return __dadd_rn(__dmul_rn(__dsub_rn(1.0, f[0]), g[i[0]]),
                         __dmul_rn(f[0], g[i[0] + 1]));
    const long long n = o.n, a = i[0] * n + i[1], b = (i[0] + 1) * n + i[1];
    const double fx = f[0], fy = f[1];
    const double gx = __dsub_rn(1.0, fx), gy = __dsub_rn(1.0, fy);
    double v = __dmul_rn(__dmul_rn(gx, gy), g[a]);
    v = __dadd_rn(v, __dmul_rn(__dmul_rn(fx, gy), g[b]));
    v = __dadd_rn(v, __dmul_rn(__dmul_rn(gx, fy), g[a + 1]));
    return __dadd_rn(v, __dmul_rn(__dmul_rn(fx, fy), g[b + 1]));
}

// The side of a node pair of a leftRight order or of a vector kernel: 0
// ll, 1 rr, 2 lr, 3 rl (left is x[0] < iface, strict).
__device__ __forceinline__ int vecSide(const double* x, const double* y,
                                       double iface) {
    const bool xl = x[0] < iface, yl = y[0] < iface;
    return (xl && yl) ? 0 : ((!xl && !yl) ? 1 : (xl ? 2 : 3));
}

// The scalar factor of a vector kernel's node pair at r2 > 0 on the side
// whose row is cf = (c0, c1, c2, b, c, e), with rad = r2^e and L = ln r2:
//   t = rad (c0 + c1 L + c2 L^2) wq
//       (+ cw1_q (b rad + 2 c rad lnR) + cw2_q c rad,  lnR = L/2 - lnEta_q)
// the log correction of a singular rule (pynucleus_tpu/nl/assembly.py
// _log_extra_scalar) where lnEta is not null.  Every operation is the plain
// versions' (nl/kernels.py vectorTerms, nl/assembly.py _vecNodeTerms and
// nl/kernels.py logExtra) in their order, rounded on its own.  K21 and K22
// multiply it by volsym and the component's gradient entry, K1, K19 and K7
// (componentTerm) by the gradient entry.
__device__ __forceinline__ double vecTermCore(double r2, const double* cf,
                                              double wq, const double* lnEta,
                                              const double* cw1,
                                              const double* cw2, int q) {
    const double rad = pow(r2, cf[5]);
    const double L = log(r2);
    const double val = __dmul_rn(
        rad, __dadd_rn(__dadd_rn(cf[0], __dmul_rn(cf[1], L)),
                       __dmul_rn(cf[2], __dmul_rn(L, L))));
    double t = __dmul_rn(val, wq);
    if (lnEta != nullptr) {
        const double b = __dmul_rn(cf[3], rad), c = __dmul_rn(cf[4], rad);
        const double lnR = __dsub_rn(__dmul_rn(0.5, L), lnEta[q]);
        t = __dadd_rn(
            t, __dadd_rn(__dmul_rn(cw1[q],
                                   __dadd_rn(b, __dmul_rn(__dmul_rn(2.0, c),
                                                          lnR))),
                         __dmul_rn(cw2[q], c)));
    }
    return t;
}

// The component order's t_q at the node pair (x, y), exactly 0 at r2 == 0:
// G_q vecTermCore with the side's row of o.table, the log correction where
// ``useLog`` and the order carries log tables.  G_q is 0 or 1 (ds/dp_q of
// the leftRight order), so this is the JAX program's gamma_q w_q + cw1_q
// (b_q + 2 c_q lnR_q) + cw2_q c_q with gamma_q, b_q, c_q the parent's
// column q, rounded alike (nl/kernels.py componentTerms and logExtra).
__device__ __forceinline__ double componentTerm(double r2, const double* x,
                                                const double* y,
                                                const Order& o, double wq,
                                                int q, bool useLog) {
    if (!(r2 > 0.0)) return 0.0;
    const double* cf = o.table + vecSide(x, y, o.interface) * COMPONENT_ROW;
    const bool lg = useLog && o.lnEta != nullptr;
    return __dmul_rn(vecTermCore(r2, cf, wq, lg ? o.lnEta : nullptr, o.cw1,
                                 o.cw2, q),
                     cf[6]);
}

template <int OC>
__device__ __forceinline__ double orderAt(const double* x, const double* y,
                                          const Order& o) {
    if constexpr (OC == ORDER_CONST) {
        return o.sll;
    } else if constexpr (OC == ORDER_LEFT_RIGHT) {
        return mixedOrder(x[0] < o.interface, y[0] < o.interface, o);
    } else if constexpr (OC == ORDER_INNER_OUTER) {
        return mixedOrder(sumSquares(x, o, true) < o.g2,
                          sumSquares(y, o, true) < o.g2, o);
    } else if constexpr (OC == ORDER_ISLANDS) {
        bool xi = true, yi = true;
        for (int d = 0; d < o.xdim; ++d) {
            const double px = fabs(x[d]), py = fabs(y[d]);
            xi = xi && px >= o.g0 && px <= o.g1;
            yi = yi && py >= o.g0 && py <= o.g1;
        }
        return mixedOrder(xi, yi, o);
    } else if constexpr (OC == ORDER_LAYERS) {
        return o.table[o.n - 1 + layerOf(x, o) * o.n + layerOf(y, o)];
    } else if constexpr (OC == ORDER_SMOOTHED_LR) {
        return smoothOrder(
            __dadd_rn(__dmul_rn(__dsub_rn(x[0], o.g0), o.g1), 0.5), o);
    } else if constexpr (OC == ORDER_LINEAR_LR) {
        const double t = fmin(
            fmax(__ddiv_rn(__dadd_rn(__dsub_rn(x[0], o.g0), o.g1), o.g2),
                 0.0),
            1.0);
        return __dadd_rn(o.sll, __dmul_rn(__dsub_rn(o.srr, o.sll), t));
    } else if constexpr (OC == ORDER_SMOOTHED_IO) {
        const double rr = sqrt(sumSquares(x, o, false));
        return smoothOrder(__dadd_rn(__dmul_rn(__dsub_rn(rr, o.g0), o.g1),
                                     0.5),
                           o);
    } else {
        static_assert(OC == ORDER_FE, "unknown order code");
        return feRaster(x, o);
    }
}

// gamma(x, y) at r2 = |x-y|^2, exactly 0 at r2 == 0: the radial profile PC
// (radial<PC>) for OC == ORDER_NONE, a component order's value
// (componentTerm) for ORDER_COMPONENT, else the variable-order fractional
// kernel of pynucleus_tpu/nl/kernels.py FractionalKernel.evalXY (infinite
// horizon) with s = s(x, y):
//   C = 2^(2s) s / pi^(d/2) * 0.5 * exp(lgamma(s + d/2) - lgamma(1 - s))
//   gamma = C r2^(-d/2 - s)   or  (C/s) r2^((1-d)/2 - s)  (boundary kernel)
// times the smooth two-point weight (twoPoint);
// each operation in the plain version's order (nl/kernels.py evalXY),
// rounded on its own; pow, exp and lgamma are CUDA's double functions.
template <int PC, int OC>
__device__ __forceinline__ double kernelXY(double r2, const double* x,
                                           const double* y, const Profile& p,
                                           const Order& o) {
    if constexpr (OC == ORDER_NONE) {
        return radial<PC>(r2, p);
    } else if constexpr (OC == ORDER_COMPONENT) {
        // the component's value (its log correction is K1's and K19's)
        return componentTerm(r2, x, y, o, 1.0, 0, false);
    } else {
        if (!(r2 > 0.0)) return 0.0;
        const double s = orderAt<OC>(x, y, o);
        const double C = __dmul_rn(
            __dmul_rn(__ddiv_rn(__dmul_rn(pow(2.0, __dmul_rn(2.0, s)), s),
                                o.piD2),
                      0.5),
            exp(__dsub_rn(lgamma(__dadd_rn(s, o.halfDim)),
                          lgamma(__dsub_rn(1.0, s)))));
        const double rp = pow(r2, __dsub_rn(o.eBase, s));
        return twoPoint(o.boundary ? __dmul_rn(__ddiv_rn(C, s), rp)
                                   : __dmul_rn(C, rp),
                        r2, p);
    }
}

// Runs the statements ... with the compile-time constants PC (profile) and
// OC (order) equal to the runtime codes: every profile without an order,
// the power profile with each variable order (a variable order is a
// fractional kernel); anything else returns cudaErrorInvalidValue from the
// enclosing launcher.
#define KERNEL_SWITCH(pcode, ocode, ...)                                  \
    if ((ocode) == ORDER_NONE) {                                          \
        constexpr int OC = ORDER_NONE;                                    \
        PROFILE_SWITCH(pcode, __VA_ARGS__)                                \
    } else if ((ocode) == ORDER_CONST && (pcode) == PROFILE_POWER) {      \
        constexpr int OC = ORDER_CONST;                                   \
        constexpr int PC = PROFILE_POWER;                                 \
        __VA_ARGS__;                                                      \
    } else if ((ocode) == ORDER_LEFT_RIGHT && (pcode) == PROFILE_POWER) { \
        constexpr int OC = ORDER_LEFT_RIGHT;                              \
        constexpr int PC = PROFILE_POWER;                                 \
        __VA_ARGS__;                                                      \
    } else {                                                              \
        return static_cast<int>(cudaErrorInvalidValue);                   \
    }

// Runs the statements ... with PC = PROFILE_POWER and the compile-time
// constant OC equal to the runtime code of an order of position or of the
// component order (a variable order is a fractional kernel); a profile
// other than the power profile or another order code returns
// cudaErrorInvalidValue.  POSITION_ORDER_SWITCH has every one of them, for
// the dense targets of K1 and K19 (panel_scatter_order.cu,
// panel_scatter_nonsym_order.cu); H2_ORDER_SWITCH those whose H2 operator
// the JAX package builds on the interval (innerOuter, islands, layers, fe)
// and the component order, for the H2 targets: K1's tree target, K19's
// slot target (panel_scatter_order_h2.cu, panel_scatter_nonsym_order_h2.cu)
// and K7 (far_field.cu).  The entry points reach them by the code;
// KERNEL_SWITCH refuses these codes.
#define POSITION_ORDER_CASE(O, ...)         \
    case O: {                                \
        constexpr int OC = O;                \
        constexpr int PC = PROFILE_POWER;    \
        __VA_ARGS__;                         \
    } break;
#define POSITION_ORDER_SWITCH(pcode, ocode, ...)                       \
    if ((pcode) != PROFILE_POWER)                                     \
        return static_cast<int>(cudaErrorInvalidValue);               \
    switch (ocode) {                                                  \
        POSITION_ORDER_CASE(ORDER_INNER_OUTER, __VA_ARGS__)           \
        POSITION_ORDER_CASE(ORDER_ISLANDS, __VA_ARGS__)               \
        POSITION_ORDER_CASE(ORDER_LAYERS, __VA_ARGS__)                \
        POSITION_ORDER_CASE(ORDER_SMOOTHED_LR, __VA_ARGS__)           \
        POSITION_ORDER_CASE(ORDER_LINEAR_LR, __VA_ARGS__)             \
        POSITION_ORDER_CASE(ORDER_SMOOTHED_IO, __VA_ARGS__)           \
        POSITION_ORDER_CASE(ORDER_FE, __VA_ARGS__)                    \
        POSITION_ORDER_CASE(ORDER_COMPONENT, __VA_ARGS__)             \
        default: return static_cast<int>(cudaErrorInvalidValue);      \
    }
#define H2_ORDER_SWITCH(pcode, ocode, ...)                             \
    if ((pcode) != PROFILE_POWER)                                     \
        return static_cast<int>(cudaErrorInvalidValue);               \
    switch (ocode) {                                                  \
        POSITION_ORDER_CASE(ORDER_INNER_OUTER, __VA_ARGS__)           \
        POSITION_ORDER_CASE(ORDER_ISLANDS, __VA_ARGS__)               \
        POSITION_ORDER_CASE(ORDER_LAYERS, __VA_ARGS__)                \
        POSITION_ORDER_CASE(ORDER_FE, __VA_ARGS__)                    \
        POSITION_ORDER_CASE(ORDER_COMPONENT, __VA_ARGS__)             \
        default: return static_cast<int>(cudaErrorInvalidValue);      \
    }

template <typename T>
__device__ __forceinline__ T warpSum(T v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

// Largest dimension and simplex vertex count the kernels take (triangles
// in 2D; tetrahedra would need 4).
constexpr int MAXDIM = 3;
constexpr int MAXNV = 3;

// v[a][d] = vertices[vid[a], d] for the nv vertex ids of one simplex
// (int64 or int32 ids; float64 or float32 coordinates).
template <typename Idx, typename T>
__device__ __forceinline__ void loadSimplex(
    T v[MAXNV][MAXDIM], const NoDeduce<T>* __restrict__ vertices,
    const Idx* vid, int nv, int dim) {
    for (int a = 0; a < nv; ++a)
        for (int d = 0; d < dim; ++d)
            v[a][d] = vertices[(long long)vid[a] * dim + d];
}

// ---- the near field's element rules, shared by K5, K11 and K12 ----------
//
// An element is a cell pair (a, b), a from the cell list of cluster node I,
// b from that of J (pynucleus_tpu/nl/assembly.py:_enum_elem_key and
// _block_mask_order).  It is quadrature work of the distant engines iff
//   a != b, the cells share no vertex (the singular path owns those), and
//   a < b where the pair is also enumerated the other way round (b has a
//   dof of node I and a one of node J).
// cells [C, nv] and cellNodes [C, dpe] (node of each local dof, -1 if
// none) are int32.
__device__ __forceinline__ bool nearValid(const int* __restrict__ cells,
                                          int nv,
                                          const int* __restrict__ cellNodes,
                                          int dpe, int a, int b, int I,
                                          int J) {
    if (a == b) return false;
    bool share = false;
    for (int i = 0; i < nv; ++i)
        for (int j = 0; j < nv; ++j)
            share |= cells[a * nv + i] == cells[b * nv + j];
    if (share) return false;
    bool bInI = false, aInJ = false;
    for (int i = 0; i < dpe; ++i) {
        bInI |= cellNodes[b * dpe + i] == I;
        aInJ |= cellNodes[a * dpe + i] == J;
    }
    return !(bInI && aInJ) || a < b;
}

// Order models of pynucleus_tpu/nl/panels.py:distantOrders in float32,
// snapped as _enum_elem_key does (even; (8,16] -> 16; > 16 -> multiple of 8).
// centers [dim, C] and logh [C] float32; (s, c, lH0) the model's constants
// (in 1D s is sval).  dim 2 (pynucleus_tpu/nl/assembly.py:1259-1268):
//   o1 = ceil((c + (s-1) l2 + max(l1, l2) - s ldh2) / (max(ldh1, 0) + 0.4))
// dim 1 (:1248-1257):
//   o1 = ceil((c + (2s-1) l2 - 2s ldh2) / (max(ldh1, 0) + 0.8))
// with li = |log h_i - lH0|, ldhi = log d - log h_i, and o2 the same with
// 1 and 2 swapped.  Each step rounds as the plain PyTorch versions'
// separate operations do: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn keep
// nvcc from contracting into FMAs, and logf (not __logf) is the accurate
// log that torch.log uses on the card.  Otherwise an order whose ceil sits
// on an integer could land in another quadrature bucket, or in the other
// near-field engine.
__device__ __forceinline__ int orderKey(const float* __restrict__ centers,
                                        int dim, int C,
                                        const float* __restrict__ logh,
                                        int a, int b, float s, float c,
                                        float lH0) {
    const float dx = __fsub_rn(centers[a], centers[b]);
    float r2c = __fmul_rn(dx, dx);
    if (dim == 2) {
        const float dy = __fsub_rn(centers[C + a], centers[C + b]);
        r2c = __fadd_rn(r2c, __fmul_rn(dy, dy));
    }
    const float logd = __fmul_rn(0.5f, logf(fmaxf(r2c, 1e-38f)));
    const float lh1 = logh[a], lh2 = logh[b];
    const float ldh1 = __fsub_rn(logd, lh1), ldh2 = __fsub_rn(logd, lh2);
    const float l1 = fabsf(__fsub_rn(lh1, lH0));
    const float l2 = fabsf(__fsub_rn(lh2, lH0));
    float num1, num2, den;
    if (dim == 1) {
        const float s2 = __fmul_rn(s, 2.0f);
        const float s2m1 = __fsub_rn(s2, 1.0f);
        num1 = __fsub_rn(__fadd_rn(c, __fmul_rn(s2m1, l2)),
                         __fmul_rn(s2, ldh2));
        num2 = __fsub_rn(__fadd_rn(c, __fmul_rn(s2m1, l1)),
                         __fmul_rn(s2, ldh1));
        den = 0.8f;
    } else {
        const float lmin = fmaxf(l1, l2);
        const float sm1 = __fsub_rn(s, 1.0f);
        num1 = __fsub_rn(__fadd_rn(__fadd_rn(c, __fmul_rn(sm1, l2)), lmin),
                         __fmul_rn(s, ldh2));
        num2 = __fsub_rn(__fadd_rn(__fadd_rn(c, __fmul_rn(sm1, l1)), lmin),
                         __fmul_rn(s, ldh1));
        den = 0.4f;
    }
    const float o1 = ceilf(__fdiv_rn(num1, __fadd_rn(fmaxf(ldh1, 0.0f), den)));
    const float o2 = ceilf(__fdiv_rn(num2, __fadd_rn(fmaxf(ldh2, 0.0f), den)));
    const float of = fminf(fmaxf(fmaxf(fmaxf(o1, o2), 2.0f), 2.0f), 120.0f);
    int o = static_cast<int>(of);
    o = ((o + 1) / 2) * 2;
    if (o > 16) o = ((o + 7) / 8) * 8;
    if (o > 8 && o <= 16) o = 16;
    return o;
}

// Per-cluster-pair element tables of the near-field enumeration (int32):
// the cell lists of the near nodes (ncArr), the mesh and the order model.
struct EnumTables {
    const int* ncArr;      // concatenated per-node cell lists
    const int* cells;      // [C, nv]
    int nv;
    const int* cellNodes;  // [C, dpe]
    int dpe;
    const float* centers;  // [dim, C]
    int dim;               // 1 or 2: the order model
    int C;
    const float* logh;     // [C]
    float s, c, lH0;
};

// Largest (negative) dof code that is a boundary dof -d-1 and not DROP:
// DROP is int32 min // 2 (pynucleus_tpu/nl/assembly.py), and a cross-target
// column c is kept iff DROP_HALF < c < 0, as BCAccumulator.add does.
constexpr long long DROP_HALF = -536870912LL;

// Interaction indicator of a finite horizon at one node pair
// (pynucleus_tpu/nl/kernels.py jaxIndicator; pynucleus_tpu_torch/nl/
// kernels.py Indicator and indicatorMask): code 1 ball2, |x-y|^2 < h2;
// code 2 ballInf, max_d |x_d-y_d|^2 < h2; code 3 ball1, (sum_d |x_d-y_d|)^2
// < h2; code 4 the ellipse (2D), |T (x-y)|^2 < h2 with T = [[t00, t01],
// [t10, t11]] in the order of jnp.einsum('ij,...j') (t_i0 d_0, then
// + t_i1 d_1); code 5 the complement of ball2, !(|x-y|^2 < h2) (a
// complement kernel: pynucleus_tpu/nl/kernels.py ball2Complement
// .jaxIndicator, r2 >= h2); code 0 the full space.  Every product and sum
// rounds on its own (no FMA), as the plain versions' operations do.
struct Inter {
    int code;
    double h2;
    double t00, t01, t10, t11;
};

__device__ __forceinline__ bool inBall(const Inter& in, const double* x,
                                       const double* y, int dim) {
    if (in.code == 0) return true;
    if (in.code == 4) {
        const double d0 = __dsub_rn(x[0], y[0]), d1 = __dsub_rn(x[1], y[1]);
        const double a = __dadd_rn(__dmul_rn(in.t00, d0),
                                   __dmul_rn(in.t01, d1));
        const double b = __dadd_rn(__dmul_rn(in.t10, d0),
                                   __dmul_rn(in.t11, d1));
        return __dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)) < in.h2;
    }
    double r2 = 0.0, m = 0.0, l1 = 0.0;
    for (int d = 0; d < dim; ++d) {
        const double dd = __dsub_rn(x[d], y[d]);
        r2 = __dadd_rn(r2, __dmul_rn(dd, dd));
        m = fmax(m, fabs(dd));
        l1 = __dadd_rn(l1, fabs(dd));
    }
    if (in.code == 1) return r2 < in.h2;
    if (in.code == 5) return !(r2 < in.h2);
    if (in.code == 2) return __dmul_rn(m, m) < in.h2;
    return __dmul_rn(l1, l1) < in.h2;
}

// The indicator at float32 nodes (K1's float32 instances on the float32
// sparse path and getDiagonal): the JAX float32 program's jaxIndicator,
// the differences, squares and sums in float32 against h2 rounded once to
// float32 (the Python float horizon ** 2 against a float32 array); the
// ellipse's T is a float64 array there, so its products and sums run in
// float64 on the float32 differences, against h2 in float64.
__device__ __forceinline__ bool inBall(const Inter& in, const float* x,
                                       const float* y, int dim) {
    if (in.code == 0) return true;
    if (in.code == 4) {
        const double d0 = __fsub_rn(x[0], y[0]), d1 = __fsub_rn(x[1], y[1]);
        const double a = __dadd_rn(__dmul_rn(in.t00, d0),
                                   __dmul_rn(in.t01, d1));
        const double b = __dadd_rn(__dmul_rn(in.t10, d0),
                                   __dmul_rn(in.t11, d1));
        return __dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)) < in.h2;
    }
    float r2 = 0.0f, m = 0.0f, l1 = 0.0f;
    for (int d = 0; d < dim; ++d) {
        const float dd = __fsub_rn(x[d], y[d]);
        r2 = __fadd_rn(r2, __fmul_rn(dd, dd));
        m = fmaxf(m, fabsf(dd));
        l1 = __fadd_rn(l1, fabsf(dd));
    }
    const float h2 = __double2float_rn(in.h2);
    if (in.code == 1) return r2 < h2;
    if (in.code == 5) return !(r2 < h2);
    if (in.code == 2) return __fmul_rn(m, m) < h2;
    return __fmul_rn(l1, l1) < h2;
}

// Quadrature node q of a pair: x_q = sum_a bary_x[a,q] v1[a] and y_q =
// sum_a bary_y[a,q] v2[a] (+ ysh [dim], or nullptr) into x, y [dim];
// returns r2 = |x_q - y_q|^2.  The node geometry of K1 (panelQuad) and K19,
// K21, K22.  The vertex sums run in order from a = 0 with the rounding
// stated here, whatever -fmad the file is built with: FMA, x = fma(b_a,
// v_a, x), one rounding per term (K1, K6, K12, K13, K19), as the JAX
// package's einsum rounds them on the CPU and the plain versions'
// nl/assembly.py _fmaNodes does; this decides the complement indicator at
// nodes exactly delta apart.  Without FMA, x = x + b_a v_a, the product and
// the sum each rounded (K21, K22, as nl/assembly.py _nodesInOrder).  In
// float32 (T = float, K1's float32 instances) the same sums with __fmaf_rn.
template <bool FMA = true, typename T>
__device__ __forceinline__ T panelNode(
    T x[MAXDIM], NoDeduce<T> y[MAXDIM], NoDeduce<T> v1[MAXNV][MAXDIM],
    int nv1, NoDeduce<T> v2[MAXNV][MAXDIM], int nv2, int dim,
    const NoDeduce<T>* __restrict__ bary_x,
    const NoDeduce<T>* __restrict__ bary_y, int Q, int q,
    const NoDeduce<T>* ysh) {
    T r2 = 0;
    for (int d = 0; d < dim; ++d) {
        T xd = 0, yd = 0;
        for (int a = 0; a < nv1; ++a)
            xd = FMA ? fmaRN(bary_x[a * Q + q], v1[a][d], xd)
                     : addRN(xd, mulRN(bary_x[a * Q + q], v1[a][d]));
        for (int a = 0; a < nv2; ++a)
            yd = FMA ? fmaRN(bary_y[a * Q + q], v2[a][d], yd)
                     : addRN(yd, mulRN(bary_y[a * Q + q], v2[a][d]));
        if (ysh != nullptr) yd = addRN(yd, ysh[d]);
        x[d] = xd;
        y[d] = yd;
        const T dd = xd - yd;
        r2 += dd * dd;
    }
    return r2;
}

// K1's quadrature body, shared by its scatter targets and by K6, K12 and
// K13:
// lanes lane, lane+nl, ... of the pair's Q nodes accumulate
//   x_q = sum_v bary_x[v,q] v1[v],  y_q = sum_v bary_y[v,q] v2[v] (+ ysh)
//   t_q = gamma(x_q, y_q) w_q (+ a component order's log correction,
//         componentTerm) (* n.(y_q-x_q)/|y_q-x_q|)
//         (* chi(x_q, y_q) for a finite horizon, in.code != 0) volsym
//   acc[k] += t_q PSIP[q, k]
// (acc zeroed here); the caller reduces across its nl lanes.  gamma is
// kernelXY<PC, OC>: the radial profile, or a variable order's kernel;
// ysh [dim] (or nullptr) shifts the y nodes of a variable-order surface
// item to one side of an order jump.  The complex profile
// PROFILE_GREENS_2D (radialC) keeps the real parts of t_q and M in acc and
// the imaginary ones in acci [NN] (no normals, no order, no shift).  The
// scalar type T is acc's: in float32 (K1's float32 instances) every value
// is a float, gamma the power profile's radial<PC, float> with no order
// (the host refuses one in float32), the indicator of a finite horizon the
// float32 inBall.
template <int NN, int PC, int OC = ORDER_NONE, typename T>
__device__ __forceinline__ void panelQuad(
    T acc[NN], NoDeduce<T> v1[MAXNV][MAXDIM], int nv1,
    NoDeduce<T> v2[MAXNV][MAXDIM], int nv2, int dim,
    const NoDeduce<T>* nrm /* [dim] or nullptr */, NoDeduce<T> vs,
    const NoDeduce<T>* __restrict__ bary_x,
    const NoDeduce<T>* __restrict__ bary_y,
    const NoDeduce<T>* __restrict__ w, const NoDeduce<T>* __restrict__ PSIP,
    int Q, const Profile& pf, int lane, int nl, const Inter in = Inter{},
    const Order od = Order{}, const NoDeduce<T>* ysh = nullptr,
    NoDeduce<T>* acci = nullptr) {
#pragma unroll
    for (int k = 0; k < NN; ++k) acc[k] = 0;
    if constexpr (PC == PROFILE_GREENS_2D) {
        static_assert(!IS_F32<T>, "the complex profile is float64");
#pragma unroll
        for (int k = 0; k < NN; ++k) acci[k] = 0.0;
        for (int q = lane; q < Q; q += nl) {
            double x[MAXDIM], y[MAXDIM];
            const double r2 = panelNode(x, y, v1, nv1, v2, nv2, dim, bary_x,
                                        bary_y, Q, q, nullptr);
            const double2 g = radialC(r2, pf);
            double tr = g.x * w[q], ti = g.y * w[q];
            if (!inBall(in, x, y, dim)) tr = ti = 0.0;
            tr *= vs;
            ti *= vs;
            const double* ps = PSIP + (long long)q * NN;
#pragma unroll
            for (int k = 0; k < NN; ++k) {
                const double c = __ldg(ps + k);
                acc[k] += tr * c;
                acci[k] += ti * c;
            }
        }
    } else {
        for (int q = lane; q < Q; q += nl) {
            T x[MAXDIM], y[MAXDIM];
            const T r2 = panelNode(x, y, v1, nv1, v2, nv2, dim, bary_x,
                                   bary_y, Q, q, ysh);
            T t;
            if constexpr (IS_F32<T>) {
                static_assert(OC == ORDER_NONE, "float32: no variable order");
                t = radial<PC>(r2, pf) * w[q];
            } else if constexpr (OC == ORDER_COMPONENT) {
                t = componentTerm(r2, x, y, od, w[q], q, true);
            } else {
                t = kernelXY<PC, OC>(r2, x, y, pf, od) * w[q];
            }
            if (!inBall(in, x, y, dim)) t = 0;
            if (nrm != nullptr) {
                T fac = 0;
                if (r2 > 0) {
                    for (int d = 0; d < dim; ++d)
                        fac += nrm[d] * (y[d] - x[d]);
                    fac /= sqrtT(r2);
                }
                t *= fac;
            }
            t *= vs;
            const T* ps = PSIP + (long long)q * NN;
#pragma unroll
            for (int k = 0; k < NN; ++k) acc[k] += t * __ldg(ps + k);
        }
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
// entry k.  Slots outside [0, nnz) are skipped.  T is the data's type
// (float64, or float32 on the float32 H2 path).
template <int NPSI, typename T>
__device__ __forceinline__ void treeScatter(T* __restrict__ data,
                                            long long nnz, const TreeTables& tt,
                                            const long long dr[NPSI], int I,
                                            int J, int offF, int offB,
                                            const NoDeduce<T>* acc,
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
