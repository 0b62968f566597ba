"""Hand-written Hopper kernels of the port and their build.

Twenty-nine kernels carry the port's device work:

  K1 panel_scatter  (csrc/panel_scatter.cuh) panel quadrature of explicit
                    pairs (times the interaction indicator of a finite
                    horizon or of a complement kernel), scattered into
                    dense A (with a launch-wide entry mask), into CSR data at
                    explicit or arithmetic tree slots, into the interior
                    x boundary coupling A_BC, or into the diagonal alone;
                    its complex variant (the greens2D profile) into a
                    complex128 dense A or diagonal
  K2 grid_distant   (csrc/grid_distant.cu)   cell-pair grid over one f32
                    distance window (dense)
  K3 grid_boundary  (csrc/grid_boundary.cu)  zero-exterior surface term
                    (dense)
  K4 pcg_update     (pcg_update.py, Triton)  fused PCG vector pass, in two
                    forms: Jacobi (z = invD r inside the pass) and general
                    (two passes around the preconditioner's z = M r);
                    float64 or float32 vectors
  K5 near_enum      (csrc/near_enum.cu)      H2 near-field enumeration:
                    element keys, f32 order model (1D or 2D),
                    histogram
  K6 near_enum_quad (csrc/near_enum.cu)      H2 near-field quadrature of
                    one order's elements into tree slots
  K7 far_field      (csrc/far_field.cu)      H2 far-field kernel blocks
  K8 h2_matvec      (csrc/h2_matvec.cu)      H2 apply (a sequence of
                    launches per call)
  K9 csr_spmv       (csrc/csr_spmv.cu)       CSR apply y = A x or y += A x
                    (multigrid prolongation and restriction); float64,
                    complex128 x with float64 or complex128 data, and
                    float32
  K10 jacobi_smooth (jacobi_smooth.py,       damped-Jacobi vector pass of
                    Triton)                  the V-cycle, three modes;
                                             float64 or complex128
  K11 block_near_count (csrc/near_block.cu)  H2 block near-field engine:
                    element counts per cluster pair and order class
  K12 block_near_quad (csrc/near_block.cu)   H2 block near-field engine:
                    quadrature of orders 2-8 into per-pair tree blocks
  K13 tree_csr_quad (csrc/near_enum.cu)      H2 host-enumeration engine:
                    quadrature of host-listed elements into tree slots
  K14 cut1d         (csrc/cut_cells.cu)      1D pairs cut by the horizon:
                    exact interval clipping
  K15 cut2d_polar   (csrc/cut_cells.cu)      2D pairs cut by the horizon:
                    kink-split polar rays clipped to the cell and the ball
                    (ball2, ballInf, ball1 or the ellipse); the power
                    profile, or the complex greens2D one
  K16 csr_scatter   (csrc/csr_scatter.cu)    local stiffness and mass
                    matrices summed into CSR data, one thread per slot
                    over its host-sorted contributions
  K17 gmres_arnoldi (gmres_arnoldi.py,       GMRES: one Arnoldi step's
                    Triton)                  modified Gram-Schmidt and
                                             normalisation; x += Z y;
                                             float64 or complex128
  K18 bicgstab_update (bicgstab_update.py,   BiCGStab's vector passes
                    Triton)                  around its applies; float64
                                             or complex128
  K19 panel_scatter_nonsym                   nonsymmetric local matrices of
                    (csrc/panel_scatter_nonsym.cuh) explicit pairs,
                                             t1 PHIxPSI - t2 PHIyPSI with
                                             t1 = gamma(x, y), t2 = gamma(y, x),
                                             into dense A or CSR data at
                                             explicit (entry-masked) slots;
                                             times the interaction
                                             indicator of a finite horizon;
                                             a variable horizon delta(x)
  K20 h2_matvec_T   (csrc/h2_matvec.cu)      transposed H2 apply of a
                    nonsymmetric operator: K8's sweeps, the far blocks
                    transposed with source and target swapped, the near
                    data read in place and scattered by column
  K21 panel_scatter_vec (csrc/panel_scatter_vec.cu)  vector-valued local
                    matrices [nPSI^2, V] of explicit pairs of a vector
                    s-derivative kernel (the zero-exterior term), with the
                    singular rules' log correction, into dense A [N, N, V]
  K22 panel_scatter_nonsym_vec (csrc/panel_scatter_vec.cu)  the
                    nonsymmetric vector-valued local matrices of every pair
                    bucket of a vector kernel, into dense A [N, N, V]
  K23 vector_matvec (csrc/vector_matvec.cu)  apply and transposed apply of
                    a dense vector operator [N, M, V]
  K24 interp_matvec (csrc/interp_matvec.cu)  apply of an interpolated
                    operator family over the fractional order: the
                    weighted sum of a stack [M+1, N, N] of dense node
                    operators applied to x
  K25 matfree_apply (csrc/matfree_apply.cu)  matrix-free apply of a finite
                    element operator from its local matrices [C, dpe, dpe],
                    one thread per dof over its host-sorted local rows; or
                    its diagonal
  K26 cheb_smooth   (csrc/cheb_smooth.cu)    one Chebyshev step of the
                    multigrid smoother, three modes (float64)
  K27 sss_spmv      (csrc/sss_spmv.cu)       apply of a symmetric sparse
                    skyline operator, diag x + L x + L^T x, one thread per
                    row over its host-sorted entries of L and of L^T
  K28 dist_h2_matvec (csrc/dist_h2.cu)       the per-shard phases of the
                    distributed H2 apply (near, moments, up, far, down,
                    leaf), every shard of a card in one launch per phase
  K29 outbox        (csrc/outbox.cu)         the packed-outbox gathers of the
                    sharded programs: pack, receive-add, masked 2D gather

The quadrature kernels (K1, K2, K3, K6, K7, K12, K13, K19) evaluate the
kernel's radial profile (nl/kernels.py Profile: the power C r2^e, the
gaussian, the exponential, their boundary forms, the power-log
r2^e (C + C1 ln r2 + C2 ln^2 r2) of the s-derivatives of a constant order,
the log-inverse distance C ln(1/r) and the polynomial C (1 - r2/a^2)^2)
in one device function, common.cuh radial<code>(); each is compiled once
per profile code (ten) and its launcher picks the instance.  The power
and power-log values of a tempered kernel are multiplied there by
exp(-t r), and every value by the smooth two-point weight of the profile
(common.cuh twoPoint: the tempered exp(-wlam |x-y|), from the node's
r2), runtime arguments of every instance.  K21 and K22
evaluate a vector kernel from its per-side table (nl/kernels.py
VectorParams).  K1, K7 and K19 also take a
variable fractional order (nl/kernels.py OrderParams: constantNonSym,
leftRight), s(x, y) and its normalization per node in common.cuh
kernelXY<profile, order>(), a template on both codes (KERNEL_SWITCH: the
ten profiles without an order, the power profile with each order); the
dense targets of K1 and K19 also the orders of position (innerOuter,
islands, layers, smoothedLeftRight, linearLeftRight, smoothedInnerOuter,
fe: common.cuh orderAt, POSITION_ORDER_SWITCH), their instances in
panel_scatter_order.cu and panel_scatter_nonsym_order.cu, reached from
the dense entry points by the order's code (every entry point that takes
an order takes the whole of it, nl/kernels.py orderArgs); the component
order of a vector kernel's component (nl/kernels.py
_ComponentFractionalKernel: the parent's VectorParams row of each side and
its gradient entry, common.cuh componentTerm, sharing K21's vecTermCore)
with the singular rules' log correction (the rule's lnEta, cw1, cw2,
pointers of the entry points of K1's dense and tree targets and of K19)
in the dense targets' instances too, and the orders of position whose H2
operator the JAX package builds on the interval (innerOuter, islands,
layers, fe) with the component order in instances of K1's tree target,
K19's slot target (panel_scatter_order_h2.cu,
panel_scatter_nonsym_order_h2.cu) and K7 (H2_ORDER_SWITCH); the float32
dense path (a builder's ``params={'dtype': float32}``) has float32
instances of K1's dense target, K2 and K3 with the power profile alone
(common.cuh radial<PC, float>: powf, the constants rounded to float32 on
the host) and runs K4's Triton kernels on float32 vectors; the float32 H2
path (getH2 with that dtype) has float32 instances of K1's slot and tree
targets (panel_scatter_f32.cu), K6 (near_enum.cu), K7 (far_field.cu), K8
(h2_matvec.cu), K12 (near_block.cu) and K13 (near_enum.cu), the power
profile alone; the float32 sparse path and getDiagonal (a finite horizon:
the indicator, peridynamic and truncated fractional kernels) have float32
instances of K1's slot and diagonal targets that add their float32 local
entries into float64 targets, with the indicator (common.cuh inBall on
floats), and K9's float32 instance applies the result (its pairs cut by
the horizon run K14 and K15 in float64, as the JAX float32 program runs
them);
K19 also the variable horizon delta(x) of a constant order (its own
Horizon argument and instances).  K1 and K19 apply the interaction
indicator of a finite horizon per node (common.cuh inBall: ball2, ballInf,
ball1, the ellipse with its map T; K1 also the complement of ball2), K15
clips its rays in the same balls' norms.  K14 and K15 take the profiles
of a finite horizon (cut_cells.cu CUT_PROFILE_SWITCH: the power one with
its tempering, the gaussian, the exponential, the log-inverse distance and
the polynomial, five instances of each target), K15 also the complex one.
The complex greens2D profile (code 8, common.cuh radialC: the A&S Bessel
functions of pynucleus_tpu/nl/kernels.py _bessel_j0y0) has its own
instances: K1's complex variant (dense and diagonal targets) and K15's.
K5, K11 and K12 decide orders by the 1D or the 2D order model, as the
dimension of their centers says.

Their wrappers, each beside its plain PyTorch version, live where the JAX
package has the program they replace: K1-K3, K5-K7, K11-K15, K19, K21
and K22 in nl/assembly.py, K4, K17 and K18 in base/solvers.py, K8 and K20
in nl/h2.py, K9, K23 and K27 in base/linear_operators.py, K10 and K26 in
multilevel/gmg.py, K16 and K25 in fem/assembly.py, K24 in
nl/operator_interpolation.py, K28 and K29 in kernels/dist_h2.py and
kernels/outbox.py (called by parallel/).  A wrapper runs the plain
version only for tensors on the CPU; on a CUDA tensor it launches its
kernel or raises.

``launches`` counts, per kernel, the wrapper calls that launched it (a
plain int each, bumped by the wrapper where it launches).  K1's five
scatter targets are also counted apart, under ``panel_scatter:dense``,
``:slots``, ``:tree``, ``:cross`` and ``:diag``, K19's two under
``panel_scatter_nonsym:dense`` and ``:slots``, K4's two forms under
``pcg_update:jacobi`` and ``:general``, and K23's under
``vector_matvec:apply`` and ``:transposed``, K25's under
``matfree_apply:apply`` and ``:diagonal``, and the complex128 variants
of K9, K10, K17, K15 and K18 (their own template instances and Triton
kernels) also under ``csr_spmv:complex``, ``jacobi_smooth:complex``,
``gmres_arnoldi:complex``, ``cut2d_polar:complex`` and
``bicgstab_update:complex``, K1's under ``panel_scatter:complex`` (dense
target) and ``panel_scatter:complex_diag`` (diagonal target); the
finite-horizon variants (HORIZON) under ``panel_scatter:ball1`` and
``:ellipse`` (K1 with those indicators), ``cut2d_polar:ball1`` and
``:ellipse``, and ``panel_scatter_nonsym:var_horizon`` (K19's
variable-horizon instances); the matrix formats' variants (FORMATS) under
``panel_scatter:complement`` (K1 with the complement indicator, code 5)
and ``panel_scatter:diag_exterior`` (K1's diagonal target on the
zero-exterior pairs of a cell and a surface simplex); the profile and
two-point variants (TWOPOINT) of K1, K2, K3, K14, K15 and K19 under
``<kernel>:tempered`` (a tempered profile, t != 0), ``:two_point`` (the
smooth two-point weight), ``:log_inverse`` and ``:polynomial`` (those
profile codes), and of K14 and K15 also ``:gaussian`` and
``:exponential`` (a finite horizon's); the orders of position in K1's
and K19's dense targets (ORDERS) under ``<kernel>:inner_outer``,
``:islands``, ``:layers``, ``:smoothed_left_right``,
``:linear_left_right``, ``:smoothed_inner_outer`` and ``:fe``, the
manifold kernel's 1D cells in R^2 under ``panel_scatter:manifold`` and
``grid_distant:manifold``, and the interval's variable-order H2 (VARH2)
under ``<kernel>:position`` (the orders of position in K1's tree target,
K19's slot target and K7), ``:component`` (the component order) and
``:log`` (the singular rules' log tables) of K1, K19 and K7; the float32 instances of the dense path
(FLOAT32: K1's dense target in csrc/panel_scatter_f32.cu, K2 and K3 in
their sources, K4's Triton kernels on float32 vectors) under
``<kernel>:float32``, and of K1's float32 launches those of the
natural-order buckets (the cell ids gathered on the device, nl/assembly.py
panel_scatter_natural) also under ``panel_scatter:float32_natural`` and
those with normals (the 2D zero-exterior rows) under
``panel_scatter:float32_rows``; the float32 instances of the H2 path
under ``panel_scatter:float32_slots`` and ``:float32_tree`` (K1's CSR
targets, also under ``panel_scatter:float32``), ``near_enum_quad:float32``,
``far_field:float32``, ``h2_matvec:float32`` (its CUDA launches as K8's),
``block_near_quad:float32`` and ``tree_csr_quad:float32``; of the sparse
path and getDiagonal under ``panel_scatter:float32_indicator`` (K1's
float32 entries into float64 CSR data, with the indicator; the H2 path's
touching panels into their float64 shadow count as ``:float32_slots``)
and ``panel_scatter:float32_diag`` (into the
float64 diagonal), both also under ``panel_scatter:float32``, and
``csr_spmv:float32``; one launch may count under several.
``deviceLaunches`` counts, per kernel and per variant, the CUDA launches
those calls made, where they launched: one per
call, except for K2 (two), K4 (three in the Jacobi form,
four in the general form), K8 (one per pass that has work, as the C entry
point reports: at most 2 nLvl + 2 for an operator of nLvl levels), K20
(the same way, at most 2 nLvl + 3), K17 (j + 3 for Arnoldi step j, two to
start a cycle, one to combine) and K18 (two per call).  ``resetLaunches``
zeroes both.

The CUDA sources are compiled on first use by ``nvcc`` for sm_90a into
``kernels/build/`` (a shared library with a plain C interface, loaded with
ctypes); only sources in this directory are used.  cut_cells.cu,
panel_scatter_vec.cu, cheb_smooth.cu and sss_spmv.cu are compiled with
-fmad=false (the branch decisions of the first and the sums and steps of
the others must round as the plain versions' separate operations do).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

KERNELS = ('panel_scatter', 'grid_distant', 'grid_boundary', 'pcg_update',
           'near_enum', 'near_enum_quad', 'far_field', 'h2_matvec',
           'csr_spmv', 'jacobi_smooth', 'block_near_count', 'block_near_quad',
           'tree_csr_quad', 'cut1d', 'cut2d_polar', 'csr_scatter',
           'gmres_arnoldi', 'bicgstab_update', 'panel_scatter_nonsym',
           'h2_matvec_T', 'panel_scatter_vec', 'panel_scatter_nonsym_vec',
           'vector_matvec', 'interp_matvec', 'matfree_apply',
           'dist_h2_matvec', 'outbox', 'cheb_smooth', 'sss_spmv')
K1_TARGETS = ('panel_scatter:dense', 'panel_scatter:slots',
              'panel_scatter:tree', 'panel_scatter:cross',
              'panel_scatter:diag')
K19_TARGETS = ('panel_scatter_nonsym:dense', 'panel_scatter_nonsym:slots')
K4_FORMS = ('pcg_update:jacobi', 'pcg_update:general')
K23_FORMS = ('vector_matvec:apply', 'vector_matvec:transposed')
K25_FORMS = ('matfree_apply:apply', 'matfree_apply:diagonal')
COMPLEX = ('csr_spmv:complex', 'jacobi_smooth:complex',
           'gmres_arnoldi:complex', 'panel_scatter:complex',
           'panel_scatter:complex_diag', 'cut2d_polar:complex',
           'bicgstab_update:complex')
# the finite-horizon variants: K1 and K15 with the ball1 and ellipse
# interactions, K19 with the variable horizon
HORIZON = ('panel_scatter:ball1', 'panel_scatter:ellipse',
           'cut2d_polar:ball1', 'cut2d_polar:ellipse',
           'panel_scatter_nonsym:var_horizon')
# the variants of the matrix formats: K1 with the complement indicator
# (code 5, the dense target with its entry mask) and K1's diagonal target
# on the zero-exterior term's pairs of a cell and a surface simplex
FORMATS = ('panel_scatter:complement', 'panel_scatter:diag_exterior')
# the variants of the tempered profile, the smooth two-point weight and
# the log-inverse-distance and polynomial profiles in the kernels that can
# take them (K1, K2 and K3 of an infinite horizon, K14 and K15 with the
# gaussian and exponential profiles of a finite horizon too, K19 of a
# nonsymmetric order, K3 of a boundary kernel, which has no weight)
TWOPOINT = tuple(f'panel_scatter:{v}' for v in (
    'tempered', 'two_point', 'log_inverse', 'polynomial')) + tuple(
    f'grid_distant:{v}' for v in ('tempered', 'two_point',
                                  'log_inverse')) + (
    'grid_boundary:tempered', 'panel_scatter_nonsym:two_point') + tuple(
    f'{k}:{v}' for k in ('cut1d', 'cut2d_polar') for v in (
        'tempered', 'two_point', 'log_inverse', 'polynomial', 'gaussian',
        'exponential'))
# the variants of the interval's variable-order H2 (nl/assembly.py
# _countOrder): the orders of position in the H2 targets (K1's tree target,
# K19's slot target, K7) under ``<kernel>:position``, the component order
# of a vector kernel's component (any target) under ``<kernel>:component``
# and the launches with a singular rule's log tables under ``<kernel>:log``
VARH2 = tuple(f'{k}:{v}' for k in ('panel_scatter', 'panel_scatter_nonsym',
                                   'far_field')
              for v in ('position', 'component', 'log')
              if (k, v) != ('far_field', 'log'))
# the variants of the orders of position (nl/kernels.py ORDER_VARIANTS)
# in the dense targets of K1 and K19 (their own entry points and
# instances), and the manifold kernel's K1 launches (1D rules on 2D
# vertices)
ORDERS = tuple(f'{k}:{v}' for k in ('panel_scatter', 'panel_scatter_nonsym')
               for v in ('inner_outer', 'islands', 'layers',
                         'smoothed_left_right', 'linear_left_right',
                         'smoothed_inner_outer', 'fe')) + (
    'panel_scatter:manifold', 'grid_distant:manifold') + VARH2

# the float32 instances: of the dense path K1 (every float32 launch, and of
# those the natural-order buckets gathered on the device and the rows with
# normals of the 2D zero-exterior term), K2, K3 and K4; of the H2 path K1's
# slot and tree targets (also counted under panel_scatter:float32), K6,
# K7, K8, K12 and K13 (the host engine); of the sparse path and
# getDiagonal K1's float32 entries into float64 CSR data (with the
# indicator of a finite horizon) and into the float64 diagonal, and K9
FLOAT32 = ('panel_scatter:float32', 'panel_scatter:float32_natural',
           'panel_scatter:float32_rows', 'grid_distant:float32',
           'grid_boundary:float32', 'pcg_update:float32',
           'panel_scatter:float32_slots', 'panel_scatter:float32_tree',
           'near_enum_quad:float32', 'far_field:float32',
           'h2_matvec:float32', 'block_near_quad:float32',
           'panel_scatter:float32_indicator', 'panel_scatter:float32_diag',
           'csr_spmv:float32', 'tree_csr_quad:float32')
# the phases of K28 (kernels/dist_h2.py) and the three gathers of K29
# (kernels/outbox.py), each counted also under its kernel
DIST = tuple(f'dist_h2_matvec:{p}' for p in (
    'near', 'moments', 'up', 'up_shared', 'far', 'far_shared', 'down',
    'leaf')) + ('outbox:pack', 'outbox:recv_add', 'outbox:gather2d')
launches = {k: 0 for k in KERNELS + K1_TARGETS + K19_TARGETS + K4_FORMS
            + K23_FORMS + K25_FORMS + COMPLEX + HORIZON + FORMATS + TWOPOINT
            + ORDERS + FLOAT32 + DIST}
deviceLaunches = {k: 0 for k in KERNELS + COMPLEX + HORIZON + FORMATS
                  + TWOPOINT + ORDERS + FLOAT32}

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
# the heaviest compiles first (buildLibrary starts them in this order)
SOURCES = ('panel_scatter_csr.cu', 'panel_scatter_nonsym.cu',
           'panel_scatter.cu', 'grid_distant.cu', 'near_enum.cu',
           'panel_scatter_cross.cu', 'panel_scatter_nonsym_order.cu',
           'cut_cells.cu', 'panel_scatter_order.cu',
           'panel_scatter_order_h2.cu', 'panel_scatter_nonsym_order_h2.cu',
           'near_block.cu',
           'grid_boundary.cu', 'panel_scatter_f32.cu', 'far_field.cu',
           'panel_scatter_vec.cu', 'h2_matvec.cu', 'vector_matvec.cu',
           'cheb_smooth.cu', 'matfree_apply.cu', 'csr_scatter.cu',
           'interp_matvec.cu', 'sss_spmv.cu', 'dist_h2.cu', 'csr_spmv.cu',
           'outbox.cu')
HEADERS = ('common.cuh', 'panel_scatter.cuh', 'panel_scatter_nonsym.cuh')
# flags of one source on top of NVCC_FLAGS
SOURCE_FLAGS = {'cut_cells.cu': ('-fmad=false',),
                'panel_scatter_vec.cu': ('-fmad=false',),
                'cheb_smooth.cu': ('-fmad=false',),
                'sss_spmv.cu': ('-fmad=false',)}
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC')

_lib = None


def countVariant(key, device=1):
    """Counts a wrapper call of a complex or finite-horizon variant
    (``key``) and the ``device`` CUDA launches it made."""
    launches[key] += 1
    deviceLaunches[key] += device


def resetLaunches():
    for counts in (launches, deviceLaunches):
        for k in counts:
            counts[k] = 0


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    return path if os.path.exists(path) else 'nvcc'


def buildLibrary(verbose=False):
    """Compile the CUDA sources (once per source content) and return the
    path of the shared library.  One nvcc per source, as many at a time as
    the host has cores, the heaviest first (SOURCES' order: the longest
    compile starts at once and holds a core of its own, the short ones fill
    the other cores), then one link."""
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f'libnucleax_{h.hexdigest()[:16]}.so')
    if os.path.exists(out):
        return out
    extra = ['-Xptxas=-v'] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.replace('.cu', '.o')) for s in SOURCES]

        def compileOne(source, obj):
            return subprocess.run([_nvcc(), *NVCC_FLAGS,
                                   *SOURCE_FLAGS.get(source, ()), *extra,
                                   '-c', os.path.join(CSRC, source), '-o',
                                   obj], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            procs = list(pool.map(compileOne, SOURCES, objs))
        logs = [p.stdout for p in procs]
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([_nvcc(), '-shared', '-gencode',
                                   'arch=compute_90a,code=sm_90a', '-o',
                                   os.path.join(tmp, 'lib.so'), *objs],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append('link')
        if failed:
            raise RuntimeError(f'nvcc failed ({", ".join(failed)}):\n'
                               + '\n'.join(logs))
        if verbose:
            print('\n'.join(logs))
        os.replace(os.path.join(tmp, 'lib.so'), out)
    return out


def _declare(lib):
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    F = ctypes.c_float
    # a radial profile: code, C, e, a, C1, C2, tempering t, two-point
    # weight code and lambda (nl/kernels.py Profile)
    PROF = (I, D, D, D, D, D, D, I, D)
    # the float32 instances' profile: code, C, e, t, wcode
    PROF32 = (I, D, D, D, I)
    # a variable order: code, sll, srr, slr, srl, interface, pi^(d/2), d/2,
    # exponent base, boundary, the point dimension, g0-g3, the table
    # (device), its n, lo0, lo1, hi0, hi1 (nl/kernels.py orderArgs)
    ORD = (I, D, D, D, D, D, D, D, D, I, I, D, D, D, D, P, I, D, D, D, D)
    # an interaction indicator: code, h2, T00, T01, T10, T11 (nl/kernels.py
    # Indicator)
    IND = (I, D, D, D, D, D)
    # a variable horizon: on, c0, c, min, max, 2 - 2s, 2s - 2, d,
    # Gamma(d/2), pi^(d/2), -d/2 - s, normalized (nl/kernels.py horizonArgs)
    HOR = (I, D, D, D, D, D, D, D, D, D, D, I)
    # a singular rule's log tables lnEta, cw1, cw2 [Q] (null: none), which
    # the component order adds (nl/assembly.py _logArgs)
    LOGS = (P, P, P)
    sigs = {
        # A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym,
        # normals, P, bary_x, bary_y, w, PSIP, Q, profile (code, C, e, a),
        # indicator, order, yShift, the log tables (LOGS), entry mask bits
        # (-1: all), stream
        'panel_scatter': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                          P, P, P, P, I, *PROF, *IND, *ORD, P, *LOGS, L, P],
        # A_BC, NB, then as panel_scatter up to the indicator (a finite
        # horizon: no variable order, no y shift), stream
        'panel_scatter_cross': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                P, P, P, P, I, *PROF, *IND, P],
        # d, N, then as panel_scatter_cross
        'panel_scatter_diag': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                               P, P, P, P, I, *PROF, *IND, P],
        # A, N, X, Q, dim, ccf, vols, dofs, dpe, C, PhiXw, PhiX, PsiYw, w,
        # t_lo, t_hi, profile, R, stream
        'grid_distant': [P, L, P, I, I, P, P, P, I, L, P, P, P, P,
                         ctypes.c_float, ctypes.c_float, *PROF, P, P],
        # A, N, X, Q1, dim, vols, dofs, dpe, C, Ysurf, svolw2, normals,
        # S, Q2, exclPtr, exclIdx, PhiXw, PhiX, profile, useNormals, stream
        'grid_boundary': [P, L, P, I, I, P, P, I, L, P, P, P, L, I,
                          P, P, P, P, *PROF, I, P],
        # the float32 instances (every array float32) with the power
        # profile's code, C, e, t and wcode (PROF32): K1's dense target
        # (as panel_scatter up to PSIP, Q; no indicator, order, shift or
        # entry mask), K2 and K3 (as grid_distant and grid_boundary)
        'panel_scatter_f32': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                              P, P, P, P, I, *PROF32, P],
        # the float32 instances of the float32 H2 path, each with PROF32 in
        # place of its profile (and no indicator, order or y shift): K1's
        # slot and tree targets (as panel_scatter_slots and
        # panel_scatter_tree), K6, K7, K8 (as h2_matvec) and K12
        'panel_scatter_slots_f32': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                    P, P, P, P, I, *PROF32, P],
        'panel_scatter_tree_f32': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                   P, P, P, P, P, P, P, P, P, P, P, P, I,
                                   *PROF32, P],
        'near_enum_quad_f32': [P, L, P, I, P, P, P, P, P, P, P, P, P, P, P,
                               I, P, I, P, P, I, P, P, P, P, P, P, P, P, I,
                               *PROF32, P],
        'far_field_f32': [P, P, P, L, I, I, *PROF32, P],
        'h2_matvec_f32': [P, P, P, P, P, I, I, I, I, P, P, P, P, P, P, P,
                          P, P, P, P, P, P, P, I, P, P, P, L,
                          ctypes.POINTER(ctypes.c_int), P],
        'block_near_quad_f32': [P, I, P, P, P, P, P, P, P, P, P, P, P, P, P,
                                P, I, P, P, I, P, I, P, I, I, P, F, F, F, P,
                                I, P, P, P, P, ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_longlong), *PROF32,
                                P],
        'grid_distant_f32': [P, L, P, I, I, P, P, P, I, L, P, P, P, P,
                             F, F, *PROF32, P, P],
        'grid_boundary_f32': [P, L, P, I, I, P, P, I, L, P, P, P, L, I,
                              P, P, P, P, *PROF32, I, P],
        # K1's float32 local entries into a float64 target, with an
        # indicator (IND): the CSR data at slots (as panel_scatter_slots_f32)
        # and the diagonal (as panel_scatter_diag)
        'panel_scatter_slots_f32d': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                     P, P, P, P, I, *PROF32, *IND, P],
        'panel_scatter_diag_f32': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                   P, P, P, P, I, *PROF32, *IND, P],
        # K13's float32 instance (as tree_csr_quad with PROF32)
        'tree_csr_quad_f32': [P, L, P, P, P, P, P, P, P, L, P, I, P, I, P, P,
                              I, P, P, P, P, P, P, P, P, I, *PROF32, P],
        # data, nnz, vertices, dim, vi1, nv1, vi2, nv2, slots, nPSI, volsym,
        # normals, P, bary_x, bary_y, w, PSIP, Q, profile, indicator, order,
        # yShift, stream
        'panel_scatter_slots': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                P, P, P, P, I, *PROF, *IND, *ORD, P, P],
        # A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym, P,
        # bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, profile, indicator, order,
        # horizon, stream
        'panel_scatter_nonsym': [P, L, P, I, P, I, P, I, P, I, P, L,
                                 P, P, P, P, P, I, *PROF, *IND, *ORD, *HOR,
                                 *LOGS, P],
        # data, nnz, then as panel_scatter_nonsym with slots for dofRows
        'panel_scatter_nonsym_slots': [P, L, P, I, P, I, P, I, P, I, P, L,
                                       P, P, P, P, P, I, *PROF, *IND, *ORD,
                                       *HOR, *LOGS, P],
        # A, N, V, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym,
        # P, bary_x, bary_y, w, PSIP, Q, table, interface, lnEta, cw1, cw2,
        # stream
        'panel_scatter_vec': [P, L, I, P, I, P, I, P, I, P, I, P, L, P, P, P,
                              P, I, P, D, P, P, P, P],
        # as panel_scatter_vec with PHIxPSI, PHIyPSI for PSIP
        'panel_scatter_nonsym_vec': [P, L, I, P, I, P, I, P, I, P, I, P, L,
                                     P, P, P, P, P, I, P, D, P, P, P, P],
        # y, A, x, N, M, V, stream (both directions)
        'vector_matvec': [P, P, P, L, L, I, P],
        'vector_matvec_T': [P, P, P, L, L, I, P],
        # y, w, A, x, M+1, N, stream
        'interp_matvec': [P, P, P, P, I, L, P],
        # y, A, dofs, order, offsets, x, N, dpe, diagonal, stream
        'matfree_apply': [P, P, P, P, P, P, I, I, I, P],
        # x, d, b, Ax, Dinv, n, mode, theta, c1, c2, stream
        'cheb_smooth': [P, P, P, P, P, I, I, D, D, D, P],
        # y, diag, data, indices, rowids, order1, offsets1, order2,
        # offsets2, x, n, stream
        'sss_spmv': [P, P, P, P, P, P, P, P, P, P, I, P],
        # out, N, target, vertices, vi1, vi2, vols1, dofRows, slots, P, tq,
        # wq, Qx, ur, wr, Qy, horizon, profile, stream
        'cut1d': [P, L, I, P, P, P, P, P, P, L, P, P, I, P, P, I, D, *PROF,
                  P],
        # out, N, target, vertices, vi1, vi2, vols1, dofRows, slots, P,
        # bary_x, wx, Qx, thetas, wtheta, Qt, rq, wr, Qr, horizon, inter,
        # T00, T01, T10, T11, profile, stream
        'cut2d_polar': [P, L, I, P, P, P, P, P, P, L, P, P, I, P, P, I, P, P,
                        I, D, I, D, D, D, D, *PROF, P],
        # data, nnz, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI,
        # volsym, normals, P, I, J, offF, offB, dofNode, treePos, indptrT,
        # tStart, bary_x, bary_y, w, PSIP, Q, profile, order, yShift, the log
        # tables, stream
        'panel_scatter_tree': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                               P, P, P, P, P, P, P, P, P, P, P, P, I, *PROF,
                               *ORD, P, *LOGS, P],
        # keys, pT, hist, cum, nP, offI, offJ, n2, IA, JA, ncArr, cells, nv,
        # cellNodes, dpe, centers, dim, C, logh, s, c, logH0, T, stream
        'near_enum': [P, P, P, P, I, P, P, P, P, P, P, P, I, P, I, P, I, I,
                      P, F, F, F, I, P],
        # data, nnz, ids, n, pT, cum, offI, offJ, n2, IA, JA, offF, offB,
        # ncArr, vertices, dim, cells, nv, vols, dofs, dpe, dofNode,
        # treePos, indptrT, tStart, bary_x, bary_y, w, PSIP, Q, profile,
        # stream
        'near_enum_quad': [P, L, P, I, P, P, P, P, P, P, P, P, P, P, P, I,
                           P, I, P, P, I, P, P, P, P, P, P, P, P, I, *PROF,
                           P],
        # data, nnz, c1, c2, I, J, offF, offB, sf, n, vertices, dim, cells,
        # nv, vols, dofs, dpe, dofNode, treePos, indptrT, tStart, bary_x,
        # bary_y, w, PSIP, Q, profile, stream
        'tree_csr_quad': [P, L, P, P, P, P, P, P, P, L, P, I, P, I, P, P, I,
                          P, P, P, P, P, P, P, P, I, *PROF, P],
        # counts, nP, offI, offJ, n1, n2, I, J, ncArr, cells, nv, cellNodes,
        # dpe, centers, dim, C, logh, s, c, logH0, stream
        'block_near_count': [P, I, P, P, P, P, P, P, P, P, I, P, I, P, I, I,
                             P, F, F, F, P],
        # data, nP, offI, offJ, n1, n2, I, J, tSI, tSJ, baseF, baseB, LI,
        # LJ, nI, nJ, maxBlock, ncArr, cells, nv, cellNodes, dpe, centers,
        # dim, C, logh, s, c, logH0, vertices, dim, vols, dofs, treePos,
        # rules, ruleQ (host), ruleOff (host), profile, stream
        'block_near_quad': [P, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                            I, P, P, I, P, I, P, I, I, P, F, F, F, P, I, P,
                            P, P, P, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_longlong), *PROF, P],
        # K, gi, gj, P, M, dim, profile, order, stream
        'far_field': [P, P, P, L, I, I, *PROF, *ORD, P],
        # y, x, xt, coef, far, Nt, L, nbar, M, perm, rowNode, indptrT,
        # tStartRow, tLen, rowLen, tmplStart, tmplAll, data, leafPhi,
        # leafNode, T, parent, levelOff (host), nLvl, K, src, dst, nFar,
        # launched (host, out), stream
        'h2_matvec': [P, P, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P,
                      P, P, P, P, P, I, P, P, P, L,
                      ctypes.POINTER(ctypes.c_int), P],
        # y, x, xt, coef, far, yt, then as h2_matvec from Nt on
        'h2_matvec_T': [P, P, P, P, P, P, I, I, I, I, P, P, P, P, P, P, P,
                        P, P, P, P, P, P, P, I, P, P, P, L,
                        ctypes.POINTER(ctypes.c_int), P],
        # y, indptr, indices, data, x, nRows, accumulate, value types
        # (0 float64, 1 float64 data and complex128 x, 2 complex128), stream
        'csr_spmv': [P, P, P, P, P, I, I, I, P],
        # data, vals, order, offsets, nnz, stream
        'csr_scatter': [P, P, P, P, I, P],
        # K29: out, src, srcStride, S, slot, idx64, nk, P, W, stream
        'outbox_pack': [P, P, L, L, P, I, I, L, I, P],
        # X, L, buf, nbuf, rp, rs, idx64, nk, nI, C, stream
        'outbox_recv_add': [P, L, P, L, P, P, I, I, L, I, P],
        # out, buf, L, gp, gs, vm, idx64, nk, nI, stream
        'outbox_gather2d': [P, P, L, P, P, P, I, I, L, P],
        # K28's phases (kernels/dist_h2.py): y, R, xl, buf, bufStride, B,
        # ptr, col, dat, nnzStride, nk, stream
        'dist_h2_near': [P, L, P, P, L, L, P, P, P, L, I, P],
        # own, ownTot, M, xl, R, lfPhi, lfXslot, lfRow, LP, nbar, nk, stream
        'dist_h2_moments': [P, L, I, P, L, P, P, P, L, I, I, P],
        # own, partial, ownTot, M, Town, ptr, idx, idxStride, moP, nShrP,
        # rowOffChild, rowOffParent, nk, stream
        'dist_h2_up': [P, P, L, I, P, P, P, L, L, L, L, L, I, P],
        # shr, shrTot, M, psum, Tshr, ptr, idx, nShrP, shrOffChild,
        # shrOffParent, nk, stream
        'dist_h2_up_shared': [P, L, I, P, P, P, P, L, L, L, I, P],
        # outOwn, partC, own, shr, buf, bufStride, nBufRows, ownTot, shrTot,
        # M, rowOff, shrOff, mo, nShr, ptrA, srcA, KA, nA, ptrC, srcC, KC,
        # nC, nk, stream
        'dist_h2_far': [P, P, P, P, P, L, L, L, L, I, L, L, L, L, P, P, P, L,
                        P, P, P, L, I, P],
        # outShr, shr, shrTot, M, shrOff, nShr, psum, ptrD, srcD, KD, nk,
        # stream
        'dist_h2_far_shared': [P, P, L, I, L, L, P, P, P, P, I, P],
        # outOwn, outShr, ownTot, shrTot, M, Town, parOwnRow, parShrRow,
        # Tshr, shrParRow, rowOff, mo, shrOff, nShr, nk, stream
        'dist_h2_down': [P, P, L, L, I, P, P, P, P, P, L, L, L, L, I, P],
        # y, R, outOwn, ownTot, M, lfPhi, lfXslot, lfRow, LP, nbar, nk,
        # stream
        'dist_h2_leaf': [P, L, P, L, I, P, P, P, L, I, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded CUDA library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(buildLibrary()))
    return _lib


def check(err):
    """Raise on a CUDA error code returned by a C entry point."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f'CUDA kernel launch failed: {msg} ({err})')


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def i64array(values):
    """A host array of int64 (read by a C entry point on the host)."""
    values = [int(v) for v in values]
    return (ctypes.c_longlong * len(values))(*values)


def i32array(values):
    """A host array of int32 (read by a C entry point on the host)."""
    values = [int(v) for v in values]
    return (ctypes.c_int * len(values))(*values)
