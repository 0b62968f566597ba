"""Hand-written Hopper kernels of the port and their build.

Twenty-three kernels carry the port's device work:

  K1 panel_scatter  (csrc/panel_scatter.cu)  panel quadrature of explicit
                    pairs (times the interaction indicator of a finite
                    horizon), scattered into dense A, into CSR data at
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
                    (two passes around the preconditioner's z = M r)
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
                    and complex128 x with float64 or complex128 data
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
                    kink-split polar rays clipped to the cell and the ball;
                    the power profile, or the complex greens2D one
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
                    (csrc/panel_scatter_nonsym.cu)  explicit pairs,
                                             t1 PHIxPSI - t2 PHIyPSI with
                                             t1 = gamma(x, y), t2 = gamma(y, x),
                                             into dense A or CSR data at
                                             explicit (entry-masked) slots
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

The quadrature kernels (K1, K2, K3, K6, K7, K12, K13, K19) evaluate the
kernel's radial profile (nl/kernels.py Profile: the power C r2^e, the
gaussian, the exponential, their boundary forms and the power-log
r2^e (C + C1 ln r2 + C2 ln^2 r2) of the s-derivatives of a constant order)
in one device function, common.cuh radial<code>(); each is compiled once
per profile code (eight) and its launcher picks the instance.  K21 and K22
evaluate a vector kernel from its per-side table (nl/kernels.py
VectorParams).  K1, K7 and K19 also take a
variable fractional order (nl/kernels.py OrderParams: constantNonSym,
leftRight), s(x, y) and its normalization per node in common.cuh
kernelXY<profile, order>(), a template on both codes (KERNEL_SWITCH: the
seven profiles without an order, the power profile with each order).
K14 and K15 take the power profile only, K15 also the complex one.  The
complex greens2D profile (code 8, common.cuh radialC: the A&S Bessel
functions of pynucleus_tpu/nl/kernels.py _bessel_j0y0) has its own
instances: K1's complex variant (dense and diagonal targets) and K15's.
K5, K11 and K12 decide orders by the 1D or the 2D order model, as the
dimension of their centers says.

Their wrappers, each beside its plain PyTorch version, live where the JAX
package has the program they replace: K1-K3, K5-K7, K11-K15, K19, K21
and K22 in nl/assembly.py, K4, K17 and K18 in base/solvers.py, K8 and K20
in nl/h2.py, K9 and K23 in base/linear_operators.py, K10 in
multilevel/gmg.py, K16 in fem/assembly.py.  A wrapper runs the plain
version only for tensors on the CPU; on a CUDA tensor it launches its
kernel or raises.

``launches`` counts, per kernel, the wrapper calls that launched it (a
plain int each, bumped by the wrapper where it launches).  K1's five
scatter targets are also counted apart, under ``panel_scatter:dense``,
``:slots``, ``:tree``, ``:cross`` and ``:diag``, K19's two under
``panel_scatter_nonsym:dense`` and ``:slots``, K4's two forms under
``pcg_update:jacobi`` and ``:general``, and K23's under
``vector_matvec:apply`` and ``:transposed``, and the complex128 variants
of K9, K10, K17, K15 and K18 (their own template instances and Triton
kernels) also under ``csr_spmv:complex``, ``jacobi_smooth:complex``,
``gmres_arnoldi:complex``, ``cut2d_polar:complex`` and
``bicgstab_update:complex``, K1's under ``panel_scatter:complex`` (dense
target) and ``panel_scatter:complex_diag`` (diagonal target).
``deviceLaunches`` counts, per kernel, the CUDA launches those calls
made: one per call, except for K2 (two), K4 (three in the Jacobi form,
four in the general form), K8 (one per pass that has work, as the C entry
point reports: at most 2 nLvl + 2 for an operator of nLvl levels), K20
(the same way, at most 2 nLvl + 3), K17 (j + 3 for Arnoldi step j, two to
start a cycle, one to combine) and K18 (two per call).  ``resetLaunches``
zeroes both.

The CUDA sources are compiled on first use by ``nvcc`` for sm_90a into
``kernels/build/`` (a shared library with a plain C interface, loaded with
ctypes); only sources in this directory are used.  cut_cells.cu and
panel_scatter_vec.cu are compiled with -fmad=false (the branch decisions
of the one and the sums of the other must round as the plain versions'
separate operations do).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

KERNELS = ('panel_scatter', 'grid_distant', 'grid_boundary', 'pcg_update',
           'near_enum', 'near_enum_quad', 'far_field', 'h2_matvec',
           'csr_spmv', 'jacobi_smooth', 'block_near_count', 'block_near_quad',
           'tree_csr_quad', 'cut1d', 'cut2d_polar', 'csr_scatter',
           'gmres_arnoldi', 'bicgstab_update', 'panel_scatter_nonsym',
           'h2_matvec_T', 'panel_scatter_vec', 'panel_scatter_nonsym_vec',
           'vector_matvec')
K1_TARGETS = ('panel_scatter:dense', 'panel_scatter:slots',
              'panel_scatter:tree', 'panel_scatter:cross',
              'panel_scatter:diag')
K19_TARGETS = ('panel_scatter_nonsym:dense', 'panel_scatter_nonsym:slots')
K4_FORMS = ('pcg_update:jacobi', 'pcg_update:general')
K23_FORMS = ('vector_matvec:apply', 'vector_matvec:transposed')
COMPLEX = ('csr_spmv:complex', 'jacobi_smooth:complex',
           'gmres_arnoldi:complex', 'panel_scatter:complex',
           'panel_scatter:complex_diag', 'cut2d_polar:complex',
           'bicgstab_update:complex')
launches = {k: 0 for k in KERNELS + K1_TARGETS + K19_TARGETS + K4_FORMS
            + K23_FORMS + COMPLEX}
deviceLaunches = {k: 0 for k in KERNELS}

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
SOURCES = ('panel_scatter.cu', 'grid_distant.cu', 'grid_boundary.cu',
           'near_enum.cu', 'far_field.cu', 'h2_matvec.cu', 'csr_spmv.cu',
           'near_block.cu', 'cut_cells.cu', 'csr_scatter.cu',
           'panel_scatter_nonsym.cu', 'panel_scatter_vec.cu',
           'vector_matvec.cu')
# flags of one source on top of NVCC_FLAGS
SOURCE_FLAGS = {'cut_cells.cu': ('-fmad=false',),
                'panel_scatter_vec.cu': ('-fmad=false',)}
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC')

_lib = None


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
    path of the shared library.  One nvcc per source, all started
    together, then one link: on the H100 machine (8 cores) the cold build
    of seven sources took 9.2 s, where one nvcc over the first three
    alone had taken 15.0 s."""
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in SOURCES + ('common.cuh',):
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f'libnucleax_{h.hexdigest()[:16]}.so')
    if os.path.exists(out):
        return out
    extra = ['-Xptxas=-v'] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.replace('.cu', '.o')) for s in SOURCES]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS,
                                   *SOURCE_FLAGS.get(s, ()), *extra, '-c',
                                   os.path.join(CSRC, s), '-o', o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
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
    # a radial profile: code, C, e, a, C1, C2 (nl/kernels.py Profile)
    PROF = (I, D, D, D, D, D)
    # a variable order: code, sll, srr, slr, srl, interface, pi^(d/2), d/2,
    # exponent base, boundary (nl/kernels.py orderArgs)
    ORD = (I, D, D, D, D, D, D, D, D, I)
    sigs = {
        # A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym,
        # normals, P, bary_x, bary_y, w, PSIP, Q, profile (code, C, e, a),
        # inter, h2, order, yShift, stream
        'panel_scatter': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                          P, P, P, P, I, *PROF, I, D, *ORD, P, P],
        # A_BC, NB, then as panel_scatter up to h2 (a finite horizon: no
        # variable order, no y shift), stream
        'panel_scatter_cross': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                P, P, P, P, I, *PROF, I, D, P],
        # d, N, then as panel_scatter_cross
        'panel_scatter_diag': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                               P, P, P, P, I, *PROF, I, D, P],
        # A, N, X, Q, dim, ccf, vols, dofs, dpe, C, PhiXw, PhiX, PsiYw, w,
        # t_lo, t_hi, profile, R, stream
        'grid_distant': [P, L, P, I, I, P, P, P, I, L, P, P, P, P,
                         ctypes.c_float, ctypes.c_float, *PROF, P, P],
        # A, N, X, Q1, dim, vols, dofs, dpe, C, Ysurf, svolw2, normals,
        # S, Q2, exclPtr, exclIdx, PhiXw, PhiX, profile, useNormals, stream
        'grid_boundary': [P, L, P, I, I, P, P, I, L, P, P, P, L, I,
                          P, P, P, P, *PROF, I, P],
        # data, nnz, vertices, dim, vi1, nv1, vi2, nv2, slots, nPSI, volsym,
        # normals, P, bary_x, bary_y, w, PSIP, Q, profile, inter, h2, order,
        # yShift, stream
        'panel_scatter_slots': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                P, P, P, P, I, *PROF, I, D, *ORD, P, P],
        # A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym, P,
        # bary_x, bary_y, w, PHIxPSI, PHIyPSI, Q, profile, order, stream
        'panel_scatter_nonsym': [P, L, P, I, P, I, P, I, P, I, P, L,
                                 P, P, P, P, P, I, *PROF, *ORD, P],
        # data, nnz, then as panel_scatter_nonsym with slots for dofRows
        'panel_scatter_nonsym_slots': [P, L, P, I, P, I, P, I, P, I, P, L,
                                       P, P, P, P, P, I, *PROF, *ORD, P],
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
        # out, N, target, vertices, vi1, vi2, vols1, dofRows, slots, P, tq,
        # wq, Qx, ur, wr, Qy, horizon, C, e, stream
        'cut1d': [P, L, I, P, P, P, P, P, P, L, P, P, I, P, P, I, D, D, D, P],
        # out, N, target, vertices, vi1, vi2, vols1, dofRows, slots, P,
        # bary_x, wx, Qx, thetas, wtheta, Qt, rq, wr, Qr, horizon, inter,
        # profile code, C, e, a, stream
        'cut2d_polar': [P, L, I, P, P, P, P, P, P, L, P, P, I, P, P, I, P, P,
                        I, D, I, I, D, D, D, P],
        # data, nnz, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI,
        # volsym, normals, P, I, J, offF, offB, dofNode, treePos, indptrT,
        # tStart, bary_x, bary_y, w, PSIP, Q, profile, order, yShift, stream
        'panel_scatter_tree': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                               P, P, P, P, P, P, P, P, P, P, P, P, I, *PROF,
                               *ORD, P, P],
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
