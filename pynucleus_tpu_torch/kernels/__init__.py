"""Hand-written Hopper kernels of the port and their build.

Eighteen kernels carry the port's device work:

  K1 panel_scatter  (csrc/panel_scatter.cu)  panel quadrature of explicit
                    pairs (times the interaction indicator of a finite
                    horizon), scattered into dense A, into CSR data at
                    explicit or arithmetic tree slots, or into the interior
                    x boundary coupling A_BC
  K2 grid_distant   (csrc/grid_distant.cu)   cell-pair grid over one f32
                    distance window (dense)
  K3 grid_boundary  (csrc/grid_boundary.cu)  zero-exterior surface term
                    (dense)
  K4 pcg_update     (pcg_update.py, Triton)  fused PCG vector pass, in two
                    forms: Jacobi (z = invD r inside the pass) and general
                    (two passes around the preconditioner's z = M r)
  K5 near_enum      (csrc/near_enum.cu)      H2 near-field enumeration:
                    element keys, f32 order model, histogram
  K6 near_enum_quad (csrc/near_enum.cu)      H2 near-field quadrature of
                    one order's elements into tree slots
  K7 far_field      (csrc/far_field.cu)      H2 far-field kernel blocks
  K8 h2_matvec      (csrc/h2_matvec.cu)      H2 apply (a sequence of
                    launches per call)
  K9 csr_spmv       (csrc/csr_spmv.cu)       CSR apply y = A x or y += A x
                    (multigrid prolongation and restriction)
  K10 jacobi_smooth (jacobi_smooth.py,       damped-Jacobi vector pass of
                    Triton)                  the V-cycle, three modes
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
  K16 csr_scatter   (csrc/csr_scatter.cu)    local stiffness and mass
                    matrices summed into CSR data, one thread per slot
                    over its host-sorted contributions
  K17 gmres_arnoldi (gmres_arnoldi.py,       GMRES: one Arnoldi step's
                    Triton)                  modified Gram-Schmidt and
                                             normalisation; x += Z y
  K18 bicgstab_update (bicgstab_update.py,   BiCGStab's vector passes
                    Triton)                  around its applies

Their wrappers, each beside its plain PyTorch version, live where the JAX
package has the program they replace: K1-K3, K5-K7 and K11-K15 in
nl/assembly.py, K4, K17 and K18 in base/solvers.py, K8 in nl/h2.py, K9 in
base/linear_operators.py, K10 in multilevel/gmg.py, K16 in
fem/assembly.py.  A wrapper runs the
plain version only for tensors on the CPU; on a CUDA tensor it launches
its kernel or raises.

``launches`` counts, per kernel, the wrapper calls that launched it (a
plain int each, bumped by the wrapper where it launches).  K1's four
scatter targets are also counted apart, under ``panel_scatter:dense``,
``:slots``, ``:tree`` and ``:cross``, and K4's two forms under
``pcg_update:jacobi`` and ``:general``.  ``deviceLaunches`` counts, per
kernel, the CUDA
launches those calls made: one per call, except for K2 (two), K4 (three
in the Jacobi form, four in the general form), K8 (one per pass that
has work, as the C entry point reports: at most 2 nLvl + 2 for an
operator of nLvl levels), K17 (j + 3 for Arnoldi step j, two to start a
cycle, one to combine) and K18 (two per call).  ``resetLaunches`` zeroes both.

The CUDA sources are compiled on first use by ``nvcc`` for sm_90a into
``kernels/build/`` (a shared library with a plain C interface, loaded with
ctypes); only sources in this directory are used.  cut_cells.cu is
compiled with -fmad=false (its branch decisions must round as the plain
versions' separate operations do).
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
           'gmres_arnoldi', 'bicgstab_update')
K1_TARGETS = ('panel_scatter:dense', 'panel_scatter:slots',
              'panel_scatter:tree', 'panel_scatter:cross')
K4_FORMS = ('pcg_update:jacobi', 'pcg_update:general')
launches = {k: 0 for k in KERNELS + K1_TARGETS + K4_FORMS}
deviceLaunches = {k: 0 for k in KERNELS}

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
SOURCES = ('panel_scatter.cu', 'grid_distant.cu', 'grid_boundary.cu',
           'near_enum.cu', 'far_field.cu', 'h2_matvec.cu', 'csr_spmv.cu',
           'near_block.cu', 'cut_cells.cu', 'csr_scatter.cu')
# flags of one source on top of NVCC_FLAGS
SOURCE_FLAGS = {'cut_cells.cu': ('-fmad=false',)}
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
    sigs = {
        # A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym,
        # normals, P, bary_x, bary_y, w, PSIP, Q, C, e, inter, h2, stream
        'panel_scatter': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                          P, P, P, P, I, D, D, I, D, P],
        # A_BC, NB, then as panel_scatter
        'panel_scatter_cross': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                P, P, P, P, I, D, D, I, D, P],
        # A, N, X, Q, dim, ccf, vols, dofs, dpe, C, PhiXw, PhiX, PsiYw, w,
        # t_lo, t_hi, Cg, e, R, stream
        'grid_distant': [P, L, P, I, I, P, P, P, I, L, P, P, P, P,
                         ctypes.c_float, ctypes.c_float, D, D, P, P],
        # A, N, X, Q1, dim, vols, dofs, dpe, C, Ysurf, svolw2, normals,
        # S, Q2, exclPtr, exclIdx, PhiXw, PhiX, Cg, e, useNormals, stream
        'grid_boundary': [P, L, P, I, I, P, P, I, L, P, P, P, L, I,
                          P, P, P, P, D, D, I, P],
        # data, nnz, vertices, dim, vi1, nv1, vi2, nv2, slots, nPSI, volsym,
        # normals, P, bary_x, bary_y, w, PSIP, Q, C, e, inter, h2, stream
        'panel_scatter_slots': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                                P, P, P, P, I, D, D, I, D, P],
        # out, N, target, vertices, vi1, vi2, vols1, dofRows, slots, P, tq,
        # wq, Qx, ur, wr, Qy, horizon, C, e, stream
        'cut1d': [P, L, I, P, P, P, P, P, P, L, P, P, I, P, P, I, D, D, D, P],
        # out, N, target, vertices, vi1, vi2, vols1, dofRows, slots, P,
        # bary_x, wx, Qx, thetas, wtheta, Qt, rq, wr, Qr, horizon, inter, C,
        # e, stream
        'cut2d_polar': [P, L, I, P, P, P, P, P, P, L, P, P, I, P, P, I, P, P,
                        I, D, I, D, D, P],
        # data, nnz, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI,
        # volsym, normals, P, I, J, offF, offB, dofNode, treePos, indptrT,
        # tStart, bary_x, bary_y, w, PSIP, Q, C, e, stream
        'panel_scatter_tree': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                               P, P, P, P, P, P, P, P, P, P, P, P, I, D, D,
                               P],
        # keys, pT, hist, cum, nP, offI, offJ, n2, IA, JA, ncArr, cells, nv,
        # cellNodes, dpe, centers, C, logh, s, c, logH0, T, stream
        'near_enum': [P, P, P, P, I, P, P, P, P, P, P, P, I, P, I, P, I, P,
                      F, F, F, I, P],
        # data, nnz, ids, n, pT, cum, offI, offJ, n2, IA, JA, offF, offB,
        # ncArr, vertices, dim, cells, nv, vols, dofs, dpe, dofNode,
        # treePos, indptrT, tStart, bary_x, bary_y, w, PSIP, Q, C, e, stream
        'near_enum_quad': [P, L, P, I, P, P, P, P, P, P, P, P, P, P, P, I,
                           P, I, P, P, I, P, P, P, P, P, P, P, P, I, D, D,
                           P],
        # data, nnz, c1, c2, I, J, offF, offB, sf, n, vertices, dim, cells,
        # nv, vols, dofs, dpe, dofNode, treePos, indptrT, tStart, bary_x,
        # bary_y, w, PSIP, Q, C, e, stream
        'tree_csr_quad': [P, L, P, P, P, P, P, P, P, L, P, I, P, I, P, P, I,
                          P, P, P, P, P, P, P, P, I, D, D, P],
        # counts, nP, offI, offJ, n1, n2, I, J, ncArr, cells, nv, cellNodes,
        # dpe, centers, C, logh, s, c, logH0, stream
        'block_near_count': [P, I, P, P, P, P, P, P, P, P, I, P, I, P, I, P,
                             F, F, F, P],
        # data, nP, offI, offJ, n1, n2, I, J, tSI, tSJ, baseF, baseB, LI,
        # LJ, nI, nJ, maxBlock, ncArr, cells, nv, cellNodes, dpe, centers,
        # C, logh, s, c, logH0, vertices, dim, vols, dofs, treePos, rules,
        # ruleQ (host), ruleOff (host), C, e, stream
        'block_near_quad': [P, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                            I, P, P, I, P, I, P, I, P, F, F, F, P, I, P, P,
                            P, P, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_longlong), D, D, P],
        # K, gi, gj, P, M, dim, C, e, stream
        'far_field': [P, P, P, L, I, I, D, D, P],
        # y, x, xt, coef, far, Nt, L, nbar, M, perm, rowNode, indptrT,
        # tStartRow, tLen, rowLen, tmplStart, tmplAll, data, leafPhi,
        # leafNode, T, parent, levelOff (host), nLvl, K, src, dst, nFar,
        # launched (host, out), stream
        'h2_matvec': [P, P, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P,
                      P, P, P, P, P, I, P, P, P, L,
                      ctypes.POINTER(ctypes.c_int), P],
        # y, indptr, indices, data, x, nRows, accumulate, stream
        'csr_spmv': [P, P, P, P, P, I, I, P],
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
