"""Hand-written Hopper kernels of the port and their build.

Four kernels carry the slice's device work:

  K1 panel_scatter  (csrc/panel_scatter.cu)  singular/touching/correction
                    panel quadrature + scatter into dense A
  K2 grid_distant   (csrc/grid_distant.cu)   cell-pair grid over one f32
                    distance window
  K3 grid_boundary  (csrc/grid_boundary.cu)  zero-exterior surface term
  K4 pcg_update     (pcg_update.py, Triton)  fused PCG vector pass

Their wrappers, each beside its plain PyTorch version, live where the JAX
package has the program they replace: K1-K3 in nl/assembly.py, K4 in
base/solvers.py.  A wrapper runs the plain version only for tensors on the
CPU; on a CUDA tensor it launches its kernel or raises.

``launches`` counts kernel launches per kernel (a plain int each, bumped by
the wrapper where it launches); ``resetLaunches`` zeroes them.

The CUDA sources are compiled on first use by ``nvcc`` for sm_90a into
``kernels/build/`` (a shared library with a plain C interface, loaded with
ctypes); only sources in this directory are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

KERNELS = ('panel_scatter', 'grid_distant', 'grid_boundary', 'pcg_update')
launches = {k: 0 for k in KERNELS}

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
SOURCES = ('panel_scatter.cu', 'grid_distant.cu', 'grid_boundary.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_lib = None


def resetLaunches():
    for k in KERNELS:
        launches[k] = 0


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    return path if os.path.exists(path) else 'nvcc'


def buildLibrary(verbose=False):
    """Compile the CUDA sources (once per source content) and return the
    path of the shared library."""
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES + ('common.cuh',):
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f'libnucleax_{h.hexdigest()[:16]}.so')
    if os.path.exists(out):
        return out
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp] + \
        [os.path.join(CSRC, s) for s in SOURCES]
    if verbose:
        cmd.insert(1, '-Xptxas=-v')
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError('nvcc failed:\n' + proc.stdout + proc.stderr)
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _declare(lib):
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    sigs = {
        # A, N, vertices, dim, vi1, nv1, vi2, nv2, dofRows, nPSI, volsym,
        # normals, P, bary_x, bary_y, w, PSIP, Q, C, e, stream
        'panel_scatter': [P, L, P, I, P, I, P, I, P, I, P, P, L,
                          P, P, P, P, I, D, D, P],
        # A, N, X, Q, dim, ccf, vols, dofs, dpe, C, PhiXw, PhiX, PsiYw, w,
        # t_lo, t_hi, Cg, e, R, stream
        'grid_distant': [P, L, P, I, I, P, P, P, I, L, P, P, P, P,
                         ctypes.c_float, ctypes.c_float, D, D, P, P],
        # A, N, X, Q1, dim, vols, dofs, dpe, C, Ysurf, svolw2, normals,
        # S, Q2, exclPtr, exclIdx, PhiXw, PhiX, Cg, e, useNormals, stream
        'grid_boundary': [P, L, P, I, I, P, P, I, L, P, P, P, L, I,
                          P, P, P, P, D, D, I, P],
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
