"""ctypes bindings of the port's incomplete-Cholesky factorization and
triangular solves (base/csrc/sparse_factor.cpp).

Port of pynucleus_tpu/base/sparse_native.py.  The source is the port's own
copy of native/sparse_factor.cpp; it is compiled with g++ (the JAX
package's flags) at first use into kernels/build/, named by a hash of its
content, and loaded with ctypes.  Both are host algorithms: IC(0) and the
triangular solves go row after row.
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'csrc', 'sparse_factor.cpp')
_BUILD = os.path.join(os.path.dirname(_HERE), 'kernels', 'build')
_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC')

_lib = None


def buildLibrary():
    """Compile the source (once per content and flags); returns the path of
    the shared library."""
    h = hashlib.sha1(' '.join(_FLAGS).encode())
    with open(_SRC, 'rb') as f:
        h.update(f.read())
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, f'libsparse_factor_{h.hexdigest()[:16]}.so')
    if not os.path.exists(out):
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
            so = os.path.join(tmp, 'lib.so')
            subprocess.run(['g++', *_FLAGS, '-o', so, _SRC], check=True)
            os.replace(so, out)
    return out


def _getLib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(buildLibrary())
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.ichol_csr.restype = ctypes.c_int64
    lib.ichol_csr.argtypes = [ctypes.c_int64, ip, ip, dp, ip, ip, dp, dp]
    lib.forward_solve_lower.restype = None
    lib.forward_solve_lower.argtypes = [ctypes.c_int64, ip, ip, dp, dp,
                                        dp, dp]
    lib.backward_solve_lower_t.restype = None
    lib.backward_solve_lower_t.argtypes = [ctypes.c_int64, ip, ip, dp, dp,
                                           dp, dp]
    _lib = lib
    return lib


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class IChol:
    """IC(0) factors of a symmetric positive definite CSR matrix
    (A ~ L L^T on tril(A)'s sparsity); apply() performs
    x = L^{-T} L^{-1} b on host arrays."""

    def __init__(self, indptr, indices, data, n, shift=0.0):
        lib = _getLib()
        self.n = n
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        data = np.ascontiguousarray(data, dtype=np.float64)
        rows = np.repeat(np.arange(n), np.diff(indptr))
        lower = int((indices < rows).sum())
        self.Lindptr = np.zeros(n + 1, dtype=np.int64)
        self.Lindices = np.zeros(max(lower, 1), dtype=np.int64)
        self.Ldata = np.zeros(max(lower, 1), dtype=np.float64)
        self.diag = np.zeros(n, dtype=np.float64)
        attempt = data
        for k in range(8):
            rc = lib.ichol_csr(n, _ip(indptr), _ip(indices), _dp(attempt),
                               _ip(self.Lindptr), _ip(self.Lindices),
                               _dp(self.Ldata), _dp(self.diag))
            if rc == 0:
                return
            # breakdown: diagonal shift (standard remedy) and retry
            shift = max(2.0 * shift, 1e-3)
            attempt = data.copy()
            diagMask = indices == rows
            attempt[diagMask] *= (1.0 + shift)
        raise RuntimeError('ichol breakdown persists after shifts')

    def apply(self, b):
        lib = _getLib()
        b = np.ascontiguousarray(b, dtype=np.float64)
        y = np.zeros(self.n, dtype=np.float64)
        x = np.zeros(self.n, dtype=np.float64)
        lib.forward_solve_lower(self.n, _ip(self.Lindptr),
                                _ip(self.Lindices), _dp(self.Ldata),
                                _dp(self.diag), _dp(b), _dp(y))
        lib.backward_solve_lower_t(self.n, _ip(self.Lindptr),
                                   _ip(self.Lindices), _dp(self.Ldata),
                                   _dp(self.diag), _dp(y), _dp(x))
        return x
