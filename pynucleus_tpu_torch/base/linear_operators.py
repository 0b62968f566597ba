"""Dense, diagonal and CSR linear operators on tensors; kernel K9.

Port of Dense_LinearOperator, Diagonal_LinearOperator and
CSR_LinearOperator of pynucleus_tpu/base/linear_operators.py.  The dense
matvec is ``torch.mv``: the plain large product the JAX package leaves to
XLA (``A.data @ x``).  The CSR matvec is kernel K9 :func:`csr_spmv`.
Every operator's ``matvec(x, out=None)`` writes into ``out`` when given
(the CG loop and the V-cycle reuse their buffers); the H2 operator is
nl/h2.py H2Matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import getDevice

__all__ = ['LinearOperator', 'Dense_LinearOperator', 'Diagonal_LinearOperator',
           'CSR_LinearOperator', 'csr_spmv']


class LinearOperator:
    """Abstract linear operator with shape (num_rows, num_columns)."""

    num_rows: int
    num_columns: int

    @property
    def shape(self):
        return (self.num_rows, self.num_columns)

    def matvec(self, x, out=None):
        raise NotImplementedError()

    def __matmul__(self, x):
        return self.matvec(x)

    def toarray(self):
        """Dense host array: the operator applied to the identity's columns
        (pynucleus_tpu/base/linear_operators.py:85-90)."""
        eye = torch.eye(self.num_columns, dtype=torch.float64,
                        device=self.device)
        A = np.zeros(self.shape)
        for j in range(self.num_columns):
            A[:, j] = self.matvec(eye[j]).cpu().numpy()
        return A

    def __repr__(self):
        return f'<{self.num_rows}x{self.num_columns} {type(self).__name__}>'


class Dense_LinearOperator(LinearOperator):
    def __init__(self, data):
        self.data = data
        self.num_rows, self.num_columns = data.shape

    @property
    def device(self):
        return self.data.device

    def matvec(self, x, out=None):
        return torch.mv(self.data, x, out=out)

    def toarray(self):
        return self.data.detach().cpu().numpy()

    @property
    def diagonal(self):
        return torch.diagonal(self.data)


class Diagonal_LinearOperator(LinearOperator):
    def __init__(self, data):
        self.data = data
        self.num_rows = self.num_columns = data.shape[0]

    @property
    def device(self):
        return self.data.device

    def matvec(self, x, out=None):
        return torch.mul(self.data, x, out=out)

    @property
    def diagonal(self):
        return self.data

    def toarray(self):
        return torch.diag(self.data).cpu().numpy()


# ------------------------------------------------------------------ K9 ----

def csr_spmv(indptr, indices, data, x, out=None, accumulate=False):
    """y = A x (``accumulate``: y += A x) for the CSR matrix A given by
    indptr [nRows+1], indices [nnz] int32 and data [nnz] float64; x
    [nCols] float64.  Writes into ``out`` [nRows] when given, else into a
    new vector (zero-filled first with ``accumulate``), and returns it.

    Kernel K9 (kernels/csrc/csr_spmv.cu) on CUDA tensors, the plain version
    on CPU tensors.  Replaces the gather + segment-sum of
    pynucleus_tpu/base/linear_operators.py:310 CSR_LinearOperator.matvec
    and, on the CSR of the transpose, :314 rmatvec."""
    nRows = indptr.shape[0] - 1
    dev = x.device
    for t, dt in ((indptr, torch.int32), (indices, torch.int32),
                  (data, torch.float64), (x, torch.float64)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 1:
            raise ValueError(f'csr_spmv: expected a contiguous {dt} vector '
                             f'on {dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
    if indices.shape != data.shape:
        raise ValueError('csr_spmv: indices and data differ in length')
    if out is None:
        out = (torch.zeros if accumulate else torch.empty)(
            nRows, dtype=torch.float64, device=dev)
    elif out.dtype != torch.float64 or out.shape != (nRows,) \
            or not out.is_contiguous() or out.device != dev:
        raise ValueError(f'csr_spmv: out must be a contiguous float64 '
                         f'[{nRows}] on {dev}')
    if dev.type == 'cpu':
        _csr_spmv_plain(indptr, indices, data, x, out, accumulate)
        return out
    if dev.type != 'cuda':
        raise ValueError(f'csr_spmv: unsupported device {dev}')
    if nRows == 0:
        return out
    lib = kernels.library()
    kernels.launches['csr_spmv'] += 1
    kernels.deviceLaunches['csr_spmv'] += 1
    p = kernels.ptr
    kernels.check(lib.csr_spmv(p(out), p(indptr), p(indices), p(data), p(x),
                               nRows, int(bool(accumulate)),
                               kernels.stream()))
    return out


def _csr_spmv_plain(indptr, indices, data, x, out, accumulate=False):
    """Plain PyTorch version of :func:`csr_spmv` (any device): the JAX
    package's gather and segment sum."""
    nRows = indptr.shape[0] - 1
    ip = indptr.long()
    rowids = torch.repeat_interleave(torch.arange(nRows, device=x.device),
                                     ip[1:] - ip[:-1])
    y = torch.zeros(nRows, dtype=torch.float64, device=x.device)
    y.index_add_(0, rowids, data * x[indices.long()])
    if accumulate:
        out.add_(y)
    else:
        out.copy_(y)
    return out


class CSR_LinearOperator(LinearOperator):
    """CSR operator on the device: int32 ``indptr``/``indices`` and float64
    ``data``, with host copies of the three arrays for set-up logic.

    ``T`` is a second CSR_LinearOperator, of the transpose, built once on
    the host (scipy ``.T.tocsr()``) at the first use of ``T`` or
    ``rmatvec``; ``rmatvec`` is its matvec.  So both directions are the same
    row-gather kernel K9, with no atomics and a fixed order of summation."""

    def __init__(self, indptr, indices, data, num_columns=None,
                 device='cuda'):
        dev = getDevice(device)
        self.indptrH = np.array(indptr, dtype=np.int32)
        self.indicesH = np.array(indices, dtype=np.int32)
        self.dataH = np.array(data, dtype=np.float64)
        self.num_rows = len(self.indptrH) - 1
        self.num_columns = int(num_columns) if num_columns is not None \
            else self.num_rows
        self.indptr = torch.as_tensor(self.indptrH, device=dev)
        self.indices = torch.as_tensor(self.indicesH, device=dev)
        self.data = torch.as_tensor(self.dataH, device=dev)
        self._transpose = None

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self):
        return self.indices.shape[0]

    def matvec(self, x, out=None, accumulate=False):
        return csr_spmv(self.indptr, self.indices, self.data, x, out=out,
                        accumulate=accumulate)

    def transposed(self):
        """The CSR_LinearOperator of the transpose (built once; its own
        transpose is this operator)."""
        if self._transpose is None:
            At = self.to_scipy().T.tocsr()
            At.sort_indices()
            self._transpose = CSR_LinearOperator(
                At.indptr, At.indices, At.data, num_columns=self.num_rows,
                device=self.device)
            self._transpose._transpose = self
        return self._transpose

    def rmatvec(self, x, out=None, accumulate=False):
        return self.transposed().matvec(x, out=out, accumulate=accumulate)

    @property
    def T(self):
        return self.transposed()

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.dataH, self.indicesH, self.indptrH),
                             shape=self.shape)

    def toarray(self):
        A = np.zeros(self.shape, dtype=np.float64)
        rows = np.repeat(np.arange(self.num_rows), np.diff(self.indptrH))
        np.add.at(A, (rows, self.indicesH), self.dataH)
        return A

    @property
    def diagonal(self):
        return torch.as_tensor(self.to_scipy().diagonal(), device=self.device)

    @staticmethod
    def from_scipy(A, device='cuda'):
        A = A.tocsr()
        return CSR_LinearOperator(A.indptr, A.indices, A.data,
                                  num_columns=A.shape[1], device=device)
