"""Dense, diagonal and CSR linear operators on tensors, and the
vector-valued operators; kernels K9 and K23.

Port of Dense_LinearOperator, Diagonal_LinearOperator, CSR_LinearOperator,
VectorLinearOperator, Dense_VectorLinearOperator and
H2_VectorLinearOperator, SSS_LinearOperator and SchurComplement of
pynucleus_tpu/base/linear_operators.py.  The
dense matvec is ``torch.mv``: the plain large product the JAX package
leaves to XLA (``A.data @ x``); the dense and diagonal operators take
float64 or complex128 data (the complex Greens operators).  The CSR matvec is kernel K9
:func:`csr_spmv`, the SSS matvec kernel K27 :func:`sss_spmv`, the dense
vector operator's apply and transposed apply
kernel K23 :func:`vector_matvec`.  Every scalar operator's ``matvec(x,
out=None)`` writes into ``out`` when given (the CG loop and the V-cycle
reuse their buffers); the H2 operator is nl/h2.py H2Matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import getDevice

__all__ = ['LinearOperator', 'Dense_LinearOperator', 'Diagonal_LinearOperator',
           'CSR_LinearOperator', 'csr_spmv', 'SSS_LinearOperator', 'sss_spmv',
           'SchurComplement', 'VectorLinearOperator',
           'Dense_VectorLinearOperator', 'H2_VectorLinearOperator',
           'vector_matvec']


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

# the value types K9 takes: (data, x) -> the code of its C entry point
_SPMV_TYPES = {(torch.float64, torch.float64): 0,
               (torch.float64, torch.complex128): 1,
               (torch.complex128, torch.complex128): 2,
               (torch.float32, torch.float32): 3}


def csr_spmv(indptr, indices, data, x, out=None, accumulate=False):
    """y = A x (``accumulate``: y += A x) for the CSR matrix A given by
    indptr [nRows+1], indices [nnz] int32 and data [nnz]; x [nCols].  data
    and x are float64, or x is complex128 and data float64 or complex128
    (a real prolongation applied to a complex vector, a complex operator),
    or both float32 (the float32 sparse operator); y has x's type.
    Writes into ``out`` [nRows] when given, else into a
    new vector (zero-filled first with ``accumulate``), and returns it.

    Kernel K9 (kernels/csrc/csr_spmv.cu; the complex variant its
    double2 instances, counted also as ``csr_spmv:complex``, the float32
    one as ``csr_spmv:float32``) on CUDA tensors, the plain version on CPU
    tensors.  Replaces the gather + segment-sum of
    pynucleus_tpu/base/linear_operators.py:310 CSR_LinearOperator.matvec
    and, on the CSR of the transpose, :314 rmatvec."""
    nRows = indptr.shape[0] - 1
    dev = x.device
    types = _SPMV_TYPES.get((data.dtype, x.dtype))
    if types is None:
        raise ValueError(f'csr_spmv: data {data.dtype} and x {x.dtype}: '
                         'expected float64 and float64, float64 and '
                         'complex128, complex128 and complex128, or float32 '
                         'and float32')
    for t in (indptr, indices, data, x):
        if t.device != dev or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f'csr_spmv: expected contiguous vectors on '
                             f'{dev}, got {tuple(t.shape)} on {t.device}')
    for t in (indptr, indices):
        if t.dtype != torch.int32:
            raise ValueError(f'csr_spmv: expected int32 indptr and indices, '
                             f'got {t.dtype}')
    if indices.shape != data.shape:
        raise ValueError('csr_spmv: indices and data differ in length')
    if out is None:
        out = (torch.zeros if accumulate else torch.empty)(
            nRows, dtype=x.dtype, device=dev)
    elif out.dtype != x.dtype or out.shape != (nRows,) \
            or not out.is_contiguous() or out.device != dev:
        raise ValueError(f'csr_spmv: out must be a contiguous {x.dtype} '
                         f'[{nRows}] on {dev}')
    if dev.type == 'cpu':
        _csr_spmv_plain(indptr, indices, data, x, out, accumulate)
        return out
    if dev.type != 'cuda':
        raise ValueError(f'csr_spmv: unsupported device {dev}')
    if nRows == 0:
        return out
    if types in (1, 2):
        # complex values are read as double2: 16-byte aligned
        for t in (data, x, out):
            if t.is_complex() and t.data_ptr() % 16:
                raise ValueError('csr_spmv: a complex128 vector not aligned '
                                 'to 16 bytes')
    lib = kernels.library()
    kernels.launches['csr_spmv'] += 1
    kernels.deviceLaunches['csr_spmv'] += 1
    if types in (1, 2):
        kernels.countVariant('csr_spmv:complex')
    elif types == 3:
        kernels.countVariant('csr_spmv:float32')
    p = kernels.ptr
    kernels.check(lib.csr_spmv(p(out), p(indptr), p(indices), p(data), p(x),
                               nRows, int(bool(accumulate)), types,
                               kernels.stream()))
    return out


def _csr_spmv_plain(indptr, indices, data, x, out, accumulate=False):
    """Plain PyTorch version of :func:`csr_spmv` (any device): the JAX
    package's gather and segment sum."""
    nRows = indptr.shape[0] - 1
    ip = indptr.long()
    rowids = torch.repeat_interleave(torch.arange(nRows, device=x.device),
                                     ip[1:] - ip[:-1])
    y = torch.zeros(nRows, dtype=x.dtype, device=x.device)
    y.index_add_(0, rowids, data * x[indices.long()])
    if accumulate:
        out.add_(y)
    else:
        out.copy_(y)
    return out


class CSR_LinearOperator(LinearOperator):
    """CSR operator on the device: int32 ``indptr``/``indices`` and float64
    or complex128 ``data``, with host copies of the three arrays for set-up
    logic.

    ``T`` is a second CSR_LinearOperator, of the transpose, built once on
    the host (scipy ``.T.tocsr()``) at the first use of ``T`` or
    ``rmatvec``; ``rmatvec`` is its matvec.  So both directions are the same
    row-gather kernel K9, with no atomics and a fixed order of summation."""

    def __init__(self, indptr, indices, data, num_columns=None,
                 device='cuda'):
        dev = getDevice(device)
        self.indptrH = np.array(indptr, dtype=np.int32)
        self.indicesH = np.array(indices, dtype=np.int32)
        self._dataH = np.array(data, dtype=np.complex128
                               if np.iscomplexobj(data) else np.float64)
        self.num_rows = len(self.indptrH) - 1
        self.num_columns = int(num_columns) if num_columns is not None \
            else self.num_rows
        self.indptr = torch.as_tensor(self.indptrH, device=dev)
        self.indices = torch.as_tensor(self.indicesH, device=dev)
        self.data = torch.as_tensor(self._dataH, device=dev)
        self._transpose = None

    @classmethod
    def fromDevice(cls, indptr, indices, data, num_columns=None):
        """The operator of host indptr and indices and of ``data``, a
        tensor already on its device (assembled there); the host copy of
        the data is made at its first use (``dataH``)."""
        A = object.__new__(cls)
        dev = data.device
        A.indptrH = np.array(indptr, dtype=np.int32)
        A.indicesH = np.array(indices, dtype=np.int32)
        A._dataH = None
        A.num_rows = len(A.indptrH) - 1
        A.num_columns = int(num_columns) if num_columns is not None \
            else A.num_rows
        A.indptr = torch.as_tensor(A.indptrH, device=dev)
        A.indices = torch.as_tensor(A.indicesH, device=dev)
        A.data = data.contiguous()
        A._transpose = None
        return A

    @property
    def dataH(self):
        if self._dataH is None:
            self._dataH = self.data.detach().cpu().numpy()
        return self._dataH

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
        A = np.zeros(self.shape, dtype=self.dataH.dtype)
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


# ----------------------------------------------------------------- K27 ----

def _segments(keys, n):
    """(order, offsets): the stable order of the entries by key and each
    key's range [offsets[k], offsets[k+1]) of it, as int32 host arrays."""
    order = np.argsort(keys, kind='stable').astype(np.int32)
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(keys, minlength=n), out=offsets[1:])
    return order, offsets


def sss_spmv(diag, data, indices, rowids, order1, offsets1, order2,
             offsets2, x, out=None):
    """y = diag x + L x + L^T x for the strictly lower triangle L given by
    its entries data [nnz] (float64) at (rowids, indices) (int32), in any
    order, and diag and x [n] (float64).  order1/offsets1 list the entries
    of each row (stably sorted by rowids), order2/offsets2 those of each
    column (by indices), int32 [nnz] and [n+1] (:func:`_segments`).
    Writes into ``out`` [n] when given, else into a new vector, and
    returns it.

    Kernel K27 (kernels/csrc/sss_spmv.cu) on CUDA tensors, the plain
    version on CPU tensors.  Replaces the two segment sums of
    pynucleus_tpu/base/linear_operators.py:434 SSS_LinearOperator.matvec."""
    n = diag.shape[0]
    dev = x.device
    for t in (diag, data, indices, rowids, order1, offsets1, order2,
              offsets2, x):
        if t.device != dev or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f'sss_spmv: contiguous vectors on {dev} '
                             'expected')
    for t in (diag, data, x):
        if t.dtype != torch.float64:
            raise ValueError(f'sss_spmv: float64 values expected, got '
                             f'{t.dtype}')
    for t in (indices, rowids, order1, offsets1, order2, offsets2):
        if t.dtype != torch.int32:
            raise ValueError(f'sss_spmv: int32 indices expected, got '
                             f'{t.dtype}')
    nnz = data.shape[0]
    if x.shape != (n,) or any(t.shape != (nnz,) for t in (
            indices, rowids, order1, order2)) \
            or offsets1.shape != (n + 1,) or offsets2.shape != (n + 1,):
        raise ValueError('sss_spmv: shape mismatch')
    if out is None:
        out = torch.empty(n, dtype=torch.float64, device=dev)
    elif out.dtype != torch.float64 or out.shape != (n,) \
            or not out.is_contiguous() or out.device != dev:
        raise ValueError(f'sss_spmv: out must be a contiguous float64 [{n}] '
                         f'on {dev}')
    if dev.type == 'cpu':
        return out.copy_(_sss_spmv_plain(diag, data, indices, rowids, x))
    if dev.type != 'cuda':
        raise ValueError(f'sss_spmv: unsupported device {dev}')
    if n == 0:
        return out
    lib = kernels.library()
    kernels.launches['sss_spmv'] += 1
    kernels.deviceLaunches['sss_spmv'] += 1
    p = kernels.ptr
    kernels.check(lib.sss_spmv(p(out), p(diag), p(data), p(indices),
                               p(rowids), p(order1), p(offsets1), p(order2),
                               p(offsets2), p(x), n, kernels.stream()))
    return out


def _sss_spmv_plain(diag, data, indices, rowids, x):
    """Plain PyTorch version of :func:`sss_spmv` (any device): the JAX
    package's two segment sums, added in its order."""
    n = diag.shape[0]
    ri, ci = rowids.long(), indices.long()
    s1 = torch.zeros(n, dtype=x.dtype, device=x.device)
    s1.index_add_(0, ri, data * x[ci])
    s2 = torch.zeros(n, dtype=x.dtype, device=x.device)
    s2.index_add_(0, ci, data * x[ri])
    return (diag * x + s1) + s2


class SSS_LinearOperator(LinearOperator):
    """Symmetric sparse skyline: diagonal + strictly lower CSR
    (pynucleus_tpu/base/linear_operators.py:408); matvec(x) = diag x + L x
    + L^T x by kernel K27 :func:`sss_spmv`.  L's entries are given by
    ``indptr`` (CSR rows) or by ``rowids`` with ``num_rows``, in any
    order; the host sorts them by row and by column once, here, so that
    both products are gathers.  The operator lives on ``device``."""

    def __init__(self, indices, indptr=None, data=None, diagonal=None, *,
                 rowids=None, num_rows=None, device='cuda'):
        dev = getDevice(device)
        if indptr is not None:
            indptr = np.asarray(indptr)
            nr = indptr.shape[0] - 1
            rowids = np.repeat(np.arange(nr, dtype=np.int32),
                               np.diff(indptr))
            self.indptr = indptr
        else:
            assert rowids is not None and num_rows is not None
            nr = num_rows
            self.indptr = None
        self.num_rows = self.num_columns = int(nr)
        rowids = np.asarray(rowids, dtype=np.int32)
        indices = np.asarray(indices, dtype=np.int32)
        segs = _segments(rowids, nr) + _segments(indices, nr)

        def t(a, dtype=None):
            return torch.as_tensor(np.array(a, dtype=dtype), device=dev)
        self.rowids, self.indices = t(rowids), t(indices)
        self.data = t(data, np.float64)
        self.diag = t(diagonal, np.float64)
        self.order1, self.offsets1, self.order2, self.offsets2 = \
            (t(a) for a in segs)

    def _host(self):
        """L's row ids, column ids and data and the diagonal, read back
        from the device as numpy arrays."""
        return tuple(a.cpu().numpy() for a in (self.rowids, self.indices,
                                               self.data, self.diag))

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self):
        return self.indices.shape[0] + self.num_rows

    def matvec(self, x, out=None):
        return sss_spmv(self.diag, self.data, self.indices, self.rowids,
                        self.order1, self.offsets1, self.order2,
                        self.offsets2, x, out=out)

    @property
    def T(self):
        return self

    @property
    def diagonal(self):
        return self.diag

    def toarray(self):
        r, c, d, diag = self._host()
        A = np.diag(diag)
        np.add.at(A, (r, c), d)
        np.add.at(A, (c, r), d)
        return A

    def to_csr(self):
        import scipy.sparse as sp
        r, c, d, diag = self._host()
        n = self.num_rows
        rows = np.concatenate([r, c, np.arange(n)])
        cols = np.concatenate([c, r, np.arange(n)])
        vals = np.concatenate([d, d, diag])
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        return CSR_LinearOperator.from_scipy(A, device=self.device)


class SchurComplement(LinearOperator):
    """S = A11 - A12 A22^{-1} A21 for the index split (indices, complement)
    (pynucleus_tpu/base/linear_operators.py:664).  The blocks are dense on
    A's device and A22 is factorised once by the library LU
    (torch.linalg.lu_factor, where the JAX package has
    jax.scipy.linalg.lu_factor)."""

    def __init__(self, A, indices):
        arr = torch.as_tensor(A.toarray(), device=A.device)
        n = arr.shape[0]
        indices = np.asarray(indices, dtype=np.int64)
        comp = np.setdiff1d(np.arange(n), indices)
        self.indices = indices
        self.complement = comp
        ii, cc = (torch.as_tensor(a, device=arr.device)
                  for a in (indices, comp))
        self.A11 = arr[ii][:, ii]
        self.A12 = arr[ii][:, cc]
        self.A21 = arr[cc][:, ii]
        self.A22 = arr[cc][:, cc]
        self._lu = torch.linalg.lu_factor(self.A22)
        self.num_rows = self.num_columns = len(indices)

    @property
    def device(self):
        return self.A11.device

    def matvec(self, x, out=None):
        t = torch.linalg.lu_solve(*self._lu, (self.A21 @ x).unsqueeze(1))
        return torch.sub(self.A11 @ x, self.A12 @ t.squeeze(1), out=out)

    def toarray(self):
        inv22 = np.linalg.inv(self.A22.cpu().numpy())
        return self.A11.cpu().numpy() - self.A12.cpu().numpy() @ inv22 \
            @ self.A21.cpu().numpy()

    def __repr__(self):
        return f'SchurComplement({self.num_rows}x{self.num_rows})'


# ----------------------------------------------------- vector operators ----

class VectorLinearOperator:
    """Operator with vector-valued entries: matvec maps x [M] to y [N, V]
    (pynucleus_tpu/base/linear_operators.py VectorLinearOperator: the
    s-derivative operators, whose entries have kernel.valueSize
    components)."""

    def __init__(self, num_rows, num_columns, vectorSize):
        self.num_rows = num_rows
        self.num_columns = num_columns
        self.vectorSize = vectorSize

    def __call__(self, x, trans=False):
        return self.matvecTrans(x) if trans else self.matvec(x)


class Dense_VectorLinearOperator(VectorLinearOperator):
    """data [N, M, V] float64 on its device; matvec and matvecTrans are
    kernel K23 (:func:`vector_matvec`)."""

    def __init__(self, data):
        self.data = data
        super().__init__(*data.shape)

    @property
    def device(self):
        return self.data.device

    def matvec(self, x):
        return vector_matvec(self.data, x)

    def matvecTrans(self, x):
        return vector_matvec(self.data, x, trans=True)

    def toarray(self):
        return self.data.detach().cpu().numpy()

    def __add__(self, other):
        return Dense_VectorLinearOperator(self.data + other.data)

    def __mul__(self, fac):
        return Dense_VectorLinearOperator(fac * self.data)

    __rmul__ = __mul__

    def __repr__(self):
        return (f'<Dense_VectorLinearOperator {self.num_rows}x'
                f'{self.num_columns}x{self.vectorSize}>')


class H2_VectorLinearOperator(VectorLinearOperator):
    """One H2 operator per value component: the apply stacks theirs, the
    transposed apply stacks their transposes' (a symmetric operator's
    ``T`` is itself)."""

    def __init__(self, components):
        self.components = list(components)
        c0 = self.components[0]
        super().__init__(c0.num_rows, c0.num_columns, len(self.components))

    def matvec(self, x):
        return torch.stack([c.matvec(x) for c in self.components], dim=1)

    def matvecTrans(self, x):
        return torch.stack([c.T.matvec(x) for c in self.components], dim=1)


# ------------------------------------------------------------------ K23 ---

def vector_matvec(A, x, trans=False):
    """y [N, V] with y[n, k] = sum_m A[n, m, k] x[m] (``trans``: y [M, V],
    y[m, k] = sum_n A[n, m, k] x[n]) for A [N, M, V] and x float64,
    contiguous, on one device.

    Kernel K23 (kernels/csrc/vector_matvec.cu) on CUDA tensors, the plain
    version on CPU tensors.  Replaces
    pynucleus_tpu/base/linear_operators.py:156
    Dense_VectorLinearOperator.matvec and :159 matvecTrans."""
    if A.dim() != 3 or A.dtype != torch.float64 or not A.is_contiguous():
        raise ValueError('vector_matvec: A must be a contiguous float64 '
                         '[N, M, V] tensor')
    N, M, V = A.shape
    n = N if trans else M
    if x.dtype != torch.float64 or x.shape != (n,) or not x.is_contiguous() \
            or x.device != A.device:
        raise ValueError(f'vector_matvec: x must be a contiguous float64 [{n}]'
                         f' on {A.device}')
    if A.device.type == 'cpu':
        return _vector_matvec_plain(A, x, trans)
    if A.device.type != 'cuda':
        raise ValueError(f'vector_matvec: unsupported device {A.device}')
    y = torch.zeros((M if trans else N, V), dtype=torch.float64,
                    device=A.device)
    lib = kernels.library()
    kernels.launches['vector_matvec'] += 1
    kernels.deviceLaunches['vector_matvec'] += 1
    kernels.launches['vector_matvec:transposed' if trans else
                     'vector_matvec:apply'] += 1
    p = kernels.ptr
    fn = lib.vector_matvec_T if trans else lib.vector_matvec
    kernels.check(fn(p(y), p(A), p(x), N, M, V, kernels.stream()))
    return y


# rows of A per step of the plain version (bounds its [rows, M, V]
# intermediate)
_PLAIN_ENTRIES = 1 << 24


def _vector_matvec_plain(A, x, trans=False):
    """Plain PyTorch version of :func:`vector_matvec` (any device): the
    products summed over m (over n for ``trans``), a block of rows at a
    time."""
    N, M, V = A.shape
    step = max(_PLAIN_ENTRIES // max(M * V, 1), 1)
    if not trans:
        return torch.cat([(A[s:s + step] * x[None, :, None]).sum(1)
                          for s in range(0, N, step)])
    y = torch.zeros((M, V), dtype=A.dtype, device=A.device)
    for s in range(0, N, step):
        y += (A[s:s + step] * x[s:s + step, None, None]).sum(0)
    return y
