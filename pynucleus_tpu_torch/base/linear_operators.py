"""Dense and diagonal linear operators on tensors.

Port of Dense_LinearOperator and Diagonal_LinearOperator of
pynucleus_tpu/base/linear_operators.py.  The dense matvec is ``torch.mv``:
the plain large product the JAX package leaves to XLA (``A.data @ x``).
Every operator's ``matvec(x, out=None)`` writes into ``out`` when given
(the CG loop reuses one buffer); the H2 operator is nl/h2.py H2Matrix.
"""
from __future__ import annotations

import torch

__all__ = ['LinearOperator', 'Dense_LinearOperator', 'Diagonal_LinearOperator']


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

    def __repr__(self):
        return f'<{self.num_rows}x{self.num_columns} {type(self).__name__}>'


class Dense_LinearOperator(LinearOperator):
    def __init__(self, data):
        self.data = data
        self.num_rows, self.num_columns = data.shape

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

    def matvec(self, x, out=None):
        return torch.mul(self.data, x, out=out)

    @property
    def diagonal(self):
        return self.data

    def toarray(self):
        return torch.diag(self.data).cpu().numpy()
