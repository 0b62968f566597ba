from .linear_operators import (Dense_LinearOperator, Diagonal_LinearOperator,
                               CSR_LinearOperator, SSS_LinearOperator,
                               SchurComplement)
from .solvers import (solverFactory, cg_solver, jacobi_solver, ichol_solver,
                      ilu_solver)
from .linalg import (estimateSpectralRadius, lanczos, lanczosSpectralBounds,
                     arnoldi)

__all__ = ['Dense_LinearOperator', 'Diagonal_LinearOperator',
           'CSR_LinearOperator', 'SSS_LinearOperator', 'SchurComplement',
           'solverFactory', 'cg_solver', 'jacobi_solver', 'ichol_solver',
           'ilu_solver', 'estimateSpectralRadius', 'lanczos',
           'lanczosSpectralBounds', 'arnoldi']
