from .linear_operators import Dense_LinearOperator, Diagonal_LinearOperator
from .solvers import solverFactory, cg_solver, jacobi_solver

__all__ = ['Dense_LinearOperator', 'Diagonal_LinearOperator', 'solverFactory',
           'cg_solver', 'jacobi_solver']
