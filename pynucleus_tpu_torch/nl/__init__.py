from .kernels import FractionalKernel, getFractionalKernel, constFractionalOrder
from .assembly import nonlocalBuilder, assembleNonlocal
from .problems import fractionalLaplacianProblem

__all__ = ['FractionalKernel', 'getFractionalKernel', 'constFractionalOrder',
           'nonlocalBuilder', 'assembleNonlocal', 'fractionalLaplacianProblem']
