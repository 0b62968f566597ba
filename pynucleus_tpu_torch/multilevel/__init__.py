from .gmg import buildProlongation, multigrid, mgPreconditioner
from . import smoothers  # noqa: F401  (registers the gs/sor/ssor solvers)
from .hierarchies import paramsForMG, hierarchyManager, algebraicLevel

__all__ = ['buildProlongation', 'multigrid', 'mgPreconditioner',
           'paramsForMG', 'hierarchyManager', 'algebraicLevel']
