from .gmg import buildProlongation, multigrid, mgPreconditioner

__all__ = ['buildProlongation', 'multigrid', 'mgPreconditioner']
