from .meshes import simplexMesh, simpleInterval, circle, uniformSquare, \
    sphere1, PHYSICAL
from .dofmaps import P1_DoFMap, fe_vector, str2DoFMap
from .functions import constant, Lambda, radialIndicator, solFractional
from .assembly import assembleMass, assembleStiffness, assembleRHS, \
    matrixFreeOperator
from .lookup import cellFinder, lookupFunction

__all__ = ['simplexMesh', 'simpleInterval', 'circle', 'uniformSquare',
           'sphere1', 'PHYSICAL',
           'P1_DoFMap', 'fe_vector', 'str2DoFMap', 'constant', 'Lambda',
           'radialIndicator', 'solFractional', 'assembleMass',
           'assembleStiffness', 'assembleRHS', 'matrixFreeOperator',
           'cellFinder', 'lookupFunction']
