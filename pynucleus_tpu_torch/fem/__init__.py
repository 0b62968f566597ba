from .meshes import simplexMesh, simpleInterval, circle, uniformSquare, \
    PHYSICAL
from .dofmaps import P1_DoFMap, fe_vector, str2DoFMap
from .functions import constant, Lambda, radialIndicator, solFractional
from .assembly import assembleMass, assembleStiffness, assembleRHS

__all__ = ['simplexMesh', 'simpleInterval', 'circle', 'uniformSquare',
           'PHYSICAL',
           'P1_DoFMap', 'fe_vector', 'str2DoFMap', 'constant', 'Lambda',
           'radialIndicator', 'solFractional', 'assembleMass',
           'assembleStiffness', 'assembleRHS']
