from .meshes import simplexMesh, simpleInterval, circle, PHYSICAL
from .dofmaps import P1_DoFMap, fe_vector, str2DoFMap
from .functions import constant, Lambda, radialIndicator, solFractional
from .assembly import assembleMass, assembleRHS

__all__ = ['simplexMesh', 'simpleInterval', 'circle', 'PHYSICAL',
           'P1_DoFMap', 'fe_vector', 'str2DoFMap', 'constant', 'Lambda',
           'radialIndicator', 'solFractional', 'assembleMass', 'assembleRHS']
