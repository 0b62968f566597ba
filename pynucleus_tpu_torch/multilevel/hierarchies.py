"""Hierarchy construction and management.

Port of pynucleus_tpu/multilevel/hierarchies.py: ``paramsForMG``,
``algebraicLevel`` and ``hierarchyManager``.  A hierarchy is a list of
levels, each {'mesh', 'dm', 'A', 'P', 'R'}, coarse to fine, built by
uniform refinement of the port's meshes (``uniformSquare``,
``simpleInterval``, ...): the level operators are assembled on the
dofmaps' device (the stiffness by kernel K16 on the card), the
prolongations on the host (``buildProlongation``).
"""
from .gmg import buildProlongation

__all__ = ['paramsForMG', 'algebraicLevel', 'hierarchyManager']


def paramsForMG(noRef, dim=2, element='P1', coarseSize=4500):
    """The multigrid schedule (pynucleus_tpu/multilevel/hierarchies.py:21):
    refinements, element, dimension and the bound of the coarse LU."""
    return {'noRef': noRef,
            'element': element,
            'dim': dim,
            'coarseSize': coarseSize}


class algebraicLevel:
    """One hierarchy level: mesh, DoFMap, assembled operators, transfer
    (pynucleus_tpu/multilevel/hierarchies.py:31)."""

    def __init__(self, mesh, dm, A=None, P=None, R=None, M=None):
        self.mesh = mesh
        self.dm = dm
        self.A = A
        self.P = P
        self.R = R
        self.M = M

    def asDict(self):
        entry = {'mesh': self.mesh, 'dm': self.dm, 'A': self.A}
        if self.P is not None:
            entry['P'] = self.P
            entry['R'] = self.R
        if self.M is not None:
            entry['M'] = self.M
        return entry


class hierarchyManager:
    """Build and hold a mesh/operator hierarchy
    (pynucleus_tpu/multilevel/hierarchies.py:54).

    :param mesh0: coarsest mesh (refined until the FE space is nonempty)
    :param params: dict from paramsForMG
    :param assembler: dm -> operator (default: the stiffness)
    :param massAssembler: optional dm -> mass operator per level
    :param dofmapArgs: keyword arguments of the dofmaps
    :param device: the dofmaps' device (the card unless the caller asks
        for the CPU)
    """

    def __init__(self, mesh0, params, assembler=None, massAssembler=None,
                 dofmapArgs=None, device='cuda'):
        self.mesh0 = mesh0
        self.params = params
        self.assembler = assembler
        self.massAssembler = massAssembler
        self.dofmapArgs = dofmapArgs or {}
        self.device = device
        self.levels = None

    def setup(self):
        from ..fem.dofmaps import str2DoFMap
        from ..fem.assembly import assembleStiffness
        assembler = self.assembler or assembleStiffness
        DM = str2DoFMap[self.params.get('element', 'P1')]
        mesh = self.mesh0
        # the dof count of a coarse mesh is host work
        while DM(mesh, **self.dofmapArgs, device='cpu').num_dofs == 0:
            mesh = mesh.refine()
        meshes = [mesh]
        for _ in range(self.params['noRef']):
            meshes.append(meshes[-1].refine())
        dms = [DM(m, **self.dofmapArgs, device=self.device) for m in meshes]
        # the JAX package's loop: drop empty coarse levels (the coarse
        # bound 'coarseSize' is kept in params, not applied, as there)
        start = 0
        while start < len(dms) - 1 and dms[start].num_dofs == 0:
            start += 1
        self.levels = []
        for lvl in range(start, len(dms)):
            lv = algebraicLevel(meshes[lvl], dms[lvl])
            lv.A = assembler(dms[lvl])
            if self.massAssembler is not None:
                lv.M = self.massAssembler(dms[lvl])
            if lvl > start:
                lv.P = buildProlongation(dms[lvl - 1], dms[lvl])
                lv.R = lv.P.T
            self.levels.append(lv)
        return self

    def getLevelList(self):
        """-> list of level dicts consumed by multigrid()
        (pynucleus_tpu/multilevel/hierarchies.py:103)."""
        assert self.levels is not None, 'call setup() first'
        return [lv.asDict() for lv in self.levels]

    def __getitem__(self, lvl):
        return self.levels[lvl]

    def __len__(self):
        return len(self.levels) if self.levels else 0
