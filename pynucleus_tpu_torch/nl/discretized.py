"""Error report of a stationary nonlocal solve (host float64).

Port of stationaryModelSolution's error formulas
(pynucleus_tpu/nl/discretized.py:34-129) as a plain function.  The
solution comes from the device; the error integrals are host numpy with
the mass matrix of fem/assembly.py.
"""
from __future__ import annotations

import numpy as np

from ..fem.assembly import assembleMass, assembleRHS

__all__ = ['ERROR_LABELS', 'modelErrors']

# labels, in the order of the JAX package's report (reportErrors)
ERROR_LABELS = ('L2 error', 'relative L2 error', 'L2 error interpolated',
                'relative interpolated L2 error', 'Linf error interpolated',
                'relative interpolated Linf error', 'Hs error',
                'relative Hs error')


def modelErrors(dm, u, b, analyticSolution, exactL2Squared, exactHsSquared):
    """Errors of the solution u (fe_vector or tensor) against the analytic
    solution; b is the load vector the solve used."""
    uh = np.asarray(u.toarray() if hasattr(u, 'toarray') else
                    u.detach().cpu().numpy(), dtype=np.float64)
    bh = b.toarray() if hasattr(b, 'toarray') else b.detach().cpu().numpy()
    M = assembleMass(dm)
    z = assembleRHS(dm, analyticSolution).toarray()
    L2 = np.sqrt(abs(exactL2Squared - 2 * float(z @ uh) + float(uh @ (M @ uh))))
    uI = np.asarray(analyticSolution(dm.getDoFCoordinates()), dtype=np.float64)
    d = uh - uI
    L2i = float(np.sqrt(d @ (M @ d)))
    Linf = float(np.abs(d).max())
    Hs = np.sqrt(abs(float(bh @ uh) - exactHsSquared))
    return {'L2 error': L2,
            'relative L2 error': L2 / np.sqrt(exactL2Squared),
            'L2 error interpolated': L2i,
            'relative interpolated L2 error':
                L2i / float(np.sqrt(uI @ (M @ uI))),
            'Linf error interpolated': Linf,
            'relative interpolated Linf error': Linf / float(np.abs(uI).max()),
            'Hs error': Hs,
            'relative Hs error': Hs / np.sqrt(exactHsSquared)}
