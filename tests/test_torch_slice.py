"""The port's slice as a whole against the JAX package.

  getDense      nonlocalBuilder(dm, k, params={'denseGrid': True}) of the
                JAX package, the same grid algorithm: 1e-12 relative to
                max|A| (same float64 quadrature, other summation order)
  the driver    drivers/runFractional.py against the port's driver with the
                same flags: errors to rtol 3e-2 and iterations within +-1.
                The JAX driver takes the per-pair path on the CPU and the
                port the grid path (A differs by ~1e-6 at this size), so
                the tight parity is the getDense and CG checks.
"""
import numpy as np
import pytest
import torch

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl.assembly import nonlocalBuilder as jBuilder

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder as tBuilder, \
    assembleNonlocal
from pynucleus_tpu_torch.drivers.runFractional import main as tMain


@pytest.mark.parametrize('domain,noRef,s', [('disc', 3, 0.75),
                                            ('interval', 5, 0.75),
                                            ('interval', 4, 0.25)])
def test_getDense_matches_jax_grid(domain, noRef, s):
    if domain == 'disc':
        m, dim = jfem.circle(h=0.78, radius=1.0), 2
    else:
        m, dim = jfem.simpleInterval(-1.0, 1.0).refine(), 1
    for _ in range(noRef):
        m = m.refine()
    dm = jfem.P1_DoFMap(m)
    Aj = np.asarray(jBuilder(dm, jKernel(dim, s),
                             params={'denseGrid': True}).getDense().toarray())
    _, tdm, tk = fromArrays(m.vertices, m.cells, s, dim, device='cpu')
    A = tBuilder(tdm, tk).getDense()
    assert A.data.dtype == torch.float64 and A.data.device.type == 'cpu'
    At = A.toarray()
    assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()
    # symmetric, positive diagonal
    assert np.abs(At - At.T).max() <= 1e-12 * np.abs(At).max()
    assert (np.diag(At) > 0).all()


def test_assembleNonlocal_rejects_other_formats():
    m = jfem.simpleInterval(-1.0, 1.0).refine()
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 1, device='cpu')
    with pytest.raises(NotImplementedError):
        assembleNonlocal(tdm, tk, matrixFormat='sparse')


@pytest.mark.parametrize('argv', [
    ['--domain', 'disc', '--noRef', '2'],
    ['--domain', 'interval', '--noRef', '4'],
], ids=['disc-noRef2', 'interval-noRef4'])
def test_driver_matches_jax_driver(argv):
    from drivers.runFractional import main as jMain
    flags = ['--s', 'const(0.75)', '--problem', 'constant', '--element', 'P1',
             '--solverType', 'cg-jacobi', '--matrixFormat', 'dense'] + argv
    d, _ = jMain(flags)
    out = tMain(flags + ['--device', 'cpu'], quiet=True)
    ej = d.outputGroups['errors'].toDict()
    et = out['errors'].toDict()
    assert set(et) == set(ej)
    for label, val in ej.items():
        assert np.isclose(et[label], val, rtol=3e-2, atol=1e-8), \
            (label, et[label], val)
    rj = d.outputGroups['results'].toDict()
    rt = out['results'].toDict()
    assert rt['dofs'] == rj['dofs']
    assert abs(rt['iterations'] - rj['iterations']) <= 1
    for label in ('kernel', 'problem', 'h', 'hmin', 'solver'):
        assert rt[label] == rj[label], label


def test_driver_prints_jax_labels(capsys):
    tMain(['--domain', 'interval', '--noRef', '3', '--device', 'cpu'])
    text = capsys.readouterr().out
    for label in ('results:', 'errors:', 'dofs:', 'iterations:',
                  'L2 error:', 'relative interpolated Linf error:',
                  'Hs error:'):
        assert label in text
