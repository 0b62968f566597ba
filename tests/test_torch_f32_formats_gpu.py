"""The float32 instances of the finite horizon's formats and of the smooth
kernels on the card against their plain versions (needs an NVIDIA GPU;
skipped elsewhere).  No JAX here: the card's machine runs the port alone.

    python -m pytest tests/test_torch_f32_formats_gpu.py -q -m cuda

The same float32 builds on the card and on the CPU (the plain versions),
within 1e-5 of the largest entry: getDense of a finite horizon (K1's
float32 dense target with the indicator, the cut pairs' float64 entries
through K14's and K15's float32 dense target, each rounded as it is
added), getDenseCross (K1 into the float64 A_BC), the complement
cross operator of H2corrected (K1 with the complement indicator and the
block mask into a float64 dense A), and the gaussian, exponential,
tempered and polynomial kernels (K1, K2 and K3 with the profile switch;
getSparse and getDiagonal into float64).
"""
import numpy as np
import pytest
import torch

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.fem.meshes import simpleInterval, uniformSquare
from pynucleus_tpu_torch.nl import kernels as tk
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
from pynucleus_tpu_torch.nl.problems import (nonlocalMesh, processKernel,
                                             HOMOGENEOUS_DIRICHLET)

TOL = 1e-5
F32 = {'dtype': np.float32}


def _close(got, ref):
    got, ref = got.cpu().double(), ref.cpu().double()
    return float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


def _finite(domain, noRef, device):
    kernel = processKernel(domain, 'constant', 'const(0.4)', 0.2)
    mesh, info = nonlocalMesh(domain, kernel, HOMOGENEOUS_DIRICHLET)
    for _ in range(noRef):
        mesh = mesh.refine()
    return P1_DoFMap(mesh, tag=info['domain'], device=device), kernel


@pytest.mark.cuda
@pytest.mark.parametrize('domain,noRef', [('interval', 6), ('square', 1)])
def test_finite_horizon_formats_match_plain_on_gpu(domain, noRef):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    out = {}
    for dev in ('cuda', 'cpu'):
        dm, kernel = _finite(domain, noRef, dev)
        b = nonlocalBuilder(dm, kernel, params=dict(F32))
        kernels.resetLaunches()
        A = b.getDense().data
        cut = 'cut1d' if domain == 'interval' else 'cut2d_polar'
        assert kernels.deviceLaunches[cut + ':float32'] > 0 or dev == 'cpu'
        out[dev] = (A, b.getDenseCross().data,
                    nonlocalBuilder(dm, kernel.getComplementKernel(),
                                    params=dict(F32), zeroExterior=False)
                    ._getComplementCross().data)
    for g, c in zip(out['cuda'], out['cpu']):
        assert g.dtype == c.dtype
        assert _close(g, c)


def _profileKernel(name, dim):
    if name == 'gaussian':
        return tk.getIntegrableKernel(dim, 'gaussian', np.inf), True
    if name == 'exponential':
        return tk.getIntegrableKernel(dim, 'exponential', np.inf), True
    if name == 'tempered':
        return tk.FractionalKernel(dim, 0.4, temperedLambda=2.0), True
    if name == 'gaussian-finite':
        return tk.getIntegrableKernel(dim, 'gaussian', 0.25), False
    return tk.Kernel(dim, 'polynomial', 0.3, tk.ball2(), 0.5, 0.0,
                     exponentParam=0.3), False


@pytest.mark.cuda
@pytest.mark.parametrize('name,dim', [
    ('gaussian', 1), ('gaussian', 2), ('exponential', 1), ('tempered', 2),
    ('gaussian-finite', 1), ('gaussian-finite', 2), ('polynomial', 2)])
def test_profiles_match_plain_on_gpu(name, dim):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    mesh = simpleInterval(-1.0, 1.0) if dim == 1 else uniformSquare(2, 2)
    for _ in range(6 if dim == 1 else 3):
        mesh = mesh.refine()
    kernel, ze = _profileKernel(name, dim)
    out = {}
    for dev in ('cuda', 'cpu'):
        dm = P1_DoFMap(mesh, device=dev)
        ops = []
        for grid in ((False,) if kernel.finiteHorizon else (False, True)):
            ops.append(nonlocalBuilder(
                dm, kernel, params=dict(F32, denseGrid=grid),
                zeroExterior=ze).getDense().data)
        b = nonlocalBuilder(dm, kernel, params=dict(F32), zeroExterior=ze)
        ops.append(b.getDiagonal().data)
        if kernel.finiteHorizon:
            ops.append(b.getSparse().data)
        out[dev] = ops
    for g, c in zip(out['cuda'], out['cpu']):
        assert g.dtype == c.dtype
        assert _close(g, c)
