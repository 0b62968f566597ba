"""The variable-order H2 kernels on the card against their plain versions
(needs an NVIDIA GPU; skipped elsewhere).  No JAX here: the card's
machine runs the port alone.

    python -m pytest tests/test_torch_varorder_h2_gpu.py -q -m cuda

getH2Vector of the derivative-1 kernel of leftRight(0.25, 0.75, 0.4, 0.6)
(the component order with the singular rules' log correction in K1's
dense and tree targets, K19's slot target and K7) and the getH2 of
innerOuter (symmetric: K1's slot and tree targets; sio != soi: K19's slot
target) with the orders of position in K7, at noRef 6 on the card and on
the CPU (the plain versions): applies and transposed applies to 1e-12
relative; the getDense of a component (K1's and K19's dense targets) to
1e-12 of its largest entry.
"""
import pytest
import torch

from pynucleus_tpu_torch.fem.meshes import simpleInterval
from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl import assembly as tasm

CASES = [((0.25, 0.75, 0.4, 0.6), {'derivative': 1}),
         ('innerOuter(1,0.75,0.25,0.5)', {}),
         ('innerOuter(1,0.75,0.25,0.5,sio=0.4,soi=0.6)', {})]


def _interval(noRef):
    m = simpleInterval(-1.0, 1.0)
    for _ in range(noRef + 1):
        m = m.refine()
    return m


@pytest.mark.cuda
@pytest.mark.parametrize('spec,kw', CASES, ids=['LR4-d1', 'innerOuter',
                                                'innerOuter_sio'])
def test_varorder_h2_kernels_match_plain_on_gpu(spec, kw):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    m = _interval(6)
    ops, dense = [], []
    for dev in ('cuda', 'cpu'):
        _, dm, k = fromArrays(m.vertices, m.cells, spec, 1, device=dev, **kw)
        b = tasm.nonlocalBuilder(dm, k)
        ops.append(b.getH2Vector() if kw else b.getH2())
        if kw:
            dense.append(tasm.nonlocalBuilder(
                dm, k.componentKernels()[2]).getDense().data.cpu())
    x = torch.sin(torch.arange(dm.num_dofs, dtype=torch.float64))
    for fwd in (True, False):
        if kw:
            name = 'matvec' if fwd else 'matvecTrans'
            yg, yc = getattr(ops[0], name)(x.cuda()).cpu(), \
                getattr(ops[1], name)(x)
        else:
            yg = (ops[0] if fwd else ops[0].T).matvec(x.cuda()).cpu()
            yc = (ops[1] if fwd else ops[1].T).matvec(x)
        assert float(torch.linalg.norm(yg - yc)) <= 1e-12 * float(
            torch.linalg.norm(yc))
    if kw:
        assert float((dense[0] - dense[1]).abs().max()) <= 1e-12 * float(
            dense[1].abs().max())
