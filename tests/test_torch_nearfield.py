"""The H2 near field of the port against the JAX package.

The JAX side is pynucleus_tpu's getH2 with the device-CSR accumulator and
the flat device enumeration (``params={'forceDeviceCSR': True}``,
``PYNUCLEUS_TPU_BLOCK_NEAR=0``), run on the CPU; the port's builds that
are held to it run its flat engine too (``params={'nearEngine':
'flat'}``; the default block engine is held to the JAX default in
test_torch_nearblock.py).  Its device programs are
recorded with their inputs; each kernel's plain version gets the same
inputs (into zeroed data) and is held to the program it replaces:

  K1 CSR slots   _bucket_masked_csr_scan        1e-12 of max|data|
  K1 CSR tree    _bucket_surface_tree_scan      1e-12 of max|data|
  K1 touching    the host adds (hostData)       1e-12 of max|data|
  K5             _enum_phase1                   keys, pT, histogram equal
  K6             _enum_phase2                   1e-12 of max|data|

(1e-12: the same float64 quadrature summed in another order.)  The slice's
near data must equal the JAX tree-ordered data entry by entry to 1e-12 of
max|data| (both packages build the same tree, pattern and layout), and
its H2 apply the JAX host-path H2 apply to 1e-10, the bar the JAX package
sets between its own near-field engines.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl import assembly as tasm

TOL = 1e-12
FLAT = {'nearEngine': 'flat'}
RECORDED = ('_bucket_masked_csr_scan', '_bucket_surface_tree_scan',
            '_enum_phase1', '_enum_phase2')


def _mesh(name):
    if name == 'circle8':
        m = jfem.circle(n=8)
    else:
        m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(2):
        m = m.refine()
    return m


def _buildJax(m, record=None):
    """JAX getH2 on the flat device-enumeration engine; with ``record``
    (a dict) the inputs of its device programs and the host-add part of
    the accumulator are recorded."""
    dm = jfem.P1_DoFMap(m)
    k = jKernel(2, 0.75)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('PYNUCLEUS_TPU_BLOCK_NEAR', '0')
        mp.delenv('PYNUCLEUS_TPU_HOST_ENUM', raising=False)
        if record is not None:
            launch = jasm._launch

            def rec(fn, *args, _statics=None, _force=False, **kw):
                name = getattr(fn, '__name__', '')
                if name in RECORDED:
                    record.setdefault(name, []).append(
                        ([a if isinstance(a, (int, float)) else np.asarray(a)
                          for a in args], dict(_statics or {})))
                return launch(fn, *args, _statics=_statics, _force=_force,
                              **kw)
            result = jasm.DeviceCSRAccumulator.result

            def res(acc):
                record['hostData'] = np.array(acc.hostData)
                return result(acc)
            mp.setattr(jasm, '_launch', rec)
            mp.setattr(jasm.DeviceCSRAccumulator, 'result', res)
        H = jasm.nonlocalBuilder(dm, k,
                                 params={'forceDeviceCSR': True}).getH2()
    return dm, H


@pytest.fixture(scope='module')
def recorded():
    m = _mesh('circle8')
    record = {}
    dm, H = _buildJax(m, record)
    for name in RECORDED:
        assert record.get(name), name
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 2,
                           device='cpu')
    return m, dm, H, record, tk


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _assertData(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(np.asarray(got) - ref).max() <= TOL * scale


def _tables(args):
    """(dofNode, treePos, indptrT, tStart) int32 from recorded arrays."""
    return tuple(_t(a, torch.int32) for a in args)


def test_masked_csr_scan_vs_panel_scatter_slots(recorded):
    m, dm, H, record, tk = recorded
    prof = tk.profileParams()
    for args, statics in record['_bucket_masked_csr_scan']:
        (data, vertices, cells, vols, di, dj, sf, slots, bx, by, w,
         PSIP) = args
        ref = np.asarray(jasm._bucket_masked_csr_scan(
            jnp.zeros_like(data), vertices, cells, vols, di, dj, sf, slots,
            bx, by, w, PSIP, **statics))
        di, dj, sf = di.reshape(-1), dj.reshape(-1), sf.reshape(-1)
        got = torch.zeros(data.shape[0], dtype=torch.float64)
        tasm.panel_scatter_slots(
            got, _t(vertices), _t(cells[di], torch.int64),
            _t(cells[dj], torch.int64),
            _t(slots.reshape(len(di), -1), torch.int32),
            _t(vols[di] * vols[dj] * sf), None, _t(bx), _t(by), _t(w),
            _t(PSIP), prof)
        _assertData(got.numpy()[:-1], ref[:-1])


def test_surface_tree_scan_vs_panel_scatter_tree(recorded):
    m, dm, H, record, tk = recorded
    prof = tk.getBoundaryKernel().profileParams()
    for args, statics in record['_bucket_surface_tree_scan']:
        (data, vertices, dofNode, treePos, indptrT, tStart, vi1, vi2, dr, vs,
         nm, yo, I, J, offF, offB, bx, by, w, PSIP) = args
        assert statics['useNormals'] and not statics['useYShift']
        ref = np.asarray(jasm._bucket_surface_tree_scan(
            jnp.zeros_like(data), *args[1:], **statics))
        P = vi1.shape[0] * vi1.shape[1]
        flat = (lambda a: a.reshape((P,) + a.shape[2:]))
        got = torch.zeros(data.shape[0], dtype=torch.float64)
        tasm.panel_scatter_tree(
            got, _t(vertices), _t(flat(vi1), torch.int64),
            _t(flat(vi2), torch.int64), _t(flat(dr), torch.int64),
            _t(flat(vs)), _t(flat(nm)),
            *(_t(flat(a), torch.int32) for a in (I, J, offF, offB)),
            _tables((dofNode, treePos, indptrT, tStart)), _t(bx), _t(by),
            _t(w), _t(PSIP), prof)
        _assertData(got.numpy()[:-1], ref[:-1])


def test_enum_phase1_vs_near_enum(recorded):
    m, dm, H, record, tk = recorded
    for args, statics in record['_enum_phase1']:
        (cum, offI, offJ, n2, IA, JA, ncArr, cells, cellNodes, centers, logh,
         cA, cB, cC, Treal) = args
        keys, pT, hist = (np.asarray(a) for a in jasm._enum_phase1(
            *args, **statics))
        i32 = (lambda a: _t(a, torch.int32))
        k, p, h = tasm.near_enum(
            *(i32(a) for a in (cum, offI, offJ, n2, IA, JA, ncArr, cells,
                               cellNodes)),
            _t(centers, torch.float32), _t(logh, torch.float32),
            (cA, cB, cC))
        T = int(Treal)
        assert k.shape == (T,) and k.dtype == torch.int8
        np.testing.assert_array_equal(k.numpy(), keys[:T])
        np.testing.assert_array_equal(p.numpy(), pT[:T])
        # the JAX keys are padded to Tpad with the sentinel
        hist = hist.copy()
        hist[tasm.ENUM_SENTINEL] -= statics['Tpad'] - T
        np.testing.assert_array_equal(h.numpy(), hist)
        assert (keys[:T] != tasm.ENUM_SENTINEL).any()


def test_enum_phase2_vs_near_enum_quad(recorded):
    m, dm, H, record, tk = recorded
    prof = tk.profileParams()
    orders = set()
    for args, statics in record['_enum_phase2']:
        (data, keys, pT, cum, offI, offJ, n2, IA, JA, offF, offB, ncArr,
         vertices, cells, vols, dofs, treePos, dofNode, indptrT, tStart,
         order, count, bx, by, w, PSIP) = args
        ref = np.asarray(jasm._enum_phase2(jnp.zeros_like(data), *args[1:],
                                           **statics))
        ids = np.nonzero(keys == int(order))[0]
        assert len(ids) == int(count)
        orders.add(int(order))
        i32 = (lambda a: _t(a, torch.int32))
        got = torch.zeros(data.shape[0], dtype=torch.float64)
        tasm.near_enum_quad(
            got, i32(ids), *(i32(a) for a in (pT, cum, offI, offJ, n2, IA, JA,
                                               offF, offB, ncArr)),
            _t(vertices), _t(cells, torch.int64), _t(vols),
            _t(dofs, torch.int64),
            _tables((dofNode, treePos, indptrT, tStart)), _t(bx), _t(by),
            _t(w), _t(PSIP), prof)
        _assertData(got.numpy()[:-1], ref[:-1])
    assert len(orders) >= 2


def test_touching_slots_vs_host_adds(recorded):
    """The touching pairs go to explicit slots in the port and through the
    host adds of DeviceCSRAccumulator in the JAX package (with the shared
    j-side dofs DROPped and the cluster-pair incidence masks)."""
    m, dm, H, record, tk = recorded
    _, tdm, _ = fromArrays(m.vertices, m.cells, 0.75, 2,
                         device='cpu')
    calls = []
    orig = tasm.panel_scatter_slots

    def rec(data, *args):
        calls.append((data.shape[0], args))
        return orig(data, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tasm, 'panel_scatter_slots', rec)
        tasm.nonlocalBuilder(tdm, tk).getH2()
    touching = [c for c in calls if c[1][3].shape[1] == 36]
    assert touching and len(touching) < len(calls)
    got = torch.zeros(calls[0][0], dtype=torch.float64)
    for n, args in touching:
        orig(got, *args)
    _assertData(got.numpy()[:-1], record['hostData'][:-1])


@pytest.fixture(scope='module', params=['circle8', 'disc'])
def built(request, recorded):
    if request.param == 'circle8':
        m, dm, H, _, tk = recorded
    else:
        m = _mesh('disc')
        dm, H = _buildJax(m)
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 2,
                           device='cpu')
    return m, dm, H, tasm.nonlocalBuilder(tdm, tk, params=FLAT).getH2()


def test_near_data_matches_jax_flat_engine(built):
    m, dm, H, Ht = built
    ref = np.asarray(H.Anear.dataZ[:-1])
    mt = H.Anear.meta
    np.testing.assert_array_equal(Ht.Anear.meta.indptrT, mt.indptrT)
    np.testing.assert_array_equal(Ht.Anear.meta.tmplAll, mt.tmplAll)
    np.testing.assert_array_equal(Ht.Anear.meta.perm, mt.perm)
    _assertData(Ht.Anear.dataT.numpy(), ref)
    np.testing.assert_allclose(Ht.diagonal.numpy(), np.asarray(H.diagonal),
                               rtol=0, atol=TOL * np.abs(ref).max())


def test_h2_matvec_matches_jax_host_path(built):
    m, dm, H, Ht = built
    Hhost = jasm.nonlocalBuilder(dm, jKernel(2, 0.75)).getH2()
    x = np.random.default_rng(0).normal(size=dm.num_dofs)
    ref = np.asarray(Hhost.matvec(jnp.asarray(x)))
    got = Ht.matvec(torch.as_tensor(x)).numpy()
    assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)


def test_near_enum_validates_inputs():
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match='int32'):
        tasm.near_enum(z.long(), z[:1], z[:1], z[:1], z[:1], z[:1], z,
                       torch.zeros((2, 3), dtype=torch.int32),
                       torch.zeros((2, 3), dtype=torch.int32),
                       torch.zeros((2, 2)), torch.zeros(2), (0.75, 1.0, 0.0))
    with pytest.raises(ValueError, match='2D'):
        tasm.near_enum(z, z[:1], z[:1], z[:1], z[:1], z[:1], z,
                       torch.zeros((2, 2), dtype=torch.int32),
                       torch.zeros((2, 2), dtype=torch.int32),
                       torch.zeros((3, 2)), torch.zeros(2), (0.75, 1.0, 0.0))


def test_enumeration_segments_do_not_change_the_near_data(recorded):
    """At test sizes all flat elements fit one 2^25 segment; with segments
    of 2^10 elements the same near data must come out (the segments cut
    the cluster-pair list; the sums only change order)."""
    m, dm, H, _, tk = recorded
    _, tdm, _ = fromArrays(m.vertices, m.cells, 0.75, 2,
                         device='cpu')
    ref = tasm.nonlocalBuilder(tdm, tk, params=FLAT).getH2().Anear.dataT
    calls = []
    orig = tasm.near_enum
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tasm, 'ENUM_SEGMENT', 1 << 10)
        mp.setattr(tasm, 'near_enum',
                   lambda *a: calls.append(int(a[0][-1])) or orig(*a))
        got = tasm.nonlocalBuilder(tdm, tk, params=FLAT).getH2().Anear.dataT
    assert len(calls) > 10 and max(calls) <= 1 << 10
    _assertData(got.numpy(), ref.numpy())


def test_tree_slots_match_pattern_search(recorded):
    """The host slot arithmetic of the explicit-slot buckets against a
    search of the tree-ordered pattern itself, on random entries (in and
    outside the pattern, and negative dofs)."""
    m, dm, H, _, tk = recorded
    _, tdm, _ = fromArrays(m.vertices, m.cells, 0.75, 2,
                         device='cpu')
    accs = []
    cls = tasm.DeviceTreeCSRAccumulator

    def keep(*a, **kw):
        acc = cls(*a, **kw)
        accs.append(acc)
        return acc
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tasm, 'DeviceTreeCSRAccumulator', keep)
        Ht = tasm.nonlocalBuilder(tdm, tk).getH2()
    acc, = accs
    rows, cols = (t.numpy() for t in Ht.Anear.rowsCols())
    perm = Ht.Anear.meta.perm
    N = tdm.num_dofs
    key = perm[rows] * N + perm[cols]              # global (row, col)
    slotOf = dict(zip(key.tolist(), range(len(key))))
    rng = np.random.default_rng(0)
    a = rng.integers(-3, N, size=20000)
    b = rng.integers(-3, N, size=20000)
    # half of them taken from the pattern itself
    pick = rng.integers(0, len(key), size=10000)
    a[:10000], b[:10000] = perm[rows[pick]], perm[cols[pick]]
    ref = np.array([slotOf.get(int(i) * N + int(j), acc.nnz)
                    if i >= 0 and j >= 0 else acc.nnz
                    for i, j in zip(a, b)])
    np.testing.assert_array_equal(acc.slots(a, b), ref)
    assert (ref < acc.nnz).sum() >= 10000
