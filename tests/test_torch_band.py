"""The band-ELL layout (K18) of the port against the JAX package, on the
CPU, in float64.

- Tables: ``rcm_permutation``, ``build_band_tables`` and
  ``build_band_tables_coo`` equal the JAX package's, entry for entry, on
  the vessel's and the cylinder's P2 dofmaps; the port's pair tables
  (only the (tile, slot) pairs that hold an entry) expand back to the JAX
  (S, R, 128) lanes exactly, hold every occupied pair once, in slot order
  and in frame; ``band_values`` (a slot-grouped sum) expanded agrees with
  the JAX segment-sum to 1e-13 relative to the largest entry (the same
  float64 sums in another order).
- Kernels: the plain versions of K18 against ``make_band_matvec_batched``,
  ``make_band_bicgstab_iter`` and ``make_band_cg_iter`` in interpret mode
  on the systems of tests/test_band_kernels.py (a scrambled quad grid, so
  RCM has work to do and cross-tile shifts occur), in float64: products
  to 1e-12 relative, solves with equal iterations per row and x to 1e-10
  relative (rtol 1e-10: the same float64 algorithm, sums in another
  order); the product also on the two dofmaps' operators at batch 1
  and 3.
- The solver: ``ell_layout="band"`` against the JAX package's band engine
  (``options={"pallas": "interpret", "ell_layout": "band"}``) on the
  vessel (pure-Neumann pressure, nullspace) and the DFG cylinder (outlet
  PressureBC), 3 steps, rtol 1e-8: equal u/p/c iterations, u and p to 1e-9
  relative (the bound of tests/test_torch_unstructured.py: both run the
  same float64 algorithm, and the solves stop at rtol 1e-8).  The JAX band
  engine solves the pressure with an XLA AMG-PCG, the port with K17's
  (the same math); both run on the port's coarse pseudo-inverse.
- Band against flat ELL in the port: u and p to 1e-10 relative, equal
  iterations (only the order of the sums differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
from oasisx_tpu.assembly import band as jbd  # noqa: E402
from oasisx_tpu.assembly import pallas_ops as po  # noqa: E402
from oasisx_tpu_torch.assembly import band as tbd  # noqa: E402
from oasisx_tpu_torch.assembly import kernels as kn  # noqa: E402
from oasisx_tpu_torch.la import band  # noqa: E402
from tests.test_band_kernels import _grid_operator, _tables  # noqa: E402
from tests.test_torch_unstructured import _cylinder, _up, _vessel  # noqa: E402

DT, NU = 2e-3, 1.0 / 1600.0


@pytest.fixture(scope="module", params=["vessel", "cylinder"])
def dofmap(request):
    """A P2 velocity dofmap of the general path: (cell dofs, n)."""
    s = (_vessel(T, TM, 3, {}, device="cpu") if request.param == "vessel"
         else _cylinder(T, TM, {}, device="cpu"))
    V = s._Vi[0][0]
    return np.asarray(V.dofmap.cell_dofs, np.int64), V.num_dofs


def _expand(t, asm):
    return tbd.expand(t, asm.tile_ptr, asm.pair_slot, asm.S)


def test_band_tables_equal_jax(dofmap):
    cd, n = dofmap
    rows, cols = tbd._edges(cd)
    perm = tbd.rcm_permutation(rows, cols, n)
    assert np.array_equal(perm, jbd.rcm_permutation(rows, cols, n))
    got, ref = tbd.build_band_tables(cd, cd, n, n, perm), jbd.build_band_tables(cd, cd, n, n, perm)
    assert got[0] == ref[0] and got[3:] == ref[3:]
    assert got[1].dtype == ref[1].dtype == np.int32
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    # the port's assembly map takes the same slots and permutation
    asm = tbd.build_band_assembly(cd, n, "cpu")
    assert asm.shifts == ref[0] and asm.R == ref[3]
    assert np.array_equal(asm.perm.numpy(), perm)
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(rows.size)
    got = tbd.build_band_tables_coo(rows, cols, vals, n, n, perm)
    ref = jbd.build_band_tables_coo(rows, cols, vals, n, n, perm)
    assert got[0] == ref[0] and got[3:] == ref[3:]
    assert np.array_equal(got[2], ref[2])
    assert np.abs(got[1] - ref[1]).max() == 0


def test_pair_tables_expand_to_jax(dofmap):
    """The pair tables expand back to exactly the JAX package's (S, R, 128)
    lanes, and ``band_values`` to the JAX values; compact(expand(v)) is v."""
    cd, n = dofmap
    asm = tbd.build_band_assembly(cd, n, "cpu")
    _, slots, cols, R, _ = jbd.build_band_tables(cd, cd, n, n, asm.perm.numpy())
    lanes = _expand(asm.lanes, asm)
    assert lanes.dtype == torch.uint8 and np.array_equal(lanes.int().numpy(), cols)
    elems = np.random.default_rng(5).standard_normal((cd.shape[0], cd.shape[1], cd.shape[1]))
    ref = np.asarray(jbd.band_values(jnp.asarray(elems), jnp.asarray(slots), asm.S, R))
    vals = tbd.band_values(torch.tensor(elems), asm)
    assert vals.shape == (asm.P, 128)
    full = _expand(vals, asm).numpy()
    assert np.abs(full - ref).max() <= 1e-13 * np.abs(ref).max()
    assert torch.equal(tbd.compact(_expand(vals, asm), asm.tile_ptr, asm.pair_slot), vals)


def test_pair_tables_skip_empty_slots(dofmap):
    """Every tile has pairs, in ascending slot order and in frame, and P is
    the number of distinct occupied (slot, tile) cells of the JAX layout."""
    cd, n = dofmap
    asm = tbd.build_band_assembly(cd, n, "cpu")
    shifts, slots, _, R, _ = jbd.build_band_tables(cd, cd, n, n, asm.perm.numpy())
    slot, row = np.divmod(slots.astype(np.int64), R * 128)
    occupied = np.unique(slot * R + row // 128)
    ptr = asm.tile_ptr.numpy().astype(np.int64)
    assert asm.P == occupied.size == ptr[-1] and ptr[0] == 0 and asm.R == R
    assert asm.tile_ptr.dtype == asm.pair_shift.dtype == torch.int32
    assert isinstance(asm.pair_slot, np.ndarray) and asm.pair_slot.dtype == np.int32
    count = np.diff(ptr)
    assert count.min() >= 1
    tile = np.repeat(np.arange(R), count)
    ps = asm.pair_slot.astype(np.int64)
    assert np.array_equal(np.sort(ps * R + tile), occupied)
    same_tile = tile[1:] == tile[:-1]
    assert np.all(ps[1:][same_tile] > ps[:-1][same_tile])  # ascending slot in a tile
    sh = asm.pair_shift.numpy()
    assert np.array_equal(sh, np.asarray(shifts)[ps])
    assert (tile + sh).min() >= 0 and (tile + sh).max() < R
    assert asm.nnz == np.unique(slots).size


@pytest.mark.parametrize("nb", [1, 3])
def test_pair_product_matches_kernel(dofmap, nb):
    """The plain pair-table product against ``make_band_matvec_batched`` in
    interpret mode on the dofmap's operator (random element matrices), in
    float64."""
    cd, n = dofmap
    asm = tbd.build_band_assembly(cd, n, "cpu")
    shifts, slots, cols, R, _ = jbd.build_band_tables(cd, cd, n, n, asm.perm.numpy())
    rng = np.random.default_rng(6)
    elems = rng.standard_normal((cd.shape[0], cd.shape[1], cd.shape[1]))
    jv = jbd.band_values(jnp.asarray(elems), jnp.asarray(slots), len(shifts), R)
    x = np.zeros((nb, R * 128))
    x[:, :n] = rng.standard_normal((nb, n))
    mv = po.make_band_matvec_batched(shifts, R, R, nb, interpret=True)
    ref = np.asarray(mv(jv, jnp.asarray(cols), jnp.asarray(x.reshape(nb, R, 128)))).reshape(nb, -1)
    kn.reset_counts()
    got = band.band_matvec(tbd.band_values(torch.tensor(elems), asm), *asm.tables,
                           torch.tensor(x)).numpy()
    assert kn.plain_calls["band_matvec"] == 1 and kn.launches["band_matvec"] == 0
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_band_values_match_jax(dofmap):
    cd, n = dofmap
    asm = tbd.build_band_assembly(cd, n, "cpu")
    _, slots, _, R, _ = jbd.build_band_tables(cd, cd, n, n, asm.perm.numpy())
    elems = np.random.default_rng(2).standard_normal((cd.shape[0], cd.shape[1], cd.shape[1]))
    ref = np.asarray(jbd.band_values(jnp.asarray(elems), jnp.asarray(slots), asm.S, R))
    got = _expand(tbd.band_values(torch.tensor(elems), asm), asm).numpy()
    assert got.shape == ref.shape == (asm.S, asm.R, 128)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert np.count_nonzero(ref) == np.count_nonzero(got) <= asm.nnz


def _pairs(shifts, vals, cols, R, slots=None):
    """Pair tables (torch) and pair values of a JAX (S, R, 128) operator:
    its entries (from the entries' ``slots``, or the nonzero values) back
    to (row, col), through ``build_pair_tables``, whose slots must be the
    JAX ones."""
    S = len(shifts)
    if slots is None:
        slots = np.flatnonzero(vals.reshape(S, -1))
    slot, row = np.divmod(np.unique(np.asarray(slots, np.int64)), R * 128)
    col = (row // 128 + np.asarray(shifts)[slot]) * 128 + np.asarray(cols).reshape(S, -1)[slot, row]
    order = np.lexsort((col, row))
    sh_, tp, sh, ln, ps, _ = tbd.build_pair_tables(row[order], col[order], R)
    assert sh_ == tuple(shifts)
    tp, sh, ln = (torch.tensor(a) for a in (tp, sh, ln))
    assert np.array_equal(tbd.expand(ln, tp, ps, S).int().numpy(), cols)
    return tbd.compact(torch.tensor(vals), tp, ps), tp, sh, ln


@pytest.fixture(scope="module")
def grid_system():
    """tests/test_band_kernels.py's operator, float64, in band form."""
    cd, elems, _, n = _grid_operator()
    perm, iperm, shifts, slots, colsb, R = _tables(cd, n)
    elems = elems.astype(np.float64)
    A = np.zeros((n, n))  # assembled in float64 (the helper's is float32)
    for c in range(cd.shape[0]):
        A[np.ix_(cd[c], cd[c])] += elems[c]
    vals = np.asarray(jbd.band_values(jnp.asarray(elems), jnp.asarray(slots), len(shifts), R))
    return dict(A=A, n=n, perm=perm, iperm=iperm, shifts=shifts, cols=colsb, R=R, vals=vals,
                pairs=_pairs(shifts, vals, colsb, R, slots))


def _tb(a, sys_, fill=0.0):
    """(nb, n) canonical -> (nb, R*128) band form, numpy."""
    out = np.full((a.shape[0], sys_["R"] * 128), fill)
    out[:, : sys_["n"]] = a[:, sys_["perm"]]
    return out


def _torch_band(sys_):
    """(vals (P, 128), tile_ptr, pair_shift, lanes) of the system."""
    return sys_["pairs"]


def test_band_matvec_matches_kernel(grid_system):
    s = grid_system
    assert min(s["shifts"]) < 0 < max(s["shifts"])
    rng = np.random.default_rng(2)
    x = _tb(rng.standard_normal((3, s["n"])), s)
    R = s["R"]
    mv = po.make_band_matvec_batched(s["shifts"], R, R, 3, interpret=True)
    ref = np.asarray(mv(jnp.asarray(s["vals"]), jnp.asarray(s["cols"]),
                        jnp.asarray(x.reshape(3, R, 128)))).reshape(3, -1)
    kn.reset_counts()
    got = band.band_matvec(*_torch_band(s), torch.tensor(x)).numpy()
    assert kn.plain_calls["band_matvec"] == 1 and kn.launches["band_matvec"] == 0
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # and the dense operator, back in the canonical order
    y = got[:, : s["n"]][:, s["iperm"]]
    dense = (x[:, : s["n"]][:, s["iperm"]]) @ s["A"].T
    assert np.abs(y - dense).max() <= 1e-12 * np.abs(dense).max()


def test_band_bicgstab_matches_kernel(grid_system):
    """Dirichlet rows (zmask 0, x0 preset), two rows of different scale."""
    s = grid_system
    n, R = s["n"], s["R"]
    rng = np.random.default_rng(3)
    masks = np.zeros((2, n), bool)
    masks[0, :17] = True
    masks[1, -9:] = True
    bcv = np.where(masks, 0.7, 0.0)
    b = rng.standard_normal((2, n)) * np.array([[1.0], [50.0]])
    rhs = np.where(masks, bcv, b)
    A = s["A"]
    zmask = _tb(np.where(masks, 0.0, 1.0), s)
    x0 = _tb(bcv, s)
    rhsb = _tb(rhs, s)
    invd = _tb(1.0 / np.diag(A)[None], s, fill=1.0)[0]
    Ab = lambda v: (v[:, :n][:, s["iperm"]] @ A.T)
    r0 = zmask * (rhsb - _tb(Ab(x0), s))
    bnorm = np.sqrt(np.sum(rhsb * rhsb, axis=-1))
    rtol, maxiter = 1e-10, 300
    itf = po.make_band_bicgstab_iter(s["shifts"], R, 2, interpret=True)
    sh = lambda v: jnp.asarray(v.reshape(v.shape[0], R, 128))
    xj, itj, _, cj = po.ell_bicgstab_from_r0(
        itf, jnp.asarray(s["vals"]), jnp.asarray(s["cols"]), sh(r0), sh(x0), sh(zmask),
        jnp.asarray(invd.reshape(R, 128)), jnp.asarray(bnorm), rtol, maxiter)
    xj = np.asarray(xj).reshape(2, -1)
    t = torch.tensor
    kn.reset_counts()
    res = band.band_bicgstab(*_torch_band(s), t(r0), t(x0), t(zmask), t(invd), t(bnorm), rtol,
                             maxiter)
    assert kn.plain_calls["band_bicgstab"] == 1
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    assert np.array_equal(res.iters.numpy(), np.asarray(itj)), (res.iters, itj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    # the solution of the masked system, in the canonical order
    x = res.x.numpy()[:, :n][:, s["iperm"]]
    assert np.allclose(np.where(masks, x, x @ A.T), rhs, atol=1e-8 * np.abs(rhs).max())


def test_band_cg_matches_kernel():
    """An SPD operator (A A^T + 5 I) as a static COO band table."""
    cd, _, A, n = _grid_operator(dd=0.0)
    spd = A.astype(np.float64) @ A.astype(np.float64).T + 5 * np.eye(n)
    rows, cols = np.nonzero(spd)
    perm = tbd.rcm_permutation(rows, cols, n)
    shifts, vals, colsb, R, _ = tbd.build_band_tables_coo(rows, cols, spd[rows, cols], n, n, perm)
    s = dict(n=n, perm=perm, R=R)
    rng = np.random.default_rng(4)
    b = _tb(rng.standard_normal((2, n)) * np.array([[1.0], [1e-3]]), s)
    x0 = np.zeros_like(b)
    invd = _tb(1.0 / np.diag(spd)[None], s, fill=1.0)[0]
    bnorm = np.sqrt(np.sum(b * b, axis=-1))
    rtol, maxiter = 1e-10, 300
    itf = po.make_band_cg_iter(shifts, R, 2, interpret=True)
    sh = lambda v: jnp.asarray(v.reshape(v.shape[0], R, 128))
    xj, itj, _, cj = po.ell_cg_batched_from_r0(
        itf, jnp.asarray(vals), jnp.asarray(colsb), sh(b), sh(x0),
        jnp.asarray(invd.reshape(R, 128)), jnp.asarray(bnorm), rtol, maxiter)
    xj = np.asarray(xj).reshape(2, -1)
    t = torch.tensor
    res = band.band_cg(*_pairs(shifts, vals, colsb, R), t(b), t(x0), t(invd), t(bnorm), rtol,
                       maxiter)
    assert bool(np.asarray(cj).all()) and bool(res.converged.all())
    assert np.array_equal(res.iters.numpy(), np.asarray(itj)), (res.iters, itj)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()


def _share_coarse_inverse(sj, st):
    """The JAX band engine's XLA AMG-PCG on the port's coarse
    pseudo-inverse (the rest of the hierarchy is equal)."""
    rep = sj.config_report()
    assert rep["pallas"]["ell_single"] == "band" and rep["pressure_pc"] == "amg-pcg"
    sj._amg.coarse_inv = jnp.asarray(st._amg.coarse_inv.numpy())


def _run(s, steps, dt, nu):
    st = s.run(steps, dt, nu, max_iter=1)
    for k in ("u_converged", "p_converged", "c_converged"):
        assert np.all(st[k]), k
    return st, _up(s)


CASES = {
    "vessel": (lambda pkg, M, opts, **kw: _vessel(pkg, M, 3, opts, **kw), DT, NU),
    "cylinder": (_cylinder, 0.01, 0.001),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_band_path_matches_jax_band_engine(case):
    make, dt, nu = CASES[case]
    opts = {"low_memory_version": False, "ell_layout": "band"}
    sj = make(J, JM, dict(opts, pallas="interpret"))
    st = make(T, TM, opts, device="cpu")
    rep = st.config_report()
    assert rep["ell_layout"] == "band" and rep["path_kernels"] == list(kn.BAND_KERNELS)
    _share_coarse_inverse(sj, st)
    stj, (uj, pj) = _run(sj, 3, dt, nu)
    kn.reset_counts()
    stt, (ut, pt) = _run(st, 3, dt, nu)
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stj[k], stt[k], err_msg=k)
    assert np.abs(uj - ut).max() <= 1e-9 * np.abs(uj).max()
    assert np.abs(pj - pt).max() <= 1e-9 * np.abs(pj).max()
    # the velocity solves and products went through the band kernels' plain
    # versions, the pressure through K17's
    for name in ("band_matvec", "band_bicgstab", "band_cg", "ell_pcg_amg"):
        assert kn.plain_calls[name] >= 3, name
    assert kn.plain_calls["ell_bicgstab"] == kn.plain_calls["ell_cg"] == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_band_path_matches_ell_path(case):
    make, dt, nu = CASES[case]
    out = {}
    for layout in ("ell", "band"):
        s = make(T, TM, {"low_memory_version": False, "ell_layout": layout}, device="cpu")
        out[layout] = _run(s, 3, dt, nu)
    (se, (ue, pe)), (sb, (ub, pb)) = out["ell"], out["band"]
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(se[k], sb[k], err_msg=k)
    assert np.abs(ue - ub).max() <= 1e-10 * np.abs(ue).max()
    assert np.abs(pe - pb).max() <= 1e-10 * np.abs(pe).max()


def test_band_wrappers_route_and_raise(grid_system):
    """A CPU tensor takes the plain version; a device with no kernel
    raises; the lumped update still raises."""
    s = grid_system
    op = _torch_band(s)
    nb, m = 2, s["R"] * 128
    z = torch.zeros((nb, m), dtype=torch.float64)
    one, bn = torch.ones(m, dtype=torch.float64), torch.ones(nb, dtype=torch.float64)
    calls = {
        "band_matvec": lambda f: band.band_matvec(*map(f, op), f(z)),
        "band_bicgstab": lambda f: band.band_bicgstab(*map(f, op), f(z), f(z), f(z), f(one),
                                                      f(bn), 1e-8, 5),
        "band_cg": lambda f: band.band_cg(*map(f, op), f(z), f(z), f(one), f(bn), 1e-8, 5),
    }
    kn.reset_counts()
    for name, call in calls.items():
        call(lambda t: t)
        assert kn.plain_calls[name] == 1, name
        with pytest.raises(ValueError):
            call(lambda t: t.to("meta"))
    assert sum(kn.launches.values()) == 0
    kn.reset_counts()


def test_band_wrappers_check_frame(grid_system):
    """A vector whose tile count is not the operator's, or tables that
    disagree on the pair count, raise before any product, on either
    device."""
    vals, tp, sh, ln = _torch_band(grid_system)
    m = grid_system["R"] * 128
    z = torch.zeros((2, m), dtype=torch.float64)
    one, bn = torch.ones(m, dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    kn.reset_counts()
    for bad in (z[:, :-128], torch.zeros((2, m + 128), dtype=torch.float64)):
        with pytest.raises(ValueError, match="tiles"):
            band.band_matvec(vals, tp, sh, ln, bad)
        with pytest.raises(ValueError, match="tiles"):
            band.band_cg(vals, tp, sh, ln, bad, bad, one, bn, 1e-8, 5)
        with pytest.raises(ValueError, match="tiles"):
            band.band_bicgstab(vals, tp, sh, ln, bad, bad, bad, one, bn, 1e-8, 5)
    with pytest.raises(ValueError, match="pairs"):
        band.band_matvec(vals, tp, sh[:-1], ln, z)
    with pytest.raises(ValueError, match="pairs"):
        band.band_matvec(vals[:-1], tp, sh, ln, z)
    assert sum(kn.plain_calls.values()) == sum(kn.launches.values()) == 0


def test_check_pair_tables_rejects(grid_system):
    """The build-time check of the pair tables: a pair count other than
    tile_ptr's end, a decreasing tile_ptr, a source tile out of frame and
    tables of 2**31 lanes or more raise ValueError; the grid system's
    tables pass."""
    _, tp, sh, _ = grid_system["pairs"]
    tp, sh = tp.numpy().astype(np.int64), sh.numpy().astype(np.int64)
    R = tp.size - 1
    tbd.check_pair_tables(tp, sh, R)
    cases = {
        r"0 to P": (np.concatenate([tp[:-1], [tp[-1] + 1]]), sh, R),
        r"\(R\+1,\)": (tp, sh, R + 1),
        r"decreases": (np.concatenate([tp[:1], tp[2:3], tp[1:2], tp[3:]]), sh, R),
        r"outside": (tp, np.where(np.arange(sh.size) == sh.size - 1, R, sh), R),
    }
    for msg, (t, s, r) in cases.items():
        with pytest.raises(ValueError, match=msg):
            tbd.check_pair_tables(t, s, r)
    big = 2**31 // 128
    with pytest.raises(ValueError, match="int32"):
        tbd.check_pair_tables(np.array([0, big]), np.zeros(big, np.int8), 1)
