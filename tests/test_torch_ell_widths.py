"""The slice widths of the port's ELL operators (``graph.slice_widths``),
which bound the row loop of the ELL kernels K14-K16, on the CPU with
NumPy and torch alone:

- ``widths`` equals an independent count from the dofmap's (row, column)
  pairs (``np.unique``, the largest row length of every 32 rows), for the
  P2 and P1 spaces of the vessel-deformed N=4 box and of the 2D cylinder
  channel at res=6;
- in ``ell_values`` of a random element stack every slot at or past its
  slice's width holds value 0 and column 0, so a product that stops each
  row at its slice's width equals the product over all K slots bit for bit
  (``torch.equal``), in float64 and float32, at batch 1 and 3 (the
  kernels' slot loop, summed in the same order), and the plain version
  (all K slots) agrees with both;
- the wrappers raise on widths of another shape or type, or none.

The kernels themselves run only on the card; ``chip_smoke.py`` holds them
to their plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from chip_smoke import deform_vessel  # noqa: E402
from oasisx_tpu_torch.elements.element import make_element  # noqa: E402
from oasisx_tpu_torch.la import ell  # noqa: E402
from oasisx_tpu_torch.meshes import create_box, create_cylinder_channel  # noqa: E402
from oasisx_tpu_torch.parallel import graph as tgr  # noqa: E402
from oasisx_tpu_torch.spaces.functionspace import FunctionSpace  # noqa: E402

MESHES = ("vessel", "cylinder")


def _dofmap(mesh_name: str, deg: int):
    if mesh_name == "vessel":
        mesh = deform_vessel(create_box((-1.0,) * 3, (1.0,) * 3, (4, 4, 4)))
    else:
        mesh = create_cylinder_channel(6)
    V = FunctionSpace(mesh, make_element(("Lagrange", deg), mesh.cell_type))
    return np.asarray(V.dofmap.cell_dofs), V.num_dofs


def _operator(mesh_name: str, deg: int, dtype, seed: int = 0):
    """The ELL assembly of the space and its values from a random element stack."""
    cd, n = _dofmap(mesh_name, deg)
    asm = tgr.build_ell_assembly(cd, n, "cpu")
    nd = cd.shape[1]
    elems = np.random.default_rng(seed).standard_normal((cd.shape[0], nd, nd))
    return asm, tgr.ell_values(torch.as_tensor(elems, dtype=dtype), asm)


def _row_widths(asm) -> np.ndarray:
    """(n,) each row's slice width."""
    return np.repeat(asm.widths.numpy(), tgr.ELL_SLICE)[: asm.n]


@pytest.mark.parametrize("deg", [2, 1])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_widths_equal_dofmap_count(mesh_name, deg):
    cd, n = _dofmap(mesh_name, deg)
    asm = tgr.build_ell_assembly(cd, n, "cpu")
    nd = cd.shape[1]
    rows = np.repeat(cd.astype(np.int64), nd, axis=1).ravel()
    cols = np.tile(cd.astype(np.int64), (1, nd)).ravel()
    rowlen = np.bincount(np.unique(rows * n + cols) // n, minlength=n)
    S = tgr.ELL_SLICE
    nsl = -(-n // S)
    want = np.concatenate([rowlen, np.zeros(S * nsl - n, np.int64)]).reshape(nsl, S).max(axis=1)
    assert asm.widths.dtype == torch.int32 and tuple(asm.widths.shape) == (nsl,)
    np.testing.assert_array_equal(asm.widths.numpy(), want)
    assert int(want.max()) == asm.K
    # the slots a product reads: every row's slice width, at most K per row
    assert asm.nnz <= int(_row_widths(asm).sum()) <= asm.K * n


def _slot_product(vals, cols, x, bound):
    """y[b, r] = sum over k < bound[r] of vals[k, r] x[b, cols[k, r]], the
    slots summed one at a time in order k = 0, 1, ... (the kernels' loop)."""
    acc = torch.zeros(x.shape[0], vals.shape[1], dtype=vals.dtype)
    for k in range(vals.shape[0]):
        acc = torch.where(k < bound, acc + vals[k] * x[:, cols[k].long()], acc)
    return acc


@pytest.mark.parametrize("deg", [2, 1])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_slots_past_width_are_padding(mesh_name, deg):
    asm, vals = _operator(mesh_name, deg, torch.float64, seed=deg)
    bound = _row_widths(asm)
    past = np.arange(asm.K)[:, None] >= bound[None, :]
    assert (vals.numpy()[past] == 0).all()
    assert (asm.cols.numpy()[past] == 0).all()
    rng = np.random.default_rng(deg)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        v = vals.to(dtype)
        for nb in (1, 3):
            x = torch.as_tensor(rng.standard_normal((nb, asm.n)), dtype=dtype)
            bounded = _slot_product(v, asm.cols, x, torch.as_tensor(bound))
            full = _slot_product(v, asm.cols, x, torch.full((asm.n,), asm.K))
            assert torch.equal(bounded, full)
            plain = ell.ell_matvec(v, asm.cols, asm.widths, x)  # CPU: the plain version
            assert float((plain - full).abs().max()) <= tol * float(full.abs().max())


def _call(name, vals, cols, widths):
    n = vals.shape[1]
    v = torch.zeros(1, n, dtype=vals.dtype)
    d, bn = torch.ones(n, dtype=vals.dtype), torch.ones(1, dtype=vals.dtype)
    if name == "ell_matvec":
        return ell.ell_matvec(vals, cols, widths, v)
    if name == "ell_bicgstab":
        return ell.ell_bicgstab(vals, cols, widths, v, v, v + 1, d, bn, 1e-8, 5)
    if name == "ell_cg":
        return ell.ell_cg(vals, cols, widths, v, v, d, bn, 1e-8, 5)
    return ell.ell_pcg_amg(({}, []), vals, cols, widths, v[0], v[0], 1e-8, 5)


@pytest.mark.parametrize("bad", ["long", "short", "int64", "uint8", "none"])
@pytest.mark.parametrize("name", ["ell_matvec", "ell_bicgstab", "ell_cg", "ell_pcg_amg"])
def test_wrappers_refuse_bad_widths(name, bad):
    asm, vals = _operator("cylinder", 1, torch.float64)
    w = asm.widths
    widths = {"long": torch.cat([w, w[:1]]), "short": w[:-1], "int64": w.long(),
              "uint8": w.to(torch.uint8), "none": None}[bad]
    with pytest.raises((TypeError, ValueError), match="widths"):
        _call(name, vals, asm.cols, widths)
