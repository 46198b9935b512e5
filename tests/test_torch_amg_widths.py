"""The slice widths of K17's AMG tables and its barrier count, on the CPU
with NumPy and torch alone:

- each level's A, P and R widths (``la/amg.py`` ``_to_ell``, returned by
  ``amg_widths`` and passed to K17 beside the tables) equal an
  independent count:
  the largest row length of every 32 rows, the row lengths counted with
  ``np.bincount`` from the COO that each table is built from, on the
  smoothed-aggregation hierarchy of the P1 pressure Laplacian of the
  vessel-deformed N=4 box and of the res=6 cylinder channel;
- in the (K, n) tables every slot at or past its row's slice width holds
  value 0 and column 0, so a product that stops each row at its slice's
  width equals the product over all K slots bit for bit (``torch.equal``,
  the kernel's slot order), in float64 and float32;
- ``amg_barriers``' grid barriers an iteration against counts of the
  kernel's phases, at the sizes of those hierarchies and of the vessel
  N=36 and cylinder res=30 ones;
- ``ell_pcg_amg`` and ``ell_vcycle`` refuse AMG tables without widths, or
  with widths of another count, shape or type, on the CPU too.

The kernel runs only on the card; ``chip_smoke.py`` holds it to its plain
version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from chip_smoke import deform_vessel  # noqa: E402
from oasisx_tpu_torch.assembly.geometry import compute_cell_geometry  # noqa: E402
from oasisx_tpu_torch.assembly.reference_tensors import build_reference_tensors  # noqa: E402
from oasisx_tpu_torch.elements.element import make_element  # noqa: E402
from oasisx_tpu_torch.la import amg as tamg  # noqa: E402
from oasisx_tpu_torch.la import ell  # noqa: E402
from oasisx_tpu_torch.meshes import create_box, create_cylinder_channel  # noqa: E402
from oasisx_tpu_torch.parallel.graph import ELL_SLICE  # noqa: E402
from oasisx_tpu_torch.spaces.functionspace import FunctionSpace  # noqa: E402

MESHES = ("vessel", "cylinder")
TABLES = ("A", "P", "R")


def _pressure_coo(mesh_name: str):
    """COO of the P1 pressure Laplacian, n."""
    mesh = (deform_vessel(create_box((-1.0,) * 3, (1.0,) * 3, (4, 4, 4)))
            if mesh_name == "vessel" else create_cylinder_channel(6))
    d = mesh.dim
    el_q = make_element(("Lagrange", 1), mesh.cell_type)
    Q = FunctionSpace(mesh, el_q)
    geo = compute_cell_geometry(mesh.x, mesh.cells, d)
    ref = build_reference_tensors(make_element(("Lagrange", 2), mesh.cell_type), el_q)
    elems = np.einsum("c,cab,abij->cij", geo.detJ, geo.G, ref.stiffness_q)
    return (*tamg.coo_from_elems(np.asarray(Q.dofmap.cell_dofs), elems, Q.num_dofs),
            Q.num_dofs)


def _hierarchy(mesh_name: str, dtype=torch.float64, monkeypatch=None):
    """The AMG (a small coarse size, so that it has ELL levels) and, with
    ``monkeypatch``, the COO of every table in the order it was built."""
    rows, cols, vals, n = _pressure_coo(mesh_name)
    seen = []
    if monkeypatch is not None:
        to_ell = tamg._to_ell
        monkeypatch.setattr(tamg, "_to_ell",
                            lambda r, c, v, m: seen.append((r, m)) or to_ell(r, c, v, m))
    amg = tamg.AlgebraicMG(rows, cols, vals, n, dtype=dtype, coarse_max=8, nullvec=np.ones(n))
    return amg, seen


@pytest.mark.parametrize("mesh_name", MESHES)
def test_amg_widths_equal_csr_count(mesh_name, monkeypatch):
    amg, seen = _hierarchy(mesh_name, monkeypatch=monkeypatch)
    assert len(amg.levels) >= 2 and len(seen) == 3 * len(amg.levels)
    widths = tamg.amg_widths(amg)
    for i, lv in enumerate(amg.levels):
        for j, key in enumerate(TABLES):
            rows, m = seen[3 * i + j]
            rowlen = np.bincount(rows, minlength=m)
            want = [int(rowlen[s:s + ELL_SLICE].max()) for s in range(0, m, ELL_SLICE)]
            w = lv["widths"][key]
            assert w.dtype == torch.int32 and w.tolist() == want
            assert torch.equal(widths[3 * i + j], w)
            assert max(want) == lv[key][0].shape[1]  # the table's K


def _slot_product(vals, cols, x, bound):
    """y[r] = sum over k < bound[r] of vals[k, r] x[cols[k, r]], slot by
    slot in order k = 0, 1, ... (K17's row loop)."""
    y = torch.zeros(vals.shape[1], dtype=vals.dtype)
    for k in range(vals.shape[0]):
        on = bound > k
        y = torch.where(on, y + vals[k] * x[cols[k].long()], y)
    return y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_slots_past_width_are_padding(mesh_name, dtype):
    amg, _ = _hierarchy(mesh_name, dtype)
    meta, arrays = tamg.amg_kernel_data(amg)
    widths = tamg.amg_widths(amg)
    rng = np.random.default_rng(5)
    for i, m in enumerate(meta["levels"]):
        tables = arrays[7 * i: 7 * i + 7]
        for j, (vals, cols, nin) in enumerate(((tables[0], tables[1], m["n"]),
                                               (tables[3], tables[4], m["nc"]),
                                               (tables[5], tables[6], m["n"]))):
            K, nrow = vals.shape
            bound = torch.repeat_interleave(widths[3 * i + j], ELL_SLICE)[:nrow]
            past = torch.arange(K)[:, None] >= bound[None, :]
            assert bool((vals[past] == 0).all()) and bool((cols[past] == 0).all())
            x = torch.as_tensor(rng.standard_normal(nin), dtype=dtype)
            full = _slot_product(vals, cols, x, torch.full((nrow,), K))
            assert torch.equal(_slot_product(vals, cols, x, bound), full)


# (levels, pre, post, nullspace) -> K17's grid barriers an iteration,
# counted in csrc/ell_ops.cu: the CG body's 5, 7 with a nullspace (the two
# projections' sums); per ELL level pre + 1 down (the sweeps after the
# first, the residual, the restriction) and post + 1 up (the prolongation,
# the sweeps); 1 for the dense coarse solve
BARRIERS = {
    "2 levels, V(1, 1), nullspace": ((2, 1, 1, True), 16),
    "2 levels, V(2, 2), nullspace": ((2, 2, 2, True), 20),
    "2 levels, V(3, 0), nullspace": ((2, 3, 0, True), 18),
    "cylinder res=30, V(2, 2), outlet mask": ((2, 2, 2, False), 18),
    "vessel N=36, V(2, 2), nullspace": ((3, 2, 2, True), 26),
}


@pytest.mark.parametrize("case", list(BARRIERS))
def test_k17_barriers(case):
    """``amg_barriers`` against counts of the kernel's phases; the last two
    are the hierarchies that chip_smoke's phase 3b prints (18 and 26)."""
    (L, pre, post, null), want = BARRIERS[case]
    levels = [dict(n=64, nc=8, K_A=1, K_P=1, K_R=1)] * L
    meta = dict(levels=levels, coarse_n=8, pre=pre, post=post, has_null=null)
    assert ell.amg_barriers(meta) == want


def test_k17_barriers_of_the_test_hierarchies():
    """The vessel N=4 and cylinder res=6 hierarchies have 2 ELL levels, V(1,
    1) and a nullspace."""
    for mesh_name in MESHES:
        meta, _ = tamg.amg_kernel_data(_hierarchy(mesh_name)[0])
        assert ell.amg_barriers(meta) == BARRIERS["2 levels, V(1, 1), nullspace"][1]


@pytest.mark.parametrize("bad", ["none", "one short", "int64", "long"])
@pytest.mark.parametrize("call", ["ell_pcg_amg", "ell_vcycle"])
def test_k17_wrappers_refuse_bad_widths(call, bad):
    amg, _ = _hierarchy("cylinder")
    meta, arrays = tamg.amg_kernel_data(amg)
    w = tamg.amg_widths(amg)
    if bad == "none":
        w = None
    elif bad == "one short":
        w = w[:-1]
    elif bad == "int64":
        w[1] = w[1].long()
    else:
        w[2] = torch.cat([w[2], w[2][:1]])
    n = meta["levels"][0]["n"]
    r = torch.zeros(n, dtype=torch.float64)
    vals = torch.zeros((1, n), dtype=torch.float64)
    cols = torch.zeros((1, n), dtype=torch.int32)
    widths0 = torch.ones(-(-n // ELL_SLICE), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError), match="widths"):
        if call == "ell_vcycle":
            ell.ell_vcycle((meta, arrays), r, w)
        else:
            ell.ell_pcg_amg((meta, arrays), vals, cols, widths0, r, r, 1e-8, 5, amg_widths=w)
