"""The port's I/O, CLI and demos, on the CPU (tests/test_io_cli.py on the
port, held against the JAX package where both write or read the same).

- Readers: ``demo/meshes/patient_vessel.msh``, Gmsh 2.2 and 4.1 files with
  physical groups, an .npz with facet tags and the missing-file fallback
  give the JAX package's points, cells and tags exactly.
- Writers: ``write_vtu`` (from tensors too) and ``write_gmsh22`` write the
  JAX package's bytes; ``VTXWriter`` writes its .vtu and .pvd bytes and the
  same .npz arrays.
- ``Checkpoint`` both ways: a solver of one package takes 3 steps and
  saves; fresh solvers of both packages load the file and take 2 more, the
  JAX one on its XLA path with the kernel path's tentative x0 and Jacobi-CG
  pressure at rtol 1e-12, the port's on the structured path: equal
  iterations, u and p to 1e-10 relative; the loaded Functions equal the
  saved arrays bit for bit.
- ``python -m oasisx_tpu_torch`` in a subprocess on the CPU: its .pvd, .vtu
  and .npz files and a checkpoint that loads back; without ``--device`` on
  a machine with no card it raises (no fallback to the CPU).
- Each demo at test_io_cli.py's sizes in float64 against the JAX package's
  demo/*.py on the same arguments, both packages' solves to 1e-12 with a
  Jacobi-CG pressure (the JAX solver on its XLA path with the kernel
  path's tentative x0), so that the demos' own arithmetic is what is held
  to 1e-8 relative: the Taylor-Green rates (per-step and ``run`` paths),
  assembly_bcs's dense matrices and right-hand sides (1e-12), the
  channel's Poiseuille errors (and its bound, < 0.02), the 3D
  Taylor-Green energy and dissipation, the vessel's velocity series on its
  generated mesh and on a .msh written by ``write_gmsh22`` with remapped
  tag ids, the cylinder's Cd / Cl and their statistics, and the Strouhal
  number of a lift signal; the 3D Taylor-Green also through ``python -m``.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oasisx_tpu as J  # noqa: E402
import oasisx_tpu.io as JIO  # noqa: E402
import oasisx_tpu.meshes as JM  # noqa: E402
import oasisx_tpu.spaces as JS  # noqa: E402
import oasisx_tpu_torch as T  # noqa: E402
import oasisx_tpu_torch.io as TIO  # noqa: E402
import oasisx_tpu_torch.meshes as TM  # noqa: E402
import oasisx_tpu_torch.spaces as TS  # noqa: E402
from oasisx_tpu_torch.demo import (  # noqa: E402
    assembly_bcs, channel, cylinder, taylor_green, taylor_green3d, vessel)
from tests.test_torch_lumped import _tgv2d  # noqa: E402
from tests.test_torch_slice import _kernel_path_x0  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VESSEL_MSH = ROOT / "demo" / "meshes" / "patient_vessel.msh"
CPU = ["--device", "cpu"]
DT, NU = 0.01, 0.01


# tests/test_io_cli.py's unit squares of 2 triangles, bottom edge tagged 7,
# right edge tagged 8
GMSH = {"2.2": """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
4
1 1 2 7 1 1 2
2 1 2 8 2 2 3
3 2 2 1 1 1 2 3
4 2 2 1 1 1 3 4
$EndElements
""", "4.1": """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
4 4 1 0
1 0 0 0 0
2 1 0 0 0
3 1 1 0 0
4 0 1 0 0
1 0 0 0 1 0 0 1 7 2 1 -2
2 1 0 0 1 1 0 1 8 2 2 -3
3 0 1 0 1 1 0 0 2 3 -4
4 0 0 0 0 1 0 0 2 4 -1
1 0 0 0 1 1 0 0 2 4 1 2 3 4
$EndEntities
$Nodes
5 4 1 4
0 1 0 1
1
0 0 0
0 2 0 1
2
1 0 0
0 3 0 1
3
1 1 0
0 4 0 1
4
0 1 0
1 1 0 0
$EndNodes
$Elements
3 4 1 4
1 1 1 1
1 1 2
1 2 1 1
2 2 3
2 1 2 2
3 1 2 3
4 1 3 4
$EndElements
"""}


def _same_mesh(mt, mj, tt, tj):
    np.testing.assert_array_equal(mt.x, mj.x)
    np.testing.assert_array_equal(mt.cells, mj.cells)
    assert mt.cell_type == mj.cell_type
    assert (tt is None) == (tj is None)
    if tt is not None:
        np.testing.assert_array_equal(tt.indices, tj.indices)
        np.testing.assert_array_equal(tt.values, tj.values)


@pytest.mark.parametrize("source", ["patient_vessel", "2.2", "4.1", "npz", "missing"])
def test_readers_match_jax(source, tmp_path):
    if source == "patient_vessel":
        path = VESSEL_MSH
    elif source in ("2.2", "4.1"):
        path = tmp_path / "m.msh"
        path.write_text(GMSH[source])
    elif source == "npz":
        m = JM.create_unit_square(4)
        path = tmp_path / "mesh.npz"
        np.savez(path, points=m.x, cells=m.cells, cell_type="triangle",
                 facet_tags_indices=m.exterior_facet_indices(),
                 facet_tags_values=np.arange(len(m.exterior_facet_indices())) % 3 + 1)
    else:
        path = tmp_path / "absent.msh"
    mt, tt = TIO.import_mesh_with_tags(path)
    mj, tj = JIO.import_mesh_with_tags(path)
    _same_mesh(mt, mj, tt, tj)
    assert isinstance(mt, TM.Mesh) and TIO.import_mesh(path).num_cells == mj.num_cells
    if source == "patient_vessel":
        assert mt.num_vertices == 1813 and set(np.unique(tt.values)) == {1, 2, 3}


def _tagged_box(M):
    """test_io_cli.py's deformed box with inlet (1) and wall (2) tags."""
    mesh = M.create_box((0.0, -1.0, -1.0), (4.0, 1.0, 1.0), (4, 3, 3))
    mesh.x[:, 1] += 0.2 * np.sin(mesh.x[:, 0])
    mesh.structured = None
    inlet = M.locate_entities_boundary(mesh, 2, lambda p: np.isclose(p[0], 0.0))
    wall = np.setdiff1d(mesh.exterior_facet_indices(), inlet)
    values = np.concatenate([np.full_like(inlet, 1), np.full_like(wall, 2)]).astype(np.int32)
    return mesh, M.meshtags(mesh, 2, np.concatenate([inlet, wall]), values)


def test_writers_are_byte_identical(tmp_path):
    (mt, tt), (mj, tj) = _tagged_box(TM), _tagged_box(JM)
    TIO.write_gmsh22(tmp_path / "t.msh", mt, tt)
    JIO.write_gmsh22(tmp_path / "j.msh", mj, tj)
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()
    m2, t2 = TIO.import_mesh_with_tags(tmp_path / "t.msh")
    assert np.abs(m2.x - mt.x).max() < 1e-12 and len(t2.indices) == len(tt.indices)

    rng = np.random.default_rng(3)
    data = {"s": rng.standard_normal(16), "v": rng.standard_normal((16, 2))}  # 4x4 vertices
    TIO.write_vtu(tmp_path / "t.vtu", TM.create_unit_square(3),
                  {k: torch.as_tensor(v) for k, v in data.items()})
    JIO.write_vtu(tmp_path / "j.vtu", JM.create_unit_square(3), data)
    assert (tmp_path / "t.vtu").read_bytes() == (tmp_path / "j.vtu").read_bytes()


def test_vtx_writer_matches_jax(tmp_path):
    for pkg, M, S, tag in ((T, TM, TS, "t"), (J, JM, JS, "j")):
        mesh = M.create_unit_square(3)
        kw = dict(dtype=torch.float64, device="cpu") if pkg is T else {}
        f = S.Function(S.FunctionSpace(mesh, ("Lagrange", 2)), name="f", **kw)
        g = S.Function(S.FunctionSpace(mesh, ("Lagrange", 1), shape=(2,)), name="g", **kw)
        IO = TIO if pkg is T else JIO
        with IO.VTXWriter(tmp_path / tag / "out.bp", [f, g]) as w:
            for t in (0.0, 0.1):
                f.interpolate(lambda x, t=t: np.sin(x[0]) + t)
                g.interpolate(lambda x, t=t: np.stack([x[1] * t, x[0]]))
                w.write(t)
    for name in ("out.pvd", "out_00000.vtu", "out_00001.vtu"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    for k in range(2):
        a, b = (np.load(tmp_path / d / f"out_{k:05d}.npz") for d in ("t", "j"))
        assert sorted(a.files) == sorted(b.files) == ["f", "g", "t"]
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype


def _up(s):
    arr = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.stack([arr(f.x.array) for f in s._u]), arr(s._p.x.array)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_across_packages(writer, tmp_path):
    path = tmp_path / "state.npz"
    make = lambda pkg, M, S, **kw: _tgv2d(pkg, M, S, 6, pressure={"pc_type": "jacobi"}, **kw)
    if writer == "jax":
        src, IO = make(J, JM, JS), JIO
        _kernel_path_x0(src)
    else:
        src, IO = make(T, TM, TS, device="cpu"), TIO
    src.run(3, DT, NU, max_iter=1)
    IO.Checkpoint(path).save(src, t=0.03, step=3)
    saved = np.load(path)
    sj, st = make(J, JM, JS), make(T, TM, TS, device="cpu")
    _kernel_path_x0(sj)
    assert JIO.Checkpoint(path).load(sj) == (0.03, 3)
    assert TIO.Checkpoint(path).load(st) == (0.03, 3)
    for i, f in enumerate(st._u1):
        np.testing.assert_array_equal(f.x.array.numpy(), saved[f"u1_{i}"])
    np.testing.assert_array_equal(st._dp.x.array.numpy(), saved["dp"])
    stj, stt = sj.run(2, DT, NU, max_iter=1), st.run(2, DT, NU, max_iter=1)
    for k in ("u_iters", "p_iters", "c_iters"):
        np.testing.assert_array_equal(stt[k], stj[k], err_msg=k)
    (ut, pt), (uj, pj) = _up(st), _up(sj)
    assert np.abs(ut - uj).max() <= 1e-10 * np.abs(uj).max()
    assert np.abs(pt - pj).max() <= 1e-10 * np.abs(pj).max()


def test_cli_subprocess(tmp_path):
    out, ck = tmp_path / "run.bp", tmp_path / "ck.npz"
    r = subprocess.run(
        [sys.executable, "-m", "oasisx_tpu_torch", "-dt", "0.05", "-T", "0.1", "-nu", "0.1",
         "--output", str(out), "--checkpoint", str(ck), *CPU],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    for name in ("run.pvd", "run_00000.vtu", "run_00001.vtu", "run_00001.npz", "ck.npz"):
        assert (tmp_path / name).exists(), name
    mesh = TM.create_unit_square(10, 10)
    facets = mesh.exterior_facet_indices()
    tags = TM.meshtags(mesh, 1, facets, np.full_like(facets, 1))
    bcs = [[T.DirichletBC(0.0, T.LocatorMethod.TOPOLOGICAL, (tags, 1))] for _ in range(2)]
    s = T.FractionalStep_AB_CN(mesh, ("Lagrange", 2), ("Lagrange", 1), bcs, [], device="cpu")
    assert TIO.Checkpoint(ck).load(s) == (0.1, 2)
    data = np.load(ck)
    for i, f in enumerate(s._u):
        np.testing.assert_array_equal(f.x.array.numpy(), data[f"u{i}"].astype(np.float32))


def test_entry_points_default_to_the_card():
    from oasisx_tpu_torch.main import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-dt", "0.05", "-T", "0.05"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        channel.main(["-N", "2", "-T", "0.01"])


# The demos against the JAX package's (demo/*.py) on the same arguments, in
# float64.  Both packages' solvers are built with every solve to 1e-12 and a
# Jacobi-CG pressure, the JAX one on its XLA path with the kernel path's
# tentative x0 (the port's formulation): the solves then agree to rounding,
# and what is held to REL is each demo's own arithmetic around them.
REL = 1e-8
TIGHT = {"ksp_rtol": 1e-12, "ksp_max_it": 2000}


def _jax_demo(name):
    """demo/<name>.py of the JAX package, as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_demo_{name}",
                                                  ROOT / "demo" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tight(monkeypatch, module, pkg):
    """``module``'s solver class replaced by one with the tight solves."""
    cls = pkg.FractionalStep_AB_CN

    def make(*args, **kw):
        kw["solver_options"] = {"tentative": dict(TIGHT), "scalar": dict(TIGHT),
                                "pressure": dict(TIGHT, pc_type="jacobi")}
        s = cls(*args, **kw)
        if pkg is J:
            _kernel_path_x0(s)
        return s

    monkeypatch.setattr(module, "FractionalStep_AB_CN", make)


def _demos(monkeypatch, name, port_module):
    jax_module = _jax_demo(name)
    _tight(monkeypatch, jax_module, J)
    _tight(monkeypatch, port_module, T)
    return jax_module


def _same(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= REL * np.abs(b).max(), (what, a, b)


def test_taylor_green_demo(tmp_path, monkeypatch):
    """The rates of the per-step and the ``run`` paths against the JAX
    demo's; the output series written by ``--write-output``."""
    jtg = _demos(monkeypatch, "taylor_green", taylor_green)
    argv = ["-N", "4", "-N", "8", "-dt", "0.02", "-T1", "0.1"]
    for extra in ([], ["--use-run"]):
        rt = taylor_green.main(argv + extra + [*CPU, "--dtype", "float64"])
        rj = jtg.main(argv + extra)
        assert np.isfinite(rt).all()
        for a, b, what in zip(rt, rj, ("rate_u", "rate_p")):
            _same(a, b, (what, extra))
    monkeypatch.chdir(tmp_path)
    taylor_green.main(["-N", "4", "-N", "6", "-dt", "0.05", "-T1", "0.1", "--write-output", *CPU])
    assert (tmp_path / "u.pvd").exists() and (tmp_path / "p_00001.vtu").exists()


def _recording(monkeypatch, module, out):
    """Record what ``module.run_strategy`` returns, with the solver's BC rows."""
    run = module.run_strategy

    def record(solver, *args):
        ts, A, rhs = run(solver, *args)
        mask = solver._bc_masks
        mask = solver._uv(mask).numpy() if isinstance(mask, torch.Tensor) else None
        out.append((A, rhs, mask))
        return ts, A, rhs

    monkeypatch.setattr(module, "run_strategy", record)


def test_assembly_bcs_demo(capsys, monkeypatch):
    """Per degree and strategy, the dense tentative matrix and the
    right-hand side against the JAX demo's: the matrix to 1e-12, the
    right-hand side off the BC rows to 1e-12, the BC value on them (the
    port's system carries it there, JAX's keeps the assembled rows)."""
    jab = _jax_demo("assembly_bcs")
    got, ref = [], []
    _recording(monkeypatch, assembly_bcs, got)
    _recording(monkeypatch, jab, ref)
    argv = ["--dim", "2", "-n", "3", "--max-degree", "2", "--repeats", "1"]
    assembly_bcs.main(argv + [*CPU, "--dtype", "float64"])
    assert "matvec" in capsys.readouterr().out
    jab.main(argv)
    assert len(got) == len(ref) == 4  # two degrees, two strategies
    for (At, rt, mask), (Aj, rj, _) in zip(got, ref):
        assert At.shape == Aj.shape and mask.any()
        assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()
        assert np.abs(np.where(mask, 0.0, rt - rj)).max() <= 1e-12 * np.abs(rj).max()
        np.testing.assert_array_equal(rt[mask], 0.5)


def test_channel_demo_poiseuille(monkeypatch):
    jch = _demos(monkeypatch, "channel", channel)
    argv = ["-N", "6", "-T", "0.5", "-dt", "0.025"]
    err_x, err_y = channel.main(argv + [*CPU, "--dtype", "float64"])
    assert err_x < 0.02 and err_y < 0.02
    for a, b, what in zip((err_x, err_y), jch.main(argv), ("err_x", "err_y")):
        _same(a, b, what)


def test_taylor_green3d_demo_module():
    """Through ``python -m``: the energy decays."""
    r = subprocess.run(
        [sys.executable, "-m", "oasisx_tpu_torch.demo.taylor_green3d", "-N", "4", "-dt",
         "0.02", "-T", "0.1", "--chunk", "5", *CPU], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    import json

    e = json.loads(r.stdout.strip().splitlines()[-1])["kinetic_energy"]
    assert e[0] > 0 and np.isfinite(e).all() and e[-1] <= e[0] * 1.001


def test_taylor_green3d_demo_matches_jax(monkeypatch):
    """The energy and dissipation series against the JAX demo's."""
    jtg3 = _demos(monkeypatch, "taylor_green3d", taylor_green3d)
    argv = ["-N", "4", "-dt", "0.02", "-T", "0.08", "--chunk", "2"]
    ot = taylor_green3d.main(argv + [*CPU, "--dtype", "float64"])
    oj = jtg3.main(argv)
    assert ot["t"] == oj["t"] and ot["velocity_dofs"] == oj["velocity_dofs"]
    for key in ("kinetic_energy", "dissipation"):
        _same(ot[key], oj[key], key)


def _tube(tmp_path, ids):
    """A box tube with inlet, wall and outlet tagged ``ids``, as a .msh; the
    first 6 wall facets carry another tag (9), which the demo drops."""
    mesh = TM.create_box((0.0, 0.0, 0.0), (2.0, 1.0, 1.0), (6, 3, 3))
    inlet = TM.locate_entities_boundary(mesh, 2, lambda x: np.isclose(x[0], 0.0))
    outlet = TM.locate_entities_boundary(mesh, 2, lambda x: np.isclose(x[0], 2.0))
    wall = np.setdiff1d(mesh.exterior_facet_indices(), np.concatenate([inlet, outlet]))
    values = np.concatenate([np.full_like(inlet, ids[0]), np.full_like(wall, ids[1]),
                             np.full_like(outlet, ids[2])]).astype(np.int32)
    values[len(inlet):len(inlet) + 6] = 9
    tags = TM.meshtags(mesh, 2, np.concatenate([inlet, wall, outlet]), values)
    TIO.write_gmsh22(tmp_path / "tube.msh", mesh, tags)
    return str(tmp_path / "tube.msh")


def test_vessel_demo(tmp_path, monkeypatch):
    """The generated vessel, and a tagged .msh whose inlet, wall and outlet
    carry the ids 5, 6 and 7 (``--inlet-tag`` etc. remap them): the
    series against the JAX demo's."""
    jv = _demos(monkeypatch, "vessel", vessel)
    tube = _tube(tmp_path, (5, 6, 7))
    for argv in (["--n-axial", "8", "--n-cross", "3", "-T", "0.06", "-dt", "0.02"],
                 ["--mesh-path", tube, "--inlet-tag", "5", "--wall-tag", "6", "--outlet-tag",
                  "7", "-dt", "0.02", "-T", "0.04"]):
        ot = vessel.main(argv + [*CPU, "--dtype", "float64"])
        oj = jv.main(argv)
        assert np.isfinite(ot["max_velocity"]).all() and all(ot["converged"])
        assert ot["t"] == oj["t"] and ot["velocity_dofs"] == oj["velocity_dofs"]
        _same(ot["waveform"], oj["waveform"], "waveform")
        _same(ot["max_velocity"], oj["max_velocity"], ("max_velocity", argv[0]))
    with pytest.raises(SystemExit, match="do not include"):
        vessel.main(["--mesh-path", tube, *CPU])


def test_cylinder_demo(monkeypatch):
    """Cd, Cl and their statistics against the JAX demo's; the Strouhal
    number of a lift signal against the JAX demo's function."""
    jcy = _demos(monkeypatch, "cylinder", cylinder)
    argv = ["--res", "10", "-T", "0.006", "-dt", "0.002", "--chunk", "2"]
    ot = cylinder.main(argv + [*CPU, "--dtype", "float64"])
    oj = jcy.main(argv)
    assert sorted(ot) == sorted(oj)
    for key in oj:
        _same(ot[key], oj[key], key)
    ts = 0.01 * np.arange(1, 401)
    lift = 0.3 * np.sin(2 * np.pi * 3.1 * ts) + 0.05 * np.sin(2 * np.pi * 7.3 * ts) + 0.01
    st, sj = cylinder.strouhal_from_lift(ts, lift), jcy.strouhal_from_lift(ts, lift)
    assert st == sj and abs(st[0] - 3.1) < 0.05
