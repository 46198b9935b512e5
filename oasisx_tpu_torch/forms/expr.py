"""Minimal symbolic expression layer evaluated at quadrature points.

Counterpart of ``oasisx_tpu/forms/expr.py`` with the same names and
semantics: ``grad``, ``div``, ``inner``, ``dot``, ``as_vector``,
``SpatialCoordinate``, ``sin/cos/exp/sqrt`` and arithmetic build a small
tree, which ``QPEvaluator`` interprets into batched (ncells, nq) tensors on
its device.  The Projector's right-hand side and the scalar functionals
(``assemble_scalar``: error norms, energies) use it.

A ``Constant`` in a tree is read when the tree is evaluated, so changing its
value changes the next evaluation; a coefficient is read from its
Function's ``x.array``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..assembly.geometry import compute_cell_geometry
from ..config import real_dtype, resolve_device
from ..elements.quadrature import quadrature
from ..spaces.functionspace import Constant, Function

pi = math.pi


class Expr:
    shape: tuple = ()

    def __add__(self, o):
        return _binop(torch.add, self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return _binop(torch.sub, self, o)

    def __rsub__(self, o):
        return _binop(torch.sub, o, self)

    def __mul__(self, o):
        return _binop(torch.mul, self, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _binop(torch.div, self, o)

    def __rtruediv__(self, o):
        return _binop(torch.div, o, self)

    def __neg__(self):
        return _unop(torch.neg, self)

    def __pow__(self, p):
        return _binop(torch.pow, self, p)

    def __getitem__(self, i):
        return Component(self, i)


def as_expr(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, Function):
        return Coefficient(v)
    if isinstance(v, Constant):
        return Scalar(v)
    if isinstance(v, (int, float, np.floating, np.integer)):
        return Scalar(v)
    if isinstance(v, (tuple, list)):
        return Vector(tuple(as_expr(c) for c in v))
    raise TypeError(f"cannot treat {type(v)} as expression")


@dataclass
class Scalar(Expr):
    value: object  # float or Constant (read at evaluation time)

    shape = ()


@dataclass
class Coefficient(Expr):
    f: Function

    @property
    def shape(self):
        bs = self.f.function_space.bs
        return () if bs == 1 else (bs,)


@dataclass
class Coord(Expr):
    index: int

    shape = ()


def SpatialCoordinate(mesh) -> tuple:
    return tuple(Coord(i) for i in range(mesh.gdim))


@dataclass
class Component(Expr):
    v: Expr
    index: int

    shape = ()


@dataclass
class Vector(Expr):
    comps: tuple

    @property
    def shape(self):
        return (len(self.comps),)


def as_vector(comps) -> Vector:
    return Vector(tuple(as_expr(c) for c in comps))


@dataclass
class Grad(Expr):
    f: Expr  # scalar
    dim: int

    @property
    def shape(self):
        return (self.dim,)


def grad(f) -> Grad:
    f = as_expr(f)
    if f.shape != ():
        raise ValueError("grad supports scalar operands; use per-component grads")
    if isinstance(f, Coefficient):
        dim = f.f.function_space.mesh.gdim
    else:
        raise ValueError("grad supports FE-function operands")
    return Grad(f, dim)


@dataclass
class Div(Expr):
    v: Expr

    shape = ()


def div(v) -> Div:
    return Div(as_expr(v))


@dataclass
class BinOp(Expr):
    op: object
    a: Expr
    b: Expr

    @property
    def shape(self):
        return self.a.shape if self.a.shape != () else self.b.shape


@dataclass
class UnOp(Expr):
    op: object
    a: Expr

    @property
    def shape(self):
        return self.a.shape


def _binop(op, a, b):
    return BinOp(op, as_expr(a), as_expr(b))


def _unop(op, a):
    return UnOp(op, as_expr(a))


def sin(x):
    return _unop(torch.sin, x)


def cos(x):
    return _unop(torch.cos, x)


def exp(x):
    return _unop(torch.exp, x)


def sqrt(x):
    return _unop(torch.sqrt, x)


def dot(a, b) -> Expr:
    a, b = as_expr(a), as_expr(b)
    return inner(a, b)


def inner(a, b) -> Expr:
    a, b = as_expr(a), as_expr(b)
    if a.shape == () and b.shape == ():
        return a * b
    ca = _components(a)
    cb = _components(b)
    if len(ca) != len(cb):
        raise ValueError("inner: shape mismatch")
    out = ca[0] * cb[0]
    for x, y in zip(ca[1:], cb[1:]):
        out = out + x * y
    return out


def _components(v: Expr) -> tuple:
    if isinstance(v, Vector):
        return v.comps
    if isinstance(v, Coefficient) and v.shape != ():
        return tuple(Component(v, i) for i in range(v.shape[0]))
    if isinstance(v, Grad):
        return tuple(Component(v, i) for i in range(v.dim))
    if isinstance(v, (BinOp, UnOp)) and v.shape != ():
        return tuple(Component(v, i) for i in range(v.shape[0]))
    if v.shape == ():
        return (v,)
    raise ValueError(f"cannot extract components of {v}")


# ---------------------------------------------------------------------------
# evaluation at quadrature points
# ---------------------------------------------------------------------------


def quadrature_points(mesh, qdegree: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference rule of degree ``qdegree`` on the mesh's cell, (points
    (nq, d), weights (nq,)), and its physical points in every cell, (nc, nq,
    gdim), on the host in float64."""
    pts, w = quadrature(mesh.cell_type, qdegree)
    v0 = mesh.x[mesh.cells[:, 0]]
    J = np.stack([mesh.x[mesh.cells[:, i + 1]] - v0 for i in range(mesh.dim)], axis=2)
    return pts, w, v0[:, None, :] + np.einsum("cgd,qd->cqg", J, pts)


def padded_coordinates(xq: np.ndarray) -> np.ndarray:
    """Physical quadrature points (nc, nq, gdim) as the (3, nc, nq)
    zero-padded array a callable ``f(x)`` receives."""
    pad = np.zeros((3,) + xq.shape[:2])
    pad[: xq.shape[2]] = np.moveaxis(xq, 2, 0)
    return pad


class QPEvaluator:
    """Evaluates expression trees to (ncells, nq) tensors on a mesh, on
    ``device`` (default: the card) in ``dtype``."""

    def __init__(self, mesh, qdegree: int, dtype=None, device=None):
        self.mesh = mesh
        self.dtype = real_dtype(dtype)
        self.device = resolve_device(device)
        pts, w, xq = quadrature_points(mesh, qdegree)
        self.qpts = pts
        self.xq_host = xq
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)
        self.qw = t(w)
        geo = compute_cell_geometry(mesh.x, mesh.cells, mesh.dim)
        self.detJ = t(geo.detJ)
        self.Kinv = t(geo.Kinv)
        self.xq = t(xq)  # (nc, nq, gdim)
        self._tabs: dict = {}

    def _tab(self, space):
        key = id(space.dofmap), space.element
        if key not in self._tabs:
            phi, dphi = space.element.tabulate(self.qpts)
            t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self.device)
            cd = torch.as_tensor(np.asarray(space.dofmap.cell_dofs, np.int64), device=self.device)
            self._tabs[key] = (t(phi).to(self.dtype), t(dphi).to(self.dtype), cd)
        return self._tabs[key]

    def _coeff_array(self, f: Function, comp: int | None):
        V = f.function_space
        arr = f.x.array.to(device=self.device, dtype=self.dtype)
        if V.bs == 1:
            return arr
        if comp is None:
            raise ValueError("vector coefficient needs a component index")
        return arr.reshape(-1, V.bs)[:, comp]

    def eval(self, e: Expr, comp: int | None = None):
        """Evaluate scalar expression (or component ``comp`` of vector one)."""
        if isinstance(e, Scalar):
            v = e.value.value if isinstance(e.value, Constant) else e.value
            return torch.as_tensor(np.asarray(v, np.float64), device=self.device).to(self.dtype)
        if isinstance(e, Coord):
            return self.xq[:, :, e.index]
        if isinstance(e, Coefficient):
            phi, _, cd = self._tab(e.f.function_space)
            arr = self._coeff_array(e.f, comp)
            return torch.einsum("qn,cn->cq", phi, arr[cd])
        if isinstance(e, Component):
            return self._eval_component(e.v, e.index)
        if isinstance(e, Vector):
            if comp is None:
                raise ValueError("vector expression evaluated without component")
            return self.eval(e.comps[comp])
        if isinstance(e, Grad):
            if comp is None:
                raise ValueError("grad evaluated without component")
            return self._eval_component(e, comp)
        if isinstance(e, Div):
            return self._eval_div(e.v)
        if isinstance(e, BinOp):
            return e.op(self.eval(e.a, comp), self.eval(e.b, comp))
        if isinstance(e, UnOp):
            return e.op(self.eval(e.a, comp))
        raise TypeError(f"cannot evaluate {e}")

    def _grad_component(self, f: Function, comp: int | None, i: int):
        """d/dx_i of a scalar function or of one component of a vector one."""
        _, dphi, cd = self._tab(f.function_space)
        arr = self._coeff_array(f, comp)
        return torch.einsum("cb,qbn,cn->cq", self.Kinv[:, :, i], dphi, arr[cd])

    def _eval_component(self, v: Expr, i: int):
        if isinstance(v, Vector):
            return self.eval(v.comps[i])
        if isinstance(v, Coefficient):
            return self.eval(v, comp=i)
        if isinstance(v, Grad):
            if isinstance(v.f, Coefficient):
                return self._grad_component(v.f.f, None, i)
            raise ValueError("grad supports FE-function operands")
        if isinstance(v, (BinOp, UnOp)):
            return self.eval(v, comp=i)
        raise ValueError(f"cannot take component of {v}")

    def _eval_div(self, v: Expr):
        comps = v.comps if isinstance(v, Vector) else _components(v)
        out = None
        for i, ci in enumerate(comps):
            term = self._grad_of(ci, i)
            out = term if out is None else out + term
        return out

    def _grad_of(self, e: Expr, i: int):
        """d(e)/dx_i for a scalar FE function or a vector-function component."""
        if isinstance(e, Coefficient) and e.shape == ():
            return self._grad_component(e.f, None, i)
        if isinstance(e, Component) and isinstance(e.v, Coefficient):
            return self._grad_component(e.v.f, e.index, i)
        raise ValueError("div needs FE-function components")

    def integrate(self, e: Expr):
        vals = self.eval(as_expr(e))
        return torch.einsum("cq,q,c->", vals, self.qw, self.detJ)


def assemble_scalar(mesh, e, qdegree: int = 8, dtype=None, device=None):
    """Integral of an expression over the mesh, a 0-d tensor on ``device``
    (default: the card): the ``assemble_scalar`` equivalent
    (demo/taylor_green.py's error norms)."""
    ev = QPEvaluator(mesh, qdegree, dtype, device)
    return ev.integrate(as_expr(e))
