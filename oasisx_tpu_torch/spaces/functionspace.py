"""Function spaces, functions, constants (host dofmaps, device coefficients).

Mirrors the exercised dolfinx.fem surface (SURVEY §2b): ``functionspace``,
``Function`` (+ ``interpolate``), ``Constant``, component-subspace collapse
(reference src/oasisx/fracstep.py:187-194, :698-705).

Design: scalar spaces carry the dofmap; a vector space of block size ``bs``
interleaves components dolfinx-style (global dof = scalar_dof * bs + comp),
so ``collapse`` maps are simple strided index arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..elements.element import FiniteElement, make_element
from ..meshes.mesh import Mesh
from .dofmap import DofMap, build_dofmap, entity_closure_dofs


class FunctionSpace:
    """Scalar or blocked-vector Lagrange space on a simplex mesh."""

    def __init__(
        self,
        mesh: Mesh,
        element: FiniteElement | tuple[str, int],
        shape: tuple[int, ...] = (),
    ):
        self.mesh = mesh
        self.element = make_element(element, mesh.cell_type)
        self.shape = shape
        self.bs = 1 if not shape else int(np.prod(shape))
        self._dofmap = build_dofmap(mesh, self.element)
        self._scalar: FunctionSpace | None = None

    @property
    def dofmap(self) -> DofMap:
        return self._dofmap

    @property
    def num_dofs(self) -> int:
        """Total dofs including block size."""
        return self._dofmap.num_dofs * self.bs

    @property
    def num_scalar_dofs(self) -> int:
        return self._dofmap.num_dofs

    @property
    def num_sub_spaces(self) -> int:
        return self.bs if self.bs > 1 else 0

    @property
    def dof_coords(self) -> np.ndarray:
        return self._dofmap.dof_coords

    # dolfinx-compatible alias
    def tabulate_dof_coordinates(self) -> np.ndarray:
        return self._dofmap.dof_coords

    def sub(self, i: int) -> "SubSpace":
        if not 0 <= i < self.bs:
            raise IndexError(i)
        return SubSpace(self, i)

    def scalar_space(self) -> "FunctionSpace":
        """The collapsed single-component space (shares the dofmap)."""
        if self.bs == 1:
            return self
        if self._scalar is None:
            s = FunctionSpace.__new__(FunctionSpace)
            s.mesh = self.mesh
            s.element = self.element
            s.shape = ()
            s.bs = 1
            s._dofmap = self._dofmap
            s._scalar = s
            self._scalar = s
        return self._scalar

    # --- dof location ------------------------------------------------------
    def locate_dofs_geometrical(self, marker: Callable) -> np.ndarray:
        """Scalar dof ids whose coordinates satisfy ``marker`` (reference
        convention: marker receives (3, n) padded coords)."""
        x = self.dof_coords
        pad = np.zeros((3, x.shape[0]))
        pad[: x.shape[1]] = x.T
        return np.where(marker(pad))[0].astype(np.int32)

    def locate_dofs_topological(self, edim: int, entities: np.ndarray) -> np.ndarray:
        return entity_closure_dofs(self.mesh, self._dofmap, self.element, edim, entities)


@dataclass
class SubSpace:
    """Component view of a blocked space; ``collapse`` mirrors
    dolfinx ``V.sub(i).collapse()`` (fracstep.py:190)."""

    parent: FunctionSpace
    component: int

    def collapse(self) -> tuple[FunctionSpace, np.ndarray]:
        V = self.parent
        cmap = (np.arange(V.num_scalar_dofs, dtype=np.int32) * V.bs + self.component).astype(
            np.int32
        )
        return V.scalar_space(), cmap


class Function:
    """A finite element function: coefficient vector over a space.

    ``f.x.array`` is a tensor on the function's device, in the function's
    dtype (reference idiom ``function.x.array[:] = ...``).  A solver that
    owns the function writes its state into it after each call.
    """

    def __init__(
        self,
        V: FunctionSpace,
        name: str = "f",
        dtype: torch.dtype = torch.float64,
        *,
        device: torch.device | str,
    ):
        self.function_space = V
        self.name = name
        self._array = torch.zeros(V.num_dofs, dtype=dtype, device=device)
        self.x = _XView(self)

    @property
    def array(self) -> torch.Tensor:
        return self._array

    def interpolate(self, value) -> None:
        """Interpolate a callable/scalar/array into the nodal coefficients.

        Callables receive coords as a (3, n) zero-padded NumPy array
        (reference convention, e.g. demo/taylor_green.py:41-53) and are
        evaluated on the host; for vector spaces they must return an array
        of shape (bs, n).
        """
        V = self.function_space
        if callable(value):
            x = V.dof_coords
            pad = np.zeros((3, x.shape[0]))
            pad[: x.shape[1]] = x.T
            vals = np.asarray(value(pad), dtype=np.float64)
            if V.bs > 1:
                if vals.shape != (V.bs, x.shape[0]):
                    raise ValueError(
                        f"vector interpolation expects shape {(V.bs, x.shape[0])}, got {vals.shape}"
                    )
                vals = vals.T.reshape(-1)
            self._array.copy_(torch.as_tensor(np.broadcast_to(vals, self._array.shape).copy()))
        else:
            arr = np.asarray(getattr(value, "value", value), dtype=np.float64)
            if arr.ndim == 0:
                self._array.fill_(float(arr))
            else:
                self._array.view(-1, V.bs).copy_(torch.as_tensor(arr)[None, :])


class _XView:
    """Compatibility shim for the dolfinx ``f.x.array`` idiom. Scatter
    operations are no-ops on a single device copy."""

    __slots__ = ("_f",)

    def __init__(self, f: Function):
        self._f = f

    @property
    def array(self) -> torch.Tensor:
        return self._f._array

    def scatter_forward(self) -> None:
        pass

    def scatter_reverse(self, *_args) -> None:
        pass


class Constant:
    """Mutable scalar/vector constant (dolfinx.fem.Constant equivalent)."""

    def __init__(self, value, mesh: Mesh | None = None):
        # accept Constant(mesh, value) order too
        if isinstance(value, Mesh):
            value, mesh = mesh, value
        self.value = np.asarray(value, dtype=np.float64)

    def __float__(self) -> float:
        return float(self.value)
