"""Constant reference-element tensors for the closed form set.

The NumPy replacement for FFCx-generated C element kernels
(SURVEY §2b / reference usage at src/oasisx/fracstep.py:277-358):
each of the ~10 bilinear/linear forms the reference compiles reduces, on
affine cells, to a contraction of one of these constant tensors with
per-cell geometry factors.

Shapes (V = velocity-component element, Q = pressure element, d = dim):
    mass[i, j]          = sum_q w phiV_qi phiV_qj
    stiffness[a,b,i,j]  = sum_q w dphiV[q,a,i] dphiV[q,b,j]
    convection[b,i,j,k] = sum_q w phiV_qi dphiV[q,b,j] phiV_qk
    mixed_grad[b,j,m]   = sum_q w dphiV[q,b,j] phiQ_qm      (p * v.dx(i), div(u) q)
    grad_q[b,j,m]       = sum_q w phiV_qj dphiQ[q,b,m]      (p.dx(i) * v)
    load[j]             = sum_q w phiV_qj
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..elements.element import FiniteElement
from ..elements.quadrature import quadrature


@dataclass
class ReferenceTensors:
    qpoints: np.ndarray  # (nq, d) quadrature points on the unit cell
    qweights: np.ndarray  # (nq,)
    phi_v: np.ndarray  # (nq, ndv)
    dphi_v: np.ndarray  # (nq, d, ndv)
    phi_q: np.ndarray  # (nq, ndq)
    dphi_q: np.ndarray  # (nq, d, ndq)
    mass: np.ndarray
    mass_q: np.ndarray
    stiffness: np.ndarray
    stiffness_q: np.ndarray
    convection: np.ndarray
    mixed_grad: np.ndarray
    grad_q: np.ndarray
    load: np.ndarray


def build_reference_tensors(
    el_v: FiniteElement, el_q: FiniteElement, qdegree: int | None = None
) -> ReferenceTensors:
    if qdegree is None:
        # convection carries three element factors: 2*deg + (deg-1); mixed
        # terms are lower. One shared rule keeps all tabulations aligned.
        qdegree = max(3 * el_v.degree - 1, el_v.degree + el_q.degree, 2 * el_q.degree, 2)
    pts, w = quadrature(el_v.cell, qdegree)
    phi_v, dphi_v = el_v.tabulate(pts)
    phi_q, dphi_q = el_q.tabulate(pts)
    return ReferenceTensors(
        qpoints=pts,
        qweights=w,
        phi_v=phi_v,
        dphi_v=dphi_v,
        phi_q=phi_q,
        dphi_q=dphi_q,
        mass=np.einsum("q,qi,qj->ij", w, phi_v, phi_v),
        mass_q=np.einsum("q,qi,qj->ij", w, phi_q, phi_q),
        stiffness=np.einsum("q,qai,qbj->abij", w, dphi_v, dphi_v),
        stiffness_q=np.einsum("q,qai,qbj->abij", w, dphi_q, dphi_q),
        convection=np.einsum("q,qi,qbj,qk->bijk", w, phi_v, dphi_v, phi_v),
        mixed_grad=np.einsum("q,qbj,qm->bjm", w, dphi_v, phi_q),
        grad_q=np.einsum("q,qj,qbm->bjm", w, phi_v, dphi_q),
        load=np.einsum("q,qj->j", w, phi_v),
    )
