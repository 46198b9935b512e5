"""Global dtype/device helpers for the PyTorch port.

Correctness tests run in float64 on the CPU; the card runs float32 state.
Every tensor the solver owns lives on a device its caller named: nothing
here picks one.

FEM operators need exact float32 contractions: TF32 keeps about three
decimal digits, which degrades Krylov convergence the same way the TPU's
default bf16 matmul passes did (FIDELITY.md), so both TF32 switches are off.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DTYPE = torch.float32  # the working type on the card

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def real_dtype(dtype=None) -> torch.dtype:
    """Resolve a numpy or torch float type (None -> ``DEFAULT_DTYPE``)."""
    if dtype is None:
        return DEFAULT_DTYPE
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def resolve_device(device) -> torch.device:
    """The caller's device; there is no default."""
    if device is None:
        raise ValueError("device is required (e.g. 'cuda' or 'cpu')")
    return torch.device(device)
