"""Global dtype/device helpers for the PyTorch port.

Correctness tests run in float64 on the CPU; the card runs float32 state.
Every tensor the solver owns lives on one device: the card unless the
caller names another (the CPU tests pass ``device="cpu"``).  There is no
fallback to the CPU when no card is present.

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
    """The caller's device; None means the card, and raises when there is
    none (it never falls back to the CPU: pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the solver runs on the card by default; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
