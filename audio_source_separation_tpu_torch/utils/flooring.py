"""Numerical-guard helpers (the reference floors in place,
``R[R < eps] = eps``; these are the out-of-place equivalents)."""

import torch

EPS = 1e-12
THRESHOLD = 1e12


def floor_below(x, eps=EPS):
    """``x`` with entries below ``eps`` replaced by ``eps``."""
    return torch.clamp(x, min=eps)


def identity_ridge(X, eps=EPS):
    """Add ``eps * I`` to the trailing matrix axes (pre-inverse ridge)."""
    n = X.shape[-1]
    return X + eps * torch.eye(n, dtype=X.dtype, device=X.device)
