"""Batched linear-algebra helpers (reference ``utils/utils_linalg.py:5-53``:
``to_Hermite``, ``to_PSD``, ``parallel_sort``), batched over any leading
axes."""

import torch

from ..ops.fast_linalg import batched_eigvalsh
from ..runtime.device import resolve_device
from .flooring import EPS


def to_hermite(X, axis1=-2, axis2=-1):
    """Hermitian part of the matrices on axes ``axis1``, ``axis2``
    (reference ``utils/utils_linalg.py:5-7``)."""
    return (X + X.transpose(axis1, axis2).conj()) / 2


def to_psd(X, eps=EPS):
    """Project batched matrices (trailing two axes) onto the PSD cone
    (reference ``utils/utils_linalg.py:9-31``): the Hermitian part, shifted
    up by its most negative eigenvalue (if any), plus an ``eps * trace``
    identity ridge.  Eigenvalues by :func:`~..ops.fast_linalg.batched_eigvalsh`
    (closed forms for n <= 3)."""
    n = X.shape[-1]
    X = (X + X.transpose(-2, -1).conj()) / 2
    eigvals = batched_eigvalsh(X)
    delta = torch.clamp(eigvals.amin(dim=-1), max=0)
    trace = torch.diagonal(X, dim1=-2, dim2=-1).sum(dim=-1).real
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    return X + (eps * trace - delta)[..., None, None] * eye


def parallel_sort(x, order, axis=-2):
    """Reorder slices of ``x`` along ``axis`` by per-batch index arrays
    (reference ``utils/utils_linalg.py:33-53``, its flatten-and-offset gather
    as one ``torch.gather``).

    ``order`` has shape ``x.shape[:axis] + (k,)``; the result replaces
    ``x.shape[axis]`` with ``k``.
    """
    axis = axis % x.ndim
    index = order.reshape(order.shape + (1,) * (x.ndim - axis - 1))
    index = index.expand(order.shape + x.shape[axis + 1 :])
    return torch.gather(x, axis, index)


def eye_like_filter(n_bins, n_sources, n_channels, dtype=torch.complex64, device=None):
    """Identity demixing filter ``(n_bins, n_sources, n_channels)`` (the
    reference's init, ``bss/iva.py:53-55``)."""
    W = torch.eye(n_sources, n_channels, dtype=dtype, device=resolve_device(device))
    return W.repeat(n_bins, 1, 1)


def hermitian_outer(X):
    """Batched outer products ``x x^H``: ``X (..., C) -> (..., C, C)``."""
    return X[..., :, None] * X[..., None, :].conj()


def quadratic_form(w, U):
    """Real quadratic form ``w^H U w`` for ``w (..., C)``, ``U (..., C, C)``."""
    return torch.einsum("...c,...cd,...d->...", w.conj(), U, w).real
