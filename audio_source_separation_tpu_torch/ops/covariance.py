"""Weighted spatial covariance: the direct contraction and the dispatched form."""

import torch

from .cov_kernel import weighted_covariance_planes
from .ip_components import assemble_matrices


def weighted_covariance(X, weights):
    """``U[n, f] = (1/T) sum_t weights[n, (f,) t] x[:, f, t] x[:, f, t]^H``.

    Args:
        X: mixture ``(n_channels, n_bins, n_frames)`` complex.
        weights: real ``(n_sources, n_frames)`` or ``(n_sources, n_bins,
            n_frames)``.
    Returns:
        ``U (n_sources, n_bins, n_channels, n_channels)`` Hermitian.
    """
    n_frames = X.shape[-1]
    w = weights.to(X.dtype)
    if w.ndim == 2:
        U = torch.einsum("nt,cft,dft->nfcd", w, X, X.conj())
    else:
        U = torch.einsum("nft,cft,dft->nfcd", w, X, X.conj())
    return U / n_frames


def weighted_covariance_auto(X, weights):
    """Weighted covariance ``(N, F, C, C)`` through kernel K1
    (:func:`~.cov_kernel.weighted_covariance_planes`: the CUDA kernel for a
    CUDA mixture, its plain version on the CPU) at any C and N, for ``(N,
    T)`` and per-bin ``(N, F, T)`` weights alike."""
    return assemble_matrices(weighted_covariance_planes(X, weights))
