"""Weighted spatial covariance: the direct contraction, the pair-product
form and the dispatched form."""

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


def pair_products(X):
    """Channel pair products ``PP[c, d, f, t] = x_c x_d^*`` ``(C, C, F, T)``
    of ``X (C, F, T)``: loop-invariant, so every later weighted covariance
    is one product over frames (:func:`weighted_covariance_from_pairs`)."""
    return X[:, None] * X[None].conj()


def weighted_covariance_from_pairs(PP, weights):
    """Weighted covariance ``U (N, F, C, C)`` from pair products ``PP (C,
    C, F, T)`` and ``(N, T)`` or per-bin ``(N, F, T)`` weights: one
    ``(C^2 F, T) x (T, N)`` matmul, or a bin-batched one."""
    C, _, F, T = PP.shape
    w = weights.to(PP.dtype)
    if w.ndim == 2:
        U = torch.matmul(PP.reshape(C * C * F, T), w.transpose(0, 1)).reshape(C, C, F, -1)
    else:
        U = torch.matmul(PP.reshape(C * C, F, T).transpose(0, 1), w.permute(1, 2, 0)).transpose(0, 1)
        U = U.reshape(C, C, F, -1)
    return U.permute(3, 2, 0, 1) / T


def weighted_covariance_auto(X, weights, PP=None, use_pallas=None):
    """Weighted covariance ``(N, F, C, C)`` through kernel K1
    (:func:`~.cov_kernel.weighted_covariance_planes`: the CUDA kernel for a
    CUDA mixture, its plain version on the CPU) at any C and N, for ``(N,
    T)`` and per-bin ``(N, F, T)`` weights alike.

    ``PP`` and ``use_pallas`` are the JAX signature's: there they pick
    between the pair-product GEMM and the Pallas kernel.  Here the route
    does not depend on them; K1 is the counterpart of the Pallas route and
    reads ``X`` itself, so ``PP`` is not read."""
    return assemble_matrices(weighted_covariance_planes(X, weights))


def spatial_covariance(X):
    """Unweighted per-bin spatial covariance ``(n_bins, C, C)``, the mean
    over frames."""
    return torch.einsum("cft,dft->fcd", X, X.conj()) / X.shape[-1]
