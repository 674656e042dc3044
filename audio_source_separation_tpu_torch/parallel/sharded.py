"""Pure-functional AuxIVA-IP steps (single mixture, bins-major, stacked-real
and batched).

Each step takes and returns tensors and keeps no state: one IP iteration of
the Laplace AuxIVA, ``W -> (W_new, nll)``.  With ``use_pallas=True`` the
weighted covariance goes through
:func:`~..ops.covariance.weighted_covariance_auto`, so a CUDA mixture
launches kernel K1 once per step; otherwise it is the direct contraction, or
one product over the pair products ``PP`` where they are given.  Every step
runs with TF32 off (:func:`~..runtime.solver.full_f32_matmuls`).

The mesh builders of this module's JAX counterpart (``make_mesh_2d``,
``make_sharded_train_step``) shard these steps over devices; they wait for
the ``torch.distributed`` port.
"""

import torch

from ..ops.covariance import weighted_covariance, weighted_covariance_auto, weighted_covariance_from_pairs
from ..ops.fast_linalg import batched_log_abs_det
from ..ops.ip import ip_update
from ..runtime.solver import full_f32_matmuls


def _separate(W, X):
    """``Y[n, f, t] = sum_c W[f, n, c] X[c, f, t]``."""
    return torch.einsum("fnc,cft->nft", W, X)


def _nll(W, power_over_bins, n_frames):
    """Laplace NLL from ``sum_f |Y|^2 (N, T)`` and ``W (..., F, N, C)``."""
    return (2 * torch.sqrt(power_over_bins)).sum() - 2 * n_frames * batched_log_abs_det(W).sum()


def _covariance(X, inv_R, PP, use_pallas):
    if use_pallas:
        return weighted_covariance_auto(X, inv_R, PP=PP, use_pallas=True)
    if PP is None:
        return weighted_covariance(X, inv_R)
    return weighted_covariance_from_pairs(PP, inv_R)


def auxiva_ip_step(X, W, PP=None, eps=1e-8, threshold=1e12, use_pallas=False):
    """One AuxIVA-IP iteration (single mixture).

    Args:
        X: ``(n_channels, n_bins, n_frames)`` complex mixture (contiguous
            complex64 on CUDA where ``use_pallas``).
        W: ``(n_bins, n_sources, n_channels)`` demixing filters.
        PP: optional pair products
            (:func:`~..ops.covariance.pair_products`); without
            ``use_pallas`` the covariance is then one product over them.
        use_pallas: the covariance through K1 (its plain version on the
            CPU).
    Returns:
        ``(W_new, nll)``, ``nll`` a 0-d tensor.
    """
    with full_f32_matmuls():
        Y = _separate(W, X)
        R = torch.clamp(torch.sqrt((torch.abs(Y) ** 2).sum(dim=1)), min=eps)  # (N, T)
        W = ip_update(W, _covariance(X, 1.0 / R, PP, use_pallas), threshold=threshold)
        Y = _separate(W, X)
        return W, _nll(W, torch.sum(torch.abs(Y) ** 2, dim=1), X.shape[-1])


def auxiva_ip_step_carry(X, W, Y, PP=None, eps=1e-8, threshold=1e12, use_pallas=False):
    """AuxIVA-IP iteration carrying the estimates ``Y = separate(X, W)``
    (saves one separation per iteration).  Returns ``(W_new, Y_new,
    nll)``."""
    with full_f32_matmuls():
        R = torch.clamp(torch.sqrt((torch.abs(Y) ** 2).sum(dim=1)), min=eps)
        W = ip_update(W, _covariance(X, 1.0 / R, PP, use_pallas), threshold=threshold)
        Y = _separate(W, X)
        return W, Y, _nll(W, torch.sum(torch.abs(Y) ** 2, dim=1), X.shape[-1])


def auxiva_ip_step_binsmajor(Xf, W, Yf, PP, eps=1e-8, threshold=1e12):
    """AuxIVA-IP iteration with the frequency axis leading everywhere, so
    the separation is one bin-batched matmul.

    Args:
        Xf: mixture ``(n_bins, n_channels, n_frames)``.
        W: demixing filters ``(n_bins, n_sources, n_channels)``.
        Yf: current estimates ``(n_bins, n_sources, n_frames)``.
        PP: pair products ``(C, C, n_bins, n_frames)`` (loop-invariant).
    Returns:
        ``(W_new, Yf_new, nll)``.
    """
    with full_f32_matmuls():
        R = torch.clamp(torch.sqrt((torch.abs(Yf) ** 2).sum(dim=0)), min=eps)  # (N, T)
        W = ip_update(W, weighted_covariance_from_pairs(PP, 1.0 / R), threshold=threshold)
        Yf = W @ Xf  # (F, N, T)
        return W, Yf, _nll(W, torch.sum(torch.abs(Yf) ** 2, dim=0), Xf.shape[-1])


def auxiva_ip_step_stacked(X2, W2, eps=1e-8, threshold=1e12):
    """:func:`auxiva_ip_step` with complex tensors carried as a stacked
    leading (re, im) axis: ``X2 (2, C, F, T)``, ``W2 (2, F, N, C)`` real.
    Returns ``(W2_new, nll)``."""
    W, nll = auxiva_ip_step(torch.complex(X2[0], X2[1]), torch.complex(W2[0], W2[1]), eps=eps, threshold=threshold)
    return torch.stack([W.real, W.imag]), nll


def batched_auxiva_ip_step(X2, W2, eps=1e-8, threshold=1e12):
    """:func:`auxiva_ip_step_stacked` over a leading mixture axis, as tensor
    ops on the whole batch: ``X2 (B, 2, C, F, T)``, ``W2 (B, 2, F, N, C)``
    -> ``(W2_new (B, 2, F, N, C), nll (B,))``.  The IP sweep is per bin, so
    it runs once over the ``B F`` bins."""
    with full_f32_matmuls():
        X = torch.complex(X2[:, 0], X2[:, 1])  # (B, C, F, T)
        W = torch.complex(W2[:, 0], W2[:, 1])  # (B, F, N, C)
        B, F, N, C = W.shape
        n_frames = X.shape[-1]
        Y = torch.einsum("bfnc,bcft->bnft", W, X)
        R = torch.clamp(torch.sqrt((torch.abs(Y) ** 2).sum(dim=2)), min=eps)  # (B, N, T)
        w = (1.0 / R).to(X.dtype)
        U = torch.einsum("bnt,bcft,bdft->nbfcd", w, X, X.conj()) / n_frames
        W = ip_update(W.reshape(B * F, N, C), U.reshape(N, B * F, C, C), threshold=threshold).reshape(B, F, N, C)
        Y = torch.einsum("bfnc,bcft->bnft", W, X)
        power = torch.sum(torch.abs(Y) ** 2, dim=2)  # (B, N, T)
        nll = (2 * torch.sqrt(power)).sum(dim=(1, 2)) - 2 * n_frames * batched_log_abs_det(W).sum(dim=1)
        return torch.stack([W.real, W.imag], dim=1), nll
