"""Iterative-projection (IP) demixing-row update, matrix layout.

For each source n in turn (row n's update reads the rows already updated),
solve ``(W U_n) w = e_n`` per bin, normalise by ``sqrt(w^H U_n w)`` and keep
the old row wherever the condition guard rejects ``W U_n``.  The cheap
guards at C <= 4 run the sweep in component layout
(:func:`~.ip_components.ip_update_components`); ``guard="svd"`` and C > 4
take the matrix path here, with ``torch.linalg`` where the closed forms
stop.
"""

import torch

from .fast_linalg import batched_inv
from .ip_components import filter_rows, ip_update_components, stack_filter_rows


def uses_component_sweep(guard, n_channels):
    """Whether an IP sweep runs in component layout: a cheap guard at
    C <= 4, where the closed forms hold."""
    return guard in ("one_norm", "none") and n_channels <= 4


def cond_guard(A, A_inv=None, threshold=1e12, guard="one_norm"):
    """Boolean mask over the leading axes: True where ``A (..., n, n)`` is
    conditioned well enough to accept the IP update.

    ``"svd"`` is the reference's 2-norm condition number (singular values
    by ``torch.linalg.svdvals``); ``"one_norm"`` is ``||A||_1 ||A^-1||_1``
    (free given the inverse; NaN compares false); ``"none"`` accepts all.
    """
    if guard == "none":
        return torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    if guard == "svd":
        s = torch.linalg.svdvals(A)
        return s[..., 0] / s[..., -1] < threshold
    if guard == "one_norm":
        if A_inv is None:
            A_inv = batched_inv(A)
        norm = torch.abs(A).sum(dim=-2).amax(dim=-1)
        inv_norm = torch.abs(A_inv).sum(dim=-2).amax(dim=-1)
        return norm * inv_norm < threshold
    raise ValueError("Unknown guard {!r}".format(guard))


def psd_quadratic_form(U, w):
    """``w^H U w`` for Hermitian PSD ``U (..., C, C)`` and ``w (..., C)``,
    clamped at 0: the exact value is non-negative, so float32 cancellation
    can only land below zero by rounding noise, and the clamp keeps the
    ``sqrt`` downstream from NaN."""
    wUw = torch.einsum("...c,...cd,...d->...", w.conj(), U, w)
    return torch.clamp(wUw.real, min=0.0)


def ip_update(W, U, threshold=1e12, guard="one_norm", denom_floor=None):
    """One full IP sweep over all sources.

    Args:
        W: demixing filters ``(n_bins, n_sources, n_channels)`` (rows are
            ``w_n^H``).
        U: weighted covariances ``(n_sources, n_bins, n_channels, n_channels)``.
        denom_floor: optional floor on ``sqrt(w^H U w)``.
    Returns:
        the updated ``W`` (same shape).

    The IVA solvers hold the component configurations
    (:func:`uses_component_sweep`) in component state and call this only
    for the matrix path; the component branch serves callers that carry
    ``W (F, N, C)`` through every sweep, as ILRMA does.
    """
    n_sources, n_channels = U.shape[0], U.shape[-1]
    if uses_component_sweep(guard, n_channels):
        U_comp = [
            [[U[n, :, c, d] for d in range(n_channels)] for c in range(n_channels)]
            for n in range(n_sources)
        ]
        rows = ip_update_components(filter_rows(W), U_comp, threshold=threshold, guard=guard, denom_floor=denom_floor)
        return stack_filter_rows(rows)
    W = W.clone()
    for n in range(n_sources):
        WU = W @ U[n]  # (n_bins, n_sources, C)
        WU_inv = batched_inv(WU)
        w_n = WU_inv[..., :, n]  # solve(WU, e_n): (n_bins, C)
        ok = cond_guard(WU, WU_inv, threshold=threshold, guard=guard)
        denominator = torch.sqrt(psd_quadratic_form(U[n], w_n))
        if denom_floor is not None:
            denominator = torch.clamp(denominator, min=denom_floor)
        w_n_hermite = w_n.conj() / denominator[:, None]
        W[:, n, :] = torch.where(ok[:, None], w_n_hermite, W[:, n, :])
    return W
