"""Projection-back scale restoration: the least-squares fit
``A = X Y^H (Y Y^H)^{-1}`` per frequency bin, giving the per-(source, bin)
complex scales that restore each separated source's image at the reference
microphone."""

import torch

from ..ops.fast_linalg import inv_planes


def projection_back(Y, reference, frames_sum=None):
    """Args:
        Y: separated sources ``(n_sources, n_bins, n_frames)``.
        reference: mixture at the reference mic ``(n_bins, n_frames)`` or the
            full mixture ``(n_channels, n_bins, n_frames)``.
        frames_sum: a frame-sharded caller's sum over the shards, applied
            once to the packed frame sums (``None``: the frames are whole).
    Returns:
        scale ``(n_sources, n_bins)`` (2-D reference) or
        ``(n_channels, n_sources, n_bins)`` (3-D reference).
    """
    n_dims = reference.ndim
    if n_dims == 2:
        X = reference[None, :, :]
    elif n_dims == 3:
        X = reference
    else:
        raise ValueError("reference.ndim is expected 2 or 3, but given {}.".format(n_dims))

    n_sources = Y.shape[0]
    n_channels = X.shape[0]
    if n_sources <= 3:
        # per-bin Gram matrices as N^2 frame reductions and a closed-form
        # adjugate solve.  The Gram is ridged by 1e-12 of its trace first: a
        # silent source or an all-zero bin makes det -> 0 (inf/NaN scales),
        # and the ridge is a ~1e-12 perturbation on well-conditioned bins.
        YY = torch.stack(
            [
                torch.stack([(Y[i] * Y[j].conj()).sum(dim=-1) for j in range(n_sources)])
                for i in range(n_sources)
            ]
        )  # (N, N, F)
        XY = torch.stack(
            [torch.stack([(X[c] * Y[j].conj()).sum(dim=-1) for j in range(n_sources)]) for c in range(n_channels)]
        )  # (C, N, F)
        if frames_sum is not None:
            YY, XY = frames_sum(torch.cat([YY, XY])).split([n_sources, n_channels])
        trace = sum(YY[i, i].real for i in range(n_sources))
        ridge = (1e-12 * trace + 1e-32).to(YY.dtype)
        eye = torch.eye(n_sources, dtype=YY.dtype, device=YY.device)[..., None]
        YY = YY + eye * ridge
        inv = inv_planes(YY)
        A = torch.stack(
            [
                torch.stack(
                    [sum(XY[c][k] * inv[k, j] for k in range(n_sources)) for j in range(n_sources)]
                )
                for c in range(n_channels)
            ]
        )  # (C, N, F)
        return A[0] if n_dims == 2 else A

    Yb = Y.permute(1, 0, 2)  # (F, N, T)
    Xb = X.permute(1, 0, 2)  # (F, C, T)
    Y_hermite = Yb.transpose(-2, -1).conj()  # (F, T, N)
    YYH = Yb @ Y_hermite  # (F, N, N), Hermitian
    XYH = Xb @ Y_hermite  # (F, C, N)
    if frames_sum is not None:
        YYH, XYH = frames_sum(torch.cat([YYH, XYH], dim=1)).split([n_sources, n_channels], dim=1)
    # A = XYH inv(YYH)  <=>  YYH^H A^H = XYH^H
    # the _ex form skips the error check, which would wait on the device
    A = torch.linalg.solve_ex(YYH.transpose(-2, -1).conj(), XYH.transpose(-2, -1).conj()).result
    A = A.transpose(-2, -1).conj_physical()  # (F, C, N)
    if n_dims == 2:
        return A[:, 0, :].transpose(0, 1)
    return A.permute(1, 2, 0)


def apply_projection_back(Y, reference):
    """``Y`` scaled by its projection-back coefficients."""
    scale = projection_back(Y, reference)
    return Y * scale[..., None]
