"""Minimum-distortion-principle scale restoration (reference
``algorithm/minimum_distortion_principle.py:3-31``): the diagonal closed
form ``scale = sum_t conj(Y) X / sum_t |Y|^2``."""

import torch


def minimum_distortion_principle(Y, reference):
    """Args:
        Y: ``(n_sources, n_bins, n_frames)``.
        reference: ``(n_bins, n_frames)`` or ``(n_channels, n_bins, n_frames)``.
    Returns:
        scale ``(n_sources, n_bins)`` or ``(n_channels, n_sources, n_bins)``,
        on ``Y``'s device.
    """
    n_dims = reference.ndim
    if n_dims == 2:
        X = reference[None, :, :]
    elif n_dims == 3:
        X = reference
    else:
        raise ValueError("reference.ndim is expected 2 or 3, but given {}.".format(n_dims))
    YX_conj = torch.sum(Y[None].conj() * X[:, None], dim=3)  # (n_channels, n_sources, n_bins)
    YY = torch.sum(torch.abs(Y) ** 2, dim=2)  # (n_sources, n_bins)
    scale = YX_conj / YY
    return scale[0] if n_dims == 2 else scale


def generalized_minimum_distortion_principle():
    """Empty stub, as in the reference (``minimum_distortion_principle.py:33-34``)."""
    return
