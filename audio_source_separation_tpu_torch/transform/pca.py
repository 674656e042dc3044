"""Per-bin channel PCA (the overdetermined solvers' reduction).

Reference ``src/transform/pca.py:4-21``: the eigenvectors of the per-bin
time-averaged spatial covariance, in ascending eigenvalue order (the
``eigh`` convention), so the trailing channels carry the dominant
components.
"""

import torch


def pca(input, n_sources=None):
    """Args:
        input: ``(n_channels, n_bins, n_frames)`` complex spectrogram.
        n_sources: if given, keep only the ``n_sources`` dominant components
            (the trailing eigenvectors).
    Returns:
        ``(n_channels or n_sources, n_bins, n_frames)`` decorrelated channels.
    """
    if input.ndim != 3:
        raise ValueError("Invalid dimension.")
    X = input.permute(1, 2, 0)  # (n_bins, n_frames, n_channels)
    covariance = torch.mean(X[:, :, :, None] * X[:, :, None, :].conj(), dim=1)  # (n_bins, C, C)
    _, w = torch.linalg.eigh(covariance)
    X = X @ w.conj()
    if n_sources is not None:
        X = X[..., -n_sources:]
    return X.permute(2, 0, 1)
