"""Frequency-permutation alignment for FDICA (reference
``bss/fdica.py:106-138``).

Greedy bin-by-bin alignment: normalise each bin's amplitude envelopes over
the sources, order the bins by their total correlation (ascending), then
for each bin in that order try all ``S!`` source permutations against the
accumulated criterion envelope.  The envelopes and the correlations are
computed on the estimates' device; the greedy sweep, sequential and
data-dependent, runs on the host at float64: in C
(:func:`~..runtime.native.solve_permutation_native`) where the library
builds and ``n_sources <= 8``, else the NumPy loop :func:`greedy_permutations`.
Both give the same permutations.
"""

import itertools

import numpy as np
import torch

from ..runtime.native import solve_permutation_native
from ..utils.flooring import EPS


def greedy_permutations(P, indices):
    """The greedy sweep in NumPy (the JAX package's loop, recording each
    bin's permutation instead of moving the filter's rows).

    Args:
        P: normalised envelopes ``(n_bins, n_sources, n_frames)`` float64.
        indices: the bins' processing order ``(n_bins,)``.
    Returns:
        ``(n_bins, n_sources)`` int64 permutations.
    """
    n_bins, n_sources, _ = P.shape
    perms = np.tile(np.arange(n_sources), (n_bins, 1))
    permutations = list(itertools.permutations(range(n_sources)))
    min_idx = indices[0]
    P_criteria = P[min_idx]  # (n_sources, n_frames)

    for idx in range(1, n_bins):
        min_idx = indices[idx]
        P_max = None
        perm_max = None
        for perm in permutations:
            P_perm = np.sum(P_criteria * P[min_idx, perm, :])
            if P_max is None or P_perm > P_max:
                P_max = P_perm
                perm_max = perm
        P_criteria = P_criteria + P[min_idx, perm_max, :]
        perms[min_idx] = perm_max
    return perms


def solve_permutation(W, Y, eps=EPS):
    """Align per-bin source permutations.

    Args:
        W: demixing filters ``(n_bins, n_sources, n_channels)`` tensor.
        Y: current estimates ``(n_sources, n_bins, n_frames)`` tensor.
    Returns:
        the permutation-aligned ``W`` (a new tensor on ``W``'s device).
        ``solve_permutation.route`` records the route of the greedy sweep:
        ``"native"`` or ``"numpy"``.
    """
    P = torch.abs(Y).permute(1, 0, 2)  # (n_bins, n_sources, n_frames)
    norm = torch.sqrt(torch.sum(P**2, dim=1, keepdim=True))
    P = P / torch.where(norm < eps, eps, norm)
    correlation = torch.sum(P @ P.transpose(1, 2), dim=(1, 2))  # (n_bins,)
    indices = np.argsort(correlation.double().cpu().numpy())
    P = P.double().cpu().numpy()

    perms = solve_permutation_native(P, indices)
    solve_permutation.route = "native"
    if perms is None:
        perms = greedy_permutations(P, indices)
        solve_permutation.route = "numpy"
    index = torch.as_tensor(perms, device=W.device)
    return torch.gather(W, 1, index[:, :, None].expand(W.shape))


solve_permutation.route = None
