"""The user's path through the program for Sawada's multichannel NMF with
its init drawn on the host: a host waveform in, separated host waveforms
out.

:mod:`~portbench.pipelines.stft_seeded_bss_istft` (the same stages,
annotations, outputs and seeded draw), with the drawn ``latent`` mapped to
the upstream's init before the solver call (:func:`draw_init`): the
uniform draw ``u (S, K)`` becomes ``u * 1e-2 + 1 / S`` normalised over the
sources, as the solver's own host init forms it from ``np.random.rand``.
The other fields are handed over as drawn.
"""

import numpy as np

from . import stft_seeded_bss_istft as seeded


def latent_from_uniform(u, eps):
    """The upstream's latent init from a uniform draw ``u (S, K)``: ``Z = u
    * 1e-2 + 1 / S``, then ``Z / max(sum_s Z, eps)``."""
    Z = u * 1e-2 + 1 / u.shape[0]
    return Z / np.maximum(Z.sum(axis=0), eps)


def draw_init(config, n_bins, n_frames):
    """``{field: float64 array}``: the configuration's seeded draw
    (:func:`~portbench.pipelines.stft_seeded_bss_istft.draw_init`) with
    its ``latent`` mapped by :func:`latent_from_uniform`."""
    drawn = seeded.draw_init(config, n_bins, n_frames)
    drawn["latent"] = latent_from_uniform(drawn["latent"], config["system"]["kwargs"]["eps"])
    return drawn


class SeededSolver(seeded.SeededSolver):
    """:class:`~portbench.pipelines.stft_seeded_bss_istft.SeededSolver`
    with this module's :func:`draw_init`."""

    def __call__(self, X, **kwargs):
        return self.solver(X, **kwargs, **draw_init(self.config, X.shape[1], X.shape[2]))


class Pipeline(seeded.stft_bss_istft.Pipeline):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.solver = SeededSolver(self.solver, config)
