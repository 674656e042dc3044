"""The user's path through the program for a solver whose init is drawn on
the host: a host waveform in, separated host waveforms out.

:mod:`~portbench.pipelines.stft_bss_istft` (the same stages, annotations
and outputs) with its solver wrapped (:class:`SeededSolver`), so that:

  * before each solver call, inside the recording's ``solve`` stage, the
    configuration's ``init`` is drawn for the recording's frame count and
    handed to the solver as state keyword arguments, as a user seeds NumPy
    and calls the solver (:func:`draw_init`);
  * the filter the comparison reads is the solver attribute that the
    configuration's ``system.filter`` names.
"""

import numpy as np

from . import stft_bss_istft


def draw_init(config, n_bins, n_frames):
    """``{field: float64 array}`` of the configuration's ``init``: each
    field of ``init.draw`` uniform on [0, 1) in the order listed, from
    ``numpy.random.default_rng([init.seed, n_frames])``, its shape named by
    the configuration's sizes."""
    init = config["init"]
    sizes = {
        "n_sources": config["n_sources"],
        "n_bins": n_bins,
        "n_frames": n_frames,
        "n_basis": config["system"]["kwargs"]["n_basis"],
    }
    rng = np.random.default_rng([init["seed"], n_frames])
    return {field: rng.random(tuple(sizes[name] for name in shape)) for field, shape in init["draw"]}


class SeededSolver:
    """``solver`` called with the configuration's init drawn for each
    call's ``(n_bins, n_frames)``; its losses as ``loss`` and the filter
    that ``system.filter`` names as ``demix_filter``."""

    def __init__(self, solver, config):
        self.solver, self.config, self.filter = solver, config, config["system"]["filter"]

    def __call__(self, X, **kwargs):
        return self.solver(X, **kwargs, **draw_init(self.config, X.shape[1], X.shape[2]))

    @property
    def loss(self):
        return self.solver.loss

    @loss.setter
    def loss(self, value):
        self.solver.loss = value

    @property
    def demix_filter(self):
        return getattr(self.solver, self.filter)


class Pipeline(stft_bss_istft.Pipeline):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.solver = SeededSolver(self.solver, config)
