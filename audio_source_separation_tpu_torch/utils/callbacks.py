"""Observability callbacks: per-iteration SI-SDR and BSS Eval against ground
truth, state snapshots to ``.npz`` and a loss logger.

A solver calls each callback with itself after init (where
``callback_on_init`` is set) and after every iteration, with its state
published as attributes.  Projection-back, ``istft`` and the metric run on
the solver's device; only scalars (and the snapshots) cross to the host.
"""

import os

import numpy as np
import torch

from ..algorithm.projection_back import projection_back
from ..transform.stft import istft
from .metrics import bss_eval_sources, pit_si_sdr


class _GroundTruthCallback:
    """The signals a ground-truth callback rebuilds from the solver: the
    (projected-back) estimates in time, on the solver's device."""

    def __init__(self, targets, fft_size, hop_size, length, apply_projection_back):
        # (n_sources, n_samples), NumPy or a tensor
        self.targets = targets if isinstance(targets, torch.Tensor) else np.asarray(targets)
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.length = length if length is not None else self.targets.shape[-1]
        # mid-run estimates carry arbitrary per-bin scales (solvers restore
        # scale only at finalize); SI-SDR is invariant to a global
        # per-source scale but not to a per-bin filter, so the curve projects
        # back against the reference mic every iteration
        self.apply_projection_back = apply_projection_back
        self._device_targets = None

    def _targets(self, device):
        if self._device_targets is None or self._device_targets.device != device:
            self._device_targets = torch.as_tensor(self.targets).to(device, torch.float64)
        return self._device_targets

    def _istft(self, spectrogram):
        return istft(
            spectrogram, fft_size=self.fft_size, hop_size=self.hop_size, length=self.length,
            device=spectrogram.device,
        )

    def _signals(self, solver):
        """``(estimates (n_sources, n), targets (n_sources, n))`` on the
        solver's device, or ``None`` where the solver publishes no
        ``estimation``."""
        estimation = getattr(solver, "estimation", None)
        if estimation is None:
            return None
        mixture = getattr(solver, "input", None)
        if self.apply_projection_back and mixture is not None:
            reference = mixture[getattr(solver, "reference_id", 0)]
            estimation = estimation * projection_back(estimation, reference)[..., None]
        y = self._istft(estimation)
        return y, self._targets(y.device)[:, : y.shape[-1]]


class SDRImprovementCallback(_GroundTruthCallback):
    """Per-iteration PIT SI-SDR against ground-truth sources: pass it at
    call time (``solver(X, iteration=N)`` with ``callbacks=cb``), read
    ``cb.history`` (Python floats) afterwards."""

    def __init__(self, targets, fft_size, hop_size, length=None, apply_projection_back=True):
        super().__init__(targets, fft_size, hop_size, length, apply_projection_back)
        self.history = []

    def __call__(self, solver):
        signals = self._signals(solver)
        if signals is None:
            return
        value, _ = pit_si_sdr(*signals)
        self.history.append(value)


class BSSEvalCallback(_GroundTruthCallback):
    """Per-iteration BSS Eval SDR/SIR/SAR against ground-truth sources.

    ``history`` collects ``(sdr, sir, sar)`` triples of per-source float64
    tensors on the solver's device; ``sdri_history`` the mean-SDR
    improvement over the mixture baseline (Python floats).  The 512-tap
    joint projection is much heavier than SI-SDR, so ``stride`` subsamples
    iterations.
    """

    def __init__(
        self,
        targets,
        fft_size,
        hop_size,
        length=None,
        apply_projection_back=True,
        filter_length=512,
        stride=1,
    ):
        super().__init__(targets, fft_size, hop_size, length, apply_projection_back)
        self.filter_length = filter_length
        self.stride = max(int(stride), 1)
        self.history = []
        self.sdri_history = []
        self._baseline = None
        self._count = 0

    def __call__(self, solver):
        count = self._count
        self._count += 1
        if count % self.stride:
            return
        signals = self._signals(solver)
        if signals is None:
            return
        y, targets = signals
        sdr, sir, sar, _ = bss_eval_sources(targets, y, filter_length=self.filter_length)
        self.history.append((sdr, sir, sar))
        mixture = getattr(solver, "input", None)
        if self._baseline is None and mixture is not None:
            mix = self._istft(mixture[getattr(solver, "reference_id", 0)])
            base_sdr, _, _, _ = bss_eval_sources(targets, mix[None].expand(targets.shape), filter_length=self.filter_length)
            self._baseline = float(torch.mean(base_sdr))
        if self._baseline is not None:
            self.sdri_history.append(float(torch.mean(sdr)) - self._baseline)


class StateSnapshotCallback:
    """Write selected solver state arrays to ``{prefix}_{iteration}.npz``
    in ``directory`` on every call."""

    def __init__(self, directory, fields=("basis", "activation"), prefix="state"):
        self.directory = directory
        self.fields = fields
        self.prefix = prefix
        self.iteration = 0
        os.makedirs(directory, exist_ok=True)

    def __call__(self, solver):
        payload = {}
        for field in self.fields:
            value = getattr(solver, field, None)
            if value is not None:
                payload[field] = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        np.savez(os.path.join(self.directory, "{}_{}.npz".format(self.prefix, self.iteration)), **payload)
        self.iteration += 1


class LossLogger:
    """Print the latest recorded loss every ``stride`` iterations."""

    def __init__(self, stride=10, printer=print):
        self.stride = stride
        self.printer = printer
        self.iteration = 0

    def __call__(self, solver):
        if solver.loss and self.iteration % self.stride == 0:
            self.printer("iteration {}: loss {:.6g}".format(self.iteration, solver.loss[-1]))
        self.iteration += 1
