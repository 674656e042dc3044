"""The user's path through the program for a blind-source-separation
solver: a host waveform in, separated host waveforms out.

``stft`` (the host-to-device copy inside it), the configuration's solver
called as ``solver(X, iteration=N)`` on one solver object reused
for every recording (its graph cache holds across them, as in a
long-lived worker), ``istft`` and the copy back to the host.  With
``spans`` the stages are synchronised and timed and annotated for the
profiler; without, nothing but the final copy waits on the card.
"""

import contextlib
import time

import torch


class Pipeline:
    def __init__(self, config, device):
        import audio_source_separation_tpu_torch as port

        self.port, self.device = port, torch.device(device)
        system = config["system"]
        self.fft_size, self.hop_size = config["stft"]["fft_size"], config["stft"]["hop_size"]
        self.window = config["stft"]["window"]
        self.iteration = system["iteration"]
        self.solver = getattr(port, system["entry"])(**system["kwargs"], device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def separate(self, x, spans=False):
        """``(y, outputs, stage seconds)`` for the mixture ``x``: ``y`` the
        separated host array, ``outputs`` what the comparison reads (the
        spectrogram, the losses, the demixing filter), the stage times
        ``(frontend_in, solve, frontend_out)`` with ``spans``, else
        ``None``."""
        annotate = torch.profiler.record_function if spans else (lambda name: contextlib.nullcontext())
        marks = [time.perf_counter()]
        with annotate("portbench.frontend_in"):
            X = self.port.stft(x, self.fft_size, self.hop_size, window_fn=self.window, device=self.device)
            if spans:
                self._sync()
                marks.append(time.perf_counter())
        with annotate("portbench.solve"):
            Y = self.solver(X, iteration=self.iteration)
            if spans:
                self._sync()
                marks.append(time.perf_counter())
        with annotate("portbench.frontend_out"):
            y = self.port.istft(
                Y, self.fft_size, self.hop_size, window_fn=self.window, length=x.shape[-1], device=self.device
            )
            y = y.cpu().numpy()
            marks.append(time.perf_counter())
        loss, self.solver.loss = self.solver.loss, []
        outputs = {"spec": X, "loss": loss, "demix_filter": self.solver.demix_filter}
        stages = tuple(b - a for a, b in zip(marks, marks[1:])) if spans else None
        return y, outputs, stages

