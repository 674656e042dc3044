"""One run of one cell: set-up, the measured window, the readings.

Set-up makes the cell's recordings from the seed on the device, builds
the system under test (one solver object for the whole run) and separates
one recording: of the cell's own length where it is fixed, so its kernel
is built and its step captured; of ``warmup_s`` outside the drawn range
where lengths vary, so the kernels load and the FFT and BLAS libraries
initialise but no drawn length is captured before the window, as in a
fresh worker.

The window is a closed loop, one client: recording after recording, each
timed from the host array handed to ``stft`` to the separated host array,
for ``seconds``.  A recording is attempted when it starts inside the
window; it fails if the program raises or its output is not finite
(:meth:`Cell._finite`).
"""

import contextlib
import time
import traceback

import numpy as np
import torch

from . import trace as tracing
from .traffic import Schedule, n_frames


class Window:
    """What a window measured: ``recordings`` (one dict each: ``n_samples``,
    ``n_frames``, ``first_sight``, ``seconds``, ``stages``, ``failed``,
    ``profiled``), its ``start`` and ``end`` on the host clock, the drawn
    ``samples`` for the comparison, the ``trace`` of a traced run."""

    def __init__(self):
        self.recordings, self.samples, self.trace = [], [], None
        self.start = self.end = 0.0
        self.error = None

    @property
    def completed(self):
        return [r for r in self.recordings if not r["failed"]]


class Cell:
    def __init__(self, manifest, workload, seed, device):
        self.manifest = manifest
        self.cell = manifest.workload(workload)
        self.config = manifest.config(self.cell["config"])
        self.traffic = manifest.traffic(self.cell["traffic"])
        self.reference = manifest.reference(self.cell["config"])
        self.seed, self.device = int(seed), device
        self.schedule = Schedule(self.traffic, self.config, self.seed)

    def set_up(self, traced=False):
        """Make the pool, build the system and warm it up (module
        docstring); ``traced`` starts and stops the profiler once, so that
        its start inside the window is quick."""
        from ..reference import room

        sr = self.config["sample_rate"]
        marks = [time.perf_counter()]
        self.pool = room.recordings(
            self.traffic["pool"], self.config["n_mics"], self.schedule.longest, sr, self.seed, self.device
        )
        if self.device.type == "cuda":
            # the pool is on the host now: the card's peak is the program's
            # from here on, not the generator's
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        marks.append(time.perf_counter())
        self.pipeline = self.manifest.pipeline(self.config["pipeline"]).Pipeline(self.config, self.device)
        marks.append(time.perf_counter())
        n = int(round(self.traffic["warmup_s"] * sr))
        x = np.ascontiguousarray(self.pool[0][:, :n])
        self.pipeline.separate(x)
        self.seen = {n_frames(n, self.schedule.hop)}
        if traced:
            tracing.warm_up(self.device)
        marks.append(time.perf_counter())
        # seconds of the pool, the system's build, the warm-up
        self.setup_parts = tuple(b - a for a, b in zip(marks, marks[1:]))

    def release(self):
        """Drop the system under test (its solver, graphs and buffers)."""
        self.pipeline = None

    def window(self, seconds, traced=False):
        """Run the window (module docstring); with ``traced``, every stage
        is synchronised and timed, and ``trace_recordings`` whole
        recordings from the middle of the window on are profiled."""
        out = Window()
        rng = np.random.default_rng([self.seed, 3])
        keep = self.traffic["check_recordings"]
        to_profile = self.traffic["trace_recordings"] if traced else 0
        profiler, profiled = None, []
        longest = None
        out.start = time.perf_counter()
        i = n_done = 0
        while time.perf_counter() - out.start < seconds:
            x = self.schedule.mixture(self.pool, i)
            frames = n_frames(x.shape[-1], self.schedule.hop)
            record = {"index": i, "n_samples": x.shape[-1], "n_frames": frames, "first_sight": frames not in self.seen}
            self.seen.add(frames)
            if to_profile and profiler is None and not profiled and time.perf_counter() - out.start >= seconds / 2:
                profiler = tracing.profiler()
                profiler.start()
            record["profiled"] = profiler is not None
            annotate = tracing.recording_span() if profiler is not None else contextlib.nullcontext()
            t0 = time.perf_counter()
            try:
                with annotate:
                    y, outputs, stages = self.pipeline.separate(x, spans=traced)
                t1 = time.perf_counter()
                record["failed"] = not self._finite(y, outputs)
            except Exception:  # a failed recording is counted; the run goes on
                t1 = time.perf_counter()
                record["failed"] = True
                out.error = out.error or traceback.format_exc()
                y = None
                stages = None
            record["seconds"], record["stages"] = t1 - t0, stages
            out.recordings.append(record)
            if profiler is not None:
                profiled.append(record)
                if len(profiled) == to_profile:
                    profiler = self._stop(profiler, profiled, out)
            if not record["failed"]:
                sample = {"index": i, "x": x, "y": y, "outputs": outputs}
                n_done += 1
                if n_done <= keep:
                    out.samples.append(sample)
                elif rng.integers(n_done) < keep:
                    out.samples[int(rng.integers(keep))] = sample
                if self.schedule.shortest < self.schedule.longest and (longest is None or x.shape[-1] > longest["x"].shape[-1]):
                    longest = sample
                sample = None
            # what the run does not keep is freed here, not in the next
            # recording's time
            y = outputs = None
            i += 1
        out.end = time.perf_counter()
        if profiler is not None:
            self._stop(profiler, profiled, out)
        if longest is not None and all(s["index"] != longest["index"] for s in out.samples):
            out.samples.append(longest)
        return out

    def _finite(self, y, outputs):
        """Whether a recording's output is finite: its losses, and its
        waveforms every half hop (a non-finite bin spreads over a whole
        frame of the inverse STFT, a window's length)."""
        stride = max(self.schedule.hop // 2, 1)
        return bool(np.isfinite(outputs["loss"]).all() and np.isfinite(y[..., ::stride]).all())

    @staticmethod
    def _stop(profiler, profiled, out):
        profiler.stop()
        out.trace = tracing.Trace(profiler.profiler.kineto_results.events(), list(profiled))
        return None


def end_to_end(window, sample_rate):
    """``audio_s_per_s`` (the audio of every recording completed, over the
    window's wall time) and ``sep_p95_ms`` (the 95th percentile of the
    completed recordings' times) of a window; ``None`` where none
    completed."""
    done = window.completed
    if not done:
        return {"audio_s_per_s": None, "sep_p95_ms": None}
    audio_s = sum(r["n_samples"] for r in done) / sample_rate
    return {
        "audio_s_per_s": audio_s / (window.end - window.start),
        "sep_p95_ms": float(np.percentile([r["seconds"] for r in done], 95)) * 1e3,
    }
