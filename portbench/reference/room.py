"""The benchmark's recordings: seeded sources through rooms on the MIRD
array geometry, made on the run's device from one ``torch.Generator``.

The room is a frozen restatement of the far-field model in the program's
``utils/synthesis.py::mird_geometry_rirs`` (MIRD's linear array, spacings
3-3-3-8-3-3-3 cm; the source 1 m away at an angle of MIRD's grid; a
windowed-sinc fractional-delay direct path and an exponentially decaying
diffuse tail with T60 = 0.16 s), written here so that a change to the
program cannot change the benchmark's input.  Two adjacent microphones of
the array and two distinct grid angles are drawn per recording.

A source is Laplacian noise and five harmonic partials (a fundamental of
100-300 Hz with a slow vibrato) under a syllable-rate envelope (a sum of
2-6 Hz sinusoids, half-wave rectified): super-Gaussian and non-stationary,
so the solvers have sources to separate.  Each mixture is scaled to a peak
of 0.5 and quantised to 16-bit levels, as read from a 16-bit WAV.
"""

import math

import numpy as np
import torch

MIRD_INTERVALS_CM = (3, 3, 3, 8, 3, 3, 3)
MIRD_DEGREES = (0, 15, 30, 45, 60, 75, 90, 270, 285, 300, 315, 330, 345)
DISTANCE_M = 1.0
T60_S = 0.16
SOUND_SPEED = 343.0
RIR_S = 0.5


def _uniform(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float64)


def _mic_positions():
    positions = np.concatenate([[0.0], np.cumsum(MIRD_INTERVALS_CM)]) / 100.0
    return positions - positions.mean()


def impulse_responses(degrees, mics, sr, generator, device):
    """``(len(degrees), len(mics), taps)`` impulse responses, source ``s``
    at ``degrees[s]`` and the microphones at ``mics`` (array indices)."""
    positions = _mic_positions()[list(mics)]
    taps = int(RIR_S * sr)
    n = torch.arange(taps, dtype=torch.float64, device=device)
    decay = torch.exp(-6.908 * n / max(int(T60_S * sr), 1))  # -60 dB at T60
    base_delay = DISTANCE_M / SOUND_SPEED * sr + 8.0  # headroom for the sinc
    draws = torch.randn((len(degrees), len(mics), taps), generator=generator, device=device, dtype=torch.float64)
    rirs = []
    for s, degree in enumerate(degrees):
        theta = math.radians(degree if degree <= 90 else degree - 360)
        tau = torch.as_tensor(base_delay + positions * math.sin(theta) / SOUND_SPEED * sr, device=device)
        x = n[None, :] - tau[:, None]  # (mics, taps)
        window = 0.5 * (1 + torch.cos(math.pi * torch.clamp(x / 8.0, -1, 1)))
        direct = torch.sinc(x) * window / DISTANCE_M
        tail = 0.12 * draws[s] * decay / DISTANCE_M
        tail = torch.where(n[None, :] <= torch.floor(tau)[:, None], 0.0, tail)  # causal
        rirs.append(direct + tail)
    return torch.stack(rirs)


def sources(n_recordings, n_sources, n_samples, sr, generator, device):
    """``(n_recordings, n_sources, n_samples)`` dry sources (module
    docstring), float64."""
    shape = (n_recordings, n_sources)
    t = torch.arange(n_samples, dtype=torch.float64, device=device) / sr
    u = _uniform(shape + (n_samples,), generator, device) - 0.5
    noise = -torch.sign(u) * torch.log1p(-2 * u.abs().clamp(max=0.5 - 1e-12))
    f0 = 100 + 200 * _uniform(shape + (1,), generator, device)
    vibrato = 1 + 0.02 * torch.sin(2 * math.pi * (4 + 2 * _uniform(shape + (1,), generator, device)) * t)
    phase = 2 * math.pi * torch.cumsum(f0 * vibrato, dim=-1) / sr
    harmonic = sum(torch.sin(k * phase) / k for k in range(1, 6))
    rates = 2 + 4 * _uniform(shape + (4, 1), generator, device)
    offsets = 2 * math.pi * _uniform(shape + (4, 1), generator, device)
    envelope = 0.05 + torch.clamp(torch.sin(2 * math.pi * rates * t + offsets).sum(dim=-2), min=0)
    return envelope * (0.3 * noise + harmonic)


def recordings(n_recordings, n_mics, n_samples, sr, seed, device):
    """The pool: ``n_recordings`` mixtures ``(n_mics, n_samples)`` as host
    float32 NumPy arrays, each made of ``n_mics`` sources (determined
    mixing), all drawn from ``seed`` on ``device``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) % (1 << 63))
    dry = sources(n_recordings, n_mics, n_samples, sr, generator, device)
    pool = []
    array_size = len(MIRD_INTERVALS_CM) + 1
    for r in range(n_recordings):
        first = int(torch.randint(array_size - n_mics + 1, (1,), generator=generator, device=device))
        picks = torch.randperm(len(MIRD_DEGREES), generator=generator, device=device)[:n_mics]
        degrees = [MIRD_DEGREES[int(i)] for i in picks]
        rirs = impulse_responses(degrees, range(first, first + n_mics), sr, generator, device)
        n_fft = 1 << math.ceil(math.log2(n_samples + rirs.shape[-1] - 1))
        spectra = torch.fft.rfft(dry[r], n=n_fft)[:, None] * torch.fft.rfft(rirs, n=n_fft)
        mixture = torch.fft.irfft(spectra, n=n_fft)[..., :n_samples].sum(dim=0)  # (mics, samples)
        mixture = mixture * (0.5 / mixture.abs().max())
        pool.append((torch.round(mixture * 32768) / 32768).to(torch.float32).cpu().numpy())
    return pool
