"""Convolutive-mixture synthesis: sources through per-(source, mic) impulse
responses, and two network-free impulse-response generators.

The random draws stay ``np.random.RandomState(seed)`` on the host, in the
JAX package's order, so both packages draw the same numbers; the arithmetic
runs in torch at float64 on ``device`` (the CUDA card unless the caller
passes ``device="cpu"``; a tensor argument keeps its own device).
"""

import numpy as np
import torch

from ..runtime.device import float64_tensors, resolve_device


def convolutive_mixture(sources, impulse_responses, n_samples=None, device=None):
    """Mix sources through per-(source, mic) impulse responses (FFT
    convolution).

    Args:
        sources: ``(n_sources, n_samples)`` dry signals.
        impulse_responses: ``(n_sources, n_mics, taps)`` RIRs.
        n_samples: output length (default: the sources' length).
    Returns:
        ``(mixture (n_mics, n_samples), images (n_sources, n_mics,
        n_samples))`` float64 tensors, ``images[n, m]`` source ``n``'s
        contribution at mic ``m``.
    """
    sources, rirs = float64_tensors([sources, impulse_responses], device)
    length, taps = sources.shape[-1], rirs.shape[-1]
    n_samples = length if n_samples is None else n_samples
    n_fft = 1 << int(np.ceil(np.log2(max(length + taps - 1, n_samples, 1))))
    spectra = torch.fft.rfft(sources, n=n_fft)[:, None] * torch.fft.rfft(rirs, n=n_fft)
    images = torch.fft.irfft(spectra, n=n_fft)[..., :n_samples]
    return images.sum(dim=0), images


def synthetic_room_impulse_responses(
    n_sources, n_mics, taps=64, decay=0.3, seed=111, sr=16000, max_delay=8, device=None
):
    """Deterministic exponential-decay RIRs ``(n_sources, n_mics, taps)``
    with distinct direct-path delays per (source, mic)."""
    rng = np.random.RandomState(seed)
    draws = np.stack([np.stack([rng.randn(taps) for _ in range(n_mics)]) for _ in range(n_sources)])
    device = resolve_device(device)
    envelope = torch.exp(-torch.arange(taps, dtype=torch.float64, device=device) / (decay * taps))
    rirs = 0.2 * (torch.as_tensor(draws, device=device) * envelope)
    for n in range(n_sources):
        for m in range(n_mics):
            rirs[n, m, (3 * m + 5 * n) % max_delay] += 1.0 if (m % n_sources) == n else 0.8
    return rirs


# MIRD's angle grid, encoded as in its filenames: 0..90 in 15 degree steps
# plus 270..345 (= -90..-15)
MIRD_DEGREES = [0, 15, 30, 45, 60, 75, 90, 270, 285, 300, 315, 330, 345]


def mird_geometry_rirs(
    degree,
    mic_intervals="3-3-3-8-3-3-3",
    distance=1.0,
    reverb=0.16,
    sr=16000,
    samples=None,
    seed=111,
    sound_speed=343.0,
    device=None,
):
    """Synthetic far-field RIRs on the MIRD linear-array geometry.

    A linear array whose adjacent-mic spacings are ``mic_intervals``
    centimetres, the source at ``distance`` metres and ``degree`` on MIRD's
    grid (0..90 and 270..345, i.e. -90..-15).  Each mic gets a
    windowed-sinc fractional-delay direct path (far-field delay
    ``x_m sin(theta) / c``) plus a causal exponentially decaying diffuse
    tail calibrated to T60 = ``reverb``.

    Returns a ``(samples, n_mics)`` float64 tensor, the orientation of
    MIRD's ``impulse_response`` arrays.
    """
    intervals_cm = [float(v) for v in str(mic_intervals).split("-")]
    positions = np.concatenate([[0.0], np.cumsum(intervals_cm)]) / 100.0
    positions = positions - positions.mean()
    n_mics = len(positions)
    theta = np.deg2rad(degree if degree <= 90 else degree - 360)
    if samples is None:
        samples = int(0.5 * sr)
    rng = np.random.RandomState(seed + int(degree))
    draws = np.stack([rng.randn(samples) for _ in range(n_mics)], axis=1)  # (samples, n_mics)

    device = resolve_device(device)
    t60_samples = max(int(reverb * sr), 1)
    n = torch.arange(samples, dtype=torch.float64, device=device)[:, None]
    decay = torch.exp(-6.908 * n / t60_samples)  # -60 dB at T60
    base_delay = distance / sound_speed * sr + 8.0  # headroom for the sinc
    tau = torch.as_tensor(base_delay + positions * np.sin(theta) / sound_speed * sr, device=device)
    x = n - tau
    window = 0.5 * (1 + torch.cos(np.pi * torch.clamp(x / 8.0, -1, 1)))
    direct = torch.sinc(x) * window / max(distance, 1e-3)
    tail = 0.12 * torch.as_tensor(draws, device=device) * decay / max(distance, 1e-3)
    tail = torch.where(n <= torch.floor(tau), 0.0, tail)  # causal
    return direct + tail
