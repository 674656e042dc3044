"""WAV I/O and mu-law companding.

I/O stays on the host: ``read_wav`` returns NumPy and ``write_wav`` takes
NumPy or a tensor on any device.  Companding works on tensors (on their
device) and on arrays.
"""

import numpy as np
import torch
from scipy.io import wavfile


def read_wav(path):
    """Read a WAV file as ``(signal, sr)``; integer data is scaled to
    [-1, 1) (int16 by 1/32768)."""
    sr, signal = wavfile.read(path)
    if signal.dtype == np.int16:
        signal = signal / 32768
    elif signal.dtype == np.int32:
        signal = signal / 2147483648
    elif signal.dtype == np.uint8:
        signal = (signal.astype(np.float64) - 128) / 128
    else:
        signal = signal.astype(np.float64)
    return signal, sr


def write_wav(path, signal, sr, channel_last=True):
    """Write a float signal as int16 WAV, scaled by 32768 and clipped."""
    if isinstance(signal, torch.Tensor):
        signal = signal.detach().cpu().numpy()
    signal = np.asarray(signal) * 32768
    signal = np.clip(signal, -32768, 32767).astype(np.int16)
    if signal.ndim not in (1, 2):
        raise ValueError("Only 1D or 2D signals are supported.")
    if signal.ndim == 2 and not channel_last:
        signal = signal.T
    wavfile.write(path, sr, signal)


def mu_law_compand(x, mu=255):
    if isinstance(x, torch.Tensor):
        return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu)
    return np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)


def inv_mu_law_compand(y, mu=255):
    if isinstance(y, torch.Tensor):
        return torch.sign(y) * ((1 + mu) ** torch.abs(y) - 1) / mu
    return np.sign(y) * ((1 + mu) ** np.abs(y) - 1) / mu
