"""STFT / iSTFT with ``scipy.signal.stft`` / ``istft`` semantics.

scipy's conventions, reproduced with explicit framing and
``torch.fft.rfft`` / ``irfft`` (``torch.stft`` pads and normalises
differently):
  * periodic (``sym=False``) hann / hamming windows;
  * ``boundary='zeros'``: ``nperseg // 2`` zeros on both ends;
  * ``padded=True``: zero-pad so the signal divides into whole hops;
  * forward scaling by ``1 / window.sum()``;
  * inverse: irfft, scale by ``window.sum()``, windowed overlap-add divided
    by the overlap-add of ``window**2`` (guarded at ``1e-10``), then the
    boundary padding is trimmed.

The overlap-add is ``torch.nn.functional.fold``, which gathers each output
sample's terms in a fixed order (no atomics), so it is deterministic on CUDA.
Both transforms run at the input's precision (at least float32) on the
device that ``device`` names (default ``"cuda"``; pass ``device="cpu"`` for
the host).

Each transform is a span of the program's span log (``stft``, ``istft``,
:mod:`~..runtime.spanlog`) with a child ``stft.copy_in`` / ``istft.copy_in``
around each site that can copy host data in (the input, the window); the
sites add to the ``host_copies`` counters.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.device import resolve_device
from ..runtime.spanlog import count_copy, span


def build_window(fft_size, window_fn="hann", dtype=torch.float64, device=None):
    """Periodic (DFT-even) analysis window on ``device`` (``None`` means
    ``"cuda"``)."""
    n = np.arange(fft_size)
    if window_fn == "hann":
        window = 0.5 - 0.5 * np.cos(2 * np.pi * n / fft_size)
    elif window_fn == "hamming":
        window = 0.54 - 0.46 * np.cos(2 * np.pi * n / fft_size)
    elif window_fn in ("boxcar", "rectangular", None):
        window = np.ones(fft_size)
    else:
        raise ValueError("Not support {} window.".format(window_fn))
    window = torch.as_tensor(window, dtype=dtype, device=resolve_device(device))
    count_copy(window.numel() * window.element_size())
    return window


def build_optimal_window(window, hop_size=None, device=None):
    """COLA-normalised synthesis window.  A tensor ``window`` stays on its
    device; anything else goes to ``device`` (``None`` means ``"cuda"``)."""
    window = window if isinstance(window, torch.Tensor) else _as_tensor(window, resolve_device(device))
    window_length = window.shape[0]
    if hop_size is None:
        hop_size = window_length // 2
    n_shifts = window_length // hop_size
    shifts = torch.stack([torch.roll(window, hop_size * idx) for idx in range(n_shifts)])
    norm = torch.sum(shifts**2, dim=0)
    return window / norm


def _as_tensor(input, device):
    """``input`` as a tensor on ``device``; host data counts as a copy."""
    if isinstance(input, torch.Tensor):
        if input.device.type == "cpu" and device.type != "cpu":
            count_copy(input.numel() * input.element_size())
        return input.to(device)
    x = torch.as_tensor(np.asarray(input), device=device)
    count_copy(x.numel() * x.element_size())
    return x


def stft(input, fft_size, hop_size=None, window_fn="hann", normalize=False, device=None):
    """Short-time Fourier transform.

    Args:
        input: real signal ``(..., n_samples)`` (numpy or tensor).
        fft_size: FFT / window length (scipy ``nperseg``).
        hop_size: hop length (scipy ``nperseg - noverlap``); default
            ``fft_size // 2``.
        device: where to compute; ``None`` means ``"cuda"``.
    Returns:
        complex spectrogram ``(..., fft_size // 2 + 1, n_frames)`` on
        ``device``, equal to ``scipy.signal.stft(x, nperseg=fft_size,
        noverlap=fft_size - hop_size)[2]``.
    """
    with span("stft"):
        device = resolve_device(device)
        if hop_size is None:
            hop_size = fft_size // 2
        with span("stft.copy_in"):
            x = _as_tensor(input, device)
        real_dtype = torch.promote_types(x.dtype, torch.float32)
        x = x.to(real_dtype)
        with span("stft.copy_in"):
            window = build_window(fft_size, window_fn=window_fn, dtype=real_dtype, device=device)

        half = fft_size // 2
        x = F.pad(x, (half, half))
        n_samples = x.shape[-1]
        remainder = (n_samples - fft_size) % hop_size
        if remainder != 0:
            x = F.pad(x, (0, hop_size - remainder))

        frames = x.unfold(-1, fft_size, hop_size) * window  # (..., n_frames, fft_size)
        spec = torch.fft.rfft(frames, dim=-1) / torch.sum(window)
        return spec.transpose(-2, -1)


def istft(input, fft_size, hop_size=None, window_fn="hann", normalize=False, length=None, device=None):
    """Inverse STFT matching ``scipy.signal.istft`` (boundary trim included).

    Args:
        input: complex spectrogram ``(..., n_bins, n_frames)``.
        length: optional truncation of the output.
        device: where to compute; ``None`` means ``"cuda"``.
    Returns:
        real signal ``(..., n_samples)`` on ``device``.
    """
    with span("istft"):
        device = resolve_device(device)
        if hop_size is None:
            hop_size = fft_size // 2
        with span("istft.copy_in"):
            X = _as_tensor(input, device)
        if not X.is_complex():
            X = X.to(torch.promote_types(X.dtype, torch.complex64))
        n_frames = X.shape[-1]
        real_dtype = X.real.dtype
        with span("istft.copy_in"):
            window = build_window(fft_size, window_fn=window_fn, dtype=real_dtype, device=device)

        frames = torch.fft.irfft(X.transpose(-2, -1), n=fft_size, dim=-1)
        frames = frames * torch.sum(window) * window  # (..., n_frames, fft_size)

        n_samples = fft_size + (n_frames - 1) * hop_size
        batch_shape = X.shape[:-2]
        flat = frames.reshape(-1, n_frames, fft_size).transpose(1, 2)  # (B, fft, frames)

        def overlap_add(cols):
            out = F.fold(cols, output_size=(1, n_samples), kernel_size=(1, fft_size), stride=(1, hop_size))
            return out.reshape(cols.shape[0], n_samples)

        out = overlap_add(flat)
        norm = overlap_add((window**2)[None, :, None].expand(1, fft_size, n_frames).contiguous())[0]
        out = out / torch.where(norm > 1e-10, norm, torch.ones_like(norm))
        out = out.reshape(batch_shape + (n_samples,))

        half = fft_size // 2
        out = out[..., half : n_samples - half]
        if length is not None:
            out = out[..., :length]
        return out
