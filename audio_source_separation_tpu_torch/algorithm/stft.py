"""Alias of :mod:`..transform.stft`.

The reference ships two identical STFT modules (``transform/stft.py`` and
``algorithm/stft.py``) and different solvers import different copies; the
port has one implementation and keeps the second import path.
"""

from ..transform.stft import build_optimal_window, build_window, istft, stft

__all__ = ["stft", "istft", "build_window", "build_optimal_window"]
