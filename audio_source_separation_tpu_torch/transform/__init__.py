from .pca import pca
from .stft import build_optimal_window, build_window, istft, stft
from .whitening import whitening

__all__ = ["stft", "istft", "build_window", "build_optimal_window", "pca", "whitening"]
