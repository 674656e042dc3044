from .pca import pca  # noqa: F401
from .stft import build_optimal_window, build_window, istft, stft  # noqa: F401
from .whitening import whitening  # noqa: F401
