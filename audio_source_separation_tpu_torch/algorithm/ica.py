"""Fixed-point ICA placeholder (reference ``algorithm/ica.py:5-7``): a
constructor-only stub ("A Fast Fixed-Point Algorithm for Independent
Component Analysis"), kept for the API surface."""

import torch

from ..runtime.device import resolve_device


class FixedPointICA:
    def __init__(self, n_channels=10, dtype=torch.complex128, device=None):
        self.demix_filter = torch.eye(n_channels, dtype=dtype, device=resolve_device(device))
