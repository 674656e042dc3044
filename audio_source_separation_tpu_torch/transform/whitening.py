"""Time-domain whitening (reference ``transform/whitening.py:3-18``).

The reference takes ``np.linalg.eig`` of the real symmetric self-covariance;
``x x^T`` is symmetric PSD, so ``torch.linalg.eigh`` gives the same
whitening up to the order and sign of the rows: the output's self-covariance
is the identity either way.
"""

import numpy as np
import torch

from ..runtime.device import resolve_device


def whitening(input, zero_mean=True, channel_first=True, device=None):
    """Args:
        input: real ``(n_channels, T)`` signal.  A tensor stays on its
            device; anything else goes to ``device``, the CUDA card unless
            the caller passes ``device="cpu"``.
    Returns:
        whitened ``(n_channels, T)`` tensor with identity self-covariance.
    """
    if not zero_mean:
        raise AssertionError("`zero_mean` must be True.")
    if not channel_first:
        raise AssertionError("`channel_first` must be True.")
    x = input if isinstance(input, torch.Tensor) else torch.as_tensor(np.asarray(input), device=resolve_device(device))
    w, v = torch.linalg.eigh(x @ x.T)
    return (v.T @ x) / torch.sqrt(w)[:, None]
