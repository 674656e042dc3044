"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.  There
is no silent fallback: asking for CUDA (explicitly, or by passing
``device=None``) on a machine without a card raises.
"""

import numpy as np
import torch


def resolve_device(device=None):
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is requested and CUDA is not
    available — pass ``device="cpu"`` to run on the host.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return device


def float64_tensors(arrays, device=None):
    """``arrays`` as float64 tensors on one device: that of the first tensor
    among them, else ``device`` (``None`` means ``"cuda"``)."""
    on = next((a.device for a in arrays if isinstance(a, torch.Tensor)), None)
    on = resolve_device(device) if on is None else on
    return [torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a)).to(on, torch.float64) for a in arrays]
