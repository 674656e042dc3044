"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.  There
is no silent fallback: asking for CUDA (explicitly, or by passing
``device=None``) on a machine without a card raises.
"""

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
