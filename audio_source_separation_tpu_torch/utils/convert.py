"""Carry solver state across from the JAX package.

The JAX package's ``IterativeSolver.save_state`` writes an ``.npz`` of the
warm-startable host arrays; its IVA solvers publish the demixing filter as
``demix_filter (F, N, C)`` and, inside the power-only scan, as
``demix_components (N, C, F)``.  :func:`state_from_jax` turns either into
the port's warm-start kwargs, so a JAX run resumes in the port.
"""

import os

import numpy as np
import torch

from ..runtime.device import resolve_device


def state_from_jax(arrays, device=None):
    """Warm-start kwargs for the port's IVA solvers from JAX solver state.

    Args:
        arrays: a mapping holding ``demix_filter (F, N, C)`` or
            ``demix_components (N, C, F)`` as numpy arrays, or the path of an
            ``.npz`` written by the JAX ``save_state``.
        device: where the tensors go; ``None`` means ``"cuda"``.
    Returns:
        ``{"demix_filter": tensor (F, N, C)}``.  A saved ``estimation`` is
        dropped: the IP update re-derives the estimates from the filter.
    """
    if isinstance(arrays, (str, os.PathLike)):
        with np.load(arrays) as data:
            arrays = {k: data[k] for k in data.files}
    if "demix_filter" in arrays:
        W = np.asarray(arrays["demix_filter"])
    elif "demix_components" in arrays:
        W = np.transpose(np.asarray(arrays["demix_components"]), (2, 0, 1))
    else:
        raise KeyError("JAX state holds neither 'demix_filter' nor 'demix_components'")
    return {"demix_filter": torch.as_tensor(np.ascontiguousarray(W), device=resolve_device(device))}
