"""Carry solver state across from the JAX package.

The JAX package's ``IterativeSolver.save_state`` writes an ``.npz`` of the
warm-startable host arrays.  Its IVA solvers publish the demixing filter as
``demix_filter (F, N, C)`` and, inside the power-only scan, as
``demix_components (N, C, F)``; ISS publishes no filter, only
``estimation``; IP2 adds its pair counter ``step_count``.  The ILRMA solvers
add their source model: ``basis``, ``activation`` and, with partitioning,
``latent``.
:func:`state_from_jax` turns these into the port's warm-start kwargs, so a
JAX run resumes in the port.
"""

import os

import numpy as np
import torch

from ..runtime.device import resolve_device


def state_from_jax(arrays, device=None):
    """Warm-start kwargs for the port's IVA and ILRMA solvers from JAX
    solver state.

    Args:
        arrays: a mapping of numpy arrays holding any of ``demix_filter (F,
            N, C)`` or ``demix_components (N, C, F)``, ``estimation (N, F,
            T)``, ``basis``, ``activation``, ``latent`` and ``step_count
            ()``, or the path of an ``.npz`` written by the JAX
            ``save_state``.
        device: where the tensors go; ``None`` means ``"cuda"``.
    Returns:
        a dict with ``demix_filter`` (tensor ``(F, N, C)``), ``estimation``
        (tensor; it seeds ISS, and the other updates re-derive the
        estimates from the filter), ``basis``, ``activation``, ``latent``
        (tensors) and ``step_count`` (int), each where the JAX state had it.
    """
    if isinstance(arrays, (str, os.PathLike)):
        with np.load(arrays) as data:
            arrays = {k: data[k] for k in data.files}
    device = resolve_device(device)
    kwargs = {}
    if "demix_filter" in arrays:
        kwargs["demix_filter"] = np.asarray(arrays["demix_filter"])
    elif "demix_components" in arrays:
        kwargs["demix_filter"] = np.transpose(np.asarray(arrays["demix_components"]), (2, 0, 1))
    for field in ("estimation", "basis", "activation", "latent"):
        if field in arrays:
            kwargs[field] = np.asarray(arrays[field])
    if "demix_filter" not in kwargs and "estimation" not in kwargs:
        raise KeyError("JAX state holds none of 'demix_filter', 'demix_components' or 'estimation'")
    kwargs = {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in kwargs.items()}
    if "step_count" in arrays:
        kwargs["step_count"] = int(np.asarray(arrays["step_count"]))
    return kwargs
