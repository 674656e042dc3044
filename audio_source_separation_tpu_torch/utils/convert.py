"""Carry solver state across from the JAX package.

The JAX package's ``IterativeSolver.save_state`` writes an ``.npz`` of the
warm-startable host arrays.  Its IVA solvers publish the demixing filter as
``demix_filter (F, N, C)`` and, inside the power-only scan, as
``demix_components (N, C, F)``; ISS publishes no filter, only
``estimation``; IP2 adds its pair counter ``step_count``.  The ILRMA solvers
add their source model: ``basis``, ``activation`` and, with partitioning,
``latent``.  The factorisation models write their factors: ``basis`` and
``activation`` (NMF; ``ComplexEUCNMF`` writes no ``phase``, its phase state
being phasor planes), with ``spatial`` (``CovarianceISNMF``, its basis in
the input frame) or ``partitioning`` (``EUCNTF``).  ``ProxLaplaceIVA``
adds its dual variable ``dual (F, N, T)``.  The MNMF solvers write
``latent``, ``spatial``, ``basis`` and ``activation`` (Sawada),
``mix_filter (F, C, S)``, ``noise_covariance (F, C)``, ``basis`` and
``activation`` (Ozerov, basis and noise in the input frame), or
``diagonalizer (F, C, C)``, ``spatial_covariance (S, F, C)``, ``basis``
and ``activation`` (``FastMultichannelISNMF``).
:func:`state_from_jax` turns these into the port's warm-start kwargs, so a
JAX run resumes in the port.
"""

import os

import numpy as np
import torch

from ..runtime.device import resolve_device

# the state arrays that carry over as they are
STATE_ARRAYS = (
    "estimation", "basis", "activation", "latent", "spatial", "partitioning", "phase", "dual",
    "mix_filter", "noise_covariance", "diagonalizer", "spatial_covariance", "fixed_point",
)  # fmt: skip


def state_from_jax(arrays, device=None):
    """Warm-start kwargs for the port's solvers from JAX solver state.

    Args:
        arrays: a mapping of numpy arrays holding any of ``demix_filter (F,
            N, C)`` or ``demix_components (N, C, F)``, ``estimation (N, F,
            T)``, ``basis``, ``activation``, ``latent``, ``spatial``,
            ``partitioning``, ``phase``, ``dual``, ``mix_filter``,
            ``noise_covariance``, ``diagonalizer``, ``spatial_covariance``,
            ``fixed_point`` and ``step_count ()``, or the path
            of an ``.npz`` written by the JAX ``save_state``.
        device: where the tensors go; ``None`` means ``"cuda"``.
    Returns:
        a dict with ``demix_filter`` (tensor ``(F, N, C)``), ``estimation``
        (tensor; it seeds ISS, and the other updates re-derive the
        estimates from the filter), the other arrays as tensors and
        ``step_count`` (int), each where the JAX state had it.
    Raises:
        KeyError: the state holds none of these arrays.
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
    for field in STATE_ARRAYS:
        if field in arrays:
            kwargs[field] = np.asarray(arrays[field])
    if not kwargs:
        known = ("demix_filter", "demix_components") + STATE_ARRAYS
        raise KeyError("JAX state holds none of {}".format(", ".join(map(repr, known))))
    kwargs = {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in kwargs.items()}
    if "step_count" in arrays:
        kwargs["step_count"] = int(np.asarray(arrays["step_count"]))
    return kwargs
