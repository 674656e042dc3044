"""Iterative-source-steering (ISS) rank-1 sweep.

Demixing-filter-free updates ``Y <- Y - v_n Y[n]`` with
``v_k = sum_t(Y_k Y_n^* / R_k) / sum_t(|Y_n|^2 / R_k)``, swept over the
sources in turn.  Each reduction is over the frame axis, batched over
(source, bin); there are no C x C solves.

Documented divergence from the reference: for the self-steering coefficient
the reference uses ``v_nn = 1 - 1/sqrt(D_nn)`` with ``D_nn = sum_t |Y_n|^2 /
R_n`` (``bss/iva.py:539``), which minimises an auxiliary function whose
log-det term is weighted by 1 instead of ``n_frames``.  That disagrees with
its own NLL (``-2 n_frames sum log|det W|``, ``bss/iva.py:617``) and raises
that NLL on inputs that are already separated.  The minimiser of the
documented NLL is ``v_nn = 1 - sqrt(n_frames / D_nn)``, the default here,
which keeps the auxiliary function's monotone descent.  ``compat=True``
reproduces the reference's scale.
"""

import torch


def iss_sweep(Y, inv_R, compat=False, frames_sum=None, n_frames=None):
    """One full ISS sweep.

    Args:
        Y: current estimates ``(n_sources, n_bins, n_frames)``.
        inv_R: reciprocal source weights, ``(n_sources, n_frames)`` (IVA,
            bin-coupled contrast) or ``(n_sources, n_bins, n_frames)``
            (ILRMA's per-bin variances); ``1/R`` with ``R`` floored.
        compat: the reference's self-steering scale ``v_nn = 1 -
            1/sqrt(D_nn)`` instead of ``1 - sqrt(T/D_nn)`` (module docstring).
        frames_sum, n_frames: a frame-sharded caller's sum over the shards
            (once per source, on the packed frame sums) and the whole frame
            count.
    Returns:
        the updated ``Y``.
    """
    n_sources = Y.shape[0]
    scale = 1.0 if compat else (Y.shape[-1] if n_frames is None else n_frames)
    w = inv_R[:, None, :] if inv_R.ndim == 2 else inv_R
    for n in range(n_sources):
        Yn = Y[n]  # (n_bins, n_frames)
        U_n = torch.sum(Y * Yn.conj() * w, dim=2)  # (n_sources, n_bins)
        D_n = torch.sum(torch.abs(Yn) ** 2 * w, dim=2)  # (n_sources, n_bins), real
        if frames_sum is not None:
            U_n, D_n = frames_sum(torch.cat([U_n, D_n.to(U_n.dtype)])).split(n_sources)
            D_n = D_n.real
        V_n = U_n / D_n
        V_n[n] = 1 - torch.sqrt(scale / D_n[n])
        Y = Y - V_n[:, :, None] * Yn
    return Y
