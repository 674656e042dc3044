"""Pure-functional AuxIVA-IP steps (single mixture, bins-major, stacked-real
and batched).

Each step takes and returns tensors and keeps no state: one IP iteration of
the Laplace AuxIVA, ``W -> (W_new, nll)``.  With ``use_pallas=True`` the
weighted covariance goes through
:func:`~..ops.covariance.weighted_covariance_auto`, so a CUDA mixture
launches kernel K1 once per step; otherwise it is the direct contraction, or
one product over the pair products ``PP`` where they are given.  Every step
runs with TF32 off (:func:`~..runtime.solver.full_f32_matmuls`).

:func:`make_mesh_2d` and :func:`make_sharded_train_step` run the batched step
over a ``("dp", "tp")`` device mesh of one rank per device: the mixtures
split over ``dp``, the bins over ``tp``.
"""

import torch
import torch.distributed as dist

from ..ops.covariance import weighted_covariance_auto, weighted_covariance_from_pairs
from ..ops.fast_linalg import batched_log_abs_det
from ..ops.ip import ip_update
from ..runtime.solver import full_f32_matmuls
from .mesh import all_gather_cat, all_reduce_sum, shard_bounds, take_shard


def _separate(W, X):
    """``Y[n, f, t] = sum_c W[f, n, c] X[c, f, t]``."""
    return torch.einsum("fnc,cft->nft", W, X)


def _nll(W, power_over_bins, n_frames):
    """Laplace NLL from ``sum_f |Y|^2 (N, T)`` and ``W (..., F, N, C)``."""
    return (2 * torch.sqrt(power_over_bins)).sum() - 2 * n_frames * batched_log_abs_det(W).sum()


def auxiva_ip_step(X, W, PP=None, eps=1e-8, threshold=1e12, use_pallas=False):
    """One AuxIVA-IP iteration (single mixture).

    Args:
        X: ``(n_channels, n_bins, n_frames)`` complex mixture (contiguous
            complex64 on CUDA where ``use_pallas``).
        W: ``(n_bins, n_sources, n_channels)`` demixing filters.
        PP: optional pair products
            (:func:`~..ops.covariance.pair_products`); without
            ``use_pallas`` the covariance is then one product over them.
        use_pallas: the covariance through K1 (its plain version on the
            CPU).
    Returns:
        ``(W_new, nll)``, ``nll`` a 0-d tensor.
    """
    with full_f32_matmuls():
        Y = _separate(W, X)
        R = torch.clamp(torch.sqrt((torch.abs(Y) ** 2).sum(dim=1)), min=eps)  # (N, T)
        W = ip_update(W, weighted_covariance_auto(X, 1.0 / R, PP=PP, use_pallas=use_pallas), threshold=threshold)
        Y = _separate(W, X)
        return W, _nll(W, torch.sum(torch.abs(Y) ** 2, dim=1), X.shape[-1])


def auxiva_ip_step_carry(X, W, Y, PP=None, eps=1e-8, threshold=1e12, use_pallas=False):
    """AuxIVA-IP iteration carrying the estimates ``Y = separate(X, W)``
    (saves one separation per iteration).  Returns ``(W_new, Y_new,
    nll)``."""
    with full_f32_matmuls():
        R = torch.clamp(torch.sqrt((torch.abs(Y) ** 2).sum(dim=1)), min=eps)
        W = ip_update(W, weighted_covariance_auto(X, 1.0 / R, PP=PP, use_pallas=use_pallas), threshold=threshold)
        Y = _separate(W, X)
        return W, Y, _nll(W, torch.sum(torch.abs(Y) ** 2, dim=1), X.shape[-1])


def auxiva_ip_step_binsmajor(Xf, W, Yf, PP, eps=1e-8, threshold=1e12):
    """AuxIVA-IP iteration with the frequency axis leading everywhere, so
    the separation is one bin-batched matmul.

    Args:
        Xf: mixture ``(n_bins, n_channels, n_frames)``.
        W: demixing filters ``(n_bins, n_sources, n_channels)``.
        Yf: current estimates ``(n_bins, n_sources, n_frames)``.
        PP: pair products ``(C, C, n_bins, n_frames)`` (loop-invariant).
    Returns:
        ``(W_new, Yf_new, nll)``.
    """
    with full_f32_matmuls():
        R = torch.clamp(torch.sqrt((torch.abs(Yf) ** 2).sum(dim=0)), min=eps)  # (N, T)
        W = ip_update(W, weighted_covariance_from_pairs(PP, 1.0 / R), threshold=threshold)
        Yf = W @ Xf  # (F, N, T)
        return W, Yf, _nll(W, torch.sum(torch.abs(Yf) ** 2, dim=0), Xf.shape[-1])


def auxiva_ip_step_stacked(X2, W2, eps=1e-8, threshold=1e12):
    """:func:`auxiva_ip_step` with complex tensors carried as a stacked
    leading (re, im) axis: ``X2 (2, C, F, T)``, ``W2 (2, F, N, C)`` real.
    Returns ``(W2_new, nll)``."""
    W, nll = auxiva_ip_step(torch.complex(X2[0], X2[1]), torch.complex(W2[0], W2[1]), eps=eps, threshold=threshold)
    return torch.stack([W.real, W.imag]), nll


def batched_auxiva_ip_step(X2, W2, eps=1e-8, threshold=1e12, bins_sum=None):
    """:func:`auxiva_ip_step_stacked` over a leading mixture axis, as tensor
    ops on the whole batch: ``X2 (B, 2, C, F, T)``, ``W2 (B, 2, F, N, C)``
    -> ``(W2_new (B, 2, F, N, C), nll (B,))``.  The IP sweep is per bin, so
    it runs once over the ``B F`` bins.  ``bins_sum`` is a bin-sharded
    caller's sum over the shards, applied to the frame powers and to the
    NLL's sums over bins."""
    bins_sum = (lambda x: x) if bins_sum is None else bins_sum
    with full_f32_matmuls():
        X = torch.complex(X2[:, 0], X2[:, 1])  # (B, C, F, T)
        W = torch.complex(W2[:, 0], W2[:, 1])  # (B, F, N, C)
        B, F, N, C = W.shape
        n_frames = X.shape[-1]
        Y = torch.einsum("bfnc,bcft->bnft", W, X)
        R = torch.clamp(torch.sqrt(bins_sum((torch.abs(Y) ** 2).sum(dim=2))), min=eps)  # (B, N, T)
        w = (1.0 / R).to(X.dtype)
        U = torch.einsum("bnt,bcft,bdft->nbfcd", w, X, X.conj()) / n_frames
        W = ip_update(W.reshape(B * F, N, C), U.reshape(N, B * F, C, C), threshold=threshold).reshape(B, F, N, C)
        Y = torch.einsum("bfnc,bcft->bnft", W, X)
        power = torch.sum(torch.abs(Y) ** 2, dim=2)  # (B, N, T)
        logdet = batched_log_abs_det(W).sum(dim=1)  # (B,)
        sums = bins_sum(torch.cat([power.reshape(-1), logdet]))
        power, logdet = sums[: power.numel()].reshape(power.shape), sums[power.numel() :]
        nll = (2 * torch.sqrt(power)).sum(dim=(1, 2)) - 2 * n_frames * logdet
        return torch.stack([W.real, W.imag], dim=1), nll


def make_mesh_2d(n_devices=None, device_type=None):
    """A ``("dp", "tp")`` :class:`~torch.distributed.device_mesh.DeviceMesh`
    over the initialised process group: ``dp`` is the largest power of two
    at most the square root of the world size that divides it (the JAX
    package's rule), ``tp`` the rest.  ``device_type`` ``None`` means
    ``"cuda"``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError("make_mesh_2d: {} devices asked, the process group has {} ranks".format(n_devices, n))
    dp = 1
    while dp * 2 <= n // (dp * 2) and n % (dp * 2) == 0:
        dp *= 2
    return init_device_mesh(device_type or "cuda", (dp, n // dp), mesh_dim_names=("dp", "tp"))


def make_sharded_train_step(mesh):
    """The batched AuxIVA-IP step over a ``("dp", "tp")`` mesh.

    Returns ``(step, x_spec, w_spec)``.  The specs are the JAX layouts as
    placement tuples, one mesh dimension (or ``None``) per axis: ``X
    (batch, 2, C, F, T)`` as ``("dp", None, None, "tp", None)``, ``W (batch,
    2, F, N, C)`` as ``("dp", None, "tp", None, None)``.  ``step(X2, W2)``
    takes the whole stacked arrays on every rank, runs
    :func:`batched_auxiva_ip_step` on this rank's ``(dp, tp)`` block with the
    frame powers and the NLL all-reduced over ``tp``, and returns the whole
    ``(W2_new, nll)`` (gathered over both dimensions)."""
    x_spec = ("dp", None, None, "tp", None)
    w_spec = ("dp", None, "tp", None, None)
    tp_group, dp_group = mesh.get_group("tp"), mesh.get_group("dp")

    def step(X2, W2, eps=1e-8, threshold=1e12):
        batch, n_bins = X2.shape[0], X2.shape[3]
        for name, length in (("dp", batch), ("tp", n_bins)):
            size = mesh.size(mesh.mesh_dim_names.index(name))
            if length % size:
                raise ValueError(
                    "make_sharded_train_step: axis length {} is not divisible by the {}-way mesh axis {!r}".format(
                        length, size, name
                    )
                )
        rows, bins = shard_bounds(batch, mesh, "dp"), shard_bounds(n_bins, mesh, "tp")
        X_block = take_shard(take_shard(X2, 0, rows), 3, bins).contiguous()
        W_block = take_shard(take_shard(W2, 0, rows), 2, bins).contiguous()
        W_new, nll = batched_auxiva_ip_step(
            X_block, W_block, eps=eps, threshold=threshold, bins_sum=lambda x: all_reduce_sum(x, tp_group)
        )
        W_new = all_gather_cat(all_gather_cat(W_new, 2, tp_group), 0, dp_group)
        return W_new, all_gather_cat(nll, 0, dp_group)

    return step, x_spec, w_spec
