"""Divergence criteria for the factorisation losses (reference
``src/criterion/divergence.py``).

Documented divergence from the reference: its ``kl_divergence`` sums with a
PyTorch-style ``loss.sum(dim=0)`` on a NumPy array, which raises; here it
sums over the leading axis, as the JAX package does.
"""

import torch

from ..ops.fast_linalg import batched_det, batched_eigvalsh, batched_inv

EPS = 1e-12


def _trace(M):
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1).real


def _square_matrices(input, target):
    # AssertionError, as the JAX package's asserts raise, but kept under -O
    if input.shape[-2] != input.shape[-1] or target.shape[-2] != target.shape[-1]:
        raise AssertionError("Invalid input shape")


def kl_divergence(input, target, eps=EPS):
    """KL divergence summed over the leading axis (``(C, *) -> (*)``)."""
    _input, _target = input + eps, target + eps
    return (_target * torch.log(_target / _input)).sum(dim=0)


def is_divergence(input, target, eps=EPS):
    """Itakura-Saito divergence, elementwise."""
    ratio = (target + eps) / (input + eps)
    return ratio - torch.log(ratio) - 1


def generalized_kl_divergence(input, target, eps=EPS):
    """Generalized KL divergence, elementwise."""
    _input, _target = input + eps, target + eps
    return _target * torch.log(_target / _input) + _input - _target


def beta_divergence(input, target, beta=2):
    """Beta divergence (beta not in {0, 1}), elementwise."""
    if beta == 0:
        raise AssertionError("Use is_divergence instead.")
    if beta == 1:
        raise AssertionError("Use generalized_kl_divergence instead.")
    beta_minus1 = beta - 1
    return (
        target * (target**beta_minus1 - input**beta_minus1) / beta_minus1
        - (target**beta - input**beta) / beta
    )


def multichannel_is_divergence(input, target, eps=EPS):
    """Multichannel IS divergence ``tr(T I^-1) - logdet(T I^-1) - C`` of
    Hermitian ``(*, C, C)`` matrices -> ``(*)``."""
    _square_matrices(input, target)
    n_channels = input.shape[-1]
    eye = torch.eye(n_channels, dtype=input.dtype, device=input.device)
    XX = (target + eps * eye) @ batched_inv(input + eps * eye)
    return _trace(XX) - torch.log(batched_det(XX).real) - n_channels


def logdet_divergence(input, target, eps=EPS):
    """Log-det divergence with eigenvalue-floored log-determinants (the
    MNMF loss)."""
    _square_matrices(input, target)
    n_channels = input.shape[-1]
    XY = target @ batched_inv(input)
    eig_x = torch.clamp(batched_eigvalsh(target).real, min=eps)
    eig_y = torch.clamp(batched_eigvalsh(input).real, min=eps)
    logdet = torch.log(eig_x).sum(dim=-1) - torch.log(eig_y).sum(dim=-1)
    return _trace(XY) - logdet - n_channels
