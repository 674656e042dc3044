"""Algebraic Riccati solve and Hermitian matrix functions.

For Hermitian PSD ``A`` and ``B`` (every call site: the covariance-domain
NMF's spatial update), ``H A H = B`` has the closed form

    H = A^-1/2 (A^1/2 B A^1/2)^1/2 A^-1/2,

the branch the reference's eigenvector-sorting construction selects.  The
matrix powers are closed forms at 2 x 2 and K3
(:func:`~..ops.eigh_kernel.batched_eigh`) otherwise.
"""

import torch

from ..ops.eigh_kernel import batched_eigh
from ..ops.fast_linalg import power_coefficients_2x2

EPS = 1e-12


def _power_2x2(X, power, eps=0.0):
    """Closed-form spectral power of Hermitian 2 x 2 matrices ``X (..., 2,
    2)``: ``f(X) = a X + b I`` with the divided differences of ``f`` over
    the two eigenvalues.

    Scale-invariant: a spectral-radius bound ``s`` is factored out (``f(X) =
    f(s (X / s))``, the clip carried as ``eps / s``), so covariance chains
    whose entries reach about 1e30 at float32 do not overflow ``det``.
    """
    s = (torch.abs(X[..., 0, 0].real) + torch.abs(X[..., 1, 1].real) + 2 * torch.abs(X[..., 0, 1])) / 2
    s = torch.clamp(s, min=torch.finfo(s.dtype).tiny)
    Xn = X / s[..., None, None].to(X.dtype)
    tr = Xn[..., 0, 0].real + Xn[..., 1, 1].real
    det = (Xn[..., 0, 0] * Xn[..., 1, 1] - Xn[..., 0, 1] * Xn[..., 1, 0]).real
    mean = tr / 2
    rad = torch.sqrt(torch.clamp(mean**2 - det, min=0.0))
    a, b = power_coefficients_2x2(mean + rad, mean - rad, power, eps / s)
    eye = torch.eye(2, dtype=X.dtype, device=X.device)
    sp = s**power
    return sp[..., None, None].to(X.dtype) * (a[..., None, None].to(X.dtype) * Xn + b[..., None, None] * eye)


def hermitian_matrix_power(X, power, eps=0.0):
    """Batched Hermitian fractional matrix power: the closed form at 2 x 2,
    K3's eigendecomposition otherwise (``v f(w) v^H``: no phase of the
    vectors changes it).  Eigenvalues are clipped at ``eps`` (pass a
    positive ``eps`` for negative powers of near-singular inputs)."""
    if X.shape[-1] == 2:
        return _power_2x2(X, power, eps=eps)
    w, v = batched_eigh(X)
    w = torch.clamp(w, min=eps)
    pw = torch.where(w > 0, torch.where(w > 0, w, 1.0) ** power, 0.0)
    return (v * pw[..., None, :].to(v.dtype)) @ v.transpose(-2, -1).conj()


def sqrtm_hermitian(X, eps=0.0):
    return hermitian_matrix_power(X, 0.5, eps=eps)


def invsqrtm_hermitian(X, eps=EPS):
    return hermitian_matrix_power(X, -0.5, eps=eps)


def _hermitize(M):
    return (M + M.transpose(-2, -1).conj()) / 2


def solve_riccati(A, B, eps=EPS):
    """The Hermitian PSD solution ``H`` of ``H A H = B`` for batched
    Hermitian PSD ``A``, ``B`` (``(..., n, n)``)."""
    A_sqrt = sqrtm_hermitian(A, eps=0.0)
    A_invsqrt = invsqrtm_hermitian(A, eps=eps)
    M_sqrt = sqrtm_hermitian(_hermitize(A_sqrt @ B @ A_sqrt), eps=0.0)
    return _hermitize(A_invsqrt @ M_sqrt @ A_invsqrt)
