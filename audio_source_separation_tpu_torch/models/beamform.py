"""Beamformers: delay-and-sum, ML/MVDR and max-SNR (GEV) (reference
``bss/beamform.py``).

  * ``delay_sum_beamform`` (``beamform.py:5-19``): ``y = a^H x`` per bin,
    re-imaged at the reference mic;
  * ``ml_beamform`` (``beamform.py:21-44``): ``w = R^{-1} a / (a^H R^{-1} a)``;
  * ``mvdr_beamform`` (``beamform.py:46-58``): the ML beamformer with the
    covariance estimated from the data.  The reference's ``MVDRBeamformer``
    passes a ``covariance=`` that ``mvdr_beamform`` does not accept (a
    latent ``TypeError``, ``beamform.py:117`` against ``:46``); here a
    given covariance is honoured (documented divergence);
  * ``max_snr_beamform``: the reference's ``MaxSNRBeamformer``
    (``beamform.py:121-138``) is empty; here it is the GEV beamformer, the
    dominant generalised eigenvector of ``(R_noise, R_signal)`` by Cholesky
    whitening and a Hermitian ``eigh``.

The functions run on their inputs' device, batched over the bins.  Their
per-bin ``C x C`` algebra (MVDR's covariance and solve, MaxSNR's Cholesky
whitening and ``eigh``) runs at complex128 whatever the input's type, and
the weights are applied at the input's type: a mixture's covariance is
ill-conditioned in bins where one source dominates, and forming it at
float32 alone cost MVDR about three of its digits against a float64 run
(``chip_smoke.py``'s beamformer phase reads the gap; ``PERF.md``).

The classes take ``device=None`` (the CUDA card unless the caller passes
``device="cpu"``) and move their inputs there: complex64 on the card, the
input's precision (at least complex64) on the CPU, as the solvers run;
steering vectors and covariances keep their own precision where it is
finer than the input's, and the products run with TF32 off
(:func:`~..runtime.solver.full_f32_matmuls`), as a solver call does.
"""

import numpy as np
import torch

from ..runtime.device import resolve_device
from ..runtime.solver import full_f32_matmuls
from ..utils.flooring import EPS

LINALG_DTYPE = torch.complex128  # the per-bin algebra's type


def delay_sum_beamform(input, steering_vector, reference_id=0):
    """Args:
        input: ``(n_channels, n_bins, n_frames)``.
        steering_vector: ``(n_bins, n_channels, n_sources)``.
    Returns:
        ``(n_sources, n_bins, n_frames)`` re-imaged at ``reference_id``.
    """
    X, A = input, steering_vector.to(input.dtype)
    a_hermite = A.permute(2, 1, 0)[..., None].conj()  # (S, C, F, 1)
    Y = torch.sum(a_hermite * X, dim=1)  # (S, F, T)
    A_img = A.permute(1, 2, 0)[..., None]  # (C, S, F, 1)
    return A_img[reference_id] * Y


def ml_beamform(input, steering_vector, covariance, reference_id=0, eps=EPS):
    """Maximum-likelihood (MVDR with a known covariance) beamformer:
    ``w = R^{-1} a / (a^H R^{-1} a)`` per bin, applied as ``y = w^H x``.

    Documented divergence: the reference applies ``w^T x`` (no conjugate,
    ``beamform.py:41-42``), which breaks the distortionless constraint
    ``w^H a = 1``; the adjoint is used here.
    """
    X = input.permute(1, 0, 2)  # (F, C, T)
    A = steering_vector.to(LINALG_DTYPE)  # (F, C, S)
    numerator = torch.linalg.solve(covariance.to(LINALG_DTYPE), A)  # R^{-1} A, (F, C, S)
    denominator = torch.sum(A.conj() * numerator, dim=1, keepdim=True)  # (F, 1, S)
    denominator = torch.where(torch.abs(denominator) < eps, eps, denominator)
    W = (numerator / denominator).to(input.dtype)  # (F, C, S)
    Y = (W.transpose(-2, -1).conj() @ X).permute(1, 0, 2)  # y = w^H x, (S, F, T)
    A_img = steering_vector.to(input.dtype).permute(1, 2, 0)[..., None]  # (C, S, F, 1)
    return A_img[reference_id] * Y


def mvdr_beamform(input, steering_vector, covariance=None, reference_id=0, eps=EPS):
    """MVDR: the ML beamformer with the spatial covariance estimated from the
    data unless given (``beamform.py:46-58``)."""
    if covariance is None:
        Xb = input.permute(1, 0, 2).to(LINALG_DTYPE)  # (F, C, T)
        covariance = Xb @ Xb.transpose(-2, -1).conj() / Xb.shape[-1]  # (F, C, C)
    return ml_beamform(input, steering_vector, covariance, reference_id=reference_id, eps=eps)


def max_snr_beamform(input, signal_covariance, noise_covariance, reference_id=0, eps=EPS):
    """Max-SNR (GEV) beamformer: per bin, the dominant generalised
    eigenvector of ``(R_noise, R_signal)`` by Cholesky whitening and a
    Hermitian ``eigh``.  The output is re-imaged at the reference channel of
    the signal covariance (rank-1 assumption).

    Args:
        input: ``(n_channels, n_bins, n_frames)``.
        signal_covariance, noise_covariance: ``(n_bins, C, C)`` Hermitian.
    Returns:
        ``(1, n_bins, n_frames)``, the enhanced signal at the reference
        channel.
    """
    n_channels = input.shape[0]
    Rs = signal_covariance.to(LINALG_DTYPE)
    Rn = noise_covariance.to(LINALG_DTYPE) + eps * torch.eye(n_channels, dtype=LINALG_DTYPE, device=input.device)
    L_inv = torch.linalg.inv(torch.linalg.cholesky(Rn))  # (F, C, C)
    M = L_inv @ Rs @ L_inv.transpose(-2, -1).conj()
    M = (M + M.transpose(-2, -1).conj()) / 2
    _, v = torch.linalg.eigh(M)
    w = (L_inv.transpose(-2, -1).conj() @ v[..., -1:])[..., 0]  # (F, C)
    # re-image: for a rank-1 Rs = s^2 a a^H, (Rs w)_ref / (w^H Rs w) =
    # a_ref / (w^H a), so scaling w^H x recovers the image a_ref s exactly
    img = torch.einsum("fcd,fd->fc", Rs, w)  # Rs w
    denom = torch.einsum("fc,fc->f", w.conj(), img)  # w^H Rs w, real >= 0
    scale = img[:, reference_id] / torch.where(torch.abs(denom) < eps, eps, denom)
    Y = torch.einsum("fc,cft->ft", w.conj().to(input.dtype), input) * scale.to(input.dtype)[:, None]
    return Y[None]


class _Beamformer:
    """The classes' shared device handling."""

    def __init__(self, steering_vector=None, reference_id=0, eps=EPS, device=None):
        self.steering_vector = steering_vector
        self.reference_id = reference_id
        self.eps = eps
        self.device = resolve_device(device)

    @staticmethod
    def _tensor(value):
        return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))

    def _input(self, input):
        """The input on the device, complex64 on CUDA and at least complex64
        on the CPU; sets ``self.input``."""
        X = self._tensor(input)
        dtype = torch.complex64 if self.device.type == "cuda" else torch.promote_types(X.dtype, torch.complex64)
        self.input = X.to(device=self.device, dtype=dtype)
        return self.input

    def _like_input(self, value):
        """``value`` (numpy or tensor) on the device, at the input's type or
        its own where that is finer."""
        value = self._tensor(value)
        return value.to(device=self.device, dtype=torch.promote_types(value.dtype, self.input.dtype))

    def _steering(self, steering_vector):
        if steering_vector is not None:
            self.steering_vector = steering_vector
        elif self.steering_vector is None:
            raise ValueError("Specify steering vector.")
        return self._like_input(self.steering_vector)


class DelaySumBeamformer(_Beamformer):
    """Class wrapper (``beamform.py:62-90``)."""

    def __init__(self, steering_vector=None, reference_id=0, device=None):
        super().__init__(steering_vector=steering_vector, reference_id=reference_id, device=device)

    def __call__(self, input, steering_vector=None):
        X = self._input(input)
        with full_f32_matmuls():
            self.estimation = delay_sum_beamform(X, self._steering(steering_vector), reference_id=self.reference_id)
        return self.estimation


class MVDRBeamformer(_Beamformer):
    """Class wrapper (``beamform.py:92-119``); honours ``covariance=``."""

    def __call__(self, input, steering_vector=None, covariance=None):
        X = self._input(input)
        A = self._steering(steering_vector)
        R = None if covariance is None else self._like_input(covariance)
        with full_f32_matmuls():
            self.estimation = mvdr_beamform(X, A, covariance=R, reference_id=self.reference_id, eps=self.eps)
        return self.estimation


class MaxSNRBeamformer(_Beamformer):
    """Max-SNR/GEV beamformer (working where the reference's class is an
    empty shell, ``beamform.py:121-138``)."""

    def __call__(self, input, signal_covariance=None, noise_covariance=None):
        X = self._input(input)
        if signal_covariance is None or noise_covariance is None:
            raise ValueError("Specify signal_covariance and noise_covariance.")
        with full_f32_matmuls():
            self.estimation = max_snr_beamform(
                X,
                self._like_input(signal_covariance),
                self._like_input(noise_covariance),
                reference_id=self.reference_id,
                eps=self.eps,
            )
        return self.estimation
