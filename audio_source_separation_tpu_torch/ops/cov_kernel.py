"""Kernel K1: weighted spatial covariance in compact Hermitian planes.

``weighted_covariance_planes(X, w)[p, f, n] = (1/T) sum_t w[n, t] plane_p(f, t)``
with the C^2 compact pair-product planes of
:func:`~audio_source_separation_tpu_torch.ops.ip_components.pair_products_planes`.

Replaces ``audio_source_separation_tpu/ops/pallas_kernels.py::_cov_kernel``.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/weighted_covariance.cu`` (its source note gives the bound and the
design); on a CPU tensor it runs :func:`weighted_covariance_planes_plain`.
"""

import ctypes

import torch

from . import _build
from .ip_components import _covariance_planes, pair_products_planes


def weighted_covariance_planes_plain(X, weights):
    """Plain PyTorch version of K1: ``X (C, F, T)`` complex and 2-D weights
    ``(N, T)`` -> ``(C^2, F, N)`` real, via the pair-product planes and one
    ``(C^2 F, T) x (T, N)`` matmul."""
    return _covariance_planes(pair_products_planes(X), weights)


def _entry():
    fn = _build.load("weighted_covariance").weighted_covariance_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def weighted_covariance_planes(X, weights):
    """K1: compact weighted covariance ``(C^2, F, N)``.

    Args:
        X: ``(C, F, T)`` complex mixture, any C >= 1.  On CUDA it must be
            contiguous complex64.
        weights: ``(N, T)`` real weights (``1/R``), any N >= 1.  On CUDA it
            must be contiguous float32 on the same device.
    """
    if X.device.type == "cpu":
        return weighted_covariance_planes_plain(X, weights)
    if X.device.type != "cuda":
        raise ValueError("weighted_covariance_planes: unsupported device {}".format(X.device))
    if X.dtype != torch.complex64 or not X.is_contiguous() or X.ndim != 3:
        raise ValueError("K1 takes a contiguous complex64 (C, F, T) mixture")
    C, F, T = X.shape
    if weights.dtype != torch.float32 or not weights.is_contiguous():
        raise ValueError("K1 takes contiguous float32 (N, T) weights")
    if weights.device != X.device or weights.ndim != 2 or weights.shape[1] != T:
        raise ValueError("K1 weights must be (N, T) on the mixture's device")
    N = weights.shape[0]
    if C < 1 or N < 1 or F < 1 or T < 1:
        raise ValueError("K1 needs C, N, F, T >= 1, got C={}, N={}, F={}, T={}".format(C, N, F, T))
    out = torch.empty((C * C, F, N), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    status = _entry()(X.data_ptr(), weights.data_ptr(), out.data_ptr(), C, N, F, T, stream)
    _build.check(status, "weighted_covariance")
    weighted_covariance_planes.launches += 1
    return out


weighted_covariance_planes.launches = 0
