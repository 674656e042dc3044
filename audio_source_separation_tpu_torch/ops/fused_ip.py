"""Kernel K2: one whole AuxIVA-IP iteration for C = N = 2.

Replaces ``audio_source_separation_tpu/ops/pallas_fused.py::_iter_kernel``.
From the mixture, the demixing rows and the previous frame power sums it
computes the weights ``1/max(sqrt(psum), eps)``, both weighted covariances,
the guarded sequential IP row update, and, for the new rows, the frame power
sums ``sum_f |y|^2``, ``sum_f log|det W_f|`` and the Laplace NLL
``2 sum sqrt(psum) - 2 T logdet``.  The returned ``psum`` is both the next
iteration's weights and this iteration's loss.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/fused_auxiva_ip.cu`` (its source note gives the bound and the design);
on a CPU tensor it runs :func:`fused_auxiva_ip_iter_plain`.
"""

import ctypes

import torch

from . import _build
from .ip_components import (
    ip_update_components,
    log_abs_det_components,
    pair_products_planes,
    separate_components,
    weighted_covariance_components,
)
from ..utils.flooring import EPS, THRESHOLD, floor_below


def fused_auxiva_ip_iter_plain(X, W, psum, eps=EPS, threshold=THRESHOLD):
    """Plain PyTorch version of K2.

    Args:
        X: ``(2, F, T)`` complex mixture.
        W: ``(2, 2, F)`` complex demixing rows as components ``W[n, c]``.
        psum: ``(2, T)`` frame power sums of the current rows.
    Returns:
        ``(W_new (2, 2, F), psum_new (2, T), logdet (), nll ())``.
    """
    n_frames = X.shape[-1]
    winv = 1.0 / floor_below(torch.sqrt(psum), eps)
    U = weighted_covariance_components(pair_products_planes(X), winv)
    rows = [[W[s, c] for c in range(2)] for s in range(2)]
    rows = ip_update_components(rows, U, threshold=threshold, guard="one_norm")
    Y = separate_components(rows, X)
    psum_new = torch.sum(torch.abs(Y) ** 2, dim=1)
    logdet = log_abs_det_components(rows, 2).sum()
    nll = 2 * torch.sqrt(psum_new).sum() - 2 * n_frames * logdet
    return torch.stack([torch.stack(row) for row in rows]), psum_new, logdet, nll


def _entry():
    lib = _build.load("fused_auxiva_ip")
    fn = lib.fused_auxiva_ip_f32
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 2
            + [ctypes.c_float] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.fused_auxiva_ip_bins_per_block.argtypes = []
        lib.fused_auxiva_ip_bins_per_block.restype = ctypes.c_int
    return fn, lib.fused_auxiva_ip_bins_per_block()


def _check_operand(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != device:
        raise ValueError(
            "K2 takes {} as contiguous {} {} on {}, got {} {} on {}".format(
                name, dtype, shape, device, t.dtype, tuple(t.shape), t.device
            )
        )


def fused_auxiva_ip_iter(X, W, psum, eps=EPS, threshold=THRESHOLD):
    """K2: one fused AuxIVA-IP iteration (see the module docstring).

    On CUDA, ``X`` is contiguous complex64 ``(2, F, T)``, ``W`` contiguous
    complex64 ``(2, 2, F)`` and ``psum`` contiguous float32 ``(2, T)``, all
    on one device; ``T`` is at most 6144 (the weights live in shared memory).
    """
    if X.device.type == "cpu":
        return fused_auxiva_ip_iter_plain(X, W, psum, eps=eps, threshold=threshold)
    if X.device.type != "cuda":
        raise ValueError("fused_auxiva_ip_iter: unsupported device {}".format(X.device))
    if X.ndim != 3 or X.shape[0] != 2:
        raise ValueError("K2 takes a (2, F, T) mixture, got {}".format(tuple(X.shape)))
    _, F, T = X.shape
    if T > 6144:
        raise ValueError("K2 covers T <= 6144 frames, got {}".format(T))
    device = X.device
    _check_operand("X", X, torch.complex64, (2, F, T), device)
    _check_operand("W", W, torch.complex64, (2, 2, F), device)
    _check_operand("psum", psum, torch.float32, (2, T), device)
    fn, bins = _entry()
    blocks = -(-F // bins)
    W_new = torch.empty_like(W)
    psum_new = torch.empty_like(psum)
    psum_part = torch.empty((blocks, 2, T), dtype=torch.float32, device=device)
    logdet_part = torch.empty((blocks,), dtype=torch.float32, device=device)
    stats = torch.empty((2,), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fn(
        X.data_ptr(), W.data_ptr(), psum.data_ptr(), W_new.data_ptr(),
        psum_part.data_ptr(), logdet_part.data_ptr(), psum_new.data_ptr(),
        stats.data_ptr(), F, T, eps, threshold, stream,
    )
    _build.check(status, "fused_auxiva_ip")
    fused_auxiva_ip_iter.launches += 1
    return W_new, psum_new, stats[0], stats[1]


fused_auxiva_ip_iter.launches = 0
