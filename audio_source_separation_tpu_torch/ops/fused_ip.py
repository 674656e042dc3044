"""Kernel K2: one whole AuxIVA-IP iteration for C = N = 2.

Replaces ``audio_source_separation_tpu/ops/pallas_fused.py::_iter_kernel``.
From the mixture, the demixing rows and the previous frame power sums it
computes the weights ``1/R``, both weighted covariances, the guarded
sequential IP row update, and, for the new rows, the frame power sums
``sum_f |y|^2``, ``sum_f log|det W_f|`` and the NLL.  The contrast fixes
``R`` and the NLL (``CONTRASTS``):

  * ``"laplace"``: ``R = max(sqrt(psum), eps)``, NLL ``2 sum sqrt(psum) -
    2 T logdet`` (``AuxLaplaceIVA``);
  * ``"gauss"``: ``R = max(psum / F, eps)``, NLL ``F sum log max(psum / F,
    eps) - 2 T logdet`` (``AuxGaussIVA``).

``F`` in the Gauss contrast is ``n_bins``, by default the launch's own bin
count; a bin-sharded caller passes the whole input's, and then reads the
returned ``psum`` and ``logdet`` as its shard's share of sums it reduces
over the shards itself (the NLL is then the shard's only).

The returned ``psum`` is both the next iteration's weights and this
iteration's loss.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/fused_auxiva_ip.cu`` (its source note gives the bound and the
design), one launch per iteration at any ``T``, laid out by
:func:`k2_launch_plan`; on a CPU tensor it runs
:func:`fused_auxiva_ip_iter_plain`.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from . import _build
from ..runtime.cost_model import charged
from ..runtime.spanlog import watch
from .ip_components import (
    ip_update_components,
    log_abs_det_components,
    pair_products_planes,
    separate_components,
    weighted_covariance_components,
)
from ..utils.flooring import EPS, THRESHOLD, floor_below


CONTRASTS = ("laplace", "gauss")  # the C entry's contrast code is the index


def _contrast_code(contrast):
    if contrast not in CONTRASTS:
        raise ValueError("K2 contrast must be one of {}, got {!r}".format(CONTRASTS, contrast))
    return CONTRASTS.index(contrast)


def fused_auxiva_ip_iter_plain(X, W, psum, eps=EPS, threshold=THRESHOLD, contrast="laplace", n_bins=None):
    """Plain PyTorch version of K2.

    Args:
        X: ``(2, F, T)`` complex mixture.
        W: ``(2, 2, F)`` complex demixing rows as components ``W[n, c]``.
        psum: ``(2, T)`` frame power sums of the current rows.
        contrast: ``"laplace"`` or ``"gauss"`` (module docstring).
        n_bins: the Gauss contrast's ``F`` (``None``: ``X``'s bin count).
    Returns:
        ``(W_new (2, 2, F), psum_new (2, T), logdet (), nll ())``.
    """
    _contrast_code(contrast)
    n_bins = X.shape[1] if n_bins is None else n_bins
    n_frames = X.shape[2]
    if contrast == "gauss":
        winv = 1.0 / floor_below(psum / n_bins, eps)
    else:
        winv = 1.0 / floor_below(torch.sqrt(psum), eps)
    U = weighted_covariance_components(pair_products_planes(X), winv)
    rows = [[W[s, c] for c in range(2)] for s in range(2)]
    rows = ip_update_components(rows, U, threshold=threshold, guard="one_norm")
    Y = separate_components(rows, X)
    psum_new = torch.sum(torch.abs(Y) ** 2, dim=1)
    logdet = log_abs_det_components(rows, 2).sum()
    if contrast == "gauss":
        nll = n_bins * torch.log(floor_below(psum_new / n_bins, eps)).sum() - 2 * n_frames * logdet
    else:
        nll = 2 * torch.sqrt(psum_new).sum() - 2 * n_frames * logdet
    return torch.stack([torch.stack(row) for row in rows]), psum_new, logdet, nll


# Launch plan constants; each mirrors the CUDA source.
SMEM_LIMIT = 232_448  # shared memory a Hopper block may opt into, bytes
STATIC_SMEM = 2_048  # bound on the kernel's static shared arrays (under 1 KB)
WEIGHT_CHUNK = 1024  # frames of weights staged per pass (kChunk)
RESIDENT_BINS = (8, 4, 2)  # bins per group with a resident-slab kernel, most first
STREAMED_BINS = 8  # bins per group of the streamed kernel

K2Plan = namedtuple("K2Plan", "bins resident smem_bytes groups row_stride")
K2Plan.__doc__ = """How K2 is launched for one ``(F, T)``.

``bins`` per group; ``resident`` whether a group's X slab lives in shared
memory (else the frame axis is streamed and X is read twice);
``smem_bytes`` of dynamic shared memory per block; ``groups`` of bins, at
most one block each (the kernel launches as many blocks as fit on the card
at once, each taking every so many groups); ``row_stride`` floats per
partial row (``2 T`` frame sums and the logdet, padded to 16 bytes).
"""


def _slab_bytes(bins, T):
    """Shared memory of a resident slab: per channel, ``bins`` rows of ``T``
    complex64 and 16 bytes of slack for an 8-byte-aligned start."""
    return 2 * (8 * bins * T + 16)


def _plan(F, T, bins, resident):
    weights = -(-8 * min(T, WEIGHT_CHUNK) // 16) * 16
    return K2Plan(
        bins=bins,
        resident=resident,
        smem_bytes=weights + (_slab_bytes(bins, T) if resident else 0),
        groups=-(-F // bins),
        row_stride=-(-(2 * T + 1) // 4) * 4,
    )


@functools.lru_cache(maxsize=64)
def k2_launch_plan(F, T):
    """The :class:`K2Plan` for a ``(2, F, T)`` mixture.

    The slab is resident with the most bins per group of
    ``RESIDENT_BINS`` whose slab fits beside the staged weights; past
    ``T = 6943``, where not even 2 bins fit, the frame axis is streamed in
    groups of ``STREAMED_BINS``.
    """
    if F < 1 or T < 1:
        raise ValueError("K2 takes F >= 1 bins and T >= 1 frames, got F={}, T={}".format(F, T))
    for bins in RESIDENT_BINS:
        plan = _plan(F, T, bins, True)
        if plan.smem_bytes + STATIC_SMEM <= SMEM_LIMIT:
            return plan
    return _plan(F, T, STREAMED_BINS, False)


def _entry():
    fn = _build.load("fused_auxiva_ip").fused_auxiva_ip_f32
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 7
            + [ctypes.c_float] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


# (device index, stream) -> (partial rows, tickets); the kernel leaves the
# tickets' counters at zero, so they are zeroed only when allocated.  A
# captured graph takes the scratch of its capture stream (:func:`take_scratch`)
_scratch = {}


def _scratch_for(device, stream, plan):
    key = (device.index, stream)
    part, tickets = _scratch.get(key, (None, None))
    n_part = plan.groups * (plan.row_stride + 1) + 1  # rows, root sums, logdet
    grow = part is None or part.numel() < n_part
    if (grow or tickets is None) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("K2's scratch for this stream must exist before capture: launch it once eagerly there first")
    if grow:
        part = torch.empty((n_part,), dtype=torch.float32, device=device)
    if tickets is None:
        tickets = torch.zeros((3,), dtype=torch.int32, device=device)
    _scratch[key] = (part, tickets)
    return part, tickets


def take_scratch(device, stream):
    """Remove and return the scratch of ``stream`` on ``device`` (``None``
    where there is none): a captured graph keeps the scratch its launches
    were captured with, and a later capture on a stream of the pool gets
    its own."""
    return _scratch.pop((device.index, stream), None)


def _check_operand(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != device:
        raise ValueError(
            "K2 takes {} as contiguous {} {} on {}, got {} {} on {}".format(
                name, dtype, shape, device, t.dtype, tuple(t.shape), t.device
            )
        )


def k2_cost(F, T, x_itemsize):
    """K2's compulsory ``(bytes, flops)`` at ``(2, F, T)`` with
    ``x_itemsize``-byte complex elements: ``X`` read once, ``W`` read and
    written, ``psum`` read and written and the two statistics (``logdet``
    and the NLL) written at the real type; ``62 F T`` FLOPs (the weighted
    covariances 26 and the new rows' power sums 36 a bin and frame).
    Whatever runs it, launch plan and streaming aside."""
    real = x_itemsize // 2
    return 2 * F * T * x_itemsize + 2 * 4 * F * x_itemsize + 2 * 2 * T * real + 2 * real, 62 * F * T


def fused_auxiva_ip_iter(X, W, psum, eps=EPS, threshold=THRESHOLD, contrast="laplace", n_bins=None):
    """K2: one fused AuxIVA-IP iteration (see the module docstring).

    On CUDA, ``X`` is contiguous complex64 ``(2, F, T)``, ``W`` contiguous
    complex64 ``(2, 2, F)`` and ``psum`` contiguous float32 ``(2, T)``, all
    on one device, at any ``F`` and ``T``; ``contrast`` picks the kernel's
    instance and ``n_bins`` (default ``F``) is the Gauss contrast's bin
    count.

    Inside a cost count (:mod:`~..runtime.cost_model`) a call is charged
    :func:`k2_cost` on either route.
    """
    with charged("K2", lambda: k2_cost(X.shape[1], X.shape[2], X.element_size())):
        return _fused_auxiva_ip_iter(X, W, psum, eps, threshold, contrast, n_bins)


def _fused_auxiva_ip_iter(X, W, psum, eps, threshold, contrast, n_bins):
    code = _contrast_code(contrast)
    if X.device.type == "cpu":
        return fused_auxiva_ip_iter_plain(
            X, W, psum, eps=eps, threshold=threshold, contrast=contrast, n_bins=n_bins
        )
    if X.device.type != "cuda":
        raise ValueError("fused_auxiva_ip_iter: unsupported device {}".format(X.device))
    if X.ndim != 3 or X.shape[0] != 2:
        raise ValueError("K2 takes a (2, F, T) mixture, got {}".format(tuple(X.shape)))
    _, F, T = X.shape
    n_bins = F if n_bins is None else int(n_bins)
    if n_bins < 1:
        raise ValueError("K2 takes n_bins >= 1, got {}".format(n_bins))
    device = X.device
    _check_operand("X", X, torch.complex64, (2, F, T), device)
    _check_operand("W", W, torch.complex64, (2, 2, F), device)
    _check_operand("psum", psum, torch.float32, (2, T), device)
    plan = k2_launch_plan(F, T)
    stream = torch.cuda.current_stream(device).cuda_stream
    part, tickets = _scratch_for(device, stream, plan)
    W_new = torch.empty_like(W)
    psum_new = torch.empty_like(psum)
    stats = torch.empty((2,), dtype=torch.float32, device=device)
    status = _entry()(
        X.data_ptr(), W.data_ptr(), psum.data_ptr(), W_new.data_ptr(),
        psum_new.data_ptr(), stats.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        F, T, n_bins, plan.bins, int(plan.resident), plan.smem_bytes, code,
        eps, threshold, stream,
    )
    _build.check(status, "fused_auxiva_ip")
    fused_auxiva_ip_iter.launches += 1
    return W_new, psum_new, stats[0], stats[1]


fused_auxiva_ip_iter.launches = 0
watch("k2_launches", lambda: fused_auxiva_ip_iter.launches)
