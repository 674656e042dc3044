"""Kernel K1: weighted spatial covariance in compact Hermitian planes.

``weighted_covariance_planes(X, w)[p, f, n] = (1/T) sum_t w[n, (f,) t] plane_p(f, t)``
for ``(N, T)`` weights or per-bin ``(N, F, T)`` weights (ILRMA's), with the
C^2 compact pair-product planes of
:func:`~audio_source_separation_tpu_torch.ops.ip_components.pair_products_planes`.

Replaces ``audio_source_separation_tpu/ops/pallas_kernels.py::_cov_kernel``.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/weighted_covariance.cu`` (its source note gives the bound and the
design), one launch per covariance at any C, N, F and T, laid out by
:func:`k1_launch_plan`; on a CPU tensor it runs
:func:`weighted_covariance_planes_plain`.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from . import _build
from .ip_components import _covariance_planes, pair_products_planes


def weighted_covariance_planes_plain(X, weights):
    """Plain PyTorch version of K1: ``X (C, F, T)`` complex and ``(N, T)`` or
    ``(N, F, T)`` weights -> ``(C^2, F, N)`` real, via the pair-product planes
    and one ``(C^2 F, T) x (T, N)`` matmul (a bin-batched one for per-bin
    weights)."""
    return _covariance_planes(pair_products_planes(X), weights)


# Launch plan constants; each mirrors csrc/weighted_covariance.cu or the card.
WARPS = 8  # kWarps, per block
PAIRS_PER_UNIT = 4  # kPairs: channel pairs of one generic unit
ROWS_PER_UNIT = 8  # kRows: weight rows of one generic unit
SPECIALISED_C = 4  # compile-time instances for C <= SPECIALISED_C, N <= SPECIALISED_N
SPECIALISED_N = 4
MAX_STAGES = 2  # kMaxStages
SMEM_LIMIT = 232_448  # shared memory a Hopper block may opt into, bytes
STATIC_SMEM = 512  # bound on the kernel's static shared arrays (under 100 bytes)
# dynamic shared memory of each of two blocks on one SM (233,472 bytes, less
# 1 KB reserved per block)
TWO_PER_SM = (233_472 - 2 * 1024) // 2 - STATIC_SMEM
TARGET_BLOCKS = 256  # about two blocks per SM on the H100's 132 SMs
MIN_SPLIT_FRAMES = 256  # frames of the shortest span the frame axis is split into

K1Plan = namedtuple("K1Plan", "bins chunk stages splits span groups smem_bytes specialised per_bin")
K1Plan.__doc__ = """How K1 is launched for one ``(C, N, F, T)``.

A block takes ``bins`` consecutive bins (``groups`` groups in all) and one
of ``splits`` spans of ``span`` frames (even; the last may be shorter), so
the grid is ``groups * splits`` blocks.  It walks its span ``chunk``
frames (even) at a time through a ring of ``stages`` shared-memory
buffers, ``smem_bytes`` of dynamic shared memory in all.
``specialised``: a compile-time instance (C <= ``SPECIALISED_C``,
N <= ``SPECIALISED_N``), else the generic one.  ``per_bin``: the weights are
``(N, F, T)``, so a stage holds each of its bins' N weight rows beside the
bin's C rows of X (else the N rows of ``(N, T)`` weights, once).
"""


def _slot_bytes(chunk, size):
    """Stage bytes of one row of ``chunk`` elements of ``size`` bytes, with
    room for a start up to 15 bytes past a 16-byte boundary."""
    return -(-chunk * size // 16) * 16 + 16


def _stage_bytes(C, N, bins, chunk, per_bin=False):
    w_rows = N * bins if per_bin else N
    return C * bins * _slot_bytes(chunk, 8) + w_rows * _slot_bytes(chunk, 4)


def _fit(C, N, bins, room, per_bin):
    """The most frames (even) of a chunk whose stage fits in ``room`` bytes."""
    w_rows = N * bins if per_bin else N
    chunk = max(0, (room - 32 * (C * bins + w_rows)) // (8 * C * bins + 4 * w_rows)) // 2 * 2
    while _stage_bytes(C, N, bins, chunk + 2, per_bin) <= room:
        chunk += 2
    return chunk


@functools.lru_cache(maxsize=256)
def k1_launch_plan(C, N, F, T, per_bin=False):
    """The :class:`K1Plan` for a ``(C, F, T)`` mixture and ``(N, T)``
    weights, or ``(N, F, T)`` ones with ``per_bin``.

    Bins per block: 8 for the specialised instance (a warp each); for the
    generic one, 8 over the number of units a bin is cut into (at least 1).
    One split where the bin groups give ``TARGET_BLOCKS``, else the fewest
    that do, with spans of at least ``MIN_SPLIT_FRAMES``.  A span that fits
    in one stage beside a second block on the SM is one chunk; a longer one
    walks a ring of ``MAX_STAGES`` stages in as few chunks as fit two blocks
    per SM (one per SM where two do not fit).  Few chunks mean few and long
    bulk copies, which the kernel issues faster than many short ones.
    """
    if min(C, N, F, T) < 1:
        raise ValueError("K1 needs C, N, F, T >= 1, got C={}, N={}, F={}, T={}".format(C, N, F, T))
    specialised = C <= SPECIALISED_C and N <= SPECIALISED_N
    if specialised:
        bins = WARPS
    else:
        units = -(-(C * (C + 1) // 2) // PAIRS_PER_UNIT) * -(-N // ROWS_PER_UNIT)
        bins = max(1, WARPS // units)
    groups = -(-F // bins)
    splits = 1
    if groups < TARGET_BLOCKS:
        splits = max(1, min(-(-TARGET_BLOCKS // groups), T // MIN_SPLIT_FRAMES))
    span = 2 * -(-T // (2 * splits))
    splits = -(-T // span)
    sums = -(-C * C * bins * N * 4 // 16) * 16

    def plan(chunk, stages):
        return K1Plan(
            bins=bins, chunk=chunk, stages=stages, splits=splits, span=span, groups=groups,
            smem_bytes=stages * _stage_bytes(C, N, bins, chunk, per_bin) + sums, specialised=specialised,
            per_bin=per_bin,
        )

    if _stage_bytes(C, N, bins, span, per_bin) <= TWO_PER_SM - sums:
        return plan(span, 1)
    for budget in (TWO_PER_SM, SMEM_LIMIT - STATIC_SMEM):
        ring = _fit(C, N, bins, (budget - sums) // MAX_STAGES, per_bin)
        if ring >= 2:
            n_chunks = max(MAX_STAGES, -(-span // ring))
            return plan(2 * -(-span // (2 * n_chunks)), MAX_STAGES)
    raise ValueError("K1 cannot stage C={}, N={} in a block's shared memory".format(C, N))


def _entry():
    fn = _build.load("weighted_covariance").weighted_covariance_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# (device index, stream) -> (split rows, tickets); the kernel leaves the
# tickets at zero, so they are zeroed only when allocated
_scratch = {}


def _scratch_for(device, stream, plan, n_sums):
    key = (device.index, stream)
    part, tickets = _scratch.get(key, (None, None))
    n_part = plan.groups * plan.splits * n_sums
    if part is None or part.numel() < n_part:
        part = torch.empty((n_part,), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < plan.groups:
        tickets = torch.zeros((plan.groups,), dtype=torch.int32, device=device)
    _scratch[key] = (part, tickets)
    return part, tickets


def weighted_covariance_planes(X, weights):
    """K1: compact weighted covariance ``(C^2, F, N)``.

    Args:
        X: ``(C, F, T)`` complex mixture, any C >= 1.  On CUDA it must be
            contiguous complex64.
        weights: ``(N, T)`` real weights (``1/R``), or per-bin ``(N, F, T)``
            ones, any N >= 1.  On CUDA they must be contiguous float32 on
            the same device.
    """
    if X.device.type == "cpu":
        return weighted_covariance_planes_plain(X, weights)
    if X.device.type != "cuda":
        raise ValueError("weighted_covariance_planes: unsupported device {}".format(X.device))
    if X.dtype != torch.complex64 or not X.is_contiguous() or X.ndim != 3:
        raise ValueError("K1 takes a contiguous complex64 (C, F, T) mixture")
    C, F, T = X.shape
    if weights.dtype != torch.float32 or not weights.is_contiguous():
        raise ValueError("K1 takes contiguous float32 (N, T) or (N, F, T) weights")
    per_bin = weights.ndim == 3
    if weights.device != X.device or weights.shape[1:] not in ((T,), (F, T)):
        raise ValueError("K1 weights must be (N, T) or (N, F, T) on the mixture's device")
    N = weights.shape[0]
    plan = k1_launch_plan(C, N, F, T, per_bin)
    out = torch.empty((C * C, F, N), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    part = tickets = None
    if plan.splits > 1:
        part, tickets = _scratch_for(X.device, stream, plan, C * C * plan.bins * N)
    status = _entry()(
        X.data_ptr(), weights.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if tickets is None else tickets.data_ptr(),
        C, N, F, T, plan.bins, plan.chunk, plan.stages, plan.splits, plan.span, plan.smem_bytes,
        int(plan.specialised), int(plan.per_bin), stream,
    )
    _build.check(status, "weighted_covariance")
    weighted_covariance_planes.launches += 1
    return out


weighted_covariance_planes.launches = 0
