"""Kernel K4: FastMNMF's per-bin diagonaliser sweep and power normalisation.

``fastmnmf_rows(U_planes, Q, g, W, ...)`` does, bin by bin, what follows
kernel K1 in one FastMNMF iteration
(``models/mnmf.py::FastMultichannelISNMF``):

1. the IP-style row sweep of the diagonaliser ``Q (F, C, C)``: for each row
   ``m``, from the rows as updated so far, ``QV = Q U_m``, its determinant
   and the column ``q_m = (QV)^-1 e_m`` by the adjugate; under the
   ``one_norm`` guard ``||QV||_1 ||QV^-1||_1 < threshold`` (a bin that
   fails, NaN included, keeps its old row); ``qVq = q_m^H U_m q_m``, the
   floored ``max(sqrt(qVq), eps)`` and the new row ``q_m^H`` over it;
2. with ``normalize``, the per-bin part of the power normalisation: ``QQsum
   = max(mean_m sum_c |Q_mc|^2, eps)``, ``Q /= sqrt(QQsum)``, ``g /=
   QQsum``; then ``g_sum = max(sum_m g, eps)``, ``g /= g_sum``, ``W *=
   g_sum``.

The sum over bins of ``W`` (an all-reduce under a bin-sharded mesh) and
what follows from it stay with the caller.

No Pallas kernel stands behind it: XLA fuses this elementwise chain in the
JAX package's jitted step.  In PyTorch it is some 160 launches an
iteration on ``(F,)`` slices, so on a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/fastmnmf_rows.cu`` (its source note gives
the design), one launch a call, C <= 4, complex64 or complex128; on a CPU
tensor it runs :func:`fastmnmf_rows_plain`.
"""

import ctypes

import torch

from . import _build
from ..runtime.cost_model import charged
from ..runtime.spanlog import watch
from ..utils.flooring import floor_below
from .fast_linalg import _sum
from .ip_components import assemble_components, det_components, solve_column_components

GUARDS = ("one_norm", "none")  # the C entry's guard code is the index
MAX_C = 4  # the kernel's compile-time instances: C = 1, ..., MAX_C

# the C entry's type codes, and each type's real type
_DTYPES = {torch.complex64: 0, torch.complex128: 1}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def fastmnmf_rows_plain(U_planes, Q, g, W, eps, threshold, guard="one_norm", normalize=True):
    """Plain PyTorch version of K4: the row sweep in component layout, then
    with ``normalize`` the per-bin power normalisation; returns ``(Q, g,
    W)`` (``g`` and ``W`` the inputs themselves without ``normalize``)."""
    C = Q.shape[-1]
    U_all = assemble_components(U_planes)
    Q_rows = [[Q[:, i, c] for c in range(C)] for i in range(C)]
    for m in range(C):
        U = U_all[m]
        QV = [[_sum(Q_rows[i][c] * U[c][j] for c in range(C)) for j in range(C)] for i in range(C)]
        det = det_components(QV, C)
        q_m = solve_column_components(QV, C, m, det=det)
        ok = None
        if guard == "one_norm":
            inv_cols = [solve_column_components(QV, C, j, det=det) for j in range(C)]
            norm = torch.stack([_sum(torch.abs(QV[i][j]) for i in range(C)) for j in range(C)]).amax(dim=0)
            inv_norm = torch.stack([_sum(torch.abs(inv_cols[j][i]) for i in range(C)) for j in range(C)]).amax(dim=0)
            ok = norm * inv_norm < threshold
        Uq = [_sum(U[c][d] * q_m[d] for d in range(C)) for c in range(C)]
        qVq = _sum((q_m[c].conj() * Uq[c]).real for c in range(C))
        denominator = floor_below(torch.sqrt(qVq), eps)
        for c in range(C):
            new_c = q_m[c].conj() / denominator
            Q_rows[m][c] = new_c if ok is None else torch.where(ok, new_c, Q_rows[m][c])
    Q = torch.stack([torch.stack(row, dim=-1) for row in Q_rows], dim=1)
    if normalize:
        return power_normalize_bins(Q, g, W, eps)
    return Q, g, W


def power_normalize_bins(Q, g, W, eps):
    """The per-bin part of the power normalisation (step 2 of the module
    docstring): ``Q (F, C, C)``, gains ``g (S, F, C)``, basis ``W (S, F,
    K)`` -> the new ``(Q, g, W)``."""
    QQsum = floor_below((Q * Q.conj()).real.sum(dim=2).mean(dim=1), eps)  # (F,)
    Q = Q / torch.sqrt(QQsum)[:, None, None].to(Q.dtype)
    g = g / QQsum[None, :, None]
    g_sum = floor_below(g.sum(dim=2), eps)
    g = g / g_sum[:, :, None]
    W = W * g_sum[:, :, None]
    return Q, g, W


def k4_cost(C, S, K, F, normalize, itemsize):
    """K4's compulsory ``(bytes, flops)`` for ``F`` bins of a ``C x C``
    diagonaliser of ``itemsize``-byte complex elements, ``S`` sources and
    ``K`` bases: the planes ``(C^2, F, C)`` read once and ``Q`` read and
    written once, with ``normalize`` ``g (S, F, C)`` and ``W (S, F, K)``
    too, all at ``Q``'s real type but ``Q``.  FLOPs a bin: for each of the
    ``C`` rows ``8 C^3`` for ``Q U_m``, ``8 C^3`` for its inverse (the cost
    model's ``linalg_inv_ex`` count at a complex type), ``8 C^2`` for ``U_m
    q_m`` and ``4 C`` for ``q_m^H U_m q_m``; with ``normalize`` ``6 C^2``
    for ``Q``'s power and scale, ``3 S C`` for the gains and ``S K`` for
    the basis."""
    real = itemsize // 2
    n_bytes = C * C * F * C * real + 2 * F * C * C * itemsize
    flops = F * C * (16 * C**3 + 8 * C**2 + 4 * C)
    if normalize:
        n_bytes += 2 * S * F * (C + K) * real
        flops += F * (6 * C**2 + 3 * S * C + S * K)
    return n_bytes, flops


def _entry():
    fn = _build.load("fastmnmf_rows").fastmnmf_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(U_planes, Q, g, W, guard):
    """Raise ``ValueError`` unless the operands are as K4 takes them on any
    device: ``Q (F, C, C)`` complex64 or complex128 with ``C <= MAX_C``,
    ``U_planes (C^2, F, C)``, ``g (S, F, C)`` and ``W (S, F, K)`` at its
    real type, all on one device; on CUDA each contiguous too."""
    if guard not in GUARDS:
        raise ValueError("K4 guard must be one of {}, got {!r}".format(GUARDS, guard))
    if Q.dtype not in _DTYPES or Q.ndim != 3 or Q.shape[1] != Q.shape[2] or not 1 <= Q.shape[2] <= MAX_C:
        raise ValueError("K4 takes a complex64 or complex128 (F, C, C) diagonaliser with C <= {}".format(MAX_C))
    F, C = Q.shape[0], Q.shape[2]
    real = _REAL[Q.dtype]
    if g.ndim != 3 or W.ndim != 3 or g.shape[1:] != (F, C) or W.shape[:2] != (g.shape[0], F):
        raise ValueError("K4 takes gains (S, F, C) and a basis (S, F, K) of the diagonaliser's bins")
    if tuple(U_planes.shape) != (C * C, F, C):
        raise ValueError("K4 takes the covariance planes (C^2, F, C) of the diagonaliser's bins")
    for name, t in (("planes", U_planes), ("gains", g), ("basis", W)):
        if t.dtype != real:
            raise ValueError("K4 takes the {} at the diagonaliser's real type {}, got {}".format(name, real, t.dtype))
    if any(t.device != Q.device for t in (U_planes, g, W)):
        raise ValueError("K4's operands must be on one device")
    if Q.device.type == "cuda" and not all(t.is_contiguous() for t in (U_planes, Q, g, W)):
        raise ValueError("K4 takes contiguous operands on CUDA")


def fastmnmf_rows(U_planes, Q, g, W, eps, threshold, guard="one_norm", normalize=True):
    """K4: FastMNMF's row sweep and per-bin power normalisation.

    Args:
        U_planes: ``(C^2, F, C)`` the frames-mean weighted covariances of
            the ``C`` rows, compact (K1's output).
        Q: ``(F, C, C)`` diagonaliser, complex64 or complex128, C <= 4.
        g: ``(S, F, C)`` gains; W: ``(S, F, K)`` basis; both at ``Q``'s
            real type.
        eps, threshold: the floors' ``eps`` and the guard's threshold.
        guard: ``"one_norm"`` or ``"none"``.
        normalize: whether to apply the per-bin power normalisation.
    Returns:
        ``(Q, g, W)``, new tensors (``g`` and ``W`` the inputs without
        ``normalize``).

    Inside a cost count (:mod:`~..runtime.cost_model`) a call is charged
    :func:`k4_cost` on either route.
    """

    def cost():
        C = Q.shape[-1]
        return k4_cost(C, g.shape[0], W.shape[2], Q.shape[0], normalize, Q.element_size())

    _check(U_planes, Q, g, W, guard)
    with charged("K4", cost):
        return _fastmnmf_rows(U_planes, Q, g, W, eps, threshold, guard, normalize)


def _fastmnmf_rows(U_planes, Q, g, W, eps, threshold, guard, normalize):
    if Q.device.type == "cpu":
        return fastmnmf_rows_plain(U_planes, Q, g, W, eps, threshold, guard, normalize)
    if Q.device.type != "cuda":
        raise ValueError("fastmnmf_rows: unsupported device {}".format(Q.device))
    F, C = Q.shape[0], Q.shape[2]
    S, K = W.shape[0], W.shape[2]
    Q_out = torch.empty_like(Q)
    g_out = torch.empty_like(g) if normalize else None
    W_out = torch.empty_like(W) if normalize else None
    status = _entry()(
        U_planes.data_ptr(), Q.data_ptr(), g.data_ptr(), W.data_ptr(), Q_out.data_ptr(),
        None if g_out is None else g_out.data_ptr(), None if W_out is None else W_out.data_ptr(),
        _DTYPES[Q.dtype], C, S, K, F, GUARDS.index(guard), int(bool(normalize)), float(eps), float(threshold),
        torch.cuda.current_stream(Q.device).cuda_stream,
    )
    _build.check(status, "fastmnmf_rows")
    fastmnmf_rows.launches += 1
    return (Q_out, g_out, W_out) if normalize else (Q_out, g, W)


fastmnmf_rows.launches = 0
watch("k4_launches", lambda: fastmnmf_rows.launches)
